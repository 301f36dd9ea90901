"""The port's hot-object read tier (minio_tpu_torch/object/hotcache.py)
against the JAX package's (minio_tpu/object/hotcache.py), exact.

The frequency sketch's counters, doorkeeper and estimates after the same
records; admission, residency (probation and protected, in LRU order)
and counters after a seeded 10,000-access trace; the Date splice of a
captured head. Over HTTP on the port's server (in this process, on the
CPU): a GET, whole or ranged, miss or hit, answers the same status,
headers (but Date and x-amz-request-id) and bytes as a server with
MTPU_HOT_CACHE=off; a PUT or DELETE drops the entry; the kill switch.
Python's hash() is salted per process, so both caches run here, their
sketches given one seed.
"""

from __future__ import annotations

import os
import threading
import types

import numpy as np
import pytest

from minio_tpu.object import hotcache as jax_hot
from minio_tpu_torch import server
from minio_tpu_torch.object import hotcache
from tests.s3client import S3Client


def _pair(monkeypatch, max_entries=64, max_bytes=40_000, obj_max=6_000):
    monkeypatch.setenv("MTPU_HOT_CACHE_MAX", str(max_entries))
    monkeypatch.setenv("MTPU_HOT_CACHE_BYTES", str(max_bytes))
    monkeypatch.setenv("MTPU_HOT_CACHE_OBJ_MAX", str(obj_max))
    monkeypatch.delenv("MTPU_HOT_CACHE", raising=False)
    p = hotcache.HotObjectCache()
    j = jax_hot.HotObjectCache()
    j.attach_layer(None)
    p._sketch._seed = j._sketch._seed
    return p, j


def _residency(c):
    return list(c._probation), list(c._protected), c._bytes


@pytest.mark.parametrize("width", [16, 64, 1000])
def test_sketch_matches_jax(width):
    rng = np.random.default_rng(width)
    p, j = hotcache.FrequencySketch(width), jax_hot.FrequencySketch(width)
    p._seed = j._seed
    keys = [f"b/k{i}" for i in range(3 * width)]
    for step in range(20 * width):
        key = keys[int(rng.zipf(1.3)) % len(keys)]
        p.record(key)
        j.record(key)
        if step % 97 == 0:
            assert [p.estimate(k) for k in keys[:50]] == \
                [j.estimate(k) for k in keys[:50]]
    assert p._rows == j._rows and p._door == j._door
    assert p._increments == j._increments


def test_sketch_doorkeeper_and_aging():
    sk = hotcache.FrequencySketch(16)
    sk.record("k")
    assert sk.estimate("k") == 1          # the doorkeeper only
    for _ in range(30):
        sk.record("k")
    before = sk.estimate("k")
    sk._age()
    assert sk.estimate("k") < before
    sk.record("fresh")
    assert sk.estimate("fresh") == 1


@pytest.mark.parametrize("seed", [5, 6])
def test_seeded_trace_admission_and_residency_match_jax(monkeypatch, seed):
    """10,000 accesses over a skewed key set: a hit, or a miss whose
    admission decides a put; sometimes a raced put (a stale token) or
    a bucket invalidation. Same decisions, residency and counters."""
    p, j = _pair(monkeypatch)
    rng = np.random.default_rng(seed)
    sizes = {}
    for step in range(10_000):
        b = f"b{int(rng.integers(0, 3))}"
        k = f"k{int(rng.zipf(1.2)) % 400}"
        size = sizes.setdefault((b, k), int(rng.integers(1, 8_000)))
        stale = rng.random() < 0.02
        inv = rng.random() < 0.005
        outs = []
        for c in (p, j):
            entry = c.get(b, k)
            if entry is not None:
                outs.append(("hit", entry.body == bytes([len(k)]) * size))
                continue
            tok = c.token(b)
            ok = c.admit(b, k, size)
            put = c.put(b, k, types.SimpleNamespace(etag="e", version_id=""),
                        bytes([len(k)]) * size, None,
                        tok - 1 if stale else tok) if ok else None
            outs.append(("miss", ok, put))
            if inv:
                c.invalidate_bucket(b)
        assert outs[0] == outs[1], step
        assert _residency(p) == _residency(j), step
    assert p.stats() == j.stats()
    st = p.stats()
    assert st["hits"] and st["admits"] and st["rejects"] and st["evictions"]


def test_date_splice_matches_jax():
    head = (b"HTTP/1.1 200 OK\r\nServer: x\r\nDate: Mon, 01 Jan 2024 "
            b"00:00:00 GMT\r\nContent-Length: 3\r\n\r\n")
    assert hotcache.split_head(head) == jax_hot.split_head(head)
    pre, suf = hotcache.split_head(head)
    assert pre + b"Mon, 01 Jan 2024 00:00:00 GMT" + suf == head
    assert hotcache.split_head(b"HTTP/1.1 200 OK\r\n\r\n") is None
    assert hotcache.date_bytes().endswith(b" GMT")


def test_kill_switch(monkeypatch):
    for v in ("0", "off", "false"):
        monkeypatch.setenv("MTPU_HOT_CACHE", v)
        c = hotcache.HotObjectCache()
        assert not c.enabled and not jax_hot.HotObjectCache().enabled
        assert not c.admit("b", "k", 10)
        assert c.get("b", "k") is None
        assert c.stats()["misses"] == 0


# ---------------------------------------------------------------------------
# over HTTP
# ---------------------------------------------------------------------------

def _boot(root, monkeypatch, hot: str):
    monkeypatch.setenv("MTPU_HOT_CACHE", hot)
    srv = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                       "--scanner-interval", "0",
                       *[str(root / f"d{i}") for i in range(4)]])
    srv.objects.sets[0]._mrf_closed = True
    srv.start()
    return srv


@pytest.fixture()
def on_off(tmp_path, monkeypatch):
    srvs = [_boot(tmp_path / "on", monkeypatch, "on"),
            _boot(tmp_path / "off", monkeypatch, "off")]
    try:
        yield srvs
    finally:
        for s in srvs:
            s.stop()


def _get(addr, path, headers=None):
    st, h, body = S3Client(addr).request("GET", path, headers=headers)
    h = {k.lower(): v for k, v in h.items()
         if k.lower() not in ("date", "x-amz-request-id")}
    return st, h, body


def test_get_byte_identical_with_cache_on_and_off(on_off):
    on, off = on_off
    assert on.hot_cache.enabled and not off.hot_cache.enabled
    body = os.urandom(3_000)
    for s in on_off:
        c = S3Client(s.address)
        assert c.request("PUT", "/hot")[0] == 200
        assert c.request("PUT", "/hot/obj", body=body,
                         headers={"x-amz-meta-color": "blue"})[0] == 200
    for headers in (None, None, {"Range": "bytes=10-99"}, None,
                    {"Range": "bytes=-7"}, {"x-amz-checksum-mode":
                                            "ENABLED"}):
        a, b = _get(on.address, "/hot/obj", headers), \
            _get(off.address, "/hot/obj", headers)
        # Last-Modified is the stored version's: the two servers' PUT
        # times differ.
        a[1].pop("last-modified"), b[1].pop("last-modified")
        assert a == b
        assert a[0] in (200, 206)
    st = on.hot_cache.stats()
    assert st["admits"] == 1 and st["hits"] >= 4
    assert off.hot_cache.stats()["hits"] == 0
    entry = on.hot_cache.get("hot", "obj")
    assert entry.head_prefix.startswith(b"HTTP/1.1 200 OK\r\n")
    assert b"Content-Length: 3000\r\n" in entry.head_prefix + \
        entry.head_suffix
    # A PUT drops the entry; the next GET serves the new bytes.
    new = os.urandom(2_000)
    assert S3Client(on.address).request("PUT", "/hot/obj",
                                        body=new)[0] == 200
    assert on.hot_cache.stats()["entries"] == 0
    assert _get(on.address, "/hot/obj")[2] == new
    assert S3Client(on.address).request("DELETE", "/hot/obj")[0] == 204
    assert _get(on.address, "/hot/obj")[0] == 404


def test_concurrent_overwrites_never_serve_stale(on_off):
    """One writer overwrites a key with numbered bodies while readers
    GET it: a reader never sees a body older than the last one
    acknowledged before its GET began."""
    on = on_off[0]
    addr = on.address
    assert S3Client(addr).request("PUT", "/race")[0] == 200
    acked = [-1]
    stop = threading.Event()
    bad = []

    def body(i):
        return i.to_bytes(4, "big") * 300

    def writer():
        for i in range(25):
            assert S3Client(addr).request("PUT", "/race/k",
                                          body=body(i))[0] == 200
            acked[0] = i
        stop.set()

    def reader():
        while not stop.is_set():
            floor = acked[0]
            st, _, got = S3Client(addr).request("GET", "/race/k")
            if st == 200 and int.from_bytes(got[:4], "big") < floor:
                bad.append((floor, got[:4]))

    threads = [threading.Thread(target=writer)] + \
        [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert on.hot_cache.stats()["invalidations"] >= 25

"""The port's quorum-fileinfo cache (minio_tpu_torch/object/fi_cache.py)
against the JAX package's (minio_tpu/object/fi_cache.py), exact.

A seeded trace of token / put / get / put_stat / get_stat /
invalidate_bucket / invalidate_all over both caches, under count and
byte bounds, gives the same hits, misses, evictions, invalidations and
entries at every step. Then the JAX package's object-layer cases
(tests/test_get_path.py) on the port's ErasureSet on the CPU: a repeat
GET and HEAD make no read_version call, overwrite, delete and heal
invalidate, parity holders' inline blobs are stripped (and re-read from
the drives when a read needs them), the kill switch, and versions cached
per version id.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile

import numpy as np
import pytest

from minio_tpu.object.fi_cache import FileInfoCache as JaxCache
from minio_tpu.storage import meta as jax_meta
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.fi_cache import FileInfoCache
from minio_tpu_torch.object.types import GetOptions, ObjectNotFound, PutOptions
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import LocalStorage

RNG = np.random.default_rng(20261017)


def _fis(meta, k: int, m: int, vid: str, blob: int, inline: bool):
    """One version's quorum fi and per-drive fis in `meta`'s types."""
    fis = []
    for i in range(k + m):
        data = bytes([i + 1]) * blob if inline else None
        fis.append(meta.FileInfo(
            volume="b", name="o", version_id=vid, data_dir="dd",
            size=k * blob,
            erasure=meta.ErasureInfo(data_blocks=k, parity_blocks=m,
                                     index=i + 1),
            inline_data=data))
    return dataclasses.replace(fis[0], inline_data=None), fis


def _view(got):
    """What a lookup returned, comparable across the two packages."""
    if got is None:
        return None
    if isinstance(got, tuple):
        fi, fis = got
        return (fi.version_id, fi.size,
                [None if f is None else f.inline_data for f in fis])
    return got.version_id, got.size, got.inline_data


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_trace_matches_jax(seed):
    rng = np.random.default_rng(seed)
    bounds = dict(max_entries=12, max_bytes=6000, max_stat=9, enabled=True)
    caches = [FileInfoCache(**bounds), JaxCache(**bounds)]
    buckets = ["b0", "b1", "b2"]
    keys = [f"k{i}" for i in range(20)]
    tokens: dict = {}
    for step in range(3000):
        op = rng.choice(["token", "put", "get", "put_stat", "get_stat",
                         "inv", "inv_all"], p=[.2, .25, .25, .1, .12, .07,
                                               .01])
        b = str(rng.choice(buckets))
        key = str(rng.choice(keys))
        vid = str(rng.choice(["", "v1"]))
        k, m = int(rng.integers(1, 5)), int(rng.integers(0, 3))
        blob, inline = int(rng.integers(1, 300)), bool(rng.integers(0, 2))
        read_data = bool(rng.integers(0, 2))
        stale = bool(rng.random() < 0.1)
        outs = []
        for i, (c, meta) in enumerate(zip(caches, (port_meta, jax_meta))):
            if op == "token":
                tokens[(i, b)] = c.token(b)
                outs.append(tokens[(i, b)])
            elif op in ("put", "put_stat"):
                tok = tokens.get((i, b), 0) - (1 if stale else 0)
                fi, fis = _fis(meta, k, m, vid, blob, inline)
                if op == "put":
                    c.put(b, key, vid, fi, fis, read_data, tok)
                else:
                    c.put_stat(b, key, vid, fi, tok)
                outs.append(None)
            elif op == "get":
                outs.append(_view(c.get(b, key, vid, need_data=read_data)))
            elif op == "get_stat":
                outs.append(_view(c.get_stat(b, key, vid)))
            elif op == "inv":
                c.invalidate_bucket(b)
                outs.append(None)
            else:
                c.invalidate_all()
                outs.append(None)
        assert outs[0] == outs[1], (step, op)
        assert caches[0].stats() == caches[1].stats(), (step, op)
    st = caches[0].stats()
    assert st["hits"] and st["misses"] and st["evictions"] \
        and st["stat_hits"] and st["stat_evictions"] and st["invalidations"]


def test_parity_blobs_stripped_like_jax():
    caches = [FileInfoCache(enabled=True), JaxCache(enabled=True)]
    for c, meta in zip(caches, (port_meta, jax_meta)):
        fi, fis = _fis(meta, 4, 2, "", 100, True)
        c.put("b", "o", "", fi, fis, True, c.token("b"))
        entry = c._map[("b", "o", "")]
        assert [f.inline_data for f in entry["fis"]] == \
            [bytes([i + 1]) * 100 for i in range(4)] + [b"", b""]
        assert entry["bytes"] == 400
        assert fis[4].inline_data, "the caller's fis must stay whole"


def test_kill_switch_env(monkeypatch):
    for v in ("0", "off", "OFF", "false"):
        monkeypatch.setenv("MTPU_FILEINFO_CACHE", v)
        assert not FileInfoCache().enabled and not JaxCache().enabled
    monkeypatch.setenv("MTPU_FILEINFO_CACHE", "on")
    monkeypatch.setenv("MTPU_FILEINFO_CACHE_MAX", "7")
    monkeypatch.setenv("MTPU_FILEINFO_CACHE_BYTES", "-1")
    monkeypatch.setenv("MTPU_FILEINFO_STAT_MAX", "junk")
    p, j = FileInfoCache(), JaxCache()
    assert (p.enabled, p.max_entries, p.max_bytes, p.max_stat) == \
        (j.enabled, j.max_entries, j.max_bytes, j.max_stat) == \
        (True, 7, 256 << 20, 65536)


# ---------------------------------------------------------------------------
# on the port's ErasureSet
# ---------------------------------------------------------------------------

class CountingDisk:
    """Delegating wrapper that counts read_version calls."""

    def __init__(self, inner):
        self._inner = inner
        self.read_version_calls = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def read_version(self, *a, **kw):
        self.read_version_calls += 1
        return self._inner.read_version(*a, **kw)


@pytest.fixture()
def es6():
    root = tempfile.mkdtemp(prefix="torch-ficache-")
    disks = [CountingDisk(LocalStorage(f"{root}/d{i}")) for i in range(6)]
    for d in disks:
        d.make_vol("b")
    es = ErasureSet(disks, parity=2, device="cpu")
    es._mrf_closed = True
    yield es, disks
    es.close()
    shutil.rmtree(root, ignore_errors=True)


def _body(n: int) -> bytes:
    return RNG.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def test_repeat_get_zero_drive_metadata_calls(es6):
    es, disks = es6
    body = _body(70_000)
    es.put_object("b", "hot", body)
    assert es.get_object("b", "hot")[1] == body     # cold: the fan-out
    before = sum(d.read_version_calls for d in disks)
    for _ in range(3):
        assert es.get_object("b", "hot")[1] == body
    es.get_object_info("b", "hot")
    assert sum(d.read_version_calls for d in disks) == before
    st = es.fi_cache.stats()
    assert st["hits"] >= 3 and st["stat_hits"] >= 1


def test_cache_invalidation_overwrite_delete(es6):
    es, _ = es6
    es.put_object("b", "k", b"v1" * 5000)
    assert es.get_object("b", "k")[1] == b"v1" * 5000
    es.put_object("b", "k", b"v2" * 7000)
    assert es.get_object("b", "k")[1] == b"v2" * 7000
    es.delete_object("b", "k")
    with pytest.raises(ObjectNotFound):
        es.get_object("b", "k")


def test_cache_strips_parity_inline_blobs(es6):
    """Only the k data holders' inline payloads stay resident; a read
    that needs parity (a corrupt cached data blob) re-reads those
    holders' journals and still returns the bytes."""
    es, disks = es6
    body = _body(9_000)
    es.put_object("b", "striped", body)
    assert es.get_object("b", "striped")[1] == body
    entry = es.fi_cache._map[("b", "striped", "")]
    k = entry["fi"].erasure.data_blocks
    data = [f for f in entry["fis"] if f.erasure.index <= k]
    parity = [f for f in entry["fis"] if f.erasure.index > k]
    assert parity and all(f.inline_data == b"" for f in parity)
    assert all(f.inline_data for f in data)
    assert entry["bytes"] == sum(len(f.inline_data) for f in data)
    before = sum(d.read_version_calls for d in disks)
    assert es.get_object("b", "striped")[1] == body
    assert sum(d.read_version_calls for d in disks) == before
    victim = next(i for i, f in enumerate(entry["fis"])
                  if f.erasure.index <= k)
    f = entry["fis"][victim]
    bad = bytearray(f.inline_data)
    bad[len(bad) // 2] ^= 0xFF
    entry["fis"][victim] = dataclasses.replace(f, inline_data=bytes(bad))
    assert es.get_object("b", "striped")[1] == body
    assert sum(d.read_version_calls for d in disks) > before


def test_cache_invalidation_heal(es6):
    es, disks = es6
    body = _body(40_000)
    es.put_object("b", "healme", body)
    assert es.get_object("b", "healme")[1] == body
    disks[2].delete("b", "healme", recursive=True)
    inv0 = es.fi_cache.stats()["invalidations"]
    assert es.heal_object("b", "healme").healed >= 1
    assert es.fi_cache.stats()["invalidations"] > inv0
    assert es.get_object("b", "healme")[1] == body


def test_cache_disabled_by_env(monkeypatch, tmp_path):
    monkeypatch.setenv("MTPU_FILEINFO_CACHE", "0")
    disks = [LocalStorage(str(tmp_path / f"d{i}")) for i in range(4)]
    for d in disks:
        d.make_vol("b")
    es = ErasureSet(disks, parity=1, device="cpu")
    try:
        es.put_object("b", "o", b"z" * 3000)
        es.get_object("b", "o")
        es.get_object("b", "o")
        st = es.fi_cache.stats()
        assert not st["enabled"] and st["hits"] == 0 and st["entries"] == 0
    finally:
        es.close()


def test_versioned_get_cached_per_version(es6):
    es, disks = es6
    v1 = es.put_object("b", "ver", b"a" * 2000,
                       PutOptions(versioned=True)).version_id
    v2 = es.put_object("b", "ver", b"b" * 2000,
                       PutOptions(versioned=True)).version_id
    assert es.get_object("b", "ver", GetOptions(version_id=v1))[1] \
        == b"a" * 2000
    assert es.get_object("b", "ver", GetOptions(version_id=v2))[1] \
        == b"b" * 2000
    assert es.get_object("b", "ver")[1] == b"b" * 2000
    before = sum(d.read_version_calls for d in disks)
    assert es.get_object("b", "ver", GetOptions(version_id=v1))[1] \
        == b"a" * 2000
    assert es.get_object("b", "ver")[1] == b"b" * 2000
    assert sum(d.read_version_calls for d in disks) == before


def test_degraded_read_is_not_cached(es6):
    """Only fully healthy reads fill the cache: with one drive's copy
    gone, every GET re-reads (and queues its MRF heal)."""
    es, disks = es6
    body = _body(5_000)
    es.put_object("b", "deg", body)
    disks[0].delete("b", "deg", recursive=True)
    for _ in range(2):
        assert es.get_object("b", "deg")[1] == body
    assert ("b", "deg", "") not in es.fi_cache._map

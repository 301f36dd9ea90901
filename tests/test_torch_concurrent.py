"""Concurrent PUT / GET / degraded GET through the port's stripe batchers.

Eight threads PUT objects of 2-9 MiB at once into a 12-drive EC 8+4
ErasureSet(device="cpu") of the port (every kernel runs its plain PyTorch
version) and into the TPU package's set. Every key shares one
`hash_order`, so one survivor set serves every degraded read. Shard files
must be byte-identical per drive; concurrent GETs, healthy (all eight)
and with the 4 data-shard drives of that distribution wiped (four), must
return the PUT bytes; and `batcher_stats()` must show windows of several
requests in one device dispatch on each of the put, get and reconstruct
routes, with no host dispatch. A window pinned to the host (MTPU_BATCH_FORCE=host) is
counted as a host window.
"""

import os
import threading
import zlib

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.io.bufpool import global_pool
from minio_tpu_torch.object.erasure_object import ErasureSet, hash_order
from minio_tpu_torch.storage.local import LocalStorage
from tests.torch_no_caches import no_read_caches  # noqa: F401

N = 12
MIB = 1 << 20
BUCKET = "conc"
THREADS = 8


def _keys(count: int) -> list[str]:
    """Keys whose `hash_order` over 12 drives is the same."""
    want = zlib.crc32(f"{BUCKET}/obj-0-0".encode()) % N
    keys, i, salt = [], 0, 0
    while len(keys) < count:
        key = f"obj-{i}-{salt}"
        if zlib.crc32(f"{BUCKET}/{key}".encode()) % N == want:
            keys.append(key)
            i, salt = i + 1, 0
        else:
            salt += 1
    return keys


KEYS = _keys(THREADS)
DEGRADED = KEYS[:4]
# 2..8 MiB and 9 MiB + a ragged tail (a 1 MiB object at EC 8+4 would go
# inline into xl.meta, with no part file to compare).
SIZES = [(i + 2) * MIB for i in range(THREADS - 1)] + [9 * MIB + 12345]


def _run_threads(fn, items):
    """fn(item) on one thread per item, started together; results in order."""
    barrier = threading.Barrier(len(items))
    out, errs = [None] * len(items), []

    def work(i, item):
        barrier.wait()
        try:
            out[i] = fn(item)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)
    threads = [threading.Thread(target=work, args=(i, it))
               for i, it in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errs, errs
    return out


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    # Wide coalescing windows: the threads' windows meet in one dispatch
    # even on a loaded machine, where the plain hashing before a degraded
    # read's reconstruct takes seconds per request.
    mp.setenv("MTPU_BATCH_WAIT_MS", "500")
    mp.setenv("MTPU_GET_BATCH_WAIT_MS", "2000")
    mp.delenv("MTPU_BATCH_FORCE", raising=False)
    root = tmp_path_factory.mktemp("conc")
    ref = RefSet([RefDisk(str(root / f"r{i}")) for i in range(N)])
    ref._mrf_closed = True
    port = ErasureSet([LocalStorage(str(root / f"p{i}")) for i in range(N)],
                      device="cpu")
    port._mrf_closed = True
    rng = np.random.default_rng(77)
    objs = {k: rng.bytes(s) for k, s in zip(KEYS, SIZES)}
    for s in (ref, port):
        s.make_bucket(BUCKET)
        _run_threads(lambda k, s=s: s.put_object(BUCKET, k, objs[k]), KEYS)
    yield root, ref, port, objs
    mp.undo()
    ref.close()
    port.close()


def _part(root, prefix, i, key):
    parts = list((root / f"{prefix}{i}" / BUCKET / key).glob("*/part.1"))
    assert len(parts) == 1
    return parts[0].read_bytes()


@pytest.mark.parametrize("key", KEYS)
def test_concurrent_put_shard_files_identical(sets, key):
    root, _, _, _ = sets
    for i in range(N):
        assert _part(root, "p", i, key) == _part(root, "r", i, key), \
            f"drive {i} differs"


def test_put_coalesced_on_the_device_route(sets):
    _, _, port, _ = sets
    st = port.batcher_stats()
    put = st["routes"]["put"]
    assert put["multi_member_dispatches"] >= 1 and put["max_members"] >= 2
    assert put["dispatches"]["host"] == 0
    assert put["requests"]["device"] == THREADS
    assert put["requests"]["host"] == put["requests"]["bypass"] == 0
    assert put["dispatches"]["device"] < THREADS
    assert set(put["buckets"]) <= {8, 16, 32, 64, 128, 256}
    assert 0 < put["fill_ratio"] <= 1
    assert put["wait_hist"]["count"] == THREADS
    assert st["windows"]["device"]["put"] == THREADS
    assert st["windows"]["host"]["put"] == 0
    assert st["lane"]["service_hist"]["count"] >= put["dispatches"]["device"]
    for key in ("lane_round_trip_hist", "lane_wait_hist",
                "lane_service_hist"):
        assert put[key]["count"] == put["dispatches"]["device"], key
    assert put["lane_round_trip_hist"]["sum"] >= \
        put["lane_service_hist"]["sum"]


def test_concurrent_get_then_degraded_get(sets):
    root, _, port, objs = sets
    got = _run_threads(lambda k: port.get_object(BUCKET, k)[1], KEYS)
    assert all(g == objs[k] for g, k in zip(got, KEYS))
    dist = hash_order(f"{BUCKET}/{KEYS[0]}", N)
    wiped = [i for i in range(N) if dist[i] - 1 < 4]   # data shards 0-3
    # The survivor set's batcher, held busy for the phase: on the CPU each
    # degraded read first hashes its survivors for seconds, so the first
    # to finish would otherwise run alone before the others arrive.
    rec = port._batcher("reconstruct", 8, 4, tuple(range(4, 12)),
                        (0, 1, 2, 3))
    with rec._mu:
        rec._inflight += 1
    moved = []
    try:
        for i in wiped:
            for k in KEYS:
                src = root / f"p{i}" / BUCKET / k
                dst = root / f"p{i}" / f"wiped-{k}"
                os.rename(src, dst)
                moved.append((dst, src))
        # Half the objects: the plain HighwayHash of every survivor block
        # (one per request, outside the batchers) is slow on the CPU.
        got = _run_threads(lambda k: port.get_object(BUCKET, k)[1],
                           DEGRADED)
        assert all(g == objs[k] for g, k in zip(got, DEGRADED))
    finally:
        with rec._mu:
            rec._inflight -= 1
        for dst, src in moved:
            os.rename(dst, src)
    st = port.batcher_stats()
    for route, members in (("get", THREADS), ("reconstruct", len(DEGRADED))):
        r = st["routes"][route]
        assert r["multi_member_dispatches"] >= 1, route
        assert r["dispatches"]["host"] == 0, route
        assert r["requests"]["device"] == members, route
        assert st["windows"]["host"][route] == 0
    # One survivor set served every degraded read: one reconstruct batcher.
    names = [sb.name for sb in port._batchers.values()
             if sb.route == "reconstruct"]
    assert len(names) == 1, names
    assert global_pool("cpu").stats()["outstanding"] == 0


def test_forced_host_route_is_counted_as_host(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_BATCH_FORCE", "put=host")
    es = ErasureSet([LocalStorage(str(tmp_path / f"d{i}")) for i in range(N)],
                    device="cpu")
    try:
        es.make_bucket(BUCKET)
        data = np.random.default_rng(5).bytes(MIB + 7)
        es.put_object(BUCKET, "h", data)
        assert es.get_object(BUCKET, "h")[1] == data
        st = es.batcher_stats()
        assert st["windows"]["host"]["put"] == 1
        assert st["windows"]["device"]["put"] == 0
        assert st["windows"]["device"]["get"] == 1
        assert st["routes"]["put"]["requests"]["bypass"] == 1
        assert st["routes"]["put"]["dispatches"]["device"] == 0
    finally:
        es.close()

"""The port's namespace lock (object/nslock.py) and the GET it guards.

  * the JAX package's nslock cases (tests/test_nslock_and_fixes.py)
    against the port's NSLockMap: a writer excludes a writer, readers
    share and exclude writers (the map empties after), keys are
    independent;
  * the one-key write storm on the port's set: 8 threads overwrite and
    delete one key, and the end state is one writer's bytes or a clean
    404, every drive agreeing on the quorum version;
  * C6, on both packages: a GET streaming a 64 MiB + 1 B object (three
    32 MiB windows) while the key is overwritten with 1 KiB on another
    thread returns the old bytes whole, the overwrite finishes only
    after the stream is closed, and a GET after it returns the new
    bytes (the port used to fail the stream after its first window);
  * a stream closed before its first chunk releases the read lock.

Exact comparisons: bytes and lock states.
"""

import threading
import time

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.nslock import LockTimeout, NSLockMap
from minio_tpu_torch.object.types import ObjectNotFound
from minio_tpu_torch.storage.local import LocalStorage

MIB = 1 << 20


def port_set(root, n=4):
    es = ErasureSet([LocalStorage(str(root / f"d{i}")) for i in range(n)],
                    device="cpu")
    es._mrf_closed = True
    es.make_bucket("bkt")
    return es


def test_nslock_write_excludes_write():
    ns = NSLockMap()
    with ns.write("b", "o"):
        with pytest.raises(LockTimeout):
            with ns.write("b", "o", timeout=0.1):
                pass
    with ns.write("b", "o", timeout=1):
        pass


def test_nslock_readers_share_writers_exclude():
    ns = NSLockMap()
    with ns.read("b", "o"):
        with ns.read("b", "o"):
            with pytest.raises(LockTimeout):
                with ns.write("b", "o", timeout=0.1):
                    pass
    with ns.write("b", "o", timeout=1):
        pass
    assert not ns._locks


def test_nslock_keys_independent():
    ns = NSLockMap()
    with ns.write("b", "o1"):
        with ns.write("b", "o2", timeout=0.5):
            pass


def test_one_key_write_storm_stays_consistent(tmp_path):
    es = port_set(tmp_path)
    n_threads, n_rounds = 8, 6
    payloads = [f"writer-{t}".encode() * 4096 for t in range(n_threads)]
    errs = []

    def writer(t):
        try:
            for r in range(n_rounds):
                if t % 3 == 2 and r % 2 == 1:
                    try:
                        es.delete_object("bkt", "hot")
                    except ObjectNotFound:
                        pass
                else:
                    es.put_object("bkt", "hot", payloads[t])
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert not errs, errs[:3]
        try:
            _, got = es.get_object("bkt", "hot")
        except ObjectNotFound:
            return
        assert got in payloads
        fi, fis, _ = es._quorum_fileinfo("bkt", "hot", False)
        assert fi.mod_time in {f.mod_time for f in fis if f is not None}
    finally:
        es.close()


def _stream_during_overwrite(es, get_stream):
    """Open the stream, take its first chunk, overwrite the key with
    1 KiB on a thread, drain. (the streamed bytes, the overwrite's end
    time, the stream's close time)."""
    rng = np.random.default_rng(6)
    body = rng.bytes(64 * MIB + 1)
    es.put_object("bkt", "big", body)
    _, chunks = get_stream()
    got = [bytes(next(chunks))]
    ended = {}

    def overwrite():
        es.put_object("bkt", "big", b"n" * 1024)
        ended["t"] = time.monotonic()

    th = threading.Thread(target=overwrite)
    th.start()
    time.sleep(0.3)             # the overwrite is waiting on the lock now
    got += [bytes(c) for c in chunks]
    closed = time.monotonic()
    th.join(60)
    assert not th.is_alive()
    return body, b"".join(got), ended["t"], closed


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_get_stream_survives_overwrite(tmp_path, pkg):
    """C6: the GET holds the key's read lock until its stream ends."""
    if pkg == "port":
        es = port_set(tmp_path, n=12)
        stream = lambda: es.get_object_stream("bkt", "big")  # noqa: E731
    else:
        es = RefSet([RefDisk(str(tmp_path / f"r{i}")) for i in range(12)])
        es._mrf_closed = True
        es.make_bucket("bkt")
        stream = lambda: es.get_object_stream("bkt", "big")  # noqa: E731
    try:
        body, got, ended, closed = _stream_during_overwrite(es, stream)
        assert got == body
        assert ended >= closed
        assert es.get_object("bkt", "big")[1] == b"n" * 1024
    finally:
        if pkg == "port":
            es.close()


def test_stream_closed_before_first_chunk_unlocks(tmp_path):
    es = port_set(tmp_path)
    try:
        es.put_object("bkt", "k", b"v" * 5000)
        _, chunks = es.get_object_stream("bkt", "k")
        assert ("bkt", "k") in es.ns._locks
        chunks.close()
        assert not es.ns._locks
        with es.ns.write("bkt", "k", timeout=0.5):
            pass
        es.put_object("bkt", "k", b"w" * 10)
        assert es.get_object("bkt", "k")[1] == b"w" * 10
    finally:
        es.close()

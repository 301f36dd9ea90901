"""The port's streaming data plane on the CPU, against the JAX package.

Streamed PUT (object/erasure_object.py `_stream_framed_writes`: windows
read into pooled leases, one writer thread per drive behind a bounded
queue, the MD5 on its own thread) and the GET readahead, with the port's
STREAM_WINDOW_BLOCKS cut to 2 so that a few MiB span several windows:

  * shard files and GET bytes are byte-identical to the JAX package's
    for 0 B, 1 B, 3 MiB + 5 B and a 4-window object, healthy and with 4
    data-shard drives wiped; the ETag is the body's MD5;
  * a writer that dies after window 1 leaves the object readable when m
    or fewer drives fail; past m the PUT is WriteQuorumError and leaves
    no staging debris;
  * the producer never reads more than WRITE_QUEUE_DEPTH + 2 windows
    ahead of the slowest writer;
  * a GET iterator closed after its first chunk, and every PUT, leave no
    pool lease outstanding;
  * over HTTP (the port's S3Server in this process, device="cpu"): a
    wrong x-amz-content-sha256 answers 400, keeps the previous version
    and leaves no debris; an UNSIGNED-PAYLOAD body is never hashed.
"""

import hashlib
import http.client
import os
import threading

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu_torch.io.bufpool import global_pool
from minio_tpu_torch.object import erasure_object as eo
from minio_tpu_torch.object.types import WriteQuorumError
from minio_tpu_torch.s3 import sigv4
from minio_tpu_torch.storage.local import SYS_VOL, LocalStorage
from minio_tpu_torch.utils.streams import Payload
from tests.torch_no_caches import no_read_caches  # noqa: F401

N = 12
MIB = 1 << 20
BUCKET = "stream"
WIN_BLOCKS = 2
WINDOW = WIN_BLOCKS * eo.BLOCK_SIZE
SIZES = {"empty": 0, "one": 1, "tail": 3 * MIB + 5, "windows": 7 * MIB + 3}


@pytest.fixture(autouse=True)
def small_windows(monkeypatch):
    monkeypatch.setattr(eo, "STREAM_WINDOW_BLOCKS", WIN_BLOCKS)


def _outstanding() -> int:
    return global_pool("cpu").stats()["outstanding"]


def _staging_debris(root, prefix="p") -> list:
    out = []
    for i in range(N):
        d = root / f"{prefix}{i}" / SYS_VOL / eo.STAGING_PREFIX
        if d.exists():
            out += [str(p) for p in d.iterdir()]
    return out


def _port_set(root, prefix="p") -> eo.ErasureSet:
    es = eo.ErasureSet([LocalStorage(str(root / f"{prefix}{i}"))
                        for i in range(N)], device="cpu")
    es._mrf_closed = True         # no background heals under the tests
    return es


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("streaming")
    ref = RefSet([RefDisk(str(root / f"r{i}")) for i in range(N)])
    ref._mrf_closed = True        # no background heals under the tests
    mp = pytest.MonkeyPatch()
    mp.setattr(eo, "STREAM_WINDOW_BLOCKS", WIN_BLOCKS)
    port = _port_set(root)
    rng = np.random.default_rng(77)
    objs = {name: rng.bytes(size) for name, size in SIZES.items()}
    infos = {}
    try:
        for s in (ref, port):
            s.make_bucket(BUCKET)
        for name, data in objs.items():
            ref.put_object(BUCKET, name, data)
            infos[name] = port.put_object(BUCKET, name, data)
    finally:
        mp.undo()
    yield root, port, objs, infos
    ref.close()
    port.close()


def _part(root, prefix, i, name):
    parts = list((root / f"{prefix}{i}" / BUCKET / name).glob("*/part.1"))
    return parts[0].read_bytes() if parts else None


@pytest.mark.parametrize("name", sorted(SIZES))
def test_streamed_shard_files_identical(sets, name):
    root, _, objs, infos = sets
    for i in range(N):
        assert _part(root, "p", i, name) == _part(root, "r", i, name), \
            f"drive {i} part.1 differs"
    inline = [RefDisk(str(root / f"r{i}")).read_version(
        BUCKET, name, "", read_data=True).inline_data for i in range(N)]
    got = [LocalStorage(str(root / f"p{i}")).read_version(
        BUCKET, name, "", read_data=True).inline_data for i in range(N)]
    assert [bytes(x) if x is not None else None for x in got] == \
        [bytes(x) if x is not None else None for x in inline]
    assert infos[name].etag == hashlib.md5(objs[name]).hexdigest()
    assert not _staging_debris(root)


@pytest.mark.parametrize("name", sorted(SIZES))
@pytest.mark.parametrize("wiped", [0, 4])
def test_streamed_get_identical(sets, name, wiped, monkeypatch):
    root, port, objs, _ = sets
    dist = eo.hash_order(f"{BUCKET}/{name}", N)
    holders = [i for i in range(N) if dist[i] - 1 < 8][:wiped]
    moved = []
    try:
        for i in holders:
            src = root / f"p{i}" / BUCKET / name
            if src.exists():
                dst = root / f"p{i}" / f"wiped-{name}"
                os.rename(src, dst)
                moved.append((dst, src))
        before = port.device_windows["reconstruct"]
        assert port.get_object(BUCKET, name)[1] == objs[name]
        if wiped and len(objs[name]) >= eo.BLOCK_SIZE:
            assert port.device_windows["reconstruct"] > before
    finally:
        for dst, src in moved:
            os.rename(dst, src)
    assert _outstanding() == 0


def test_get_closed_after_first_chunk_returns_every_lease(sets):
    _, port, objs, _ = sets
    _, chunks = port.get_object_stream(BUCKET, "windows")
    first = next(chunks)
    assert bytes(first) == objs["windows"][:WINDOW]
    assert _outstanding() >= 1
    chunks.close()
    assert _outstanding() == 0


class _DyingDisk(LocalStorage):
    """A drive whose shard writer fails once `after` frame pieces went by."""

    def __init__(self, root, after):
        super().__init__(root)
        self.after = after

    def create_file(self, volume, path, chunks, append=False, sync=True):
        def cut():
            for j, c in enumerate(chunks):
                if j == self.after:
                    raise OSError("drive failed mid-stream")
                yield c
        return super().create_file(volume, path, cut(), append, sync)


@pytest.mark.parametrize("failing,windows", [(4, 3), (5, 3), (4, 1), (5, 1)])
def test_writer_dying_after_window_one(tmp_path, failing, windows):
    """Writers of `failing` drives die once window 1 is written (2 blocks,
    4 pieces), or after one piece of a one-window body: with m = 4 or
    fewer the object commits and reads back; past m the PUT is
    WriteQuorumError with no staging debris."""
    after = 2 * WIN_BLOCKS if windows > 1 else 1
    disks = [(_DyingDisk if i < failing else LocalStorage)(
        str(tmp_path / f"p{i}"), *([after] if i < failing else []))
        for i in range(N)]
    es = eo.ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    body = np.random.default_rng(failing).bytes(
        windows * WINDOW + 11 if windows > 1 else WINDOW - 7)
    try:
        es.make_bucket(BUCKET)
        if failing <= es.default_parity:
            info = es.put_object(BUCKET, "obj", body)
            assert info.etag == hashlib.md5(body).hexdigest()
            assert es.get_object(BUCKET, "obj")[1] == body
        else:
            with pytest.raises(WriteQuorumError):
                es.put_object(BUCKET, "obj", body)
            assert not any((tmp_path / f"p{i}" / BUCKET / "obj").exists()
                           for i in range(N))
        assert not _staging_debris(tmp_path)
        assert _outstanding() == 0
    finally:
        es.close()


class _CountingReader:
    """A body source that records how many bytes were pulled."""

    def __init__(self, data):
        self._mv = memoryview(data)
        self.pulled = 0
        self.trace = []        # (bytes pulled, windows the slow drive wrote)
        self.slow_done = lambda: 0

    def readinto(self, view):
        n = min(len(view), len(self._mv) - self.pulled)
        view[:n] = self._mv[self.pulled:self.pulled + n]
        self.pulled += n
        self.trace.append((self.pulled, self.slow_done()))
        return n

    def read(self, n):
        raise AssertionError("the PUT reads windows with readinto")


class _SlowDisk(LocalStorage):
    def __init__(self, root):
        super().__init__(root)
        self.windows = 0
        self.gate = threading.Event()

    def create_file(self, volume, path, chunks, append=False, sync=True):
        def slow():
            for j, c in enumerate(chunks):
                self.gate.wait(0.05)
                yield c
                if (j + 1) % (2 * WIN_BLOCKS) == 0:
                    self.windows += 1
        return super().create_file(volume, path, slow(), append, sync)


def test_put_reads_at_most_depth_plus_two_windows_ahead(tmp_path):
    disks = [_SlowDisk(str(tmp_path / "p0"))] + \
        [LocalStorage(str(tmp_path / f"p{i}")) for i in range(1, N)]
    es = eo.ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    body = np.random.default_rng(5).bytes(6 * WINDOW)
    reader = _CountingReader(body)
    reader.slow_done = lambda: disks[0].windows
    try:
        es.make_bucket(BUCKET)
        info = es.put_object(BUCKET, "slow", Payload(reader, len(body)))
        assert info.etag == hashlib.md5(body).hexdigest()
    finally:
        es.close()
    ahead = [-(-pulled // WINDOW) - done for pulled, done in reader.trace]
    assert max(ahead) <= eo.WRITE_QUEUE_DEPTH + 2, reader.trace
    # The producer did run ahead of the slow drive: windows in flight.
    assert max(ahead) >= 2, reader.trace
    assert _outstanding() == 0


def test_finish_hook_failure_commits_nothing(tmp_path):
    es = _port_set(tmp_path)
    body = np.random.default_rng(9).bytes(2 * WINDOW + 3)

    def refuse():
        raise ValueError("content check failed")
    try:
        es.make_bucket(BUCKET)
        es.put_object(BUCKET, "k", b"old version")
        with pytest.raises(ValueError):
            es.put_object(BUCKET, "k", Payload(
                Payload.wrap(body), len(body), finish=refuse))
        assert es.get_object(BUCKET, "k")[1] == b"old version"
        assert not _staging_debris(tmp_path)
        assert _outstanding() == 0
    finally:
        es.close()


# -- over HTTP -----------------------------------------------------------------


@pytest.fixture
def server(tmp_path):
    from minio_tpu_torch.s3.server import S3Server
    es = _port_set(tmp_path)
    srv = S3Server(es, ("127.0.0.1", 0), {"minioadmin": "minioadmin"})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, tmp_path
    srv.shutdown()
    t.join(timeout=30)


def _put(address: str, path: str, body: bytes, payload_hash: str):
    uri, headers = sigv4.sign_headers("PUT", address, path, "minioadmin",
                                      "minioadmin", payload_hash)
    host, _, port = address.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request("PUT", uri, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_wrong_content_sha256_keeps_previous_version(server):
    srv, root = server
    es = srv.objects
    old = np.random.default_rng(1).bytes(WINDOW + 5)
    new = np.random.default_rng(2).bytes(3 * WINDOW + 7)
    assert _put(srv.address, f"/{BUCKET}", b"",
                hashlib.sha256(b"").hexdigest())[0] == 200
    assert _put(srv.address, f"/{BUCKET}/k", old,
                hashlib.sha256(old).hexdigest())[0] == 200
    st, err = _put(srv.address, f"/{BUCKET}/k", new,
                   hashlib.sha256(new[:-1]).hexdigest())
    assert st == 400 and b"<Code>XAmzContentSHA256Mismatch</Code>" in err
    assert es.get_object(BUCKET, "k")[1] == old
    assert not _staging_debris(root)
    assert _outstanding() == 0


def test_unsigned_payload_is_never_hashed(server, monkeypatch):
    from minio_tpu_torch.s3 import server as server_mod
    srv, _ = server
    hashed = []

    class Counting(server_mod.HashingReader):
        def __init__(self, *a, **kw):
            hashed.append(1)
            super().__init__(*a, **kw)
    monkeypatch.setattr(server_mod, "HashingReader", Counting)
    body = np.random.default_rng(3).bytes(WINDOW + 1)
    assert _put(srv.address, f"/{BUCKET}", b"",
                hashlib.sha256(b"").hexdigest())[0] == 200
    assert _put(srv.address, f"/{BUCKET}/u", body,
                sigv4.UNSIGNED_PAYLOAD)[0] == 200
    assert not hashed
    assert _put(srv.address, f"/{BUCKET}/s", body,
                hashlib.sha256(body).hexdigest())[0] == 200
    assert hashed == [1]
    assert srv.objects.get_object(BUCKET, "u")[1] == body

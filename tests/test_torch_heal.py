"""The port's object healing and MRF queue against the JAX package's, on
the CPU.

Two 12-drive EC 8+4 sets, one of each package (the port with
device="cpu", so every kernel runs its plain PyTorch version), hold the
same objects: inline (200 KiB), a ragged tail (3 MiB + 12345 B), two
windows (40 MiB) and a 3-part multipart object (5 MiB, 5 MiB,
1 MiB + 777 B). Each case damages the same drives of both sets, heals
both, and holds the port's HealResult (`before`, `after`, `healed`) to
the JAX package's and the healed drives' files byte for byte to the JAX
package's heal and to the copies taken before the damage:

  * one data-shard drive wiped, one parity-shard drive wiped, and two
    data plus two parity drives wiped, in normal mode;
  * a flipped byte, which normal mode does not see and deep mode finds;
  * an outdated version on one drive;
  * the dangling purge (7 of 12 drives lost the version);
  * a bucket missing on one drive (heal_bucket).

The 40 MiB object (the case of two device windows) is in the one-data-
drive and four-drive cases; the others use the rest, to keep the CPU's
plain hash within the test's time. The MRF queue: a PUT that two drives
fail enqueues its key and a drain heals it in both packages, and a
pending.json the JAX package wrote round-trips through the port's
restart. Tolerance: none (integer math).
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta

from minio_tpu_torch.object import erasure_object as eo
from minio_tpu_torch.object import healing
from minio_tpu_torch.object.erasure_object import (STAGING_PREFIX,
                                                   ErasureSet, hash_order)
from minio_tpu_torch.object.healing import MRF_PATH
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import SYS_VOL, LocalStorage

N = 12
MIB = 1 << 20
BUCKET = "healb"
SIZES = {"inline": 200 * 1024, "tail": 3 * MIB + 12345,
         "windows": 40 * MIB}
MP_PARTS = (5 * MIB, 5 * MIB, MIB + 777)
SMALL = ("inline", "tail", "mp")
ALL = SMALL + ("windows",)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("heal")
    ref = RefSet([RefDisk(str(root / f"r{i}")) for i in range(N)])
    ref._mrf_closed = True        # heals run only when a case asks
    port = ErasureSet([LocalStorage(str(root / f"p{i}")) for i in range(N)],
                      device="cpu")
    port._mrf_closed = True
    rng = np.random.default_rng(4242)
    objs = {name: rng.bytes(size) for name, size in SIZES.items()}
    parts = [rng.bytes(n) for n in MP_PARTS]
    objs["mp"] = b"".join(parts)
    for s in (ref, port):
        s.make_bucket(BUCKET)
        for name, size in SIZES.items():
            s.put_object(BUCKET, name, objs[name])
        uid = s.new_multipart_upload(BUCKET, "mp")
        infos = [s.put_object_part(BUCKET, "mp", uid, i + 1, body)
                 for i, body in enumerate(parts)]
        s.complete_multipart_upload(BUCKET, "mp", uid,
                                    [(p.number, p.etag) for p in infos])
    pristine = root / "pristine"
    for prefix in ("r", "p"):
        for i in range(N):
            shutil.copytree(root / f"{prefix}{i}" / BUCKET,
                            pristine / f"{prefix}{i}")
    yield root, ref, port, objs
    ref.close()
    port.close()


def _obj(root, prefix, i, name):
    return root / f"{prefix}{i}" / BUCKET / name


def _pristine(root, prefix, i, name):
    return root / "pristine" / f"{prefix}{i}" / name


def _journal(path, prefix):
    load = RefMeta.load if prefix == "r" else port_meta.XLMeta.load
    xl = load((path / "xl.meta").read_bytes())
    return xl.versions, dict(xl.inline)


def _shard_files(path) -> dict:
    """{data dir/part.N: bytes} of one object dir."""
    return {f"{d.name}/{f.name}": f.read_bytes()
            for d in sorted(path.iterdir()) if d.is_dir()
            for f in sorted(d.iterdir())}


def _restore(root, drives, name):
    for prefix in ("r", "p"):
        for i in drives:
            dst = _obj(root, prefix, i, name)
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(_pristine(root, prefix, i, name), dst)


def _holders(name, shards):
    """Drives holding the given shard indices of the key, in shard order."""
    dist = hash_order(f"{BUCKET}/{name}", N)
    return [dist.index(s + 1) for s in shards]


def _heal_both(sets, name, deep=False):
    _, ref, port, _ = sets
    ref.fi_cache.invalidate_bucket(BUCKET)
    want = ref.heal_object(BUCKET, name, deep=deep)
    got = port.heal_object(BUCKET, name, deep=deep)
    assert (got.before, got.after, got.healed) == \
        (want.before, want.after, want.healed)
    assert (got.data_blocks, got.parity_blocks, got.size) == \
        (want.data_blocks, want.parity_blocks, want.size)
    return got


def _check_healed(root, drives, name):
    """The healed drives' shard files and journals equal the copies taken
    before the damage, in each package, and the port's equal the JAX
    package's."""
    for i in drives:
        files = {}
        for prefix in ("r", "p"):
            path = _obj(root, prefix, i, name)
            assert _shard_files(path) == \
                _shard_files(_pristine(root, prefix, i, name)), \
                f"{prefix}{i} {name} shard files differ from the copy"
            assert _journal(path, prefix) == \
                _journal(_pristine(root, prefix, i, name), prefix)
            files[prefix] = (sorted(_shard_files(path).values()),
                             list(_journal(path, prefix)[1].values()))
        assert files["p"] == files["r"], f"drive {i} {name}: packages differ"


CASES = {"one data drive": (0,), "one parity drive": (9,),
         "two data and two parity drives": (1, 6, 8, 11)}


@pytest.mark.parametrize("case,name", [
    (case, name) for case in sorted(CASES) for name in ALL
    if name != "windows" or case != "one parity drive"])
def test_heal_wiped_drives(sets, case, name):
    root, ref, port, objs = sets
    drives = _holders(name, CASES[case])
    try:
        for prefix in ("r", "p"):
            for i in drives:
                shutil.rmtree(_obj(root, prefix, i, name))
        got = _heal_both(sets, name)
        assert got.healed == len(drives)
        assert [got.before[i] for i in drives] == ["missing"] * len(drives)
        assert got.after == ["ok"] * N
        _check_healed(root, drives, name)
        assert port.get_object(BUCKET, name)[1] == objs[name]
    finally:
        _restore(root, drives, name)


def _flip(root, prefix, i, name):
    path = _obj(root, prefix, i, name)
    if name == "inline":
        load, dump = (RefMeta.load, RefMeta.dump) if prefix == "r" else \
            (port_meta.XLMeta.load, port_meta.XLMeta.dump)
        xl = load((path / "xl.meta").read_bytes())
        vid, blob = next(iter(xl.inline.items()))
        b = bytearray(blob)
        b[32 + 100] ^= 0x01
        xl.inline[vid] = bytes(b)
        (path / "xl.meta").write_bytes(dump(xl))
        return
    ddir = next(d for d in path.iterdir() if d.is_dir())
    part = ddir / ("part.2" if name == "mp" else "part.1")
    b = bytearray(part.read_bytes())
    b[len(b) - 5] ^= 0x01                 # in the part's last block
    part.write_bytes(bytes(b))


@pytest.mark.parametrize("name", SMALL)
def test_heal_flipped_byte(sets, name):
    root, _, _, _ = sets
    drive = _holders(name, (3,))[0]
    try:
        for prefix in ("r", "p"):
            _flip(root, prefix, drive, name)
        normal = _heal_both(sets, name)
        assert normal.healed == 0 and normal.before == ["ok"] * N
        deep = _heal_both(sets, name, deep=True)
        assert deep.before[drive] == "corrupt" and deep.healed == 1
        _check_healed(root, [drive], name)
    finally:
        _restore(root, [drive], name)


def test_heal_outdated_version(sets):
    root, ref, port, _ = sets
    rng = np.random.default_rng(5)
    old, new = rng.bytes(2 * MIB + 5), rng.bytes(2 * MIB + 9)
    drive = _holders("ver", (2,))[0]
    for s in (ref, port):
        s.put_object(BUCKET, "ver", old)
    saved = {p: root / f"old-{p}" for p in ("r", "p")}
    for prefix, dst in saved.items():
        shutil.copytree(_obj(root, prefix, drive, "ver"), dst)
    for s in (ref, port):
        s.put_object(BUCKET, "ver", new)
    for prefix, dst in saved.items():
        shutil.copytree(_obj(root, prefix, drive, "ver"),
                        root / f"new-{prefix}")
        shutil.rmtree(_obj(root, prefix, drive, "ver"))
        shutil.copytree(dst, _obj(root, prefix, drive, "ver"))
    got = _heal_both(sets, "ver")
    assert got.before[drive] == "outdated" and got.healed == 1
    for prefix in ("r", "p"):
        path = _obj(root, prefix, drive, "ver")
        assert _shard_files(path) == _shard_files(root / f"new-{prefix}")
        assert _journal(path, prefix) == \
            _journal(root / f"new-{prefix}", prefix)
    assert sorted(_shard_files(_obj(root, "p", drive, "ver")).values()) == \
        sorted(_shard_files(_obj(root, "r", drive, "ver")).values())
    assert port.get_object(BUCKET, "ver")[1] == new


def test_heal_dangling_purge(sets):
    root, ref, port, _ = sets
    body = np.random.default_rng(6).bytes(MIB + 1)
    for s in (ref, port):
        s.put_object(BUCKET, "dang", body)
    lost = list(range(7))      # 7 of 12 > max(n // 2, m): never readable
    for prefix in ("r", "p"):
        for i in lost:
            shutil.rmtree(_obj(root, prefix, i, "dang"))
    got = _heal_both(sets, "dang")
    assert got.healed == N - len(lost) and got.after == ["missing"] * N
    for prefix in ("r", "p"):
        assert not any(_obj(root, prefix, i, "dang").exists()
                       for i in range(N))


def test_heal_bucket_missing_on_one_drive(sets):
    root, ref, port, _ = sets
    for s in (ref, port):
        s.make_bucket("hb2")
    for prefix in ("r", "p"):
        os.rmdir(root / f"{prefix}4" / "hb2")
    want, got = ref.heal_bucket("hb2"), port.heal_bucket("hb2")
    assert got == want == {"bucket": "hb2", "missing": 1, "healed": 1}
    assert (root / "p4" / "hb2").is_dir()


class _FailOnce:
    """A drive whose first shard write or commit fails."""

    def __init__(self, disk):
        self._disk = disk
        self.failed = 0

    def __getattr__(self, name):
        attr = getattr(self._disk, name)
        if name not in ("create_file", "rename_data", "write_metadata"):
            return attr

        def guarded(*a, **kw):
            if not self.failed:
                self.failed += 1
                raise OSError("injected write failure")
            return attr(*a, **kw)
        return guarded


def test_mrf_heals_partial_put(tmp_path):
    """A PUT that two drives fail commits on 10, queues its key on the
    MRF, and the worker's heal, drained, writes the two drives' shards:
    the same bytes in both packages."""
    body = np.random.default_rng(7).bytes(3 * MIB + 1)
    sets_, flaky = {}, {}
    for prefix, cls, disk in (("r", RefSet, RefDisk),
                              ("p", ErasureSet, LocalStorage)):
        disks = [disk(str(tmp_path / f"{prefix}{i}")) for i in range(N)]
        es = sets_[prefix] = cls(disks, **({} if prefix == "r"
                                           else {"device": "cpu"}))
        es.make_bucket(BUCKET)
        flaky[prefix] = [_FailOnce(disks[i]) for i in (2, 7)]
        es.disks[2], es.disks[7] = flaky[prefix]
    try:
        for prefix, es in sets_.items():
            es.put_object(BUCKET, "partial", body)
            assert [d.failed for d in flaky[prefix]] == [1, 1]
            es.mrf.drain(timeout=120)
            assert es.mrf.stats()["healed"] == 1
        for i in (2, 7):
            files = [_shard_files(tmp_path / f"{p}{i}" / BUCKET / "partial")
                     for p in ("r", "p")]
            assert files[1] and sorted(files[0].values()) == \
                sorted(files[1].values())
        assert sets_["p"].get_object(BUCKET, "partial")[1] == body
    finally:
        for es in sets_.values():
            es.close()


def test_mrf_one_heal_per_degraded_get(tmp_path, monkeypatch):
    """A degraded GET of four windows queues its key once: the quorum
    read and every degraded window after the first find it pending, and
    the drain makes one heal. The key's lock is held through the GET, so
    the heal waits for the whole read."""
    monkeypatch.setattr(eo, "STREAM_WINDOW_BLOCKS", 2)
    monkeypatch.setattr(healing, "STREAM_WINDOW_BLOCKS", 2)
    body = np.random.default_rng(9).bytes(6 * MIB + 5)
    drives = [str(tmp_path / f"p{i}") for i in range(N)]
    es = ErasureSet([LocalStorage(d) for d in drives], device="cpu")
    try:
        es.make_bucket(BUCKET)
        es.put_object(BUCKET, "multi", body)
        lost = _holders("multi", (0,))[0]
        shutil.rmtree(os.path.join(drives[lost], BUCKET, "multi"))
        with es.ns.read(BUCKET, "multi"):
            assert es.get_object(BUCKET, "multi")[1] == body
        assert es.mrf.drain(timeout=120)
        assert es.mrf.stats() == {"healed": 1, "spilled": 0, "dropped": 0,
                                  "pending": 0}
        assert os.path.isdir(os.path.join(drives[lost], BUCKET, "multi"))
    finally:
        es.close()


def test_close_gives_up_a_heal_in_flight(tmp_path, monkeypatch):
    """close() during an MRF heal of four windows: the heal stops before
    its next window, its staged shards are cleared, the worker has
    exited before the pools shut, and the key stays pending on every
    drive's pending.json. The heal's first window waits for the stop."""
    monkeypatch.setattr(healing, "STREAM_WINDOW_BLOCKS", 1)
    body = np.random.default_rng(10).bytes(3 * MIB + 5)
    drives = [str(tmp_path / f"p{i}") for i in range(N)]
    es = ErasureSet([LocalStorage(d) for d in drives], device="cpu")
    entered = threading.Event()
    rebuild_window = healing._rebuild_window

    def held(es_, *a, **kw):
        entered.set()
        es_._mrf._stop.wait(timeout=60)
        return rebuild_window(es_, *a, **kw)

    monkeypatch.setattr(healing, "_rebuild_window", held)
    try:
        es.make_bucket(BUCKET)
        es.put_object(BUCKET, "cut", body)
        lost = _holders("cut", (0,))[0]
        shutil.rmtree(os.path.join(drives[lost], BUCKET, "cut"))
        es.mrf.enqueue(BUCKET, "cut")
        assert entered.wait(timeout=60)
    finally:
        es.close()
    assert not es.mrf._worker.is_alive()
    assert es.mrf.stats() == {"healed": 0, "spilled": 0, "dropped": 0,
                              "pending": 1}
    assert not os.path.exists(os.path.join(drives[lost], BUCKET, "cut"))
    for d in drives:
        staging = os.path.join(d, SYS_VOL, STAGING_PREFIX)
        assert not os.path.isdir(staging) or os.listdir(staging) == []
        with open(os.path.join(d, SYS_VOL, MRF_PATH)) as f:
            assert json.load(f) == [{"b": BUCKET, "o": "cut", "v": ""}]


def test_mrf_pending_survives_restart(tmp_path):
    """The JAX package's pending.json, carried to the port's drives,
    reloads at the port's boot and its heal runs; the port's own file
    reads back in the same format."""
    body = np.random.default_rng(8).bytes(2 * MIB)
    ref = RefSet([RefDisk(str(tmp_path / f"r{i}")) for i in range(N)])
    ref._mrf_closed = True
    ref.mrf.enqueue(BUCKET, "later")
    ref.mrf.save_now()
    ref.close()
    pending = (tmp_path / "r0" / SYS_VOL / "mrf" / "pending.json")
    assert json.loads(pending.read_bytes()) == \
        [{"b": BUCKET, "o": "later", "v": ""}]

    drives = [str(tmp_path / f"p{i}") for i in range(N)]
    es = ErasureSet([LocalStorage(d) for d in drives], device="cpu")
    es._mrf_closed = True
    es.make_bucket(BUCKET)
    es.put_object(BUCKET, "later", body)
    lost = _holders("later", (0,))[0]
    shutil.rmtree(os.path.join(drives[lost], BUCKET, "later"))
    es.close()
    for d in drives:
        os.makedirs(os.path.join(d, SYS_VOL, "mrf"), exist_ok=True)
        shutil.copy(pending, os.path.join(d, SYS_VOL, "mrf", "pending.json"))

    es = ErasureSet([LocalStorage(d) for d in drives], device="cpu")
    try:
        assert es.mrf.stats()["pending"] == 1
        assert es.mrf.drain(timeout=60)
        assert es.mrf.stats() == {"healed": 1, "spilled": 0, "dropped": 0,
                                  "pending": 0}
        assert os.path.isdir(os.path.join(drives[lost], BUCKET, "later"))
        es.mrf.stop()
        es.mrf.enqueue(BUCKET, "again", "v1")     # kept, not worked
        es.mrf.save_now()
        assert json.loads(open(os.path.join(
            drives[0], SYS_VOL, "mrf", "pending.json")).read()) \
            == [{"b": BUCKET, "o": "again", "v": "v1"}]
    finally:
        es.close()

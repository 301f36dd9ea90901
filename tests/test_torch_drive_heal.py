"""The port's drive lifecycle (object/drive_heal.py) against the JAX
package's, on the CPU.

  * The port's counterparts of the JAX package's tests/test_drive_heal.py
    cases for these modules: a replaced drive converges under PUT/GET
    traffic with no request failing; the bulk heal's checkpoint resumes
    after a restart (the first manager is stopped at a fixed point, from
    its pressure hook); every version and delete marker comes back; a
    drive adopted at boot carries the healing marker; the bulk heal
    yields under admission pressure; readiness names the healing set;
    the admin heal status shows the drive's progress.
  * One cross-package case: the JAX package writes objects on 12 drives
    (inline, ragged, multipart, versions and a delete marker), drive 1 is
    wiped on two copies of the tree, the JAX bulk_heal_drive refills one
    and the port's (device="cpu", journals carried across by
    storage.meta.from_reference_map) the other. Drive 1's shard files
    are byte-equal and its journals equal as parsed version lists.
  * A drive wiped while serving: after check_drive_formats restores its
    format, the group-commit frames it acknowledges land in the WAL file
    at its path (its cached descriptor used to name the unlinked file).

Exact comparisons: bytes, JSON and integer counts.
"""

import json
import os
import shutil
import threading
import time

import numpy as np

from minio_tpu.object import drive_heal as ref_heal
from minio_tpu.object import scanner as ref_scanner
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.storage import local as ref_local
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta
from minio_tpu.topology.format import init_formats as ref_init_formats

from minio_tpu_torch.object.drive_heal import (DriveHealManager,
                                               admission_pressure,
                                               bulk_heal_drive, new_tracker)
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.healing import DRIVE_STATE_OK
from minio_tpu_torch.object.scanner import check_drive_formats
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage import group_commit as gc_mod
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import (SYS_VOL, LocalStorage,
                                           clear_healing, read_healing,
                                           write_healing)
from minio_tpu_torch.topology import format as fmt_mod
from tests.s3client import S3Client
from tests.torch_no_caches import no_read_caches  # noqa: F401

BKT = "bkt"
MIB = 1 << 20


def make_set(tmp_path, n=4):
    disks = [LocalStorage(str(tmp_path / f"d{i}")) for i in range(n)]
    fmt_mod.init_formats(disks, n)
    es = ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    es.make_bucket(BKT)
    return es


def _replace_drive(tmp_path, i):
    """Swap drive i for a factory-fresh one (empty dir, no format)."""
    shutil.rmtree(tmp_path / f"d{i}")
    os.makedirs(tmp_path / f"d{i}")


def test_hot_replacement_converges_under_load(tmp_path):
    es = make_set(tmp_path)
    objs = {f"pre-{i:03d}": os.urandom(4_000 + i) for i in range(8)}
    for k, v in objs.items():
        es.put_object(BKT, k, v)
    _replace_drive(tmp_path, 1)
    stop = threading.Event()
    failures: list = []

    def writer(tid):
        # Read-your-writes traffic off the pre-swap keys, so the bulk
        # sweep is what repairs `objs` (small bodies: the CPU's plain
        # hash is slow).
        i = 0
        while not stop.is_set():
            key = f"live-{tid}-{i:03d}"
            try:
                body = os.urandom(2_000)
                es.put_object(BKT, key, body)
                _, got = es.get_object(BKT, key)
                assert got == body
            except Exception as e:  # noqa: BLE001 - collected for the assert
                failures.append((key, e))
            i += 1

    threads = [threading.Thread(target=writer, args=(t,), daemon=True)
               for t in range(2)]
    for t in threads:
        t.start()
    mgr = DriveHealManager([es], throttle=0.0, checkpoint_every=4)
    try:
        assert mgr.poll_once() == 1 and mgr.formats_restored == 1
        assert es.disks[1].read_format() is not None
        st = mgr.status()
        assert st["drives"] and st["drives"][0]["state"] in ("healing",
                                                            "done")
        assert mgr.wait(60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    try:
        assert not failures, f"traffic failed during heal: {failures[:3]}"
        assert read_healing(es.disks[1]) is None
        st = mgr.status()["drives"][0]
        assert st["state"] == "done" and st["finished"]
        assert st["objects_healed"] >= len(objs)
        assert st["bytes_healed"] >= sum(len(v) for v in objs.values())
        for k, v in objs.items():
            r = es.heal_object(BKT, k)
            assert r.healed == 0 and r.before[1] == DRIVE_STATE_OK
            assert es.get_object(BKT, k)[1] == v
    finally:
        mgr.stop()
        es.close()


def test_bulk_heal_checkpoint_resumes_across_restart(tmp_path):
    es = make_set(tmp_path)
    for i in range(30):
        es.put_object(BKT, f"o-{i:04d}", os.urandom(3_000))
    _replace_drive(tmp_path, 2)
    # The first manager stops itself after 10 keys: the pressure hook
    # runs before each key (it sets the stop before the 10th), and the
    # sweep checks its stop event at the next key, the 11th, saving the
    # checkpoint there.
    box = {}

    def crash_after_ten():
        tracker = box["mgr"]._active[(0, 2)]["tracker"]
        if tracker["objects_scanned"] >= 9:
            box["mgr"]._stop.set()
        return False

    mgr = DriveHealManager([es], throttle=0.0, checkpoint_every=3,
                           pressure=crash_after_ten)
    box["mgr"] = mgr
    try:
        assert mgr.poll_once() == 1
        assert mgr.wait(30)
        persisted = read_healing(es.disks[2])
        assert persisted is not None and not persisted["finished"]
        assert persisted["objects_scanned"] == 10
        assert persisted["checkpoint_object"] == "o-0010"
        mgr2 = DriveHealManager([es], throttle=0.0, checkpoint_every=3)
        assert mgr2.poll_once() == 1
        assert mgr2.wait(60)
        assert read_healing(es.disks[2]) is None
        done = mgr2.status()["drives"][0]
        assert done["state"] == "done"
        # The resumed sweep started at the checkpoint: 10 keys before the
        # stop, 20 after it.
        assert done["objects_scanned"] == 30
        for i in range(30):
            r = es.heal_object(BKT, f"o-{i:04d}")
            assert r.healed == 0 and r.before[2] == DRIVE_STATE_OK
        mgr2.stop()
    finally:
        mgr.stop()
        es.close()


def test_bulk_heal_restores_every_version(tmp_path):
    es = make_set(tmp_path)
    v1 = es.put_object(BKT, "ver", os.urandom(40_000),
                       PutOptions(versioned=True))
    v2 = es.put_object(BKT, "ver", os.urandom(42_000),
                       PutOptions(versioned=True))
    es.delete_object(BKT, "ver", DeleteOptions(versioned=True))
    _replace_drive(tmp_path, 1)
    mgr = DriveHealManager([es], throttle=0.0)
    try:
        assert mgr.poll_once() == 1 and mgr.wait(60)
        xl = port_meta.XLMeta.load(
            open(tmp_path / "d1" / BKT / "ver" / "xl.meta", "rb").read())
        vids = {v.get("vid") for v in xl.versions}
        assert v1.version_id in vids and v2.version_id in vids
        assert len(xl.versions) == 3
        for vid in (v1.version_id, v2.version_id):
            r = es.heal_object(BKT, "ver", vid)
            assert r.healed == 0 and r.before[1] == DRIVE_STATE_OK
    finally:
        mgr.stop()
        es.close()


def test_boot_time_fresh_drive_gets_healing_marker(tmp_path):
    disks = [LocalStorage(str(tmp_path / f"d{i}")) for i in range(4)]
    fmt_mod.init_formats(disks, 4)
    _replace_drive(tmp_path, 3)
    disks = [LocalStorage(str(tmp_path / f"d{i}")) for i in range(4)]
    ordered, _ = fmt_mod.load_and_order(disks, 4)
    assert all(d is not None for d in ordered)
    marked = [d for d in ordered if read_healing(d) is not None]
    assert len(marked) == 1
    t = read_healing(marked[0])
    assert t["disk_index"] == 3 and not t["finished"]
    assert marked[0].disk_info().healing


def test_bulk_heal_sheds_under_admission_pressure(tmp_path):
    es = make_set(tmp_path)
    for i in range(4):
        es.put_object(BKT, f"o-{i}", os.urandom(10_000))
    _replace_drive(tmp_path, 1)
    es.disks[1].write_format({"xl": {"this": "x"}})  # slot restored
    pressured = {"on": True, "polls": 0}

    def pressure():
        pressured["polls"] += 1
        return pressured["on"]

    tracker = new_tracker(0, 1)
    stop = threading.Event()
    th = threading.Thread(target=bulk_heal_drive, args=(es, 1, tracker),
                          kwargs={"stop": stop, "pressure": pressure},
                          daemon=True)
    th.start()
    try:
        deadline = time.time() + 10
        while pressured["polls"] == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert pressured["polls"] > 0
        time.sleep(0.1)
        assert tracker["objects_scanned"] == 0
        pressured["on"] = False
        th.join(timeout=30)
        assert tracker["finished"] and tracker["objects_healed"] == 4
    finally:
        stop.set()
        th.join(timeout=10)
        es.close()


def test_admission_pressure_reads_snapshot():
    class FakeAdm:
        def __init__(self, waiting, in_flight=0, limit=0):
            self._v = {"object": {"waiting": waiting,
                                  "in_flight": in_flight, "limit": limit}}

        def snapshot(self):
            return dict(self._v, deadline_exceeded_total=0)

    assert not admission_pressure(None)
    assert not admission_pressure(FakeAdm(0))
    assert admission_pressure(FakeAdm(3))
    assert admission_pressure(FakeAdm(0, in_flight=8, limit=8))


def _serve(es):
    srv = S3Server(es, ("127.0.0.1", 0), {"minioadmin": "minioadmin"})
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th


def test_readiness_names_healing_sets(tmp_path):
    es = make_set(tmp_path)
    srv, th = _serve(es)
    try:
        c = S3Client(srv.address)
        st, _, body = c.request("GET", "/minio/health/ready")
        assert st == 200 and json.loads(body)["ready"] is True
        write_healing(es.disks[2], new_tracker(0, 2))
        st, _, body = c.request("GET", "/minio/health/ready")
        assert st == 503
        payload = json.loads(body)
        assert payload["ready"] is False
        assert payload["degraded_sets"] == [{
            "set": 0, "drives_online": 4, "drives": 4, "write_quorum": 3,
            "healing_drives": 1}]
        clear_healing(es.disks[2])
        assert c.request("GET", "/minio/health/ready")[0] == 200
        assert c.request("GET", "/minio/health/live")[0] == 200
    finally:
        srv.shutdown()
        th.join(30)


def test_heal_status_surfaces_drive_progress(tmp_path):
    es = make_set(tmp_path)
    es.put_object(BKT, "o", os.urandom(10_000))
    srv, th = _serve(es)
    mgr = DriveHealManager([es])
    mgr._done[(0, 1)] = dict(new_tracker(0, 1), objects_scanned=7,
                             objects_healed=5, bytes_healed=12345,
                             finished=True)
    srv.drive_heal = mgr
    try:
        st, _, body = S3Client(srv.address).request(
            "GET", "/minio/admin/v3/heal")
        assert st == 200
        drives = json.loads(body)["drive_heal"]["drives"]
        assert drives[0]["objects_healed"] == 5
        assert drives[0]["state"] == "done"
        assert (drives[0]["set"], drives[0]["drive"]) == (0, 1)
    finally:
        srv.shutdown()
        th.join(30)


def _carry(src_root: str, dst_root: str) -> None:
    """Copy a JAX-written drive, each journal carried across."""
    shutil.copytree(src_root, dst_root)
    for dirpath, _, files in os.walk(dst_root):
        if "xl.meta" in files and SYS_VOL not in dirpath:
            path = os.path.join(dirpath, "xl.meta")
            ref = RefMeta.load(open(path, "rb").read())
            open(path, "wb").write(port_meta.from_reference_map(
                {"versions": ref.versions, "inline": ref.inline}).dump())


def _tree(root: str) -> dict:
    """Relative path -> bytes of every file outside the system volume."""
    out = {}
    for dirpath, _, files in os.walk(root):
        if os.path.relpath(dirpath, root).split(os.sep)[0] == SYS_VOL:
            continue
        for f in files:
            full = os.path.join(dirpath, f)
            out[os.path.relpath(full, root)] = open(full, "rb").read()
    return out


def test_bulk_heal_equals_reference(tmp_path):
    rng = np.random.default_rng(31)
    src = [str(tmp_path / "src" / f"d{i}") for i in range(12)]
    ref_disks = [RefDisk(r) for r in src]
    ref_init_formats(ref_disks, 12)
    ref = RefSet(ref_disks)
    ref._mrf_closed = True
    ref.make_bucket(BKT)
    for name, size in (("inline", 100_000), ("tail", MIB + 12345),
                       ("empty", 0)):
        ref.put_object(BKT, name, rng.bytes(size))
    uid = ref.new_multipart_upload(BKT, "mp")
    parts = [ref.put_object_part(BKT, "mp", uid, n, rng.bytes(size))
             for n, size in ((1, 2 * MIB + 3),)]
    ref.complete_multipart_upload(BKT, "mp", uid,
                                  [(p.number, p.etag) for p in parts])
    for v in range(3):
        ref.put_object(BKT, "ver", rng.bytes(100_000 * (v + 1)),
                       RefPut(versioned=True))
    ref.delete_object(BKT, "ver", RefDelete(versioned=True))
    for i in range(12):
        shutil.copytree(src[i], tmp_path / "r" / f"d{i}")
        _carry(src[i], str(tmp_path / "p" / f"d{i}"))
    for side in ("r", "p"):
        shutil.rmtree(tmp_path / side / "d1")
        os.makedirs(tmp_path / side / "d1")

    rs = RefSet([RefDisk(str(tmp_path / "r" / f"d{i}")) for i in range(12)])
    rs._mrf_closed = True
    assert ref_scanner.check_drive_formats([rs], 12) == 1
    rt = ref_heal.bulk_heal_drive(rs, 1, ref_local.read_healing(rs.disks[1]))
    ps = ErasureSet([LocalStorage(str(tmp_path / "p" / f"d{i}"))
                     for i in range(12)], device="cpu")
    ps._mrf_closed = True
    try:
        assert check_drive_formats([ps]) == 1
        pt = bulk_heal_drive(ps, 1, read_healing(ps.disks[1]))
    finally:
        ps.close()
    keys = ("objects_scanned", "objects_healed", "objects_failed",
            "bytes_healed", "finished")
    assert {k: pt[k] for k in keys} == {k: rt[k] for k in keys}
    assert pt["objects_healed"] == 5 and pt["objects_failed"] == 0
    rtree, ptree = _tree(str(tmp_path / "r" / "d1")), \
        _tree(str(tmp_path / "p" / "d1"))
    assert sorted(rtree) == sorted(ptree)
    for rel, blob in rtree.items():
        if os.path.basename(rel) != "xl.meta":
            assert ptree[rel] == blob, rel
            continue
        want = RefMeta.load(blob)
        carried = port_meta.from_reference_map(
            {"versions": want.versions, "inline": want.inline})
        got = port_meta.XLMeta.load(ptree[rel])
        assert got.versions == carried.versions, rel
        assert got.inline == carried.inline, rel


def test_wiped_drive_wal_reopens_after_format_restore(tmp_path):
    es = make_set(tmp_path)
    gc = es.group_commit
    gc.worth_batching = lambda: True        # every small PUT batches
    for d in es.disks:
        d._gc_auto = False                  # frames stay in the WALs
    try:
        es.put_object(BKT, "before", b"b" * 100)
        assert es.disks[1]._gc_wal_fd is not None
        _replace_drive(tmp_path, 1)
        assert check_drive_formats([es]) == 1
        es.heal_bucket(BKT)
        es.put_object(BKT, "after", b"a" * 100)
        wal = gc_mod.wal_file_path(es.disks[1].root)
        assert os.path.isfile(wal)
        frames = list(gc_mod.iter_frames(open(wal, "rb").read()))
        keys = {path for _, recs in frames for _, path, _ in recs}
        assert "after" in keys
    finally:
        es.close()

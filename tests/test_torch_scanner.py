"""The port's background scanner and heal sweeps (object/scanner.py)
against the JAX package's, on the CPU.

  * The seven cases of the JAX package's tests/test_scanner.py against
    the port: usage accounting (persisted and reloaded), a shard removed
    from one drive repaired with no client read, a flipped byte found by
    the deep sample, a replaced drive's format restored and its data
    repopulated, the heal_set sweep, the MRF queue persisted and reloaded
    (the port's MRFQueue API), versions and delete markers counted.
  * Both packages' scan_cycle over the same drives (written by the JAX
    package; the port's copy with each journal carried across by
    storage.meta.from_reference_map) give the same DataUsage JSON, except
    its last_update: plain, versioned (delete markers, a null version
    beside versioned ones), multipart and user-metadata objects (whose
    summary does not suffice, so the journal is parsed in full).

Exact comparisons: bytes, JSON and integer counts.
"""

import json
import os
import shutil

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.scanner import Scanner as RefScanner
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta
from minio_tpu.topology.format import init_formats as ref_init_formats

from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.healing import MRF_PATH, MRFQueue, heal_object
from minio_tpu_torch.object.scanner import (DataUsage, Scanner,
                                            check_drive_formats, heal_set)
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import SYS_VOL, LocalStorage
from minio_tpu_torch.topology.format import init_formats


@pytest.fixture
def env(tmp_path):
    roots = [str(tmp_path / f"d{i}") for i in range(6)]
    disks = [LocalStorage(r) for r in roots]
    init_formats(disks, set_size=6)
    es = ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    es.make_bucket("sb")
    yield es, roots
    es.close()


def _obj_dir(root, bucket, key):
    return os.path.join(root, bucket, key)


def test_usage_accounting(env):
    es, roots = env
    es.make_bucket("other")
    for i in range(5):
        es.put_object("sb", f"o{i}", b"x" * (1000 + i))
    es.put_object("other", "big", b"y" * 50_000)
    sc = Scanner([es], throttle=0)
    u = sc.scan_cycle()
    assert u.objects == 6
    assert u.buckets["sb"].objects == 5
    assert u.buckets["sb"].size == sum(1000 + i for i in range(5))
    assert u.buckets["other"].size == 50_000
    sc2 = Scanner([es], throttle=0)
    assert sc2.usage.objects == 6


def test_scanner_repairs_missing_shard_without_client_read(env):
    es, roots = env
    body = os.urandom(300_000)
    es.put_object("sb", "victim", body)
    shutil.rmtree(_obj_dir(roots[2], "sb", "victim"))
    u = Scanner([es], throttle=0).scan_cycle()
    assert u.healed >= 1
    assert os.path.isdir(_obj_dir(roots[2], "sb", "victim"))
    _, got = es.get_object("sb", "victim")
    assert got == body


def test_deep_sampling_finds_silent_bitrot(env):
    es, roots = env
    # Shard files of 133 KB, past the inline threshold (the JAX case
    # uses 1.5 MB; the CPU's plain hash is slow).
    body = os.urandom(400_000)
    es.put_object("sb", "rot", body)
    objdir = _obj_dir(roots[1], "sb", "rot")
    datadir = next(d for d in os.listdir(objdir) if d != "xl.meta")
    part = os.path.join(objdir, datadir, "part.1")
    blob = bytearray(open(part, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(part, "wb").write(bytes(blob))
    Scanner([es], throttle=0, deep_every=1).scan_cycle()
    r = heal_object(es, "sb", "rot", deep=True)
    assert all(s == "ok" for s in r.before), r.before
    _, got = es.get_object("sb", "rot")
    assert got == body


def test_replaced_drive_format_restore_and_repopulate(env):
    es, roots = env
    body = os.urandom(200_000)
    es.put_object("sb", "keep", body)
    old_format = json.loads(open(
        os.path.join(roots[4], SYS_VOL, "format.json")).read())
    shutil.rmtree(roots[4])
    es.disks[4] = LocalStorage(roots[4])
    assert check_drive_formats([es]) == 1
    new_format = json.loads(open(
        os.path.join(roots[4], SYS_VOL, "format.json")).read())
    assert new_format["xl"]["this"] == old_format["xl"]["this"]
    assert new_format["id"] == old_format["id"]
    Scanner([es], throttle=0).scan_cycle()
    assert os.path.isdir(_obj_dir(roots[4], "sb", "keep"))
    _, got = es.get_object("sb", "keep")
    assert got == body


def test_heal_set_sweep(env):
    es, roots = env
    for i in range(4):
        es.put_object("sb", f"s{i}", os.urandom(10_000))
    for i in range(4):
        shutil.rmtree(_obj_dir(roots[0], "sb", f"s{i}"))
    stats = heal_set(es)
    assert stats["objects"] == 4
    assert stats["healed"] == 4
    for i in range(4):
        assert os.path.isdir(_obj_dir(roots[0], "sb", f"s{i}"))


def test_mrf_persists_and_reloads(env):
    es, roots = env
    es.put_object("sb", "mrfobj", b"z" * 5000)
    # A queue whose worker is stopped keeps the entry pending (a crash
    # between the enqueue and the heal), then snapshots it.
    q = MRFQueue(es)
    q._stop.set()
    q._worker.join(timeout=2)
    q.enqueue("sb", "mrfobj")
    q.save_now()
    items = json.loads(es.disks[0].read_all(SYS_VOL, MRF_PATH))
    assert {"b": "sb", "o": "mrfobj", "v": ""} in items
    q2 = MRFQueue(es)                  # the restart loads and heals it
    try:
        assert q2.drain()
        assert q2.healed >= 1
    finally:
        q2.stop()


def test_scanner_counts_versions_and_delete_markers(env):
    es, roots = env
    es.put_object("sb", "v", b"a" * 100, PutOptions(versioned=True))
    es.put_object("sb", "v", b"b" * 200, PutOptions(versioned=True))
    es.delete_object("sb", "v", DeleteOptions(versioned=True))
    u = Scanner([es], throttle=0).scan_cycle()
    assert u.buckets["sb"].versions == 3
    assert u.buckets["sb"].delete_markers == 1
    assert u.buckets["sb"].size == 300


def _carry(src_root: str, dst_root: str) -> None:
    """Copy a JAX-written drive, each journal carried across."""
    shutil.copytree(src_root, dst_root)
    for dirpath, _, files in os.walk(dst_root):
        if "xl.meta" in files and SYS_VOL not in dirpath:
            path = os.path.join(dirpath, "xl.meta")
            ref = RefMeta.load(open(path, "rb").read())
            open(path, "wb").write(port_meta.from_reference_map(
                {"versions": ref.versions, "inline": ref.inline}).dump())


def test_data_usage_equals_reference(tmp_path):
    rng = np.random.default_rng(21)
    roots = [str(tmp_path / f"r{i}") for i in range(12)]
    ref_disks = [RefDisk(r) for r in roots]
    ref_init_formats(ref_disks, 12)
    ref = RefSet(ref_disks)
    ref._mrf_closed = True
    ref.make_bucket("plain")
    ref.make_bucket("vers")
    for i in range(7):
        ref.put_object("plain", f"k{i}", rng.bytes(500 + 3000 * i))
    ref.put_object("plain", "meta", rng.bytes(9000),
                   RefPut(user_metadata={"owner": "x"}))
    ref.put_object("plain", "big", rng.bytes(2 * (1 << 20) + 7))
    uid = ref.new_multipart_upload("plain", "mp")
    parts = [ref.put_object_part("plain", "mp", uid, n, rng.bytes(size))
             for n, size in ((1, 5 << 20), (2, 1000))]
    ref.complete_multipart_upload("plain", "mp", uid,
                                  [(p.number, p.etag) for p in parts])
    for k in range(3):
        for v in range(3):
            ref.put_object("vers", f"v{k}", rng.bytes(700 * (v + 1)),
                           RefPut(versioned=True))
    ref.delete_object("vers", "v1", RefDelete(versioned=True))
    ref.put_object("vers", "n", rng.bytes(333))       # the null version
    ref_usage = RefScanner([ref], throttle=0).scan_cycle().to_json()

    for i, r in enumerate(roots):
        _carry(r, str(tmp_path / f"p{i}"))
    port = ErasureSet([LocalStorage(str(tmp_path / f"p{i}"))
                       for i in range(12)], device="cpu")
    port._mrf_closed = True
    try:
        # The carried drives hold the JAX scanner's usage.json too: a
        # fresh one starts from nothing, as the JAX scanner did.
        for i in range(12):
            os.remove(tmp_path / f"p{i}" / SYS_VOL / "scanner" / "usage.json")
        usage = Scanner([port], throttle=0).scan_cycle()
        got = usage.to_json()
    finally:
        port.close()
    for doc in (got, ref_usage):
        doc.pop("last_update")
    assert got == ref_usage
    assert got["objects"] == 14 and got["delete_markers"] == 1
    assert DataUsage.from_json(got).to_json() == {**got, "last_update": 0}

"""The port's versioning against the JAX package's, on the CPU.

Sets of 12 drives at EC 8+4, one of each package (the port with
device="cpu", so every kernel runs its plain PyTorch version), take the
same operations and must give the same outcomes:

  * the delete quorum (C4): a 3,000,000-byte object, then 0, 3, 5 or 6
    drives that raise OSError on every call, then a delete of the null
    version, of a named version, or a delete marker. Success or
    WriteQuorumError, the key visible or gone afterwards, and the keys
    queued on the MRF must equal the JAX package's;
  * the versioning states: Enabled, Suspended and off, their bucket
    metadata files byte for byte, and what PUTs and deletes do in each;
  * a journal of three versions (a null one among them) and a delete
    marker written by the JAX package and carried through
    `from_reference_map`, read, listed and deleted by the port;
  * the versioned inline rule: shard files and inline bytes of objects
    around SMALL_FILE_THRESHOLD // 8 and SMALL_FILE_THRESHOLD;
  * heal of a named older version, whose drives' other versions stay.

Version ids are minted by each package, so outcomes are compared with
ids mapped by their order. Tolerance: none (integer math).
"""

import os
import shutil

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import GetOptions as RefGet
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta

from minio_tpu_torch.object.erasure_object import (SMALL_FILE_THRESHOLD,
                                                   ErasureSet, hash_order)
from minio_tpu_torch.object.types import DeleteOptions, GetOptions, PutOptions
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import SYS_VOL, LocalStorage

N = 12
BUCKET = "verb"
PKGS = {"r": (RefSet, RefDisk, RefPut, RefGet, RefDelete),
        "p": (ErasureSet, LocalStorage, PutOptions, GetOptions,
              DeleteOptions)}


class _Offline:
    """A drive that raises OSError on every call."""

    def __init__(self, disk):
        self._disk = disk

    def __getattr__(self, name):
        attr = getattr(self._disk, name)
        if not callable(attr):
            return attr

        def fail(*a, **kw):
            raise OSError(f"drive offline ({name})")
        return fail


def _make_sets(root, versioned=False):
    out = {}
    for prefix, (cls, disk, *_) in PKGS.items():
        es = cls([disk(str(root / f"{prefix}{i}")) for i in range(N)],
                 **({} if prefix == "r" else {"device": "cpu"}))
        es._mrf_closed = True        # heals run only when a case asks
        es.make_bucket(BUCKET)
        if versioned:
            es.set_bucket_versioning(BUCKET, "Enabled")
        out[prefix] = es
    return out


def _outcome(fn):
    """The call's result, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__


@pytest.mark.parametrize("kind", ["null", "version", "marker"])
@pytest.mark.parametrize("offline", [0, 3, 5, 6])
def test_delete_quorum_matches_reference(tmp_path, offline, kind):
    body = np.random.default_rng(4).bytes(3_000_000)
    sets = _make_sets(tmp_path, versioned=kind != "null")
    got = {}
    try:
        for prefix, es in sets.items():
            _, _, put, get, delete = PKGS[prefix]
            vid = es.put_object(BUCKET, "obj", body,
                                put(versioned=kind != "null")).version_id
            for i in range(offline):
                es.disks[i] = _Offline(es.disks[i])
            opts = delete(version_id=vid if kind == "version" else "",
                          versioned=kind == "marker")
            res = _outcome(lambda: es.delete_object(BUCKET, "obj", opts))
            if not isinstance(res, str):
                res = (res.delete_marker, res.version_id == vid,
                       bool(res.delete_marker_version_id))
            latest = _outcome(lambda: es.get_object_info(BUCKET, "obj").size)
            named = _outcome(lambda: es.get_object_info(
                BUCKET, "obj", get(version_id=vid)).size) if vid else None
            pending = sorted(es.mrf._pending)
            got[prefix] = (res, latest, named,
                           [(b, o, v == vid) for b, o, v in pending])
    finally:
        for es in sets.values():
            es.close()
    assert got["p"] == got["r"]
    if offline == 5:
        # The probe of C4: deleted on 7 of 12 is a majority, and the
        # key goes on the MRF for the five drives that missed it.
        assert not isinstance(got["p"][0], str)
        assert bool(got["p"][3]) == (kind != "marker")


def _versions(es, key):
    """[(version id, delete marker, size, is latest)] latest first."""
    return [(v.version_id, v.deleted, v.size, v.is_latest)
            for v in es.list_versions_all(BUCKET, key)]


def _by_order(rows):
    """Version ids replaced by their order of first appearance."""
    names: dict = {}
    out = []
    for vid, *rest in rows:
        if vid:
            vid = names.setdefault(vid, f"v{len(names)}")
        out.append((vid, *rest))
    return out


def test_versioning_states_match_reference(tmp_path):
    """Enabled, Suspended, off: the bucket-meta.json files and what PUTs
    and deletes do in each state."""
    rng = np.random.default_rng(5)
    bodies = [rng.bytes(n) for n in (100, 200, 300_000, 400, 500)]
    sets = _make_sets(tmp_path)
    try:
        seen = {}
        for prefix, es in sets.items():
            _, _, put, _, delete = PKGS[prefix]
            rows = []
            es.put_object(BUCKET, "k", bodies[0])          # null, unversioned
            for status, body in (("Enabled", bodies[1]),
                                 ("Enabled", bodies[2]),
                                 ("Suspended", bodies[3]),
                                 ("Suspended", bodies[4])):
                es.set_bucket_versioning(BUCKET, status)
                state = es.get_bucket_meta(BUCKET)
                es.put_object(BUCKET, "k", body,
                              put(versioned=es.bucket_versioning(BUCKET)))
                rows.append((status, sorted(state.items()),
                             _by_order(_versions(es, "k"))))
            # Suspended delete: a null marker replacing the null version.
            es.delete_object(BUCKET, "k", delete(null_marker=True))
            rows.append(("marker", _by_order(_versions(es, "k"))))
            es.set_bucket_versioning(BUCKET, False)
            rows.append(("off", sorted(es.get_bucket_meta(BUCKET).items())))
            blob = open(os.path.join(str(tmp_path / f"{prefix}0"), SYS_VOL,
                                     "buckets", BUCKET, "bucket-meta.json"),
                        "rb").read()
            seen[prefix] = (rows, blob)
    finally:
        for es in sets.values():
            es.close()
    assert seen["p"] == seen["r"]
    rows = seen["p"][0]
    # Enabled-era versions survive the suspended PUTs; the null version
    # is replaced, then covered by the null marker.
    assert [v[0] for v in rows[3][2]] == ["", "v0", "v1"]
    assert rows[4][1][0][:2] == ("", True)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A key with a null version, two versions and a delete marker
    written by the JAX package, carried to port drives."""
    root = tmp_path_factory.mktemp("vcarry")
    rng = np.random.default_rng(6)
    bodies = [rng.bytes(n) for n in (2 * (1 << 20) + 7, 50_000,
                                     3 * (1 << 20) + 11)]
    ref = RefSet([RefDisk(str(root / f"r{i}")) for i in range(N)])
    ref._mrf_closed = True
    ref.make_bucket(BUCKET)
    ref.put_object(BUCKET, "k", bodies[0])
    ref.set_bucket_versioning(BUCKET, "Enabled")
    vids = [""] + [ref.put_object(BUCKET, "k", b,
                                  RefPut(versioned=True)).version_id
                   for b in bodies[1:]]
    marker = ref.delete_object(BUCKET, "k", RefDelete(versioned=True))
    ref.close()
    disks = []
    for i in range(N):
        src, dst = root / f"r{i}", root / f"x{i}"
        shutil.copytree(src / BUCKET, dst / BUCKET)
        shutil.copytree(src / SYS_VOL / "buckets", dst / SYS_VOL / "buckets")
        xl = RefMeta.load((src / BUCKET / "k" / "xl.meta").read_bytes())
        journal = port_meta.from_reference_map(
            {"versions": xl.versions, "inline": xl.inline})
        (dst / BUCKET / "k" / "xl.meta").write_bytes(journal.dump())
        disks.append(LocalStorage(str(dst)))
    es = ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    yield es, bodies, vids, marker.delete_marker_version_id, root
    es.close()


def test_carried_journal_fields(carried):
    es, _, vids, mvid, root = carried
    ref = RefMeta.load((root / "r0" / BUCKET / "k" / "xl.meta").read_bytes())
    port = port_meta.XLMeta.load(
        (root / "x0" / BUCKET / "k" / "xl.meta").read_bytes())
    assert port.versions == ref.versions
    assert port.inline == ref.inline
    assert [v["vid"] for v in port.versions] == \
        [mvid, vids[2], vids[1], "null"]
    assert es.bucket_versioning(BUCKET)


def test_carried_versions_read_list_delete(carried):
    es, bodies, vids, mvid, _ = carried
    with pytest.raises(Exception) as e:
        es.get_object_info(BUCKET, "k")
    assert type(e.value).__name__ == "ObjectNotFound"
    assert e.value.delete_marker and e.value.version_id == mvid
    with pytest.raises(Exception) as e:
        es.get_object_info(BUCKET, "k", GetOptions(version_id=mvid))
    assert type(e.value).__name__ == "MethodNotAllowed"
    with pytest.raises(Exception) as e:
        es.get_object_info(BUCKET, "k", GetOptions(version_id="nope"))
    assert type(e.value).__name__ == "VersionNotFound"
    for vid, body in zip(vids, bodies):
        info, got = es.get_object(BUCKET, "k",
                                  GetOptions(version_id=vid or "null"))
        assert got == body and info.version_id == vid
    listed = es.list_objects(BUCKET, include_versions=True)
    assert [(o.version_id, o.delete_marker, o.is_latest, o.size)
            for o in listed.objects] == \
        [(mvid, True, True, 0), (vids[2], False, False, len(bodies[2])),
         (vids[1], False, False, len(bodies[1])),
         ("", False, False, len(bodies[0]))]
    assert es.list_objects(BUCKET).objects == []
    es.delete_object(BUCKET, "k", DeleteOptions(version_id=mvid))
    assert es.get_object(BUCKET, "k")[1] == bodies[2]
    assert [o.name for o in es.list_objects(BUCKET).objects] == ["k"]


@pytest.mark.parametrize("versioned", [False, True])
@pytest.mark.parametrize("size", [SMALL_FILE_THRESHOLD // 8 * 8 - 1,
                                  SMALL_FILE_THRESHOLD // 8 * 8 + 1,
                                  SMALL_FILE_THRESHOLD * 8,
                                  SMALL_FILE_THRESHOLD * 8 + 1])
def test_versioned_inline_rule_matches_reference(tmp_path, size, versioned):
    body = np.random.default_rng(size).bytes(size)
    vid = "0a1b2c3d-0000-4000-8000-000000000001" if versioned else ""
    sets = _make_sets(tmp_path, versioned=versioned)
    try:
        for prefix, es in sets.items():
            es.put_object(BUCKET, "obj", body,
                          PKGS[prefix][2](version_id=vid, versioned=versioned))
            assert es.get_object(BUCKET, "obj")[1] == body
    finally:
        for es in sets.values():
            es.close()
    inline = set()
    for i in range(N):
        files, blobs = {}, {}
        for prefix, load in (("r", RefMeta.load),
                             ("p", port_meta.XLMeta.load)):
            d = tmp_path / f"{prefix}{i}" / BUCKET / "obj"
            xl = load((d / "xl.meta").read_bytes())
            blobs[prefix] = dict(xl.inline)
            files[prefix] = sorted(f.read_bytes() for f in d.glob("*/part.1"))
        assert files["p"] == files["r"]
        assert blobs["p"] == blobs["r"]
        inline.add(bool(blobs["p"]))
    shard = -(-size // 8)
    limit = SMALL_FILE_THRESHOLD // 8 if versioned else SMALL_FILE_THRESHOLD
    assert inline == {shard <= limit}


def test_heal_named_older_version_matches_reference(tmp_path):
    """Version v1's data dir is wiped on one data-shard drive; healing
    v1 by its id rebuilds that shard file only, as the JAX package's
    heal does, and v2's data dir on that drive is left as it was."""
    rng = np.random.default_rng(8)
    bodies = [rng.bytes(3 * (1 << 20) + 5), rng.bytes(2 * (1 << 20) + 9)]
    sets = _make_sets(tmp_path, versioned=True)
    dist = hash_order(f"{BUCKET}/obj", N)
    lost = next(i for i in range(N) if dist[i] == 1)
    results = {}
    try:
        for prefix, es in sets.items():
            put = PKGS[prefix][2]
            v1, v2 = [es.put_object(BUCKET, "obj", b,
                                    put(versioned=True)).version_id
                      for b in bodies]
            obj = tmp_path / f"{prefix}{lost}" / BUCKET / "obj"
            ddirs = {v.version_id: v.data_dir
                     for v in es.disks[lost].list_versions(BUCKET, "obj")}
            kept = (obj / ddirs[v2] / "part.1").read_bytes()
            lost_part = (obj / ddirs[v1] / "part.1").read_bytes()
            shutil.rmtree(obj / ddirs[v1])
            res = es.heal_object(BUCKET, "obj", v1)
            assert (obj / ddirs[v1] / "part.1").read_bytes() == lost_part
            assert (obj / ddirs[v2] / "part.1").read_bytes() == kept
            for vid, body in ((v1, bodies[0]), (v2, bodies[1])):
                assert es.get_object(BUCKET, "obj",
                                     PKGS[prefix][3](version_id=vid))[1] \
                    == body
            results[prefix] = (res.before, res.after, res.healed,
                               res.version_id == v1)
    finally:
        for es in sets.values():
            es.close()
    assert results["p"] == results["r"]
    assert results["p"][2] == 1


def test_delete_bucket_clears_versioning(tmp_path):
    """A bucket deleted and made again starts unversioned: delete_bucket
    removes its metadata record from every drive, as the JAX package's
    does; a bucket that holds a version refuses first."""
    sets = _make_sets(tmp_path, versioned=True)
    seen = {}
    try:
        for prefix, es in sets.items():
            es.put_object(BUCKET, "k", b"x", PKGS[prefix][2](versioned=True))
            refused = _outcome(lambda: es.delete_bucket(BUCKET))
            es.delete_object(BUCKET, "k", PKGS[prefix][4](
                version_id=es.list_versions_all(BUCKET, "k")[0].version_id))
            es.delete_bucket(BUCKET)
            left = sorted(p.name for p in tmp_path.glob(
                f"{prefix}*/{SYS_VOL}/buckets/{BUCKET}"))
            es.make_bucket(BUCKET)
            seen[prefix] = (refused, left, es.bucket_versioning(BUCKET),
                            es.get_bucket_meta(BUCKET))
    finally:
        for es in sets.values():
            es.close()
    assert seen["p"] == seen["r"] == ("BucketNotEmpty", [], False, {})

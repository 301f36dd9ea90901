"""The port's object and version listing against the JAX package's, on
the CPU.

The same keys go to a 12-drive EC 8+4 set of each package: objects
nested under objects (`a/b`, `a/b/c`), siblings that sort between a key
and its subtree (`a-x`), five directories of five keys, deeper paths, a
key with spaces. Every page of `list_objects` (objects, common
prefixes, `is_truncated`, `next_marker`) must equal the JAX package's
over a table of prefixes, delimiters, max_keys and start markers, paged
through to the end; the table holds a marker strictly inside a
collapsed common prefix (`dir01/obj002` with delimiter `/`). Version
listings (`include_versions`) of keys with several versions, a null
version and delete markers are paged the same way, with version ids
mapped by their order. A drive that missed a delete (offline while it
ran, back for the listing) must not bring the key back, whichever
drives the rotating walk reads.
"""

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.storage.local import LocalStorage

N = 12
BUCKET = "listb"
KEYS = (["a", "a-x", "a/b", "a/b/c", "a/c", "b", "z z/sp ace", "zz",
         "photos/2024/jan/1.jpg", "photos/2024/feb/2.jpg",
         "photos/2025/x.jpg"]
        + [f"dir{d:02d}/obj{o:03d}" for d in range(5) for o in range(5)])
PREFIXES = ["", "a", "a/", "dir0", "dir02/", "photos/2024/", "q"]
MARKERS = ["", "a/b", "dir01/obj002", "dir02/", "zzz"]
PKGS = {"r": (RefSet, RefDisk, RefPut, RefDelete),
        "p": (ErasureSet, LocalStorage, PutOptions, DeleteOptions)}


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


def _make_sets(root):
    out = {}
    for prefix, (cls, disk, *_) in PKGS.items():
        es = cls([disk(str(root / f"{prefix}{i}")) for i in range(N)],
                 **({} if prefix == "r" else {"device": "cpu"}))
        es._mrf_closed = True
        es.make_bucket(BUCKET)
        out[prefix] = es
    return out


def _page(info, names):
    """A page, version ids replaced by their order in `names`."""
    objs = [(o.name, o.etag, o.size, o.is_latest, o.delete_marker,
             names.setdefault(o.version_id, f"v{len(names)}")
             if o.version_id else "")
            for o in info.objects]
    return objs, list(info.prefixes), info.is_truncated, info.next_marker


def _pages(es, names, prefix, delimiter, max_keys, marker,
           include_versions=False):
    out = []
    while True:
        info = es.list_objects(BUCKET, prefix=prefix, marker=marker,
                               delimiter=delimiter, max_keys=max_keys,
                               include_versions=include_versions)
        out.append(_page(info, names))
        if not info.is_truncated:
            return out
        marker = info.next_marker


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("listing")
    out = _make_sets(root)
    rng = np.random.default_rng(11)
    bodies = {k: rng.bytes(int(rng.integers(1, 300))) for k in KEYS}
    for es in out.values():
        for k in KEYS:
            es.put_object(BUCKET, k, bodies[k])
    yield out
    for es in out.values():
        es.close()


@pytest.mark.parametrize("max_keys", [1, 3, 1000])
@pytest.mark.parametrize("delimiter", ["", "/"])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_list_pages_match_reference(sets, prefix, delimiter, max_keys):
    for marker in MARKERS:
        want = _pages(sets["r"], {}, prefix, delimiter, max_keys, marker)
        got = _pages(sets["p"], {}, prefix, delimiter, max_keys, marker)
        assert got == want, (marker, got, want)


def test_marker_inside_collapsed_prefix(sets):
    """S3's rule, which the table above holds the port to as well:
    a marker inside dir01/ brings the dir01/ prefix back."""
    info = sets["p"].list_objects(BUCKET, marker="dir01/obj002",
                                  delimiter="/", max_keys=2)
    assert (info.prefixes, info.is_truncated, info.next_marker) == \
        (["dir01/", "dir02/"], True, "dir02/")


@pytest.fixture(scope="module")
def versioned(tmp_path_factory):
    """Keys with several versions, a null version and delete markers."""
    root = tmp_path_factory.mktemp("vlisting")
    out = _make_sets(root)
    for prefix, es in out.items():
        _, _, put, delete = PKGS[prefix]
        rng = np.random.default_rng(12)
        es.put_object(BUCKET, "k3", rng.bytes(10))          # null version
        es.set_bucket_versioning(BUCKET, "Enabled")
        for key, n in (("k1", 3), ("k2", 1), ("k3", 2), ("d/k5", 2)):
            for _ in range(n):
                es.put_object(BUCKET, key, rng.bytes(20), put(versioned=True))
        for key in ("k2", "k4", "d/k5"):
            es.delete_object(BUCKET, key, delete(versioned=True))
    yield out
    for es in out.values():
        es.close()


@pytest.mark.parametrize("delimiter", ["", "/"])
@pytest.mark.parametrize("max_keys", [1, 2, 1000])
def test_version_pages_match_reference(versioned, max_keys, delimiter):
    for marker in ("", "k1", "k2", "d/"):
        want, got = [_pages(versioned[p], {}, "", delimiter, max_keys,
                            marker, include_versions=True)
                     for p in ("r", "p")]
        assert got == want, (marker, got, want)
    latest = [o.name for o in versioned["p"].list_objects(BUCKET).objects]
    assert latest == ["k1", "k3"]


@pytest.mark.parametrize("versioned_bucket", [False, True])
def test_drive_that_missed_a_delete(tmp_path, versioned_bucket):
    """Drive 3 is offline while five keys are deleted, then back: the
    listing (run once for each rotation of the walked drives) must not
    show them, in either package."""
    out = _make_sets(tmp_path)
    keys = [f"k{i:02d}" for i in range(12)]
    gone = keys[3:8]
    seen = {}
    try:
        for prefix, es in out.items():
            _, _, put, delete = PKGS[prefix]
            if versioned_bucket:
                es.set_bucket_versioning(BUCKET, "Enabled")
            for k in keys:
                es.put_object(BUCKET, k, k.encode() * 50,
                              put(versioned=versioned_bucket))
            disk = es.disks[3]
            es.disks[3] = _Offline(disk)
            for k in gone:
                es.delete_object(BUCKET, k, delete(versioned=versioned_bucket))
            es.disks[3] = disk
            pages = [_pages(es, {}, "", "", 4, "") for _ in range(N)]
            assert all(p == pages[0] for p in pages)
            seen[prefix] = pages[0]
    finally:
        for es in out.values():
            es.close()
    assert seen["p"] == seen["r"]
    listed = [o[0] for page in seen["p"] for o in page[0]]
    assert listed == [k for k in keys if k not in gone]

"""The port's erasure set, end to end on the CPU, against the TPU package's.

Two 12-drive EC 8+4 sets, one of each package (the port with
device="cpu", so every kernel runs its plain PyTorch version), take the
same objects: a ragged tail after full blocks, two 32-block windows, and
an inline object. Shard files must be byte-identical per drive, and every
GET — healthy, with 4 data-shard drives wiped, with one flipped byte, and
of the TPU package's own drives through `from_reference_map` — must
return the object's bytes exactly.
"""

import os
import shutil

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta

from minio_tpu_torch.object.erasure_object import ErasureSet, hash_order
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import LocalStorage
from tests.torch_no_caches import no_read_caches  # noqa: F401

N = 12
MIB = 1 << 20
SIZES = {"tail": 3 * MIB + 12345, "windows": 40 * MIB, "inline": 200 * 1024,
         "blocks": 2 * MIB}
BUCKET = "bkt"


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sets")
    ref = RefSet([RefDisk(str(root / f"r{i}")) for i in range(N)])
    ref._mrf_closed = True        # no background heals under the tests
    port = ErasureSet([LocalStorage(str(root / f"p{i}")) for i in range(N)],
                      device="cpu")
    port._mrf_closed = True
    assert ref.default_parity == port.default_parity == 4
    rng = np.random.default_rng(2024)
    objs = {name: rng.bytes(size) for name, size in SIZES.items()}
    for s in (ref, port):
        s.make_bucket(BUCKET)
        for name, data in objs.items():
            s.put_object(BUCKET, name, data)
    yield root, ref, port, objs
    ref.close()
    port.close()


def _obj_dir(root, prefix, i, name):
    return root / f"{prefix}{i}" / BUCKET / name


def _part(root, prefix, i, name):
    d = _obj_dir(root, prefix, i, name)
    parts = [p for p in d.glob("*/part.1")]
    assert len(parts) <= 1
    return parts[0].read_bytes() if parts else None


def _journals(root, i, name):
    ref = RefMeta.load((_obj_dir(root, "r", i, name) / "xl.meta").read_bytes())
    port = port_meta.XLMeta.load(
        (_obj_dir(root, "p", i, name) / "xl.meta").read_bytes())
    return ref, port


@pytest.mark.parametrize("name", sorted(SIZES))
def test_shard_files_identical(sets, name):
    root, _, _, _ = sets
    for i in range(N):
        ref_part, port_part = _part(root, "r", i, name), _part(root, "p", i, name)
        assert (ref_part is None) == (name == "inline")
        assert ref_part == port_part, f"drive {i} part.1 differs"
        ref, port = _journals(root, i, name)
        assert list(ref.inline.values()) == list(port.inline.values()), \
            f"drive {i} inline shard differs"


@pytest.mark.parametrize("name", sorted(SIZES))
def test_erasure_fields_identical(sets, name):
    root, _, _, objs = sets
    for i in range(N):
        ref, port = _journals(root, i, name)
        rv, pv = ref.versions[0], port.versions[0]
        assert pv["ec"] == {**rv["ec"], "dist": list(rv["ec"]["dist"])}
        assert (pv["size"], pv["meta"]["etag"]) == \
            (rv["size"], rv["meta"]["etag"]) == \
            (len(objs[name]), rv["parts"][0]["etag"])


@pytest.mark.parametrize("name", sorted(SIZES))
def test_get_identical(sets, name):
    _, ref, port, objs = sets
    assert ref.get_object(BUCKET, name)[1] == objs[name]
    info, got = port.get_object(BUCKET, name)
    assert got == objs[name]
    assert info.size == len(objs[name])


def _data_holders(name, count):
    dist = hash_order(f"{BUCKET}/{name}", N)
    return [i for i in range(N) if dist[i] - 1 < 8][:count]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_get_with_four_data_drives_wiped(sets, name):
    root, ref, port, objs = sets
    wiped = _data_holders(name, 4)
    moved = []
    try:
        for prefix in ("r", "p"):
            for i in wiped:
                src = _obj_dir(root, prefix, i, name)
                dst = root / f"wiped-{prefix}{i}-{name}"
                os.rename(src, dst)
                moved.append((dst, src))
        before = dict(port.device_windows)
        assert ref.get_object(BUCKET, name)[1] == objs[name]
        assert port.get_object(BUCKET, name)[1] == objs[name]
        if name != "inline":
            assert port.device_windows["reconstruct"] > before["reconstruct"]
    finally:
        for dst, src in moved:
            os.rename(dst, src)


def _flip_inline(path, read, write, offset):
    xl = read(path.read_bytes())
    vid, blob = next(iter(xl.inline.items()))
    b = bytearray(blob)
    b[offset] ^= 0x01
    xl.inline[vid] = bytes(b)
    path.write_bytes(write(xl))


@pytest.mark.parametrize("name", sorted(SIZES))
def test_get_with_flipped_byte(sets, name):
    root, ref, port, objs = sets
    drive = _data_holders(name, 3)[2]
    offset = 32 + 100                    # inside the first shard block
    saved = {}
    try:
        for prefix in ("r", "p"):
            d = _obj_dir(root, prefix, drive, name)
            if name == "inline":
                meta = d / "xl.meta"
                saved[meta] = meta.read_bytes()
                if prefix == "r":
                    _flip_inline(meta, RefMeta.load, RefMeta.dump, offset)
                else:
                    _flip_inline(meta, port_meta.XLMeta.load,
                                 port_meta.XLMeta.dump, offset)
            else:
                part = next(d.glob("*/part.1"))
                saved[part] = part.read_bytes()
                b = bytearray(saved[part])
                b[offset] ^= 0x01
                part.write_bytes(bytes(b))
        # The TPU package's quorum-metadata cache would serve its stale
        # pre-flip inline bytes; drop it so both sets read the drives.
        ref.fi_cache.invalidate_bucket(BUCKET)
        assert ref.get_object(BUCKET, name)[1] == objs[name]
        assert port.get_object(BUCKET, name)[1] == objs[name]
    finally:
        for path, blob in saved.items():
            path.write_bytes(blob)
        ref.fi_cache.invalidate_bucket(BUCKET)


@pytest.fixture(scope="module")
def carried(sets, tmp_path_factory):
    """The TPU package's drives, journals carried across with
    from_reference_map, under a port set."""
    root, _, _, objs = sets
    dst = tmp_path_factory.mktemp("carried")
    disks = []
    for i in range(N):
        for name in SIZES:
            src_dir = _obj_dir(root, "r", i, name)
            out_dir = dst / f"x{i}" / BUCKET / name
            shutil.copytree(src_dir, out_dir)
            ref = RefMeta.load((src_dir / "xl.meta").read_bytes())
            journal = port_meta.from_reference_map(
                {"versions": ref.versions, "inline": ref.inline})
            (out_dir / "xl.meta").write_bytes(journal.dump())
        disks.append(LocalStorage(str(dst / f"x{i}")))
    es = ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    yield es, objs
    es.close()


@pytest.mark.parametrize("name", sorted(SIZES))
def test_get_reference_written_set(carried, name):
    es, objs = carried
    assert es.get_object(BUCKET, name)[1] == objs[name]
    assert es.get_object_info(BUCKET, name).size == len(objs[name])


@pytest.mark.parametrize("size", [0, 1, 31])
def test_tiny_objects_identical(sets, size):
    root, ref, port, _ = sets
    name = f"tiny{size}"
    data = bytes(range(size))
    for s in (ref, port):
        s.put_object(BUCKET, name, data)
        assert s.get_object(BUCKET, name)[1] == data
    for i in range(N):
        ref_j, port_j = _journals(root, i, name)
        assert list(ref_j.inline.values()) == list(port_j.inline.values())


def test_delete_then_not_found(tmp_path):
    from minio_tpu_torch.object.types import ObjectNotFound
    es = ErasureSet([LocalStorage(str(tmp_path / f"d{i}")) for i in range(N)],
                    device="cpu")
    try:
        es.make_bucket(BUCKET)
        es.put_object(BUCKET, "gone", b"x" * 1000)
        es.delete_object(BUCKET, "gone")
        with pytest.raises(ObjectNotFound):
            es.get_object(BUCKET, "gone")
        assert not any((tmp_path / f"d{i}" / BUCKET / "gone").exists()
                       for i in range(N))
    finally:
        es.close()

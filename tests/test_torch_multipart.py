"""The port's multipart uploads against the JAX package's, on the CPU.

Two 12-drive EC 8+4 sets, one of each package (the port with
device="cpu", so every kernel runs its plain PyTorch version), take the
same parts (5 MiB, 8 MiB and 3 MiB + 777 B, from a numpy seed). Per
drive, each part's shard file must be byte-identical; part ETags, the
final `-N` ETag and the journal's part list equal; GET of the whole
object and of ranges across parts must return the bytes, healthy, with
4 data-shard drives wiped and with one flipped byte; list_parts and
list_multipart_uploads agree; the two packages refuse the same
completions (InvalidPart, InvalidPartOrder, EntityTooSmall) and a part
of an aborted upload (NoSuchUpload).

`test_get_reference_written_multipart` pins fault C2: the port read only
`part.1` of a multipart object the JAX package wrote and answered
ReadQuorumError. Tolerance: none (integer math).
"""

import hashlib
import os
import shutil

import numpy as np
import pytest

from minio_tpu.object import multipart as ref_mp
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta

from minio_tpu_torch.object import types as ot
from minio_tpu_torch.object.erasure_object import ErasureSet, hash_order
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import LocalStorage
from tests.torch_no_caches import no_read_caches  # noqa: F401

N = 12
MIB = 1 << 20
BUCKET = "mpb"
KEY = "mp"
PART_SIZES = (5 * MIB, 8 * MIB, 3 * MIB + 777)
# Ranges (first byte, length) across the boundaries of parts 1|2 and 2|3,
# one inside part 2 and the last bytes.
RANGES = ((5 * MIB - 100, 300), (13 * MIB - 5, 2 * MIB), (6 * MIB + 3, 1000),
          (16 * MIB + 700, 77))


def _upload(es, key, parts):
    uid = es.new_multipart_upload(BUCKET, key)
    infos = [es.put_object_part(BUCKET, key, uid, i + 1, body)
             for i, body in enumerate(parts)]
    return uid, infos


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    ref = RefSet([RefDisk(str(root / f"r{i}")) for i in range(N)])
    ref._mrf_closed = True        # no background heals under the tests
    port = ErasureSet([LocalStorage(str(root / f"p{i}")) for i in range(N)],
                      device="cpu")
    port._mrf_closed = True
    rng = np.random.default_rng(88)
    parts = [rng.bytes(n) for n in PART_SIZES]
    out = {}
    for name, s in (("ref", ref), ("port", port)):
        s.make_bucket(BUCKET)
        uid, infos = _upload(s, KEY, parts)
        # An upload left open for the listings.
        pend = s.new_multipart_upload(BUCKET, "pending/obj")
        s.put_object_part(BUCKET, "pending/obj", pend, 2, parts[2])
        listing = (s.list_parts(BUCKET, KEY, uid),
                   s.list_multipart_uploads(BUCKET),
                   s.list_parts(BUCKET, "pending/obj", pend))
        info = s.complete_multipart_upload(
            BUCKET, KEY, uid, [(p.number, f'"{p.etag}"') for p in infos])
        out[name] = (infos, info, listing)
    yield root, ref, port, parts, out
    ref.close()
    port.close()


def _obj_dir(root, prefix, i, key=KEY):
    return root / f"{prefix}{i}" / BUCKET / key


def _journal(root, prefix, i, key=KEY):
    blob = (_obj_dir(root, prefix, i, key) / "xl.meta").read_bytes()
    load = RefMeta.load if prefix == "r" else port_meta.XLMeta.load
    return load(blob).versions[0]


def _part_file(root, prefix, i, num, key=KEY):
    ddir = _journal(root, prefix, i, key)["ddir"]
    return (_obj_dir(root, prefix, i, key) / ddir / f"part.{num}").read_bytes()


def test_part_shard_files_identical(sets):
    root = sets[0]
    for i in range(N):
        for num in range(1, len(PART_SIZES) + 1):
            assert _part_file(root, "r", i, num) == \
                _part_file(root, "p", i, num), f"drive {i} part.{num}"


def test_etags_and_journal_parts_identical(sets):
    root, _, _, parts, out = sets
    (ref_infos, ref_info, _), (port_infos, port_info, _) = \
        out["ref"], out["port"]
    assert [p.etag for p in port_infos] == [p.etag for p in ref_infos]
    assert port_info.etag == ref_info.etag
    assert port_info.etag.endswith(f"-{len(parts)}")
    assert port_info.size == ref_info.size == sum(PART_SIZES)

    def strip(ps):                 # mod times are the writers' own
        return [{k: v for k, v in p.items() if k != "mt"} for p in ps]
    for i in range(N):
        rv, pv = _journal(root, "r", i), _journal(root, "p", i)
        assert strip(pv["parts"]) == strip(rv["parts"])
        assert pv["meta"] == rv["meta"]
        assert pv["ec"] == {**rv["ec"], "dist": list(rv["ec"]["dist"])}
        assert pv["size"] == rv["size"]


def test_listings_identical(sets):
    *_, out = sets
    (rparts, rups, rpend), (pparts, pups, ppend) = out["ref"][2], \
        out["port"][2]

    def part_rows(ps):
        return [(p["number"], p["size"], p["actual_size"], p["etag"])
                for p in ps]
    assert part_rows(pparts) == part_rows(rparts)
    assert part_rows(ppend) == part_rows(rpend)
    drop = ("upload_id", "initiated")
    assert [{k: v for k, v in u.items() if k not in drop} for u in pups] \
        == [{k: v for k, v in u.items() if k not in drop} for u in rups]
    assert [u["object"] for u in pups] == [KEY, "pending/obj"]


def _get_both(ref, port, body):
    assert ref.get_object(BUCKET, KEY)[1] == body
    info, got = port.get_object(BUCKET, KEY)
    assert got == body and info.etag.endswith("-3")
    for off, length in RANGES:
        want = body[off:off + length]
        assert ref.get_object(BUCKET, KEY,
                              _ref_range(off, length))[1] == want
        _, chunks = port.get_object_stream(BUCKET, KEY, off, length)
        assert b"".join(bytes(c) for c in chunks) == want


def _ref_range(off, length):
    from minio_tpu.object.types import GetOptions
    return GetOptions(range_spec=(off, off + length - 1))


def test_get_identical(sets):
    _, ref, port, parts, _ = sets
    _get_both(ref, port, b"".join(parts))
    assert [p.number for p in port.get_object_info(BUCKET, KEY).parts] \
        == [1, 2, 3]


def _data_holders(count, key=KEY):
    dist = hash_order(f"{BUCKET}/{key}", N)
    return [i for i in range(N) if dist[i] - 1 < 8][:count]


def test_get_with_four_data_drives_wiped(sets):
    root, ref, port, parts, _ = sets
    moved = []
    try:
        for prefix in ("r", "p"):
            for i in _data_holders(4):
                src = _obj_dir(root, prefix, i)
                dst = root / f"wiped-{prefix}{i}"
                os.rename(src, dst)
                moved.append((dst, src))
        ref.fi_cache.invalidate_bucket(BUCKET)
        before = port.device_windows["reconstruct"]
        _get_both(ref, port, b"".join(parts))
        assert port.device_windows["reconstruct"] > before
    finally:
        for dst, src in moved:
            os.rename(dst, src)
        ref.fi_cache.invalidate_bucket(BUCKET)


def test_get_with_flipped_byte(sets):
    root, ref, port, parts, _ = sets
    drive = _data_holders(3)[2]
    saved = {}
    try:
        for prefix in ("r", "p"):
            ddir = _journal(root, prefix, drive)["ddir"]
            path = _obj_dir(root, prefix, drive) / ddir / "part.2"
            saved[path] = path.read_bytes()
            b = bytearray(saved[path])
            b[32 + 4 * (32 + 128 * 1024) + 9] ^= 0x01     # block 4 of part 2
            path.write_bytes(bytes(b))
        ref.fi_cache.invalidate_bucket(BUCKET)
        _get_both(ref, port, b"".join(parts))
    finally:
        for path, blob in saved.items():
            path.write_bytes(blob)
        ref.fi_cache.invalidate_bucket(BUCKET)


@pytest.fixture(scope="module")
def carried(sets, tmp_path_factory):
    """A multipart object of 5 MiB, 5 MiB and 3 MiB + 777 B written by the
    JAX package, its drives carried across as tests/test_torch_object.py
    `carried` does, under a port set."""
    root, ref, _, _, _ = sets
    rng = np.random.default_rng(89)
    parts = [rng.bytes(n) for n in (5 * MIB, 5 * MIB, 3 * MIB + 777)]
    uid, infos = _upload(ref, "c2", parts)
    ref.complete_multipart_upload(BUCKET, "c2", uid,
                                  [(p.number, p.etag) for p in infos])
    dst = tmp_path_factory.mktemp("carried-mp")
    disks = []
    for i in range(N):
        src_dir = _obj_dir(root, "r", i, "c2")
        out_dir = dst / f"x{i}" / BUCKET / "c2"
        shutil.copytree(src_dir, out_dir)
        xl = RefMeta.load((src_dir / "xl.meta").read_bytes())
        journal = port_meta.from_reference_map(
            {"versions": xl.versions, "inline": xl.inline})
        (out_dir / "xl.meta").write_bytes(journal.dump())
        disks.append(LocalStorage(str(dst / f"x{i}")))
    es = ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    yield es, dst, b"".join(parts), ref.get_object_info(BUCKET, "c2").etag
    es.close()


def test_get_reference_written_multipart(carried):
    es, dst, body, etag = carried

    def read_all_ways():
        info, got = es.get_object(BUCKET, "c2")
        assert got == body and info.etag == etag and etag.endswith("-3")
        _, chunks = es.get_object_stream(BUCKET, "c2")
        assert b"".join(bytes(c) for c in chunks) == body
        for off, length in ((5 * MIB - 10, 20), (10 * MIB - 300, MIB)):
            _, chunks = es.get_object_stream(BUCKET, "c2", off, length)
            assert b"".join(bytes(c) for c in chunks) == \
                body[off:off + length]
    read_all_ways()
    moved = []
    try:
        for i in _data_holders(4, "c2"):
            src = dst / f"x{i}" / BUCKET / "c2"
            os.rename(src, dst / f"wiped-{i}")
            moved.append((dst / f"wiped-{i}", src))
        read_all_ways()
    finally:
        for a, b in moved:
            os.rename(a, b)


def test_heal_reference_written_multipart(carried):
    """The port heals a multipart object the JAX package wrote: with one
    data and one parity drive wiped, the rebuilt part files equal the
    JAX package's and the journal its carried one."""
    es, dst, body, _ = carried
    dist = hash_order(f"{BUCKET}/c2", N)
    drives = [dist.index(1), dist.index(10)]          # shards 0 and 9
    saved = {}
    for i in drives:
        src = dst / f"x{i}" / BUCKET / "c2"
        saved[i] = ({p.relative_to(src): p.read_bytes()
                     for p in src.rglob("*") if p.is_file()
                     and p.name != "xl.meta"},
                    port_meta.XLMeta.load((src / "xl.meta").read_bytes()))
        shutil.rmtree(src)
    r = es.heal_object(BUCKET, "c2")
    assert r.healed == 2 and [r.before[i] for i in drives] == ["missing"] * 2
    for i in drives:
        src = dst / f"x{i}" / BUCKET / "c2"
        files, journal = saved[i]
        assert {p.relative_to(src): p.read_bytes() for p in src.rglob("*")
                if p.is_file() and p.name != "xl.meta"} == files
        got = port_meta.XLMeta.load((src / "xl.meta").read_bytes())
        assert (got.versions, got.inline) == (journal.versions,
                                              journal.inline)
    assert es.get_object(BUCKET, "c2")[1] == body


def test_complete_reference_started_upload(sets, tmp_path):
    """An upload the JAX package started and filled, its drives carried
    across as they stand (upload.json, part.N.meta and part files), is
    listed and completed by the port: the JAX package's ETag rule, and
    part shard files that equal the JAX package's."""
    root, ref, _, _, _ = sets
    rng = np.random.default_rng(90)
    parts = [rng.bytes(5 * MIB), rng.bytes(MIB + 3)]
    uid, infos = _upload(ref, "c3", parts)
    sys_vol = ".mtpu.sys"
    disks = []
    for i in range(N):
        shutil.copytree(root / f"r{i}" / sys_vol / "multipart",
                        tmp_path / f"y{i}" / sys_vol / "multipart")
        (tmp_path / f"y{i}" / BUCKET).mkdir()
        disks.append(LocalStorage(str(tmp_path / f"y{i}")))
    want_files = [sorted(p.read_bytes() for p in (root / f"r{i}").glob(
        f"{sys_vol}/multipart/{BUCKET}/*/{uid}/part.*")
        if not p.name.endswith(".meta")) for i in range(N)]
    es = ErasureSet(disks, device="cpu")
    es._mrf_closed = True
    try:
        assert [p["etag"] for p in es.list_parts(BUCKET, "c3", uid)] == \
            [p.etag for p in infos]
        info = es.complete_multipart_upload(
            BUCKET, "c3", uid, [(p.number, p.etag) for p in infos])
        assert info.etag == hashlib.md5(b"".join(
            bytes.fromhex(p.etag) for p in infos)).hexdigest() + "-2"
        assert es.get_object(BUCKET, "c3")[1] == b"".join(parts)
        for i in range(N):
            ddir = _journal(tmp_path, "y", i, "c3")["ddir"]
            got = sorted(p.read_bytes() for p in
                         (tmp_path / f"y{i}" / BUCKET / "c3" / ddir).iterdir())
            assert got == want_files[i], f"drive {i}"
    finally:
        es.close()
        ref.abort_multipart_upload(BUCKET, "c3", uid)


# -- refusals -----------------------------------------------------------------

_REF_ERRORS = {"InvalidPart": ref_mp.InvalidPart,
               "InvalidPartOrder": ref_mp.InvalidPartOrder,
               "EntityTooSmall": ref_mp.EntityTooSmall,
               "NoSuchUpload": ref_mp.UploadNotFound}
_PORT_ERRORS = {"InvalidPart": ot.InvalidPart,
                "InvalidPartOrder": ot.InvalidPartOrder,
                "EntityTooSmall": ot.EntityTooSmall,
                "NoSuchUpload": ot.UploadNotFound}


@pytest.mark.parametrize("case", sorted(_REF_ERRORS))
def test_refusals_match_reference(sets, case):
    _, ref, port, _, _ = sets
    rng = np.random.default_rng(7)
    small, big = rng.bytes(1000), rng.bytes(MIB)
    key = f"refuse-{case}"
    for es, errors in ((ref, _REF_ERRORS), (port, _PORT_ERRORS)):
        uid = es.new_multipart_upload(BUCKET, key)
        p1 = es.put_object_part(BUCKET, key, uid, 1, small)
        p2 = es.put_object_part(BUCKET, key, uid, 2, big)
        with pytest.raises(errors[case]):
            if case == "InvalidPart":
                es.complete_multipart_upload(
                    BUCKET, key, uid, [(2, "0" * 32)])
            elif case == "InvalidPartOrder":
                es.complete_multipart_upload(
                    BUCKET, key, uid, [(2, p2.etag), (1, p1.etag)])
            elif case == "EntityTooSmall":
                es.complete_multipart_upload(
                    BUCKET, key, uid, [(1, p1.etag), (2, p2.etag)])
            else:
                es.abort_multipart_upload(BUCKET, key, uid)
                es.put_object_part(BUCKET, key, uid, 3, small)
        if case != "NoSuchUpload":
            es.abort_multipart_upload(BUCKET, key, uid)
        with pytest.raises(errors["NoSuchUpload"]):
            es.list_parts(BUCKET, key, uid)


def test_single_small_part_completes(sets):
    """The last part may be under 5 MiB, so a one-part upload of 1000 B
    completes, and both packages store the same shard files."""
    root, ref, port, _, _ = sets
    body = np.random.default_rng(9).bytes(1000)
    for es in (ref, port):
        uid, infos = _upload(es, "one", [body])
        es.complete_multipart_upload(BUCKET, "one", uid,
                                     [(infos[0].number, infos[0].etag)])
        assert es.get_object(BUCKET, "one")[1] == body
    for i in range(N):
        assert _part_file(root, "r", i, 1, "one") == \
            _part_file(root, "p", i, 1, "one")

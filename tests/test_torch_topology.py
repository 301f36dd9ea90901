"""The port's topology against the JAX package's, on the CPU.

Ellipses expansion, set sizing, the pool split of command-line drive
arguments and `http://` endpoints refused until the distributed plane is
ported; SipHash-2-4 on the specification's vectors and object-to-set
placement on thousands of random keys, the port's against
minio_tpu/utils/siphash.py; multi-set format.json read across packages,
and a second pool formatted under the first pool's deployment id.

The one-set boot (ROADMAP C8): the port's server used to make one
erasure set of every drive it was given, so 24 drives became one set at
EC 20+4 where the JAX server writes two 12-drive sets at EC 8+4, and
17 drives or `--parity 8` were served where the JAX server refuses
them. Here the JAX package writes a 24-drive deployment in process, the
port's server boots on it (its drives given as `{1...24}`, their
journals carried into the port's encoding by tests/torch_carry.py) and
reads every key back byte for byte, and the same keys written through the
port under the same deployment id give the same shard files on the
same drives; 24 fresh drives boot as the JAX package's 2 x 12 layout,
and both packages refuse 17 drives and `--parity 8` alike.
"""

from __future__ import annotations

import os
import random

import numpy as np
import pytest

from minio_tpu import server as ref_server
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.pools import ServerPools as RefPools
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta
from minio_tpu.topology import ellipses as ref_ellipses
from minio_tpu.topology import format as ref_fmt
from minio_tpu.utils import siphash as ref_siphash

from minio_tpu_torch import server
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import SYS_VOL, LocalStorage
from minio_tpu_torch.topology import ellipses
from minio_tpu_torch.topology import format as fmt_mod
from minio_tpu_torch.utils.siphash import sip_hash_mod, siphash24
from tests import torch_carry as carry
from tests.torch_no_caches import no_read_caches  # noqa: F401

BUCKET = "topo"


# ---------------------------------------------------------------------------
# ellipses, set sizes, pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "/data/d{1...4}", "/p{01...03}", "/r{1...2}/d{1...2}", "/plain",
    "/x{7...7}", "/d{9...12}/s{008...010}"])
def test_expand_matches_jax(spec):
    assert ellipses.expand(spec) == ref_ellipses.expand(spec)


def test_expand_refuses_a_reversed_range():
    for mod in (ellipses, ref_ellipses):
        with pytest.raises(ValueError):
            mod.expand("/d{4...1}")


def test_choose_set_size_matches_jax():
    for count in range(1, 65):
        try:
            want = ref_ellipses.choose_set_size(count)
        except ValueError:
            with pytest.raises(ValueError):
                ellipses.choose_set_size(count)
            continue
        assert ellipses.choose_set_size(count) == want, count
    assert ellipses.choose_set_size(24) == 12
    assert ellipses.choose_set_size(16) == 16


@pytest.mark.parametrize("args", [
    ["/a/d{1...4}", "/b/d{1...4}"],
    ["/x", "/y", "/z", "/w"],
    ["/p1/d{1...24}", "/p2/d{1...16}"],
    ["/a/d{1...8}", "/e1", "/e2"],
    ["/n/d0,/n/d1,/m/d{0...1}", "/q/d{1...2}"]])
def test_parse_pools_matches_jax(args):
    assert ellipses.parse_pools(args) == ref_ellipses.parse_pools(args)


@pytest.mark.parametrize("count,size", [(24, None), (40, 8), (12, 4)])
def test_split_sets_matches_jax(count, size):
    drives = [f"/d{i}" for i in range(count)]
    assert ellipses.split_sets(drives, size) == \
        ref_ellipses.split_sets(drives, size)


def test_http_endpoint_names_the_distributed_plane():
    """An http:// endpoint names the node that owns the drive: it parses
    to the JAX package's host, port and path, and the CLI takes it."""
    args = ["http://h:9000/d{1...4}", "https://n2.example.net:9443/mnt/x",
            "/plain/d0"]
    assert ellipses.parse_pools(args) == ref_ellipses.parse_pools(args)
    for spec in ellipses.parse_pools(args):
        for ep in spec:
            a, b = ellipses.parse_endpoint(ep), ref_ellipses.parse_endpoint(ep)
            assert (a.host, a.port, a.path, a.is_url, str(a)) == \
                (b.host, b.port, b.path, b.is_url, str(b))
    with pytest.raises(ValueError):
        ellipses.parse_endpoint("http://h/d1")
    with pytest.raises(ValueError):
        ref_ellipses.parse_endpoint("http://h/d1")
    got = server.parse_args(["--device", "cpu", "http://h:9000/d{1...4}"])
    assert [[str(ep) for ep in spec] for spec in got.endpoints] == \
        [[f"http://h:9000/d{i}" for i in range(1, 5)]]


# ---------------------------------------------------------------------------
# SipHash and placement
# ---------------------------------------------------------------------------

def test_siphash24_reference_vectors():
    """The specification's published vectors: SipHash-2-4 under the key
    00..0f of the messages 00..(n-1)."""
    key = bytes(range(16))
    vectors = {0: 0x726FDB47DD0E0E31, 1: 0x74F839C593DC67FD,
               2: 0x0D6C8009D9A94F5A, 7: 0xAB0200F58B01D137,
               8: 0x93F5F5799A932462, 15: 0xA129CA6149BE45E5}
    for n, want in vectors.items():
        assert siphash24(key, bytes(range(n))) == want, n


def test_siphash24_matches_jax_on_every_tail_length():
    rng = random.Random(3)
    key = bytes(rng.randrange(256) for _ in range(16))
    for n in range(80):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert siphash24(key, data) == ref_siphash.siphash24(key, data), n
    with pytest.raises(ValueError):
        siphash24(b"short", b"")


@pytest.mark.parametrize("sets", [2, 3, 5, 16])
def test_placement_matches_jax_on_random_keys(sets):
    """Every key lands in the JAX package's set, or neither package
    reads the other's multi-set data."""
    rng = random.Random(sets)
    dep = bytes(rng.randrange(256) for _ in range(16))
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789/._-é"
    counts = [0] * sets
    for _ in range(2500):
        key = "".join(rng.choice(alphabet)
                      for _ in range(rng.randrange(1, 60)))
        got = sip_hash_mod(key, sets, dep)
        assert got == ref_siphash.sip_hash_mod(key, sets, dep), key
        counts[got] += 1
    assert min(counts) > 2500 / sets / 2       # roughly uniform
    assert sip_hash_mod("k", 0, dep) == ref_siphash.sip_hash_mod("k", 0, dep)


# ---------------------------------------------------------------------------
# multi-set format.json across packages
# ---------------------------------------------------------------------------

def test_multiset_format_reads_across_packages(tmp_path):
    """A 2 x 12 layout written by either package is loaded by the other
    in the same slots, with the same deployment id and matrix."""
    for writer, reader in ((fmt_mod, ref_fmt), (ref_fmt, fmt_mod)):
        sub = tmp_path / writer.__name__.replace(".", "_")
        disk_cls = LocalStorage if writer is fmt_mod else RefDisk
        read_cls = RefDisk if writer is fmt_mod else LocalStorage
        drives = [str(sub / f"d{i}") for i in range(24)]
        _, fmt = writer.boot([disk_cls(d) for d in drives], 12)
        assert [len(s) for s in fmt.sets] == [12, 12]
        shuffled = list(drives)
        random.Random(5).shuffle(shuffled)
        ordered, got = reader.load_and_order(
            [read_cls(d) for d in shuffled], 12)
        assert (got.deployment_id, got.sets) == (fmt.deployment_id, fmt.sets)
        assert [d.root for d in ordered] == [os.path.abspath(d)
                                             for d in drives]


def test_second_pool_formats_under_the_first_pools_id(tmp_path):
    p1 = [LocalStorage(str(tmp_path / "p1" / f"d{i}")) for i in range(8)]
    p2 = [LocalStorage(str(tmp_path / "p2" / f"d{i}")) for i in range(6)]
    _, f1 = fmt_mod.boot(p1, 4)
    _, f2 = fmt_mod.boot(p2, 6, f1.deployment_id)
    assert f2.deployment_id == f1.deployment_id
    assert [len(s) for s in f1.sets] == [4, 4] and len(f2.sets) == 1
    # The JAX package reads the second pool as a pool of that deployment.
    _, ref = ref_fmt.load_and_order([RefDisk(d.root) for d in p2], 6)
    assert ref.deployment_id == f1.deployment_id


# ---------------------------------------------------------------------------
# C8: the port's boot of any drive count
# ---------------------------------------------------------------------------

KEYS = {f"k{i:02d}": 900 + 37 * i for i in range(20)}
KEYS["dir/a"] = 4000
KEYS["big"] = 1200 * 1024        # a part.1 file at EC 8+4 (not inline)


def _bodies() -> dict:
    rng = np.random.default_rng(13)
    return {k: rng.bytes(n) for k, n in KEYS.items()}


def _key_files(drive: str, key: str, meta_cls=port_meta.XLMeta):
    """(journal's erasure fields, inline shards, part.1 bytes) of a key
    on one drive, or None when the drive does not hold it."""
    d = os.path.join(drive, BUCKET, key)
    meta = os.path.join(d, "xl.meta")
    if not os.path.exists(meta):
        return None
    xl = meta_cls.load(open(meta, "rb").read())
    ec, inline = xl.versions[0]["ec"], list(xl.inline.values())
    parts = [os.path.join(d, sub, "part.1") for sub in os.listdir(d)
             if os.path.exists(os.path.join(d, sub, "part.1"))]
    assert len(parts) <= 1
    return ({**ec, "dist": list(ec["dist"])}, inline,
            open(parts[0], "rb").read() if parts else None)


def _boot(drives_arg: str, *extra):
    srv = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                       "--scanner-interval", "0", *extra, drives_arg])
    for es in srv.objects.sets:
        es._mrf_closed = True
    return srv


def test_c8_port_boots_the_jax_24_drive_deployment(tmp_path):
    """Fails on the one-set boot: the JAX package's 2 x 12 deployment is
    refused there (its format's set size is not 24)."""
    drives = [str(tmp_path / "ref" / f"d{i}") for i in range(1, 25)]
    ordered, fmt = ref_fmt.boot([RefDisk(d) for d in drives], 12)
    ref = RefPools([RefSets([RefSet(ordered[:12]), RefSet(ordered[12:])],
                            fmt.deployment_id)])
    for s in ref.pools[0].sets:
        s._mrf_closed = True
    bodies = _bodies()
    ref.make_bucket(BUCKET)
    for k, b in bodies.items():
        ref.put_object(BUCKET, k, b)
    ref.close()
    for i, d in enumerate(drives, 1):
        carry.copy_to_port(d, str(tmp_path / "carried" / f"d{i}"))

    srv = _boot(str(tmp_path / "carried" / "d{1...24}"))
    try:
        layer = srv.objects
        assert srv.format.deployment_id == fmt.deployment_id
        assert srv.format.sets == fmt.sets
        assert [len(p.sets) for p in layer.pools] == [2]
        assert [(len(s.disks), s.default_parity) for s in layer.sets] == \
            [(12, 4), (12, 4)]
        for k, b in bodies.items():
            assert layer.get_object(BUCKET, k)[1] == b, k
        assert [o.name for o in layer.list_objects(BUCKET).objects] == \
            sorted(bodies)
    finally:
        srv.close()

    # The same keys through the port, under the same deployment id.
    mine = [str(tmp_path / "port" / f"d{i}") for i in range(1, 25)]
    fmt_mod.boot([LocalStorage(d) for d in mine], 12, fmt.deployment_id)
    srv = _boot(str(tmp_path / "port" / "d{1...24}"))
    try:
        srv.objects.make_bucket(BUCKET)
        for k, b in bodies.items():
            srv.objects.put_object(BUCKET, k, b)
    finally:
        srv.close()
    for k in bodies:
        got = [_key_files(d, k) for d in mine]
        want = [_key_files(d, k, RefMeta) for d in drives]
        assert [g is not None for g in got] == [w is not None for w in want]
        assert sum(w is not None for w in want) == 12, k
        assert got == want, f"{k}: shard files differ"


def test_c8_fresh_24_drives_boot_as_two_sets(tmp_path):
    srv = _boot(str(tmp_path / "d{1...24}"))
    try:
        layer = srv.objects
        assert [(len(s.disks), s.default_parity) for s in layer.sets] == \
            [(12, 4), (12, 4)]
        c = srv.objects
        c.make_bucket(BUCKET)
        c.put_object(BUCKET, "x", b"payload")
        assert c.get_object(BUCKET, "x")[1] == b"payload"
    finally:
        srv.close()
    drives = [str(tmp_path / f"d{i}") for i in range(1, 25)]
    fmts = [LocalStorage(d).read_format() for d in drives]
    assert len({f["id"] for f in fmts}) == 1
    sets = fmts[0]["xl"]["sets"]
    assert [len(s) for s in sets] == [12, 12]
    assert [f["xl"]["this"] for f in fmts] == sets[0] + sets[1]
    # The JAX package loads the port's layout as its own.
    _, ref = ref_fmt.load_and_order([RefDisk(d) for d in drives], 12)
    assert ref.sets == sets
    assert os.path.isdir(os.path.join(drives[0], SYS_VOL))


@pytest.mark.parametrize("argv", [
    ["{root}/d{{1...17}}"],
    ["--parity", "8", *[f"{{root}}/d{i}" for i in range(24)]],
    ["--set-size", "5", "{root}/d{{1...24}}"],
    ["{root}/a{{1...8}}", "{root}/b{{1...17}}"]])
def test_c8_refusals_match_jax(tmp_path, argv):
    """17 drives split into no set size of 2-16, and --parity above half
    the set size: both packages refuse before writing anything."""
    argv = [a.format(root=tmp_path) for a in argv]
    with pytest.raises(SystemExit) as ref_exit:
        ref_server.main(["--address", "127.0.0.1:0", *argv])
    with pytest.raises(SystemExit) as port_exit:
        server.parse_args(["--device", "cpu", "--address", "127.0.0.1:0",
                           *argv])
    assert port_exit.value.code == ref_exit.value.code == 2
    assert not any(tmp_path.iterdir())

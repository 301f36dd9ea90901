"""Pools of erasure sets: the port's ServerPools against the JAX package's.

The layout: pool 1 of 8 drives in 2 sets of 4 (EC 2+2) and pool 2 of 6
drives in 1 set (EC 3+3), both under one deployment id, three sets in
all. In each direction one package writes it (keys placed by the layer,
by free space, and keys written into pool 2 directly; a versioned key
with a delete marker on top; an object with part files) and the other
reads every key back byte for byte, with the same versions, from the
set SipHash names (journals carried between the packages' encodings by
tests/torch_carry.py). Both packages writing the same keys into such
layouts leave identical shard files on the same drives; their listing
pages (paged, with a delimiter, with versions) are equal; readiness
names the same degraded set. The CLI: `{x...y}` arguments boot as pools,
a new pool formats under the first pool's deployment id and receives
the deployment's buckets with their versioning state.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.pools import ServerPools as RefPools
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.object.types import DeleteOptions as RefDelete
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.storage.local import LocalStorage as RefDisk
from minio_tpu.storage.meta import XLMeta as RefMeta
from minio_tpu.topology import ellipses as ref_ellipses
from minio_tpu.topology import format as ref_fmt

from minio_tpu_torch import server
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.topology import format as fmt_mod
from tests import torch_carry as carry
from tests.s3client import S3Client
from tests.torch_no_caches import no_read_caches  # noqa: F401

DEP = "6f1c2a77-2c1e-4b3e-9d0b-5f9e7d3a4c21"
B = "pl"
LAYOUT = (("d", 8, 4), ("e", 6, 6))       # (prefix, drives, set size)
KEYS = {f"obj{i:02d}": 700 + 53 * i for i in range(16)}
KEYS.update({"dir/x": 3000, "dir/y": 2500, "big": 1200 * 1024})
POOL2_KEYS = {f"p2/{i}": 1500 + i for i in range(5)}


def _drives(root, prefix: str, n: int) -> list[str]:
    return [str(root / f"{prefix}{i}") for i in range(1, n + 1)]


def _ref_layer(root):
    pools = []
    for prefix, n, size in LAYOUT:
        ordered, _ = ref_fmt.boot([RefDisk(d) for d in
                                   _drives(root, prefix, n)], size, DEP)
        sets = [RefSet(ordered[i:i + size]) for i in range(0, n, size)]
        for s in sets:
            s._mrf_closed = True
        pools.append(RefSets(sets, DEP))
    return RefPools(pools)


def _port_layer(root):
    pools = []
    for prefix, n, size in LAYOUT:
        ordered, _ = fmt_mod.boot([LocalStorage(d) for d in
                                   _drives(root, prefix, n)], size, DEP)
        sets = [ErasureSet(ordered[i:i + size], device="cpu")
                for i in range(0, n, size)]
        for s in sets:
            s._mrf_closed = True
        pools.append(ErasureSets(sets, DEP))
    return ServerPools(pools)


def _bodies() -> dict:
    rng = np.random.default_rng(31)
    return {k: rng.bytes(n) for k, n in {**KEYS, **POOL2_KEYS}.items()}


def _load(layer, bodies: dict, put_opts, delete_opts) -> None:
    layer.make_bucket(B)
    for k in KEYS:
        layer.put_object(B, k, bodies[k])
    for k in POOL2_KEYS:
        layer.pools[1].put_object(B, k, bodies[k])
    layer.put_object(B, "ver", b"v1", put_opts(versioned=True))
    layer.put_object(B, "ver", b"v2", put_opts(versioned=True))
    layer.delete_object(B, "ver", delete_opts(versioned=True))


def _all_drives(root) -> list[str]:
    return [d for prefix, n, _ in LAYOUT for d in _drives(root, prefix, n)]


def _holders(root, key: str) -> list[int]:
    return [i for i, d in enumerate(_all_drives(root))
            if os.path.exists(os.path.join(d, B, key, "xl.meta"))]


def _expected_holders(layer, key: str) -> list[int]:
    """The drives of the set the layer's placement names for the key,
    in the pool that holds it."""
    base = 0
    for p in layer.pools:
        try:
            p.list_versions_all(B, key)
        except Exception:  # noqa: BLE001 - not in this pool
            base += len(p.disks)
            continue
        size = len(p.sets[0].disks)
        first = base + p.set_index(key) * size
        return list(range(first, first + size))
    return []


def _versions(layer, key: str) -> list:
    return [(v.version_id, v.deleted, v.metadata.get("etag", ""), v.size)
            for v in layer.list_versions_all(B, key)]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each package's copy of the layout, loaded with the same bodies."""
    root = tmp_path_factory.mktemp("pools")
    bodies = _bodies()
    ref = _ref_layer(root / "ref")
    _load(ref, bodies, RefPut, RefDelete)
    port = _port_layer(root / "port")
    _load(port, bodies, PutOptions, DeleteOptions)
    yield root, ref, port, bodies
    ref.close()
    port.close()


def test_port_reads_the_jax_layout(written, tmp_path):
    root, ref, _, bodies = written
    for d in _all_drives(root / "ref"):
        carry.copy_to_port(d, str(tmp_path / os.path.basename(d)))
    layer = _port_layer(tmp_path)
    try:
        for k, b in bodies.items():
            assert layer.get_object(B, k)[1] == b, k
            assert _holders(tmp_path, k) == _expected_holders(layer, k), k
        assert _versions(layer, "ver") == _versions(ref, "ver")
        assert [len(p.sets) for p in layer.pools] == [2, 1]
    finally:
        layer.close()


def test_jax_reads_the_port_layout(written, tmp_path):
    root, _, port, bodies = written
    for d in _all_drives(root / "port"):
        dst = str(tmp_path / os.path.basename(d))
        shutil.copytree(d, dst)
        carry.to_jax(dst)
    layer = _ref_layer(tmp_path)
    try:
        for k, b in bodies.items():
            assert layer.get_object(B, k)[1] == b, k
            assert _holders(tmp_path, k) == _expected_holders(port, k), k
        assert _versions(layer, "ver") == _versions(port, "ver")
    finally:
        layer.close()


def _key_files(drive: str, key: str, meta_cls):
    d = os.path.join(drive, B, key)
    if not os.path.exists(os.path.join(d, "xl.meta")):
        return None
    xl = meta_cls.load(open(os.path.join(d, "xl.meta"), "rb").read())
    v = xl.versions[0]
    parts = sorted(os.path.join(d, sub, "part.1") for sub in os.listdir(d)
                   if os.path.exists(os.path.join(d, sub, "part.1")))
    return ({**v["ec"], "dist": list(v["ec"]["dist"])}, v["size"],
            list(xl.inline.values()),
            [open(p, "rb").read() for p in parts])


@pytest.mark.parametrize("key", ["obj00", "obj07", "dir/x", "big", "p2/3"])
def test_shard_files_identical(written, key):
    root, _, _, _ = written
    got = [_key_files(d, key, port_meta.XLMeta)
           for d in _all_drives(root / "port")]
    want = [_key_files(d, key, RefMeta) for d in _all_drives(root / "ref")]
    assert sum(w is not None for w in want) in (4, 6)
    assert got == want


@pytest.mark.parametrize("query", [
    {}, {"max_keys": 5}, {"prefix": "dir/"}, {"delimiter": "/"},
    {"delimiter": "/", "max_keys": 3}, {"include_versions": True},
    {"marker": "obj05", "max_keys": 4}])
def test_listing_pages_equal(written, query):
    _, ref, port, _ = written

    def pages(layer):
        out, marker = [], query.get("marker", "")
        while True:
            q = {k: v for k, v in query.items() if k != "marker"}
            page = layer.list_objects(B, marker=marker, **q)
            out.append(([(o.name, o.size, o.etag, o.delete_marker)
                         for o in page.objects], list(page.prefixes),
                        page.is_truncated, page.next_marker))
            if not page.is_truncated or len(out) > 50:
                return out
            marker = page.next_marker
    assert pages(port) == pages(ref)


def test_readiness_names_the_degraded_set(written, tmp_path):
    """Three of the four drives of set 1 (pool 1's second set) away:
    both servers answer 503 with that set alone."""
    root, _, _, _ = written
    for sub in ("ref", "port"):
        shutil.copytree(root / sub, tmp_path / sub)
    away = [f"d{i}" for i in (5, 6, 7)]
    for sub in ("ref", "port"):
        for d in away:
            os.rename(tmp_path / sub / d, tmp_path / sub / f"gone-{d}")
    ref = _ref_layer(tmp_path / "ref")
    ref_srv = RefServer(ref, address="127.0.0.1:0")
    ref_srv.start()
    port = _port_layer(tmp_path / "port")
    srv = S3Server(port, ("127.0.0.1", 0), {"minioadmin": "minioadmin"})
    try:
        st, _, body = S3Client(ref_srv.address).request(
            "GET", "/minio/health/ready", sign=False)
        got = srv.readiness()
        assert (got[0], got[1]) == (st, json.loads(body))
        assert [d["set"] for d in got[1]["degraded_sets"]] == [1]
    finally:
        ref_srv.stop()
        srv.close()
        ref.close()


def test_cli_boots_pools_and_syncs_buckets(tmp_path):
    """`d{1...8}` and `e{1...6}` boot as two pools (1 x 8 at EC 4+4 and
    1 x 6 at EC 3+3, the JAX package's sizes), pool 2 under pool 1's
    deployment id. A pool added to a one-pool deployment gets its
    buckets, with their versioning state, at the next boot."""
    d_arg, e_arg = str(tmp_path / "d{1...8}"), str(tmp_path / "e{1...6}")
    base = ["--device", "cpu", "--address", "127.0.0.1:0",
            "--scanner-interval", "0"]
    srv = server.boot([*base, d_arg])
    srv.start()
    try:
        c = S3Client(srv.address)
        assert c.request("PUT", "/plv")[0] == 200
        assert c.request("PUT", "/plv", query={"versioning": ""}, body=(
            b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>"))[0] == 200
        assert c.request("PUT", "/plv/a", body=b"first")[0] == 200
    finally:
        srv.stop()
    srv = server.boot([*base, d_arg, e_arg])
    srv.start()
    try:
        layer = srv.objects
        assert [[len(s.disks) for s in p.sets] for p in layer.pools] == \
            [[ref_ellipses.choose_set_size(8)], [6]]
        assert [s.default_parity for s in layer.sets] == [4, 3]
        ids = {LocalStorage(d).read_format()["id"]
               for spec in ref_ellipses.parse_pools([d_arg, e_arg])
               for d in spec}
        assert ids == {srv.format.deployment_id}
        assert layer.pools[1].bucket_exists("plv")
        assert layer.pools[1].versioning_state("plv") == "Enabled"
        c = S3Client(srv.address)
        st, h, _ = c.request("PUT", "/plv/b", body=b"second")
        assert st == 200 and h.get("x-amz-version-id")
        assert c.request("GET", "/plv/a")[2] == b"first"
        assert c.request("GET", "/plv/b")[2] == b"second"
        # The new pool takes the key that lands there, versioned.
        layer.pools[1].put_object("plv", "c", b"third",
                                  PutOptions(versioned=True))
        st, _, body = c.request("GET", "/plv", query={"list-type": "2"})
        assert st == 200 and body.count(b"<Key>") == 3
    finally:
        srv.stop()


def test_mixed_deployments_are_fatal(tmp_path):
    fmt_mod.boot([LocalStorage(d) for d in _drives(tmp_path, "d", 4)], 4)
    fmt_mod.boot([LocalStorage(d) for d in _drives(tmp_path, "e", 4)], 4)
    with pytest.raises(fmt_mod.FormatError, match="deployment"):
        server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                     str(tmp_path / "d{1...4}"), str(tmp_path / "e{1...4}")])

"""Pool rebalance on the port (object/rebalance.py), on the CPU.

The port's cases of tests/test_rebalance.py: an overfilled pool sheds
toward the deployment's average with every object (versions and delete
markers too) readable, and its plan equals the JAX package's on the same
drives; parallel walkers stop at the byte target, not at the end of a
page, and so does a walk dispatched over peer nodes; a balanced
deployment is a no-op; a run stopped midway resumes from its
checkpoint; the admin API's rebalance verbs over HTTP. Test
pools share one filesystem, so equal drive counts make the fill
fraction the bytes used.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import pytest

from minio_tpu.object import rebalance as ref_rebalance
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.pools import ServerPools as RefPools
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.grid import GridClient, GridServer
from minio_tpu_torch.object import decom, rebalance
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import (DeleteOptions, ObjectNotFound,
                                          PutOptions)
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage.local import LocalStorage
from tests import torch_carry as carry
from tests.s3client import S3Client
from tests.torch_no_caches import no_read_caches  # noqa: F401

DEP = "00000000-0000-0000-0000-0000000eba1a"
B = "rbk"


def _layer(root):
    pools = []
    for name in ("p0", "p1"):
        es = ErasureSet([LocalStorage(str(root / name / f"d{i}"))
                         for i in range(4)], device="cpu")
        es._mrf_closed = True
        pools.append(ErasureSets([es], DEP))
    return ServerPools(pools)


@pytest.fixture
def layer(tmp_path):
    lay = _layer(tmp_path)
    lay.make_bucket(B)
    yield lay
    lay.close()


def _used(pool) -> int:
    return rebalance.pool_usage(pool)[0]


def _seed_imbalance(layer, n: int = 20, size: int = 20_000) -> dict:
    """Every object in pool 0, pool 1 empty."""
    bodies = {f"o{i:03d}": os.urandom(size + i) for i in range(n)}
    for k, b in bodies.items():
        layer.pools[0].put_object(B, k, b)
    return bodies


def test_rebalance_converges_and_preserves_objects(layer, tmp_path):
    bodies = _seed_imbalance(layer)
    layer.pools[0].put_object(B, "ver", b"v1", PutOptions(versioned=True))
    layer.pools[0].put_object(B, "ver", b"v2", PutOptions(versioned=True))
    layer.pools[0].delete_object(B, "marked", DeleteOptions(versioned=True))
    before = _used(layer.pools[0])
    # The JAX package plans the same on these drives.
    ref_plan = _jax_plan(layer, tmp_path)

    rb = layer.start_rebalance()
    assert rb.wait(120)
    st = layer.rebalance_status()
    assert st["status"] == "complete", st
    rec0 = st["pools"]["0"]
    assert rec0["participating"] and rec0["migrated"] > 0
    assert rec0["failed"] == 0 and not st["pools"]["1"]["participating"]
    assert {k: (r["participating"], r["used"], r["bytes_target"])
            for k, r in st["pools"].items()} == ref_plan
    u0, u1 = _used(layer.pools[0]), _used(layer.pools[1])
    assert u1 > 0 and u0 < before * 0.75
    assert abs(u0 - u1) < before * 0.35
    for k, b in bodies.items():
        assert layer.get_object(B, k)[1] == b
    with pytest.raises(ObjectNotFound):
        layer.get_object(B, "marked")
    assert [v.deleted for v in layer.list_versions_all(B, "marked")] == \
        [True]
    assert len(layer.list_versions_all(B, "ver")) == 2


def test_parallel_walkers_stop_at_the_byte_target(layer, monkeypatch):
    """With 4 walk workers a page of 16 keys is not moved whole: the
    target is checked before each key, so at most the keys in flight
    when it is reached move past it."""
    monkeypatch.setenv("MTPU_REBALANCE_WORKERS", "4")
    bodies = _seed_imbalance(layer, n=16)
    assert layer.start_rebalance().wait(120)
    st = layer.rebalance_status()
    assert st["status"] == "complete", st
    rec0 = st["pools"]["0"]
    biggest = max(map(len, bodies.values()))
    assert rec0["bytes_target"] <= rec0["bytes_moved"] \
        <= rec0["bytes_target"] + 4 * biggest
    assert rec0["migrated"] < len(bodies)
    for k, b in bodies.items():
        assert layer.get_object(B, k)[1] == b


def test_dispatched_rebalance_stops_at_the_byte_target(layer):
    """A coordinator with two peers over the same drives: one batch of
    8 keys a node holds the whole page of 16, yet the walk stops after
    the key that reaches the target, as the serial walk does."""
    bodies = _seed_imbalance(layer, n=16)
    peers = [ServerPools(list(layer.pools)) for _ in range(2)]
    srvs, clients = [], []
    for p in peers:
        srv = GridServer(0, host="127.0.0.1")
        srv.register("mig.page", lambda pl, p=p: decom.serve_page(p, pl))
        srv.start()
        srvs.append(srv)
        clients.append(GridClient("127.0.0.1", srv.port))
    layer.migration_peers = clients
    before = decom.PAGES_SERVED["batches"]
    try:
        assert layer.start_rebalance().wait(120)
        st = layer.rebalance_status()
        assert st["status"] == "complete", st
        assert decom.PAGES_SERVED["batches"] > before
        rec0 = st["pools"]["0"]
        biggest = max(map(len, bodies.values()))
        assert rec0["bytes_target"] <= rec0["bytes_moved"] \
            < rec0["bytes_target"] + biggest
        assert rec0["migrated"] < len(bodies)
        for k, b in bodies.items():
            assert layer.get_object(B, k)[1] == b
    finally:
        for c in clients:
            c.close()
        for s in srvs:
            s.stop()


def _jax_plan(layer, tmp_path) -> dict:
    """The JAX package's plan over a copy of the drives carried into its
    encoding: per pool (participating, used, bytes target)."""
    pools = []
    for name in ("p0", "p1"):
        disks = []
        for i in range(4):
            src = layer.pools[int(name[1])].sets[0].disks[i].root
            dst = str(tmp_path / "jaxcopy" / name / f"d{i}")
            shutil.copytree(src, dst)
            carry.to_jax(dst)
            disks.append(RefDisk(dst))
        es = RefSet(disks)
        es._mrf_closed = True
        pools.append(RefSets([es], DEP))
    ref = RefPools(pools)
    try:
        plan = ref_rebalance.Rebalance(ref)._plan()
    finally:
        ref.close()
    return {k: (r["participating"], r["used"], r["bytes_target"])
            for k, r in plan["pools"].items()}


def test_balanced_cluster_is_a_noop(layer):
    for i in range(4):
        layer.pools[0].put_object(B, f"a{i}", os.urandom(10_000))
        layer.pools[1].put_object(B, f"b{i}", os.urandom(10_000))
    assert layer.start_rebalance().wait(60)
    st = layer.rebalance_status()
    assert st["status"] == "complete"
    assert not any(r["participating"] or r["migrated"]
                   for r in st["pools"].values())


def test_rebalance_needs_two_pools(layer):
    with pytest.raises(rebalance.RebalanceError):
        rebalance.Rebalance(ServerPools([layer.pools[0]]))


def test_rebalance_kill_midway_then_resume(layer, monkeypatch):
    bodies = _seed_imbalance(layer, n=30, size=5000)
    rb = rebalance.Rebalance(layer, checkpoint_every=1)
    layer._rebalance = rb
    moved = threading.Event()
    orig = rebalance.migrate_key

    def spy(lay, src, bucket, key, pick):
        out = orig(lay, src, bucket, key, pick)
        if rb.state["pools"]["0"]["migrated"] >= 3:
            moved.set()
        return out
    monkeypatch.setattr(rebalance, "migrate_key", spy)
    rb.start()
    assert moved.wait(60)
    rb.stop()
    monkeypatch.setattr(rebalance, "migrate_key", orig)
    st = rebalance.load_state(layer)
    assert st["status"] == "rebalancing" and st["paused"]
    assert st["pools"]["0"]["migrated"] >= 3
    for k, b in bodies.items():
        assert layer.get_object(B, k)[1] == b
    rb2 = layer.resume_rebalance()
    assert rb2 is not None and rb2.wait(120)
    st = layer.rebalance_status()
    assert st["status"] == "complete", st
    u0, u1 = _used(layer.pools[0]), _used(layer.pools[1])
    assert u1 > 0 and abs(u0 - u1) < (u0 + u1) * 0.4
    for k, b in bodies.items():
        assert layer.get_object(B, k)[1] == b


def test_rebalance_admin_api(tmp_path):
    lay = _layer(tmp_path)
    srv = S3Server(lay, ("127.0.0.1", 0), {"minioadmin": "minioadmin"})
    srv.start()
    try:
        c = S3Client(srv.address)
        assert c.request("PUT", "/" + B)[0] == 200
        for i in range(10):
            lay.pools[0].put_object(B, f"x{i}", os.urandom(30_000))
        assert c.request("POST", "/minio/admin/v3/rebalance-start")[0] \
            == 200
        for _ in range(600):
            st, _, body = c.request("GET",
                                    "/minio/admin/v3/rebalance-status")
            assert st == 200
            doc = json.loads(body)
            if doc["status"] in ("complete", "failed"):
                break
            time.sleep(0.05)
        assert doc["status"] == "complete", doc
        assert doc["pools"]["0"]["migrated"] > 0
        assert c.request("POST", "/minio/admin/v3/rebalance-stop")[0] == 200
        for i in range(10):
            assert c.request("GET", f"/{B}/x{i}")[0] == 200
    finally:
        srv.stop()

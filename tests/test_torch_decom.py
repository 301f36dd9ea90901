"""Pool decommission on the port (object/decom.py), on the CPU.

The port's cases of tests/test_decom.py that need no SSE and no grid:
a drain moves every key's version stack (user metadata, content type,
versions, delete markers) and multipart parts with their composite ETag
out of the pool, which then stays out of placement, also for a layer
booted after; a drain stopped midway resumes from its checkpoint to the
same end; reads never fail while it runs; a write that lands behind
the walk's marker is drained before "complete", and a pool that never
empties fails the drain; placement waits for a re-read of the drained
pools in flight; the guards. The admin API's
decommission verbs over HTTP. Across packages: a drain the port starts
and a stop cuts midway is finished by the JAX package from the port's
config/decom.json (the drives' journals carried into its encoding by
tests/torch_carry.py), to the state a port-finished drain of the same
drives reaches.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import pytest

from minio_tpu.object import decom as ref_decom
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.pools import ServerPools as RefPools
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.object import decom, multipart
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage.local import LocalStorage
from tests import torch_carry as carry
from tests.s3client import S3Client
from tests.torch_no_caches import no_read_caches  # noqa: F401

DEP = "00000000-0000-0000-0000-00000000dec0"
B = "decb"


def _pool(root, name: str, n: int = 4):
    es = ErasureSet([LocalStorage(str(root / name / f"d{i}"))
                     for i in range(n)], device="cpu")
    es._mrf_closed = True
    return ErasureSets([es], DEP)


def _layer(root):
    return ServerPools([_pool(root, "p0"), _pool(root, "p1")])


@pytest.fixture
def layer(tmp_path):
    lay = _layer(tmp_path)
    lay.make_bucket(B)
    yield lay
    lay.close()


def _empty(pool) -> bool:
    return not pool.list_objects(B, max_keys=10,
                                 include_versions=True).objects


def _stack(layer, key: str) -> list:
    return [(v.version_id, v.deleted, v.metadata.get("etag", ""), v.size)
            for v in layer.list_versions_all(B, key)]


def test_decommission_drains_pool_preserving_everything(layer):
    src = layer.pools[0]
    bodies = {f"obj{i}": os.urandom(10_000 + i) for i in range(8)}
    for k, b in bodies.items():
        src.put_object(B, k, b, PutOptions(user_metadata={"color": "red"},
                                           content_type="text/x-test"))
    src.put_object(B, "ver", b"v1", PutOptions(versioned=True))
    src.put_object(B, "ver", b"v2", PutOptions(versioned=True))
    src.delete_object(B, "marked", DeleteOptions(versioned=True))
    before = {k: _stack(layer, k) for k in [*bodies, "ver", "marked"]}

    d = layer.start_decommission(0)
    assert d.wait(60)
    st = layer.decommission_status()
    assert st["status"] == "complete", st
    assert st["migrated"] == 10 and st["failed"] == 0

    assert _empty(layer.pools[0])
    for k, b in bodies.items():
        info, got = layer.get_object(B, k)
        assert got == b
        assert info.user_metadata.get("color") == "red"
        assert info.content_type == "text/x-test"
    assert {k: _stack(layer, k) for k in before} == before
    assert layer.get_object(B, "ver")[1] == b"v2"
    # New writes land in the surviving pool only.
    layer.put_object(B, "after", b"post-drain")
    assert _empty(layer.pools[0])
    # A layer booted after learns the finished drain and resumes none.
    again = ServerPools(list(layer.pools))
    assert again.resume_decommission() is None
    assert again.decommissioning == {0}


def test_decommission_preserves_multipart_parts_and_etag(layer, monkeypatch):
    monkeypatch.setattr(multipart, "MIN_PART_SIZE", 256 << 10)
    src = layer.pools[0]
    uid = src.new_multipart_upload(B, "mp", PutOptions())
    p1, p2 = os.urandom(300 << 10), os.urandom(1234)
    e1 = src.put_object_part(B, "mp", uid, 1, p1).etag
    e2 = src.put_object_part(B, "mp", uid, 2, p2).etag
    info = src.complete_multipart_upload(B, "mp", uid, [(1, e1), (2, e2)])
    assert info.etag.endswith("-2")

    assert layer.start_decommission(0).wait(60)
    assert layer.decommission_status()["status"] == "complete"
    got_info, got = layer.get_object(B, "mp")
    assert got == p1 + p2
    assert got_info.etag == info.etag
    assert [(p.number, p.size) for p in got_info.parts] == \
        [(1, len(p1)), (2, len(p2))]
    assert _empty(layer.pools[0])


def _seed(layer, n: int, size: int = 1500) -> dict:
    bodies = {f"k{i:03d}": os.urandom(size) for i in range(n)}
    for k, b in bodies.items():
        layer.pools[0].put_object(B, k, b)
    return bodies


def _stop_midway(d, migrated: int = 10) -> None:
    deadline = time.time() + 60
    while d.state["migrated"] < migrated and time.time() < deadline:
        time.sleep(0.005)
    d.stop()


def test_decommission_kill_and_resume(layer):
    bodies = _seed(layer, 60)
    d = layer.start_decommission(0, checkpoint_every=4)
    _stop_midway(d)
    st = decom.load_state(layer)
    assert st["migrated"] >= 10
    final = layer
    if st["status"] == "draining":
        assert st["paused"] and not _empty(layer.pools[0])
        again = ServerPools(list(layer.pools))
        d2 = again.resume_decommission()
        assert d2 is not None and d2.wait(120)
        final = again
    assert decom.load_state(final)["status"] == "complete"
    assert _empty(final.pools[0])
    for k, b in bodies.items():
        assert final.get_object(B, k)[1] == b


def test_reads_never_fail_during_drain(layer):
    bodies = _seed(layer, 16, 3000)
    failures = []
    stop = threading.Event()

    def reader(t: int) -> None:
        keys = sorted(bodies)
        i = t
        while not stop.is_set():
            k = keys[i % len(keys)]
            try:
                if layer.get_object(B, k)[1] != bodies[k]:
                    failures.append(f"{k}: wrong bytes")
            except Exception as e:  # noqa: BLE001 - recorded
                failures.append(f"{k}: {e!r}")
            i += 2
            time.sleep(0.002)           # leave the drain the interpreter

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    try:
        assert layer.start_decommission(0, checkpoint_every=4).wait(60)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not failures, failures[:5]
    assert layer.decommission_status()["status"] == "complete"


def _landing_behind_the_marker(monkeypatch, layer, every: bool):
    """Wrap the walk's migrate: while it moves a key, a write that chose
    the draining pool before the drain's notice lands there under a name
    the walk has passed (every migrate when `every`, else once)."""
    real = decom.migrate_key
    late: dict = {}

    def migrate(lay, idx, bucket, key, dst):
        moved = real(lay, idx, bucket, key, dst)
        if every or not late:
            name = f"a-late{len(late)}"
            late[name] = os.urandom(2000)
            layer.pools[0].put_object(B, name, late[name])
        return moved
    monkeypatch.setattr(decom, "migrate_key", migrate)
    return late


def test_a_write_behind_the_marker_is_drained_before_complete(
        layer, monkeypatch):
    bodies = _seed(layer, 6)
    late = _landing_behind_the_marker(monkeypatch, layer, every=False)
    assert layer.start_decommission(0).wait(60)
    st = layer.decommission_status()
    assert st["status"] == "complete", st
    assert late and _empty(layer.pools[0])
    for k, b in {**bodies, **late}.items():
        assert layer.get_object(B, k)[1] == b


def test_a_pool_that_never_empties_fails_the_drain(layer, monkeypatch):
    _seed(layer, 3)
    _landing_behind_the_marker(monkeypatch, layer, every=True)
    assert layer.start_decommission(0).wait(60)
    st = layer.decommission_status()
    assert st["status"] == "failed", st
    assert "still holds" in st["last_error"]
    assert not _empty(layer.pools[0])


def test_placement_waits_for_a_drain_sync_in_flight(layer, monkeypatch):
    """One request thread re-reads the drained pools after the fleet's
    generation moved; another placing meanwhile waits for that re-read
    instead of placing with the drains it knew before."""
    class Gen:
        moved = True

        def changed(self) -> bool:
            moved, self.moved = self.moved, False
            return moved
    layer.decom_gen = Gen()
    entered, release = threading.Event(), threading.Event()

    def sync() -> None:
        entered.set()
        release.wait(5)
        layer.decommissioning.add(0)
    monkeypatch.setattr(layer, "sync_decommission_markers", sync)
    first = threading.Thread(target=layer._pool_for_new)
    first.start()
    assert entered.wait(5)
    got: list = []
    second = threading.Thread(
        target=lambda: got.append(layer._pool_for_new()))
    second.start()
    time.sleep(0.2)
    release.set()
    first.join(5)
    second.join(5)
    assert got == [1]


def test_an_overwrite_during_a_migration_is_kept(layer):
    """An unversioned overwrite of a key in its source pool while the
    key is copied (a rebalance keeps sources in placement) replaces the
    null version under the same id: the copy is made again, and the
    acknowledged write survives the clean-up."""
    layer.pools[0].put_object(B, "k", b"old")
    dst = layer.pools[1].set_for("k")
    orig = dst.restore_version
    fired = []

    def racing(*a, **kw):
        orig(*a, **kw)
        if not fired:
            fired.append(1)
            layer.put_object(B, "k", b"new")   # the key's pool: pool 0
    dst.restore_version = racing
    decom.migrate_key(layer, 0, B, "k", lambda: 1)
    assert fired and layer.get_object(B, "k")[1] == b"new"
    assert _empty(layer.pools[0])


def test_create_file_survives_a_concurrent_prune_of_its_parent(
        tmp_path, monkeypatch):
    """C9: a shard write makes its staging path, then opens the file; a
    concurrent request's clean-up that deletes its own staging dir also
    removes the staging root once empty, and could do so between the
    two (5 of 16 shard writers of one migration failed so on the card).
    The write makes the path again."""
    from minio_tpu_torch.storage import local
    d = LocalStorage(str(tmp_path / "d"))
    real = os.makedirs
    pruned = []

    def racing(path, *a, **kw):
        real(path, *a, **kw)
        if not pruned:
            pruned.append(path)
            shutil.rmtree(os.path.join(d.root, ".mtpu.sys", "staging"))
    monkeypatch.setattr(local.os, "makedirs", racing)
    d.create_file(".mtpu.sys", "staging/p1-x/ddir/part.1", [b"ab", b"cd"])
    monkeypatch.undo()
    assert pruned
    assert d.read_file(".mtpu.sys", "staging/p1-x/ddir/part.1") == b"abcd"


def test_decommission_guards(layer):
    with pytest.raises(decom.DecomError):
        decom.Decommission(layer, 7)
    with pytest.raises(decom.DecomError):
        decom.Decommission(ServerPools([layer.pools[0]]), 0)
    layer.decommissioning.add(1)
    with pytest.raises(decom.DecomError):
        decom.Decommission(layer, 0)


def test_decommission_admin_api(tmp_path):
    lay = _layer(tmp_path)
    srv = S3Server(lay, ("127.0.0.1", 0), {"minioadmin": "minioadmin"})
    srv.start()
    try:
        c = S3Client(srv.address)
        assert c.request("PUT", "/" + B)[0] == 200
        bodies = _seed(lay, 12)
        assert c.request("GET", "/minio/admin/v3/decommission-status")[2] \
            == b""
        st, _, err = c.request("POST", "/minio/admin/v3/decommission",
                               query={"pool": "7"})
        assert st == 400 and b"InvalidArgument" in err
        assert c.request("POST", "/minio/admin/v3/decommission",
                         query={"pool": "0"})[0] == 200
        for _ in range(600):
            st, _, body = c.request("GET",
                                    "/minio/admin/v3/decommission-status")
            assert st == 200
            doc = json.loads(body)
            if doc["status"] in ("complete", "failed"):
                break
            time.sleep(0.05)
        assert (doc["status"], doc["migrated"], doc["failed"]) == \
            ("complete", 12, 0)
        assert c.request("POST",
                         "/minio/admin/v3/decommission-cancel")[0] == 200
        for k, b in bodies.items():
            assert c.request("GET", f"/{B}/{k}")[2] == b
        assert _empty(lay.pools[0])
    finally:
        srv.stop()
    # A layer of one set has no pool verbs.
    one = ErasureSet([LocalStorage(str(tmp_path / "one" / f"d{i}"))
                      for i in range(4)], device="cpu")
    srv = S3Server(one, ("127.0.0.1", 0), {"minioadmin": "minioadmin"})
    srv.start()
    try:
        assert S3Client(srv.address).request(
            "POST", "/minio/admin/v3/rebalance-start")[0] == 501
    finally:
        srv.stop()


def _ref_layer(root):
    pools = []
    for name in ("p0", "p1"):
        es = RefSet([RefDisk(str(root / name / f"d{i}")) for i in range(4)])
        es._mrf_closed = True
        pools.append(RefSets([es], DEP))
    return RefPools(pools)


def test_jax_finishes_a_drain_the_port_started(tmp_path):
    """The port drains pool 0 and is stopped midway; the JAX package,
    booted on the same drives, resumes from the port's checkpoint. The
    end state is a port-finished copy's: pool 0 empty, every key's
    version stack (ids, markers, ETags, sizes) in pool 1, and the same
    counters in the record."""
    lay = _layer(tmp_path / "run")
    lay.make_bucket(B)
    bodies = _seed(lay, 40)
    lay.pools[0].put_object(B, "ver", b"v1", PutOptions(versioned=True))
    lay.pools[0].put_object(B, "ver", b"v2", PutOptions(versioned=True))
    lay.pools[0].delete_object(B, "ver", DeleteOptions(versioned=True))
    keys = [*bodies, "ver"]
    before = {k: _stack(lay, k) for k in keys}
    d = lay.start_decommission(0, checkpoint_every=4)
    _stop_midway(d)
    lay.close()
    st = decom.load_state(lay)
    assert st["status"] == "draining" and st["marker"], st
    # A pool is known by its drives' paths: each package finishes the
    # drain on the same paths, the port on the copy moved back there.
    shutil.copytree(tmp_path / "run", tmp_path / "saved")

    # The JAX package finishes it.
    for pool in ("p0", "p1"):
        for i in range(4):
            carry.to_jax(str(tmp_path / "run" / pool / f"d{i}"))
    ref = _ref_layer(tmp_path / "run")
    try:
        d2 = ref.resume_decommission()
        assert d2 is not None and d2.wait(120)
        ref_state = ref_decom.load_state(ref)
        assert _empty(ref.pools[0])
        for k, b in bodies.items():
            assert ref.get_object(B, k)[1] == b
        jax_end = {k: _stack(ref, k) for k in keys}
    finally:
        ref.close()

    # The port finishes its own copy.
    os.rename(tmp_path / "run", tmp_path / "jax-done")
    os.rename(tmp_path / "saved", tmp_path / "run")
    port = _layer(tmp_path / "run")
    try:
        d3 = port.resume_decommission()
        assert d3 is not None and d3.wait(120)
        port_state = decom.load_state(port)
        assert _empty(port.pools[0])
        port_end = {k: _stack(port, k) for k in keys}
    finally:
        port.close()
    assert jax_end == port_end == before
    counters = ("status", "migrated", "failed", "bucket", "marker", "pool",
                "pool_sig")
    assert {k: ref_state[k] for k in counters} == \
        {k: port_state[k] for k in counters}
    assert ref_state["status"] == "complete"
    assert ref_state["migrated"] == len(keys)

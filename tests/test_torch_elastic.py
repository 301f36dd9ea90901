"""The port's fleet-wide migration plane (object/decom.py's coordinator
lease, exec_page and PageDispatcher, object/pools.py's elastic janitor)
against the JAX package's, on the CPU.

The counterparts of tests/test_elastic.py's single-process cases:
migrate_key bumps the bucket (the funnel that reaches every node's
caches) while the source copy still exists; the coordinator lease lets
one walker start a drain and none without lockers; the janitor resumes
a crashed drain and a crashed rebalance and leaves an operator's pause
alone. The pause is made deterministic here by holding the walk behind
its foreground-pressure gate, where the JAX cases race a stop against
the walk. Beyond them: `exec_page` on one seeded layout counts what the
JAX package's counts and leaves the same namespace; a PageDispatcher
with one peer down migrates that peer's shard here and the live peer's
through `mig.page`; a dispatched decommission leaves the shard files
and version stacks a single walker leaves. Tolerance: none.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from minio_tpu.grid.dsync import LocalLocker as RefLocalLocker
from minio_tpu.grid.dsync import LockServer as RefLockServer
from minio_tpu.object import decom as ref_decom
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.object.pools import ServerPools as RefPools
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.object.types import PutOptions as RefPut
from minio_tpu.storage.local import LocalStorage as RefDisk

from minio_tpu_torch.grid import GridClient, GridServer
from minio_tpu_torch.grid.dsync import LocalLocker, LockServer
from minio_tpu_torch.object import decom, rebalance
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import DeleteOptions, PutOptions
from minio_tpu_torch.storage.local import SYS_VOL, LocalStorage
from tests.torch_no_caches import no_read_caches  # noqa: F401

DEP = "00000000-0000-0000-0000-0000e1a50000"
B = "db"


def _pool(root, name: str, n: int = 4, ref: bool = False):
    if ref:
        es = RefSet([RefDisk(str(root / name / f"d{i}")) for i in range(n)])
        es._mrf_closed = True
        return RefSets([es], DEP)
    es = ErasureSet([LocalStorage(str(root / name / f"d{i}"))
                     for i in range(n)], device="cpu")
    es._mrf_closed = True
    return ErasureSets([es], DEP)


def _layer(root, ref: bool = False, fresh: bool = True):
    pools = [_pool(root, "p0", ref=ref), _pool(root, "p1", ref=ref)]
    lay = RefPools(pools) if ref else ServerPools(pools)
    if fresh:
        lay.make_bucket(B)
    return lay


@pytest.fixture
def layer(tmp_path):
    lay = _layer(tmp_path)
    yield lay
    lay.close()


def _empty(pool) -> bool:
    return not pool.list_objects(B, max_keys=10,
                                 include_versions=True).objects


def _seed(lay, n: int, size: int, seed: int = 15, put=PutOptions) -> dict:
    rng = np.random.default_rng(seed)
    bodies = {f"j{i:03d}": rng.bytes(size) for i in range(n)}
    for k, b in bodies.items():
        lay.pools[0].put_object(B, k, b)
    lay.pools[0].put_object(B, "v", b"v1", put(versioned=True))
    lay.pools[0].put_object(B, "v", b"v2", put(versioned=True))
    return bodies


class _Held:
    """A foreground-pressure probe the test opens: the walk yields
    behind it until then (decom.MigrationGovernor.gate)."""

    def __init__(self):
        self.busy = threading.Event()
        self.busy.set()

    def __call__(self) -> bool:
        return self.busy.is_set()


def _paused_walk(lay, start, state_of, held):
    """Start a walk held at its gate, wait for its first yield, stop it:
    an operator's pause, checkpointed, before any key moved."""
    lay.migration_pressure = held
    walk = start()
    deadline = time.monotonic() + 30
    while state_of(walk).get("yields", 0) < 1 and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    assert state_of(walk).get("yields", 0) >= 1
    walk.stop()
    lay.migration_pressure = None
    return walk


# ---------------------------------------------------------------------------
# migrate_key's bump, the lease
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref", [True, False], ids=["jax", "port"])
def test_migrate_key_bumps_coherence_before_source_cleanup(tmp_path, ref):
    lay = _layer(tmp_path, ref=ref)
    mod = ref_decom if ref else decom
    try:
        body = os.urandom(12_345)
        lay.pools[0].put_object(B, "bump", body)
        src_set = lay.pools[0].set_for("bump")
        calls = []
        orig = src_set.metacache.bump

        def spy(bucket, *a, **kw):
            try:
                src_has = bool(src_set.list_versions_all(B, "bump"))
            except Exception:  # noqa: BLE001 - absent: cleaned up
                src_has = False
            calls.append((bucket, src_has))
            return orig(bucket, *a, **kw)
        src_set.metacache.bump = spy
        assert mod.migrate_key(lay, 0, B, "bump", lambda: 1) == len(body)
        mig = [c for c in calls if c[0] == B]
        assert mig and mig[0][1], "the first bump came after the cleanup"
        assert _empty(lay.pools[0])
        assert lay.get_object(B, "bump")[1] == body
    finally:
        lay.close()


@pytest.mark.parametrize("ref", [True, False], ids=["jax", "port"])
def test_coordinator_lease_admits_a_single_walker(tmp_path, ref):
    lay = _layer(tmp_path, ref=ref)
    mod = ref_decom if ref else decom
    try:
        lay.lockers = [(RefLocalLocker(RefLockServer(ttl=60))) if ref
                       else LocalLocker(LockServer(ttl=60))]
        held = mod.coordinator_lease(lay, "decom")
        assert held is not None and held.lock(write=True, timeout=2)
        try:
            lay.pools[0].put_object(B, "lease", b"x" * 2048)
            with pytest.raises(mod.LeaseHeld):
                lay.start_decommission(0)
            assert 0 not in lay.decommissioning
        finally:
            held.unlock()
        d = lay.start_decommission(0)
        assert d.wait(60)
        assert lay.decommission_status()["status"] == "complete"
        assert held.resource == f"{SYS_VOL}/elastic/decom-coordinator"
    finally:
        lay.close()


def test_coordinator_lease_none_without_lockers(layer):
    assert decom.coordinator_lease(layer, "decom") is None
    assert decom.page_dispatcher(layer) is None


def test_lease_held_elsewhere_answers_no_resume(layer):
    """A boot or janitor that loses the lease to a live coordinator
    resumes nothing and keeps the drain's markers."""
    _seed(layer, 4, 1000)
    _paused_walk(layer, lambda: layer.start_decommission(0),
                 lambda d: d.state, _Held())
    st = decom.load_state(layer)
    st.pop("paused")
    decom._write_doc(layer, {"records": {st["pool_sig"]: st},
                             "rev": st.get("rev", 0) + 10}, 0)
    server = LockServer(ttl=60)
    other = ServerPools(list(layer.pools))
    other.lockers = [LocalLocker(server)]
    held = decom.coordinator_lease(other, "decom")
    assert held.lock(write=True, timeout=2)
    try:
        lay2 = ServerPools(list(layer.pools))
        lay2.lockers = [LocalLocker(server)]
        assert lay2.elastic_janitor_tick() == []
        assert lay2.decommissioning == {0}
    finally:
        held.unlock()


# ---------------------------------------------------------------------------
# the elastic janitor
# ---------------------------------------------------------------------------

def test_janitor_resumes_crashed_drain(layer):
    bodies = _seed(layer, 24, 2000)
    _paused_walk(layer, lambda: layer.start_decommission(0,
                                                         checkpoint_every=4),
                 lambda d: d.state, _Held())
    st = decom.load_state(layer)
    assert st["status"] == "draining" and st["paused"] is True
    # A crash: a SIGKILLed coordinator never writes the pause.
    st.pop("paused")
    doc = decom.load_doc(layer)
    doc["records"][st["pool_sig"]] = st
    doc["rev"] += 1
    decom._write_doc(layer, doc, 0)
    lay2 = ServerPools(list(layer.pools))
    assert lay2.elastic_janitor_tick() == ["decom"]
    assert lay2._decom.wait(120)
    assert decom.load_state(lay2)["status"] == "complete"
    assert _empty(lay2.pools[0])
    for k, b in bodies.items():
        assert lay2.get_object(B, k)[1] == b
    assert lay2.get_object(B, "v")[1] == b"v2"
    assert lay2.elastic_janitor_tick() == []


def test_janitor_skips_operator_paused_walks(layer):
    _seed(layer, 12, 2000)
    _paused_walk(layer, lambda: layer.start_decommission(0),
                 lambda d: d.state, _Held())
    assert decom.load_state(layer).get("paused") is True
    lay2 = ServerPools(list(layer.pools))
    assert lay2.elastic_janitor_tick() == []
    assert lay2._decom is None
    # An operator's (or a boot's) resume still takes a paused record on.
    d2 = lay2.resume_decommission()
    assert d2 is not None and d2.wait(120)
    assert decom.load_state(lay2)["status"] == "complete"


def test_janitor_resumes_crashed_rebalance(tmp_path):
    lay = _layer(tmp_path)
    try:
        bodies = _seed(lay, 24, 6000)
        _paused_walk(lay, lambda: lay.start_rebalance(checkpoint_every=4),
                     lambda rb: rb.state, _Held())
        st = rebalance.load_state(lay)
        assert st["status"] == "rebalancing" and st["paused"] is True
        st.pop("paused")
        st["rev"] += 1
        blob = json.dumps(st, sort_keys=True).encode()
        for d in lay.pools[0].disks:
            d.write_all(SYS_VOL, rebalance.REBAL_PATH, blob)
        lay2 = ServerPools(list(lay.pools))
        assert lay2.elastic_janitor_tick() == ["rebalance"]
        assert lay2._rebalance.wait(120)
        assert rebalance.load_state(lay2)["status"] == "complete"
        for k, b in bodies.items():
            assert lay2.get_object(B, k)[1] == b
        vpage = lay2.list_objects(B, max_keys=100, include_versions=True)
        vkeys = [(o.name, o.version_id) for o in vpage.objects]
        assert len(vkeys) == len(set(vkeys)) == len(bodies) + 2
        assert not _empty(lay2.pools[1])
    finally:
        lay.close()


def test_janitor_thread_ticks_and_stops(layer, monkeypatch):
    monkeypatch.setenv("MTPU_ELASTIC_JANITOR_S", "0.05")
    ticks = []
    layer.elastic_janitor_tick = lambda: ticks.append(1) or []
    layer.start_elastic_janitor()
    deadline = time.monotonic() + 10
    while len(ticks) < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(ticks) >= 3
    layer.stop_elastic_janitor()
    n = len(ticks)
    time.sleep(0.3)
    assert len(ticks) <= n + 1 and layer._janitor is None


# ---------------------------------------------------------------------------
# exec_page and the dispatcher
# ---------------------------------------------------------------------------

def _namespace(lay) -> dict:
    """Each pool's keys with their versions' (id, size, marker)."""
    out = {}
    for i, p in enumerate(lay.pools):
        page = p.list_objects(B, max_keys=1000, include_versions=True)
        out[i] = sorted((o.name, o.version_id, o.size, o.delete_marker)
                        for o in page.objects)
    return out


def test_exec_page_counts_what_jax_counts(tmp_path):
    """One seeded namespace on each package, the same page of keys
    (bodies, versions, a marker, a key deleted before the page runs):
    the same counters and the same namespace after."""
    outs = []
    for ref in (True, False):
        lay = _layer(tmp_path / ("r" if ref else "p"), ref=ref)
        try:
            bodies = _seed(lay, 10, 3000, put=RefPut if ref else PutOptions)
            if ref:
                from minio_tpu.object.types import DeleteOptions as RefDel
                lay.pools[0].delete_object(B, "j003", RefDel(versioned=True))
            else:
                lay.pools[0].delete_object(B, "j003",
                                           DeleteOptions(versioned=True))
            keys = sorted(bodies) + ["v", "gone"]
            mod = ref_decom if ref else decom
            res = mod.exec_page(lay, 0, B, keys, exclude=[0])
            ns = _namespace(lay)
            names = {i: [(k, s, m) for k, _, s, m in v]
                     for i, v in ns.items()}
            outs.append((res, names))
        finally:
            lay.close()
    (ref_res, ref_ns), (res, ns) = outs
    assert res == ref_res
    assert res["migrated"] == 12 and res["failed"] == 0
    assert ns == ref_ns and ns[0] == []


def _peer(layer_of_peer):
    """A peer node's grid plane serving `mig.page` for its own layer."""
    srv = GridServer(0, host="127.0.0.1")
    srv.register("mig.page", lambda p: decom.serve_page(layer_of_peer, p))
    srv.start()
    return srv


def test_dispatcher_migrates_a_down_peers_shard_here(tmp_path):
    lay = _layer(tmp_path)
    peer_layer = ServerPools(list(lay.pools))     # another node's view
    srv = _peer(peer_layer)
    dead = GridClient("127.0.0.1", 1, send_retries=0)
    live = GridClient("127.0.0.1", srv.port)
    try:
        bodies = _seed(lay, 30, 1500)
        keys = sorted(bodies) + ["v"]
        before = dict(decom.PAGES_SERVED)
        disp = decom.PageDispatcher(lay, [dead, live], timeout=60)
        import zlib
        shard = [zlib.crc32(k.encode()) % 3 for k in keys]
        assert {0, 1, 2} <= set(shard)
        agg = disp.run(0, B, keys, exclude={0})
        assert agg["migrated"] == len(keys) and agg["failed"] == 0
        assert agg["bytes"] == sum(len(b) for b in bodies.values()) + 4
        served = decom.PAGES_SERVED["keys"] - before["keys"]
        assert served == shard.count(2)
        assert decom.PAGES_SERVED["batches"] == before["batches"] + 1
        assert _empty(lay.pools[0])
        for k, b in bodies.items():
            assert lay.get_object(B, k)[1] == b
    finally:
        dead.close()
        live.close()
        srv.stop()
        lay.close()


def _tree(root: str) -> dict:
    """A drive's files by path, each data dir's fresh UUID (a restore
    makes one) replaced by the order its key's journal names it in."""
    files = {}
    for dirpath, _dirs, names in os.walk(root):
        if ".mtpu.sys" in dirpath.split(os.sep):
            continue
        for f in names:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    out = {}
    for path, blob in files.items():
        if not path.endswith("xl.meta"):
            continue
        key = path[:-len("xl.meta")]
        dirs = sorted({q[len(key):].split(os.sep)[0] for q in files
                       if q.startswith(key) and q != path},
                      key=lambda d: blob.find(d.encode()))
        for i, d in enumerate(dirs):
            blob = blob.replace(d.encode(), f"dd{i}".encode())
            for q in files:
                if q.startswith(key + d + os.sep):
                    out[key + f"dd{i}" + q[len(key + d):]] = files[q]
        out[path] = blob
    return out


def test_dispatched_decommission_equals_the_single_walker(tmp_path,
                                                          monkeypatch):
    """One seeded layout copied twice: drained by one walker, and by a
    coordinator with two peers over the same drives (batches of 2 keys a
    node): the destination drives hold the same files, byte for byte,
    and the same version stacks."""
    monkeypatch.setenv("MTPU_MIG_BATCH", "2")
    seed = _layer(tmp_path / "seed")
    bodies = _seed(seed, 20, 2500)
    seed.pools[0].delete_object(B, "j005", DeleteOptions(versioned=True))
    seed.close()
    roots = {}
    for name in ("one", "fleet"):
        shutil.copytree(tmp_path / "seed", tmp_path / name)
        roots[name] = tmp_path / name
    single = _layer(roots["one"], fresh=False)
    d = single.start_decommission(0)
    assert d.wait(120)
    fleet = _layer(roots["fleet"], fresh=False)
    peers = [ServerPools(list(fleet.pools)) for _ in range(2)]
    srvs = [_peer(p) for p in peers]
    clients = [GridClient("127.0.0.1", s.port) for s in srvs]
    fleet.migration_peers = clients
    for p in peers:
        p.decommissioning = fleet.decommissioning
    before = decom.PAGES_SERVED["batches"]
    try:
        d = fleet.start_decommission(0)
        assert d.wait(120)
        assert decom.PAGES_SERVED["batches"] > before
        for lay in (single, fleet):
            st = lay.decommission_status()
            assert st["status"] == "complete" and st["failed"] == 0, st
            assert st["migrated"] == len(bodies) + 1
            assert _empty(lay.pools[0])
        for i in range(4):
            assert _tree(str(roots["fleet"] / "p1" / f"d{i}")) == \
                _tree(str(roots["one"] / "p1" / f"d{i}"))
        stacks = [{k: [(v.version_id, v.deleted, v.size, v.mod_time)
                       for v in lay.list_versions_all(B, k)]
                   for k in [*bodies, "v"]} for lay in (single, fleet)]
        assert stacks[0] == stacks[1]
    finally:
        for c in clients:
            c.close()
        for s in srvs:
            s.stop()
        single.close()
        fleet.close()


def test_pool_signature_is_the_same_on_every_node(tmp_path):
    """A pool's identity in config/decom.json: each node sees its own
    drives as local and the others' as remote, over the grid's port, yet
    names every drive by its command-line endpoint, so a drain recorded
    by one node is found by every other (its janitor, its peer notice)."""
    from minio_tpu_torch.storage.remote import RemoteStorage
    eps = [f"http://127.0.0.1:{9000 + n}{tmp_path}/n{n}/d{d}"
           for n in range(2) for d in range(2)]

    def view(node: int):
        disks = []
        for i, ep in enumerate(eps):
            path = ep.split(str(9000 + i // 2), 1)[1]
            if i // 2 == node:
                disks.append(LocalStorage(path, endpoint=ep))
            else:
                disks.append(RemoteStorage("127.0.0.1", 10000 + i // 2,
                                           path, endpoint=ep))
        return type("P", (), {"disks": disks})()
    assert decom.pool_signature(view(0)) == decom.pool_signature(view(1))


@pytest.mark.parametrize("kind", ["decommission", "rebalance"])
def test_stop_persists_the_pause_before_the_lease_goes(layer, kind):
    """A janitor ticking between a stopped walk's end and its pause on
    the drives would win the freed lease and resume what an operator
    stopped: the pause is written first, the lease released after."""
    _seed(layer, 8, 2000)
    layer.lockers = [LocalLocker(LockServer(ttl=60))]
    mod = decom if kind == "decommission" else rebalance
    start = (lambda: layer.start_decommission(0)) \
        if kind == "decommission" else layer.start_rebalance
    held = _Held()
    layer.migration_pressure = held
    walk = start()
    deadline = time.monotonic() + 30
    while walk.state.get("yields", 0) < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    seen = []
    orig = walk._release_lease

    def release():
        if walk._lease is not None:
            seen.append(mod.load_state(layer).get("paused"))
        orig()
    walk._release_lease = release
    walk.stop()
    assert seen == [True]
    lay2 = ServerPools(list(layer.pools))
    lay2.lockers = layer.lockers
    assert lay2.elastic_janitor_tick() == []


def test_janitor_leaves_a_walk_paused_while_it_waited(layer):
    """The janitor read an unpaused checkpoint and waits for the lease;
    the coordinator pauses, persists and releases: the janitor, winning
    the lease, finds the pause and resumes nothing."""
    _seed(layer, 4, 1000)
    _paused_walk(layer, lambda: layer.start_decommission(0),
                 lambda d: d.state, _Held())
    doc = decom.load_doc(layer)
    (sig, st), = doc["records"].items()
    st.pop("paused")
    doc["rev"] += 1
    decom._write_doc(layer, doc, 0)
    server = LockServer(ttl=60)
    coordinator = ServerPools(list(layer.pools))
    coordinator.lockers = [LocalLocker(server)]
    held = decom.coordinator_lease(coordinator, "decom")
    assert held.lock(write=True, timeout=2)
    lay2 = ServerPools(list(layer.pools))
    lay2.lockers = [LocalLocker(server)]
    out = []
    t = threading.Thread(target=lambda: out.append(
        lay2.elastic_janitor_tick()))
    t.start()
    time.sleep(0.5)                     # the janitor waits on the lease
    st["paused"] = True
    doc["rev"] += 1
    decom._write_doc(layer, doc, 0)
    held.unlock()
    t.join(30)
    assert not t.is_alive() and out == [[]]
    assert lay2._decom is None
    assert decom.load_state(layer)["paused"] is True

"""The port's cross-node cache coherence (minio_tpu_torch/grid/coherence.py)
against the JAX package's (minio_tpu/grid/coherence.py), on the CPU.

The counterparts of tests/test_cluster.py's coherence cases: a pair of
nodes pushes, resyncs and re-arms, and a lost connection disarms (the
same script runs on each package, in a subprocess each, and the two
record the same observations); the fileinfo cache's and the listing
cache's gates; a two-node stack of remote sets with the caches on, where
a cross-node overwrite empties the other node's fileinfo cache before
the PUT returns and a partitioned node serves no stale hit until its
rejoin resync. Beyond them: a port node and a JAX node push, sync and
resync each other over their two grids (the payloads are the same
bytes); a sibling worker's FileGate reads a stale heartbeat as
incoherent; a failed relay's flag becomes a wildcard broadcast; the hot
cache serves a key only while its owning set's gate is open and loses
that set's entries when it reopens, and on a layer without gates serves
without asking a pool's placement. Tolerance: none.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from minio_tpu.grid.coherence import FileGate as RefFileGate
from minio_tpu.object.fi_cache import FileInfoCache as RefFileInfoCache
from minio_tpu_torch.grid import GridClient, GridError, GridServer
from minio_tpu_torch.grid.coherence import (CLASS_BUCKET_META, CLASS_LISTING,
                                            FileGate, PeerCoherence,
                                            make_set_invalidator)
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.fi_cache import FileInfoCache
from minio_tpu_torch.object.hotcache import HotObjectCache
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.storage.remote import RemoteStorage, StorageRPCService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEP = "00000000-0000-0000-0000-00000c0e4e00"


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# the protocol on a pair of nodes, one script run on each package
# ---------------------------------------------------------------------------

# tests/test_cluster.py's test_coherence_push_resync_and_rearm and
# test_coherence_conn_loss_disarms, as a script over either package
# (argv[1]) that prints what it observed.
_PAIR = textwrap.dedent("""
    import json, sys, time
    pkg = sys.argv[1]
    grid = __import__(pkg + ".grid", fromlist=["GridServer"])
    coh = __import__(pkg + ".grid.coherence", fromlist=["PeerCoherence"])
    obs = []

    def pair():
        a, b = grid.GridServer(0, host="127.0.0.1"), \\
            grid.GridServer(0, host="127.0.0.1")
        a.start()
        b.start()
        c_ab = grid.GridClient("127.0.0.1", b.port, send_retries=0)
        c_ba = grid.GridClient("127.0.0.1", a.port, send_retries=0)
        inv_a, inv_b = [], []
        ca = coh.PeerCoherence("A", {"B": c_ab},
                               on_invalidate=lambda b, c: inv_a.append([b, c]))
        cb = coh.PeerCoherence("B", {"A": c_ba},
                               on_invalidate=lambda b, c: inv_b.append([b, c]))
        ca.register_into(a)
        cb.register_into(b)
        return a, b, c_ab, c_ba, ca, cb, inv_a, inv_b

    a, b, c_ab, c_ba, ca, cb, inv_a, inv_b = pair()
    obs.append(["armed at start", ca.coherent(), cb.coherent()])
    obs.append(["resync", ca.resync("B"), cb.resync("A"),
                ca.coherent(), cb.coherent()])
    ca.broadcast("bkt", coh.CLASS_LISTING)
    obs.append(["push", list(inv_b), ca.stats()["inv_sent"],
                ca.stats()["inv_failed"]])
    real = c_ab.call

    def dead(*a, **kw):
        raise grid.GridError("partitioned")
    c_ab.call = dead
    ca.broadcast("bkt", coh.CLASS_LISTING)
    st = ca.stats()
    obs.append(["escalated", st["inv_failed"], st["escalations"]])
    n = len(inv_b)
    cb._disarm("A")
    obs.append(["disarmed", cb.coherent()])
    obs.append(["pull recovers", cb.resync("A"), len(inv_b) - n,
                cb.coherent()])
    c_ab.call = real
    n = len(inv_b)
    obs.append(["no change", cb.resync("A"), len(inv_b) - n])
    ca.broadcast("meta", coh.CLASS_BUCKET_META)
    obs.append(["meta push", inv_b[-1]])
    st = cb.stats()
    obs.append(["b stats", st["peers"], st["armed"], st["inv_applied"],
                st["resyncs"]])
    for c in (c_ab, c_ba):
        c.close()
    a.stop()
    b.stop()

    # A live connection dying disarms at once.
    a, b, c_ab, c_ba, ca, cb, inv_a, inv_b = pair()
    cb.resync("A")
    ping = c_ba.ping()
    a.stop()
    deadline = time.monotonic() + 5
    while cb.coherent() and time.monotonic() < deadline:
        time.sleep(0.05)
    obs.append(["conn loss", ping, cb.coherent()])
    for c in (c_ab, c_ba):
        c.close()
    b.stop()
    print(json.dumps(obs))
""")


def _run_pair(pkg: str) -> list:
    r = subprocess.run([sys.executable, "-c", _PAIR, pkg], env=_env(),
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_coherence_push_resync_rearm_and_conn_loss_equal_jax():
    port, ref = _run_pair("minio_tpu_torch"), _run_pair("minio_tpu")
    assert port == ref
    obs = {o[0]: o[1:] for o in port}
    assert obs["armed at start"] == [False, False]
    assert obs["resync"] == [True, True, True, True]
    # The first resync of a peer's instance flushes every class.
    assert obs["push"] == [[["", CLASS_LISTING], ["", CLASS_BUCKET_META],
                            ["bkt", CLASS_LISTING]], 1, 0]
    assert obs["escalated"] == [1, 1]
    assert obs["disarmed"] == [False]
    assert obs["pull recovers"] == [True, 1, True]
    assert obs["no change"] == [True, 0]
    assert obs["meta push"] == [["meta", CLASS_BUCKET_META]]
    assert obs["conn loss"] == [True, False]


# ---------------------------------------------------------------------------
# a port node and a JAX node
# ---------------------------------------------------------------------------

_JAX_NODE = textwrap.dedent("""
    import json, sys
    from minio_tpu.grid import GridClient, GridServer
    from minio_tpu.grid.coherence import PeerCoherence
    srv = GridServer(0, host="127.0.0.1")
    srv.start()
    print(srv.port, flush=True)
    peer = int(sys.stdin.readline())
    inv = []
    c = GridClient("127.0.0.1", peer, send_retries=0)
    node = PeerCoherence("J", {"P": c},
                         on_invalidate=lambda b, cl: inv.append([b, cl]))
    node.register_into(srv)
    print("ready", flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd[0] == "resync":
            out = node.resync("P")
        elif cmd[0] == "broadcast":
            node.broadcast(cmd[1], cmd[2])
            out = None
        else:
            st = node.stats()
            out = {"coherent": node.coherent(), "inv": inv,
                   "sent": st["inv_sent"], "failed": st["inv_failed"],
                   "applied": st["inv_applied"]}
        print(json.dumps(out), flush=True)
    c.close()
    srv.stop()
""")


def test_port_and_jax_nodes_push_sync_and_resync_each_other():
    srv = GridServer(0, host="127.0.0.1")
    srv.start()
    p = subprocess.Popen([sys.executable, "-c", _JAX_NODE],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         env=_env(), cwd=REPO, text=True)
    c = None
    try:
        jport = int(p.stdout.readline())
        c = GridClient("127.0.0.1", jport, send_retries=0)
        inv = []
        node = PeerCoherence("P", {"J": c},
                             on_invalidate=lambda b, cl: inv.append([b, cl]))
        node.register_into(srv)
        p.stdin.write(f"{srv.port}\n")
        p.stdin.flush()
        assert p.stdout.readline().strip() == "ready"

        def jax(*cmd):
            p.stdin.write(json.dumps(list(cmd)) + "\n")
            p.stdin.flush()
            return json.loads(p.stdout.readline())

        # Both start disarmed; each arms through a resync of the other.
        assert not node.coherent() and not jax("state")["coherent"]
        assert node.resync("J") and jax("resync") is True
        assert node.coherent() and jax("state")["coherent"]
        # Pushes both ways, acked.
        node.broadcast("pb", CLASS_LISTING)
        node.broadcast("pm", CLASS_BUCKET_META)
        # (Each first resync of the other's instance flushed every class.)
        wild = [["", CLASS_LISTING], ["", CLASS_BUCKET_META]]
        st = jax("state")
        assert st["inv"] == wild + [["pb", CLASS_LISTING],
                                    ["pm", CLASS_BUCKET_META]]
        assert node.stats()["inv_sent"] == 2 and st["applied"] == 4
        jax("broadcast", "jb", CLASS_LISTING)
        assert inv == wild + [["jb", CLASS_LISTING]]
        assert jax("state")["sent"] == 1
        # A push the JAX node missed comes back through its pull.
        real = srv._handlers["gen.inv"]
        srv._handlers["gen.inv"] = None          # the handler fails
        jax("broadcast", "missed", CLASS_LISTING)
        assert jax("state")["failed"] == 1 and len(inv) == 3
        srv._handlers["gen.inv"] = real
        node._disarm("J")
        assert not node.coherent()
        assert node.resync("J") and node.coherent()
        assert inv[3:] == [["missed", CLASS_LISTING]]
        # And the other way: nothing moved, nothing applied.
        n = len(jax("state")["inv"])
        assert jax("resync") is True
        assert len(jax("state")["inv"]) == n
    finally:
        if c is not None:
            c.close()
        p.stdin.close()
        p.wait(timeout=30)
        srv.stop()


# ---------------------------------------------------------------------------
# the caches' gates
# ---------------------------------------------------------------------------

class _FI:
    erasure = type("E", (), {"data_blocks": 0})()
    inline_data = b""


@pytest.mark.parametrize("cls", [RefFileInfoCache, FileInfoCache],
                         ids=["jax", "port"])
def test_fi_cache_remote_gate_blocks_serving(cls):
    """tests/test_cluster.py's case on each package: a shut gate answers
    misses (data and stat class), inserts still land, an open gate
    serves them."""
    cache = cls(enabled=True)
    tok = cache.token("b")
    cache.put("b", "o", "", _FI(), [], read_data=True, token=tok)
    assert cache.get("b", "o", "", need_data=False) is not None
    up = [False]
    cache.remote_gate = lambda: up[0]
    assert cache.get("b", "o", "", need_data=False) is None
    assert cache.get_stat("b", "o", "") is None
    cache.put("b", "o2", "", _FI(), [], read_data=True,
              token=cache.token("b"))
    up[0] = True
    assert cache.get("b", "o", "", need_data=False) is not None
    assert cache.get("b", "o2", "", need_data=False) is not None


def test_metacache_remote_gate_bypasses_cached_walks(tmp_path):
    es = ErasureSet([LocalStorage(str(tmp_path / f"d{i}"))
                     for i in range(4)], device="cpu")
    es._mrf_closed = True
    try:
        es.make_bucket("b")
        es.put_object("b", "k1", b"x" * 1024)
        mc = es.metacache
        assert [o.name for o in es.list_objects("b").objects] == ["k1"]
        hits0 = mc.stats()["hits"]
        es.list_objects("b")
        assert mc.stats()["hits"] == hits0 + 1      # the cached walk
        up = [False]
        mc.remote_gate = lambda: up[0]
        started0 = mc.stats()["walks_started"]
        es.list_objects("b")                        # incoherent: a walk
        assert mc.stats()["walks_started"] == started0 + 1
        up[0] = True
        es.list_objects("b")
        es.list_objects("b")                        # cached again
        assert mc.stats()["hits"] > hits0 + 1
    finally:
        es.close()


def test_file_gate_stale_heartbeat_reads_incoherent(tmp_path):
    """A sibling's gate on worker 0's published verdict, on each package:
    "1" fresh is coherent; "0", a missing file, and a "1" whose
    heartbeat is older than the TTL are not."""
    path = str(tmp_path / "coherence.state")
    for cls in (RefFileGate, FileGate):
        gate = cls(path, ttl=2.0, poll=0.0)
        if os.path.exists(path):
            os.unlink(path)
        assert gate() is False
        with open(path, "w") as f:
            f.write("1")
        assert gate() is True
        old = time.time() - 5
        os.utime(path, (old, old))
        assert gate() is False, cls
        with open(path, "w") as f:
            f.write("0")
        assert gate() is False


def test_relay_flag_becomes_a_wildcard_broadcast(tmp_path):
    """A sibling whose relay failed leaves the flag; worker 0's next tick
    removes it and pushes a wildcard ("") of both classes, and publishes
    its verdict for the siblings."""
    a, b = GridServer(0, host="127.0.0.1"), GridServer(0, host="127.0.0.1")
    a.start()
    b.start()
    c_ab = GridClient("127.0.0.1", b.port, send_retries=0)
    c_ba = GridClient("127.0.0.1", a.port, send_retries=0)
    got = []
    try:
        ca = PeerCoherence("A", {"B": c_ab}, sync_interval=0.1)
        cb = PeerCoherence("B", {"A": c_ba},
                           on_invalidate=lambda bk, cl: got.append((bk, cl)))
        ca.register_into(a)
        cb.register_into(b)
        assert cb.resync("A")       # B knows A's instance: no flush-all
        got.clear()
        ca.state_path = str(tmp_path / "coherence.state")
        ca.relay_flag_path = str(tmp_path / "coherence.relay-flag")
        open(ca.relay_flag_path, "w").close()
        ca.start()
        deadline = time.monotonic() + 10
        while (os.path.exists(ca.relay_flag_path) or len(got) < 2) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert not os.path.exists(ca.relay_flag_path)
        assert got == [("", CLASS_LISTING), ("", CLASS_BUCKET_META)]
        while time.monotonic() < deadline and \
                open(ca.state_path).read() != "1":
            time.sleep(0.05)
        assert open(ca.state_path).read() == "1"
        assert FileGate(ca.state_path)() is True
        # The relay verb itself: a sibling's bump pushed on its behalf.
        assert GridClient("127.0.0.1", a.port).call(
            "gen.relay", {"b": "rb", "c": CLASS_LISTING}) == "ok"
        assert got[-1] == ("rb", CLASS_LISTING)
        ca.stop()
    finally:
        c_ab.close()
        c_ba.close()
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# two nodes' remote sets with their caches on
# ---------------------------------------------------------------------------

def _two_node_stack(tmp_path):
    """tests/test_cluster.py's `_two_node_stack` on the port: one 4-drive
    layout, node A holding d0-d1 and node B d2-d3, each node's set
    reaching the other two over the grid, each wired into its own
    PeerCoherence."""
    drives = [LocalStorage(str(tmp_path / f"d{i}")) for i in range(4)]
    srv_a, srv_b = GridServer(0, host="127.0.0.1"), \
        GridServer(0, host="127.0.0.1")
    StorageRPCService({d.root: d for d in drives[:2]}).register_into(srv_a)
    StorageRPCService({d.root: d for d in drives[2:]}).register_into(srv_b)
    srv_a.start()
    srv_b.start()
    es_a = ErasureSet(drives[:2] + [RemoteStorage("127.0.0.1", srv_b.port,
                                                  d.root)
                                    for d in drives[2:]], device="cpu")
    es_b = ErasureSet([RemoteStorage("127.0.0.1", srv_a.port, d.root)
                       for d in drives[:2]] + drives[2:], device="cpu")
    for es in (es_a, es_b):
        es._mrf_closed = True
        # A set built without the protocol: on, behind a deny-all gate.
        assert es.fi_cache.enabled and es.fi_cache.remote_gate() is False
    c_ab = GridClient("127.0.0.1", srv_b.port, send_retries=0)
    c_ba = GridClient("127.0.0.1", srv_a.port, send_retries=0)
    coh_a = PeerCoherence("A", {"B": c_ab},
                          on_invalidate=make_set_invalidator([es_a]))
    coh_b = PeerCoherence("B", {"A": c_ba},
                          on_invalidate=make_set_invalidator([es_b]))
    coh_a.register_into(srv_a)
    coh_b.register_into(srv_b)
    for es, coh in ((es_a, coh_a), (es_b, coh_b)):
        es.metacache.on_bump = \
            lambda bucket, coh=coh: coh.broadcast(bucket, CLASS_LISTING)
        es.metacache.bump_coalesce = 0.0
        es.fi_cache.remote_gate = coh.coherent
        es.metacache.remote_gate = coh.coherent
    assert coh_a.resync("B") and coh_b.resync("A")
    return {"servers": (srv_a, srv_b), "clients": (c_ab, c_ba),
            "sets": (es_a, es_b), "coh": (coh_a, coh_b)}


def _teardown(stack):
    for es in stack["sets"]:
        es.close()
    for c in stack["clients"]:
        c.close()
    for s in stack["servers"]:
        s.stop()


def test_cross_node_overwrite_invalidates_sibling_fi_cache(tmp_path):
    """Repeat GETs on node B hit its fileinfo cache; an overwrite
    through node A empties B's entry before A's PUT returns; a new key
    through A lists on B at once."""
    stack = _two_node_stack(tmp_path)
    es_a, es_b = stack["sets"]
    try:
        es_a.make_bucket("bkt")
        v1 = os.urandom(64 << 10)
        es_a.put_object("bkt", "obj", v1)
        assert es_b.get_object("bkt", "obj")[1] == v1
        hits0 = es_b.fi_cache.stats()["hits"]
        assert es_b.get_object("bkt", "obj")[1] == v1
        assert es_b.fi_cache.stats()["hits"] > hits0
        v2 = os.urandom(64 << 10)
        es_a.put_object("bkt", "obj", v2)
        assert es_b.fi_cache.get("bkt", "obj", "", need_data=False) is None
        assert es_b.get_object("bkt", "obj")[1] == v2
        assert [o.name for o in es_b.list_objects("bkt").objects] == ["obj"]
        es_a.put_object("bkt", "obj2", b"x" * 2048)
        assert [o.name for o in es_b.list_objects("bkt").objects] == \
            ["obj", "obj2"]
    finally:
        _teardown(stack)


def test_partitioned_then_rejoined_node_serves_zero_stale(tmp_path):
    """B caches an entry; the coherence plane partitions; A overwrites
    (its push escalates); B answers from the drives, never its stale
    entry, until the rejoin resync re-arms it, and then hits again."""
    stack = _two_node_stack(tmp_path)
    es_a, es_b = stack["sets"]
    c_ab, c_ba = stack["clients"]
    coh_a, coh_b = stack["coh"]
    try:
        es_a.make_bucket("bkt")
        v1 = os.urandom(32 << 10)
        es_a.put_object("bkt", "obj", v1)
        assert es_b.get_object("bkt", "obj")[1] == v1
        assert es_b.fi_cache.get("bkt", "obj", "", need_data=False) \
            is not None

        def dead(*a, **kw):
            raise GridError("partitioned")
        real_ab, real_ba = c_ab.call, c_ba.call
        c_ab.call = c_ba.call = dead
        assert not coh_b.resync("A") and not coh_b.coherent()
        v2 = os.urandom(32 << 10)
        es_a.put_object("bkt", "obj", v2)
        assert coh_a.stats()["inv_failed"] >= 1
        assert es_b.fi_cache.get("bkt", "obj", "", need_data=False) is None
        assert es_b.get_object("bkt", "obj")[1] == v2
        c_ab.call, c_ba.call = real_ab, real_ba
        assert coh_b.resync("A") and coh_b.coherent()
        assert es_b.fi_cache.get("bkt", "obj", "", need_data=False) is None
        assert es_b.get_object("bkt", "obj")[1] == v2
        hits0 = es_b.fi_cache.stats()["hits"]
        assert es_b.get_object("bkt", "obj")[1] == v2
        assert es_b.fi_cache.stats()["hits"] > hits0
    finally:
        _teardown(stack)


def test_hot_cache_gates_on_the_owning_set_and_flushes_it(tmp_path):
    """Two sets of one pool: a shut gate of the set owning a key stops
    that key's hits and not the other set's; when the gate reopens the
    owning set's entries are gone and the other's stay."""
    sets = [ErasureSet([LocalStorage(str(tmp_path / f"s{j}d{i}"))
                        for i in range(4)], device="cpu") for j in range(2)]
    layer = ServerPools([ErasureSets(sets, DEP)])
    hot = HotObjectCache()
    hot.attach_layer(layer)
    try:
        keys = {}
        for i in range(64):
            keys.setdefault(layer.pools[0].set_index(f"k{i}"), f"k{i}")
            if len(keys) == 2:
                break
        k0, k1 = keys[0], keys[1]
        for k in (k0, k1):
            assert hot.put("b", k, {"etag": k}, k.encode(), None,
                           hot.token("b"))
            assert hot.get("b", k) is not None
        up = [False]
        sets[0].fi_cache.remote_gate = lambda: up[0]
        hot.attach_layer(layer)       # as a boot gates the sets first
        assert hot.get("b", k0) is None
        assert hot.get("b", k1) is not None
        up[0] = True
        assert hot.get("b", k0) is None          # flushed on reopening
        assert hot.get("b", k1) is not None
        assert hot.put("b", k0, {"etag": k0}, k0.encode(), None,
                       hot.token("b"))
        assert hot.get("b", k0) is not None
    finally:
        layer.close()


def test_hot_cache_on_an_ungated_layer_skips_placement(tmp_path,
                                                        monkeypatch):
    """One node's sets carry no gate: a lookup serves without asking a
    pool's placement. Once a set is gated and the layer attached again,
    every lookup reads the owning set's gate."""
    sets = [ErasureSet([LocalStorage(str(tmp_path / f"s{j}d{i}"))
                        for i in range(4)], device="cpu") for j in range(2)]
    layer = ServerPools([ErasureSets(sets, DEP)])
    hot = HotObjectCache()
    hot.attach_layer(layer)
    try:
        assert hot.put("b", "k", {"etag": "k"}, b"k", None, hot.token("b"))
        asked = []
        set_for = layer.pools[0].set_for
        monkeypatch.setattr(layer.pools[0], "set_for",
                            lambda key: asked.append(key) or set_for(key))
        assert hot.get("b", "k") is not None and asked == []
        for es in sets:
            es.fi_cache.remote_gate = lambda: False
        hot.attach_layer(layer)
        assert hot.get("b", "k") is None and asked == ["k"]
    finally:
        layer.close()

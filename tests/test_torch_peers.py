"""The port's peer notices (minio_tpu_torch/grid/peers.py) against the JAX
package's (minio_tpu/grid/peers.py), on the CPU.

The counterparts of tests/test_distributed.py's
test_peer_notifier_reload_handler and tests/test_cluster.py's
test_peer_notifier_counts_and_logs_failures: a broadcast reaches a
registered reload handler, which drops the cache its kind names
(bucket metadata, a bucket's listing walks without a broadcast back, a
drain's placement); iam and config are answered and change nothing
here, as the JAX handler built without them; unknown kinds and dead
peers are tolerated, and every failure is counted. Beyond them: a port notifier reaches a JAX node's handler and a
JAX notifier a port node's (the same payloads), and a decom notice
re-reads the drains and tells the node's other workers. Tolerance:
none.
"""

import json
import os
import subprocess
import sys
import textwrap

from minio_tpu_torch.grid import GridClient, GridServer
from minio_tpu_torch.grid import peers as peers_mod
from minio_tpu_torch.grid.peers import (PeerNotifier, RELOAD_HANDLER,
                                        make_reload_handler)
from minio_tpu_torch.object import decom
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.local import LocalStorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEP = "00000000-0000-0000-0000-0000000e0e15"


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


class _MC:
    def __init__(self, log):
        self.log = log

    def bump(self, bucket, broadcast=True):
        self.log.append(("bump", bucket, broadcast))


class _Set:
    def __init__(self, log):
        self.metacache = _MC(log)


class _Layer:
    """What the handler reaches of an object layer, recorded."""

    def __init__(self):
        self.log = []
        self.sets = [_Set(self.log), _Set(self.log)]

    def invalidate_bucket_meta(self, bucket=""):
        self.log.append(("meta", bucket))

    def peer_decom_notice(self):
        self.log.append(("decom",))


def test_peer_notifier_reload_handler():
    layer = _Layer()
    srv = GridServer(0, host="127.0.0.1")
    srv.register(RELOAD_HANDLER, make_reload_handler(layer))
    srv.start()
    try:
        n = PeerNotifier([GridClient("127.0.0.1", srv.port)])
        n.broadcast("iam")
        n.broadcast("bucket-meta", bucket="bkt")
        n.broadcast("config")
        n.broadcast("listing", bucket="lb")
        n.broadcast("decom")
        assert layer.log == [("meta", "bkt"), ("bump", "lb", False),
                             ("bump", "lb", False), ("decom",)]
        # Unknown kinds and dead peers are tolerated.
        n.broadcast("future-kind")
        PeerNotifier([GridClient("127.0.0.1", 1)], timeout=0.5) \
            .broadcast("iam")
        assert len(layer.log) == 4
        assert GridClient("127.0.0.1", srv.port).call(
            RELOAD_HANDLER, {"kind": "iam"}) == "ok"
    finally:
        srv.stop()


def test_peer_notifier_counts_and_logs_failures():
    srv = GridServer(0, host="127.0.0.1")
    srv.register(RELOAD_HANDLER, make_reload_handler())
    srv.start()
    try:
        before = peers_mod.notify_stats()
        live = GridClient("127.0.0.1", srv.port)
        dead = GridClient("127.0.0.1", 1, send_retries=0)
        PeerNotifier([live, dead], timeout=1.0).broadcast("iam")
        after = peers_mod.notify_stats()
        assert after["sent"] == before["sent"] + 1
        assert after["failed"] == before["failed"] + 1
    finally:
        srv.stop()


# A JAX node's reload handler over a recording layer: prints its port,
# then, once stdin closes, what it recorded.
_JAX_NODE = textwrap.dedent("""
    import json, sys
    from minio_tpu.grid import GridServer
    from minio_tpu.grid.peers import RELOAD_HANDLER, make_reload_handler
    log = []
    class Layer:
        def invalidate_bucket_meta(self, bucket=""):
            log.append(["meta", bucket])
        def sync_decommission_markers(self):
            log.append(["decom"])
    srv = GridServer(0, host="127.0.0.1")
    srv.register(RELOAD_HANDLER, make_reload_handler(object_layer=Layer()))
    srv.start()
    print(srv.port, flush=True)
    sys.stdin.read()
    srv.stop()
    print(json.dumps(log))
""")

_JAX_NOTIFIER = textwrap.dedent("""
    import sys
    from minio_tpu.grid import GridClient
    from minio_tpu.grid.peers import PeerNotifier, notify_stats
    n = PeerNotifier([GridClient("127.0.0.1", int(sys.argv[1]))])
    for kind, bucket in (("bucket-meta", "jb"), ("decom", ""),
                         ("iam", ""), ("listing", "jl")):
        n.broadcast(kind, bucket)
    print(notify_stats()["sent"])
""")


def test_notices_cross_between_the_packages():
    p = subprocess.Popen([sys.executable, "-c", _JAX_NODE],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         env=_env(), cwd=REPO, text=True)
    try:
        port = int(p.stdout.readline())
        n = PeerNotifier([GridClient("127.0.0.1", port)])
        before = peers_mod.notify_stats()
        n.broadcast("bucket-meta", "pb")
        n.broadcast("decom")
        n.broadcast("config")
        assert peers_mod.notify_stats()["sent"] == before["sent"] + 3
        p.stdin.close()
        assert json.loads(p.stdout.read().strip().splitlines()[-1]) == \
            [["meta", "pb"], ["decom"]]
    finally:
        p.wait(timeout=30)
    layer = _Layer()
    srv = GridServer(0, host="127.0.0.1")
    srv.register(RELOAD_HANDLER, make_reload_handler(layer))
    srv.start()
    try:
        r = subprocess.run([sys.executable, "-c", _JAX_NOTIFIER,
                            str(srv.port)], env=_env(), cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip().splitlines()[-1] == "4"
        assert layer.log == [("meta", "jb"), ("decom",),
                             ("bump", "jl", False), ("bump", "jl", False)]
    finally:
        srv.stop()


class _Gen:
    bumps = 0

    def bump(self):
        self.bumps += 1

    def changed(self):
        return False


def test_decom_notice_rereads_the_drains(tmp_path):
    """A drain recorded by another node leaves this node's placement at
    its notice, and the node's other workers are told (decom_gen)."""
    def pool(name):
        return ErasureSets([ErasureSet(
            [LocalStorage(str(tmp_path / name / f"d{i}")) for i in range(4)],
            device="cpu")], DEP)
    here = ServerPools([pool("p0"), pool("p1")])
    there = ServerPools(list(here.pools))
    here.decom_gen = _Gen()
    try:
        rec = {"pool": 0, "status": "draining",
               "pool_sig": decom.pool_signature(there.pools[0]),
               "started_ns": 1, "bucket": "", "marker": "",
               "migrated": 0, "failed": 0}
        decom._write_doc(there, {"records": {rec["pool_sig"]: rec},
                                 "rev": 1}, 0)
        assert here.decommissioning == set()
        make_reload_handler(here)({"kind": "decom"})
        assert here.decommissioning == {0}
        assert here.decom_gen.bumps == 1
        assert here._pool_for_new() == 1
    finally:
        here.close()

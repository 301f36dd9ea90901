"""Multi-node boots of the port's server against the JAX package's.

Port nodes (`python -m minio_tpu_torch.server --device cpu`, spawned by
tests/torch_cluster.py) and JAX nodes (tests/cluster.py) of the same
layout, fed the same requests, answer the same bytes from every node,
leave the same shard files on each drive position, and give the same
status codes as nodes die in and out of write quorum; four port nodes
given 16 http:// endpoints boot one 16-drive set at EC 12+4; two
workers a node share the node's grid plane; and a peer of another
deployment is refused at boot by either package's node.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np

from minio_tpu.storage.meta import XLMeta as RefMeta
from minio_tpu_torch.grid import GridServer
from minio_tpu_torch.storage import meta as port_meta
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.storage.remote import StorageRPCService
from tests.cluster import GRID_OFFSET, REPO_ROOT, Cluster, free_ports
from tests.torch_cluster import TorchCluster

B = "cbkt"


def _both(fn, *clusters):
    """fn(cluster) on each cluster at once; the results in order."""
    out = [None] * len(clusters)
    errs = []

    def run(i, c):
        try:
            out[i] = fn(c)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i, c))
          for i, c in enumerate(clusters)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return out


def _put_retry(cli, path, body, deadline_s=45):
    deadline = time.time() + deadline_s
    while True:
        try:
            st, _, b = cli.request("PUT", path, body=body)
        except Exception as e:  # noqa: BLE001 - conn reset mid-failover
            st, b = 0, str(e).encode()
        if st == 200:
            return st
        assert time.time() < deadline, f"PUT {path}: {st} {b[:300]}"
        time.sleep(1)


def _get_retry(cli, path, want, deadline_s=45):
    deadline = time.time() + deadline_s
    while True:
        try:
            st, _, got = cli.request("GET", path)
        except Exception as e:  # noqa: BLE001 - conn reset mid-failover
            st, got = 0, str(e).encode()
        if st == 200 and got == want:
            return
        assert time.time() < deadline, f"GET {path}: {st}"
        time.sleep(0.5)


def _key_files(drive, key, meta_cls):
    d = os.path.join(drive, B, key)
    xl = meta_cls.load(open(os.path.join(d, "xl.meta"), "rb").read())
    v = xl.versions[0]
    parts = sorted(os.path.join(d, sub, "part.1") for sub in os.listdir(d)
                   if os.path.exists(os.path.join(d, sub, "part.1")))
    return ({**v["ec"], "dist": list(v["ec"]["dist"])}, v["size"],
            list(xl.inline.values()), [open(p, "rb").read() for p in parts])


BODIES = {k: np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
          for k, n in (("tiny", 10), ("inline", 60_000), ("big", 700_001),
                       ("dir/nested", 4096))}


def test_same_bytes_and_shards_as_jax(tmp_path):
    """4 nodes x 2 drives (one set of 8, EC 4+4): every node answers
    every key byte for byte, both packages leave the same shard files
    and inline shards on each drive position, and list the same keys."""
    port = TorchCluster(tmp_path / "port", nodes=4, drives_per_node=2)
    ref = Cluster(tmp_path / "ref", nodes=4, drives_per_node=2)
    try:
        port.start()       # one after the other: boots are CPU bursts
        ref.start()

        def feed(c):
            cl = c.client(1)
            out = [cl.request("PUT", f"/{B}")[0]]
            for i, (k, body) in enumerate(BODIES.items()):
                out.append(c.client(i % 4).request(
                    "PUT", f"/{B}/{k}", body=body)[0])
            for i in range(4):
                for k, body in BODIES.items():
                    st, _, got = c.client(i).request("GET", f"/{B}/{k}")
                    out.append((i, k, st, got == body))
            st, _, listing = c.client(3).request("GET", f"/{B}")
            out.append((st, [k for k in BODIES
                             if f"<Key>{k}</Key>".encode() in listing]))
            return out
        got, want = _both(feed, port, ref)
        assert got == want
        assert all(x[3] for x in got[1 + len(BODIES):-1])
        assert got[-1] == (200, list(BODIES))
        for k in BODIES:
            assert [_key_files(port.drive_dir(i, d), k, port_meta.XLMeta)
                    for i in range(4) for d in range(2)] == \
                [_key_files(ref.drive_dir(i, d), k, RefMeta)
                 for i in range(4) for d in range(2)], k
    finally:
        port.stop()
        ref.stop()


def test_kill_in_and_out_of_write_quorum_equal_jax(tmp_path):
    """3 nodes x 2 drives (EC 3+3, write quorum 4): one node down is in
    write quorum, two down is out (503, and fast); the port answers the
    status codes the JAX package answers."""
    body = os.urandom(256 << 10)

    def steps(c):
        c0 = c.client(0)
        codes = [c0.request("PUT", "/qbkt")[0],
                 _put_retry(c0, "/qbkt/obj1", body)]
        c.kill(2)
        codes.append(_put_retry(c0, "/qbkt/obj2", body))
        st, _, got = c.client(1).request("GET", "/qbkt/obj2")
        codes += [st, got == body]
        c.kill(1)
        deadline = time.time() + 45
        while True:
            st, _, b = c0.request("PUT", "/qbkt/obj3", body=b"x" * 4096)
            if st == 503:
                break
            assert time.time() < deadline, f"want 503, got {st}"
            time.sleep(1)
        codes.append(st)
        t0 = time.time()
        st, _, _ = c0.request("PUT", "/qbkt/obj3", body=b"x" * 4096)
        codes += [st, time.time() - t0 < 10.0]
        codes.append(c0.request("GET", "/qbkt/obj1")[0])
        return codes

    port = TorchCluster(tmp_path / "port", nodes=3, drives_per_node=2)
    ref = Cluster(tmp_path / "ref", nodes=3, drives_per_node=2)
    try:
        port.start()       # one after the other: boots are CPU bursts
        ref.start()
        got, want = _both(steps, port, ref)
        assert got == want
        assert got[:6] == [200, 200, 200, 200, True, 503]
    finally:
        port.stop()
        ref.stop()


def test_four_nodes_boot_one_set_of_16(tmp_path):
    """The deployment of MinIO's multi-node multi-drive guide at test
    size: 4 nodes x 4 drives, one set at EC 12+4; every node writes and
    reads, and a listing from any node shows every node's writes."""
    with TorchCluster(tmp_path, nodes=4, drives_per_node=4) as c:
        for i in range(4):
            assert "16 drives, EC 12+4; distributed over 4 nodes" \
                in c.logs(i), c.logs(i)[-800:]
        assert c.client(2).request("PUT", f"/{B}")[0] == 200
        bodies = {f"n{i}": os.urandom(200_000 + i) for i in range(4)}
        for i, (k, v) in enumerate(bodies.items()):
            assert c.client(i).request("PUT", f"/{B}/{k}", body=v)[0] == 200
        for i in range(4):
            for k, v in bodies.items():
                st, _, got = c.client((i + 1) % 4).request("GET",
                                                           f"/{B}/{k}")
                assert st == 200 and got == v
        st, _, listing = c.client(0).request("GET", f"/{B}")
        assert all(f"<Key>{k}</Key>".encode() in listing for k in bodies)
        # Every node holds 4 of each object's 16 shards.
        for i in range(4):
            assert sum(os.path.isdir(os.path.join(c.drive_dir(i, d), B,
                                                  "n0"))
                       for d in range(4)) == 4


def test_workers_topology(tmp_path):
    """2 nodes x 2 drives x 2 workers: worker 0 owns each node's grid
    plane, its sibling votes over loopback; cross-node reads survive a
    sibling's and the grid owner's SIGKILL and respawn."""
    with TorchCluster(tmp_path, nodes=2, drives_per_node=2,
                      workers=2) as c:
        for i in range(2):
            deadline = time.time() + 60
            while len(c.worker_pids(i)) < 2:
                assert time.time() < deadline, c.logs(i)[-1500:]
                time.sleep(0.5)
        c0 = c.client(0)
        assert c0.request("PUT", "/wbkt")[0] == 200
        data = os.urandom(200 << 10)
        _put_retry(c0, "/wbkt/obj", data)
        for _ in range(4):               # both workers of node 1 answer
            st, _, got = c.client(1).request("GET", "/wbkt/obj")
            assert st == 200 and got == data
        st, _, body = c.client(1).request("GET", "/wbkt")
        assert st == 200 and b"<Key>obj</Key>" in body
        assert "grid mesh on" in c.logs(0)
        kids = c.worker_pids(0)
        os.kill(kids[1], 9)
        deadline = time.time() + 60
        while len(c.worker_pids(0)) < 2 or kids[1] in c.worker_pids(0):
            assert time.time() < deadline, "sibling worker not respawned"
            time.sleep(0.5)
        _get_retry(c0, "/wbkt/obj", data)
        kids = c.worker_pids(1)
        os.kill(kids[0], 9)
        deadline = time.time() + 60
        while len(c.worker_pids(1)) < 2 or kids[0] in c.worker_pids(1):
            assert time.time() < deadline, "worker 0 not respawned"
            time.sleep(0.5)
        _get_retry(c0, "/wbkt/obj", data)
        _get_retry(c.client(1), "/wbkt/obj", data)
        _put_retry(c.client(1), "/wbkt/obj2", data[:1000])
        _get_retry(c0, "/wbkt/obj2", data[:1000])


def _refused(tmp_path, cmd_of):
    """Boot one node whose only peer answers node.info with another
    deployment id (a port grid server serving the peer's two drives);
    the node's exit code and output."""
    p0, p1 = free_ports(2)
    roots = [str(tmp_path / f"peer{j}") for j in range(2)]
    peer = GridServer(p1 + GRID_OFFSET, host="127.0.0.1")
    StorageRPCService({r: LocalStorage(r) for r in roots}) \
        .register_into(peer)
    peer.register("node.info", lambda p: {"deployment_id": "other-one"})
    peer.start()
    eps = [f"http://127.0.0.1:{p0}{tmp_path}/own{j}" for j in range(2)] + \
        [f"http://127.0.0.1:{p1}{r}" for r in roots]
    try:
        r = subprocess.run(cmd_of(f"127.0.0.1:{p0}") + eps,
                           env=dict(os.environ, PYTHONPATH=REPO_ROOT,
                                    JAX_PLATFORMS="cpu",
                                    MTPU_HTTP_WORKERS="1"),
                           cwd=REPO_ROOT, capture_output=True, text=True,
                           timeout=120)
    finally:
        peer.stop()
    return r.returncode, r.stdout + r.stderr


def test_peer_of_another_deployment_is_refused(tmp_path):
    port_rc, port_out = _refused(tmp_path / "port", lambda a: [
        sys.executable, "-m", "minio_tpu_torch.server", "--address", a,
        "--device", "cpu", "--scanner-interval", "0", "--boot-timeout",
        "20"])
    ref_rc, ref_out = _refused(tmp_path / "ref", lambda a: [
        sys.executable, "-m", "minio_tpu.server", "--address", a,
        "--ec-backend", "host", "--scanner-interval", "0",
        "--boot-timeout", "20"])
    assert ref_rc == port_rc == 1, (ref_out[-1500:], port_out[-1500:])
    for out in (port_out, ref_out):
        assert "FATAL" in out and "other-one" in out, out[-1500:]
        assert "serving S3" not in out

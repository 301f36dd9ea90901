"""Port nodes under node-level chaos (tests/torch_cluster.py).

The port's counterparts of tests/test_cluster.py's chaos cases: a
partitioned node that rejoins never serves a stale read (its caches
serve behind the cross-node coherence gate, which the partition shuts
and only a resync after the rejoin reopens), and a holder's dsync write
lock leaked by its SIGKILL frees itself within the lock TTL.
"""

import os
import threading
import time

from tests.torch_cluster import TorchCluster


def _put_retry(cli, path, body, deadline_s=45):
    deadline = time.time() + deadline_s
    while True:
        try:
            st, _, b = cli.request("PUT", path, body=body)
        except Exception as e:  # noqa: BLE001 - conn reset mid-failover
            st, b = 0, str(e).encode()
        if st == 200:
            return
        assert time.time() < deadline, f"PUT {path}: {st} {b[:300]}"
        time.sleep(1)


def test_partition_rejoin_no_stale_reads(tmp_path):
    """Partition a node's grid plane, overwrite through the healthy
    side, rejoin: the rejoined node never answers the old bytes, and
    sees the keys written during the partition."""
    with TorchCluster(tmp_path, nodes=3, drives_per_node=2) as cluster:
        c0 = cluster.client(0)
        c2 = cluster.client(2)
        assert c0.request("PUT", "/pbkt")[0] == 200
        v1 = os.urandom(200 << 10)
        _put_retry(c0, "/pbkt/obj", v1)
        for _ in range(2):          # a repeat GET would be a cache hit
            st, _, got = c2.request("GET", "/pbkt/obj")
            assert st == 200 and got == v1
        assert c2.request("GET", "/pbkt")[0] == 200

        cluster.partition(2)
        time.sleep(1.0)
        v2 = os.urandom(200 << 10)
        _put_retry(c0, "/pbkt/obj", v2)          # 4 of 6 drives: quorum
        _put_retry(c0, "/pbkt/during", b"y" * 4096)
        st, _, got = c2.request("GET", "/pbkt/obj")
        assert not (st == 200 and got == v1), "stale read served"

        cluster.rejoin(2)
        deadline = time.time() + 45
        while True:
            st, _, got = c2.request("GET", "/pbkt/obj")
            if st == 200 and got == v2:
                break
            assert not (st == 200 and got == v1), "stale read after rejoin"
            assert time.time() < deadline, f"rejoin GET: {st}"
            time.sleep(1)
        deadline = time.time() + 30
        while True:
            st, _, body = c2.request("GET", "/pbkt")
            if st == 200 and b"during" in body:
                break
            assert time.time() < deadline, f"listing stale: {st}"
            time.sleep(1)


def test_dsync_lock_expires_after_holder_sigkill(tmp_path):
    """A node SIGKILLed mid-PUT leaks its dsync write lock on the other
    lock servers; a writer of the same key proceeds within the TTL."""
    with TorchCluster(tmp_path, nodes=3, drives_per_node=2,
                      env={"MTPU_GRID_LOCK_TTL": "4"}) as cluster:
        c0 = cluster.client(0)
        assert c0.request("PUT", "/lbkt")[0] == 200
        _put_retry(c0, "/lbkt/obj", b"seed" * 1024)
        # Node 2's PUT hangs on the other nodes' slow drives, holding
        # the write lock; its SIGKILL leaks it.
        cluster.hang_drives(0, 6.0)
        cluster.hang_drives(1, 6.0)
        time.sleep(0.2)

        def doomed():
            try:
                cluster.client(2, timeout=30).request(
                    "PUT", "/lbkt/obj", body=os.urandom(256 << 10))
            except Exception:  # noqa: BLE001 - the node dies mid-request
                pass
        t = threading.Thread(target=doomed, daemon=True)
        t.start()
        time.sleep(1.5)
        cluster.kill(2)
        cluster.rejoin(0)
        cluster.rejoin(1)
        t0 = time.time()
        _put_retry(c0, "/lbkt/obj", b"after" * 1024, deadline_s=40)
        waited = time.time() - t0
        assert waited < 30, f"writer waited {waited:.1f}s past the leak"
        st, _, got = cluster.client(1).request("GET", "/lbkt/obj")
        assert st == 200 and got == b"after" * 1024

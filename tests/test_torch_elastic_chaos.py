"""Port nodes under chaos during a migration (tests/torch_cluster.py):
the counterparts of tests/test_elastic.py's
test_cluster_sigkill_coordinator_rebalance_resumes and
test_cluster_partition_during_decommission_converges. They carry the
`slow` mark because their JAX originals do.

A rebalance's coordinator is SIGKILLed mid-walk: its lease lapses after
MTPU_GRID_LOCK_TTL and a survivor's janitor resumes the walk to
"complete", every key read back byte for byte and listed once. A node
partitioned during a decommission: the walk goes on over the remaining
quorum (a key it cannot move fails and a second start retries it),
completes, and after the rejoin every key reads back through every node,
the rejoined one included. Tolerance: none.
"""

import json
import os
import time

import pytest

from tests.torch_cluster import (TorchCluster, admin, disk_holds,
                                 put_retry, wait_status)


@pytest.mark.slow
def test_cluster_sigkill_coordinator_rebalance_resumes(tmp_path):
    env = {"MTPU_GRID_LOCK_TTL": "4", "MTPU_ELASTIC_JANITOR_S": "1",
           "MTPU_MIG_BATCH": "1"}
    bodies = {f"k{i:03d}": os.urandom(6_000 + i) for i in range(48)}
    with TorchCluster(tmp_path, nodes=4, pools=[2, 2], env=env) as c:
        c0, c1 = c.client(0), c.client(1)
        assert c0.request("PUT", "/rbkt")[0] == 200
        for k, b in bodies.items():
            put_retry(c0, f"/rbkt/{k}", b)
        st, b = admin(c0, "rebalance-start", "POST")
        assert st == 200, b
        deadline = time.time() + 60
        moved = 0
        doc = None
        while time.time() < deadline:
            st, body = admin(c0, "rebalance-status")
            doc = json.loads(body) if st == 200 and body else None
            moved = sum(r.get("migrated", 0)
                        for r in (doc or {}).get("pools", {}).values())
            if moved >= 2:
                break
            time.sleep(0.2)
        assert moved >= 2, f"the rebalance made no progress: {doc}"
        c.kill(0)
        doc = wait_status(c1, "rebalance-status", ("complete",), 120)
        recs = doc.get("pools", {})
        assert sum(r.get("failed", 0) for r in recs.values()) == 0, doc
        assert sum(r.get("migrated", 0) for r in recs.values()) >= 2
        for k, b in bodies.items():
            st, _, got = c1.request("GET", f"/rbkt/{k}")
            assert st == 200 and got == b, f"{k}: lost or torn"
        st, _, lst = c1.request("GET", "/rbkt", query={"max-keys": "1000"})
        assert st == 200
        for k in bodies:
            assert lst.count(f"<Key>{k}</Key>".encode()) == 1, k


@pytest.mark.slow
def test_cluster_partition_during_decommission_converges(tmp_path):
    env = {"MTPU_MIG_BATCH": "1"}
    bodies = {f"p{i:03d}": os.urandom(5_000) for i in range(24)}
    with TorchCluster(tmp_path, nodes=4, pools=[2, 2], env=env) as c:
        c0, c2 = c.client(0), c.client(2)
        assert c0.request("PUT", "/pbkt")[0] == 200
        for k, b in bodies.items():
            put_retry(c0, f"/pbkt/{k}", b)
        holder = 0 if any(disk_holds(c, n, 0, "p000")
                          for n in range(4)) else 1
        st, b = admin(c0, "decommission", "POST", {"pool": str(holder)})
        assert st == 200, b
        deadline = time.time() + 60
        doc = None
        while time.time() < deadline:
            st, body = admin(c0, "decommission-status")
            doc = json.loads(body) if st == 200 and body else None
            if doc and doc.get("migrated", 0) >= 2:
                break
            time.sleep(0.2)
        assert doc and doc.get("migrated", 0) >= 2, doc
        c.partition(1)
        try:
            doc = wait_status(c0, "decommission-status",
                              ("complete", "failed"), 120)
        finally:
            c.rejoin(1)
        if doc.get("status") == "failed":
            # Keys below read quorum without node 1 failed their move:
            # a second start retries them once the partition healed.
            st, b = admin(c0, "decommission", "POST", {"pool": str(holder)})
            assert st == 200, b
            doc = wait_status(c0, "decommission-status", ("complete",), 120)
        assert doc["status"] == "complete", doc
        for k, b in bodies.items():
            st, _, got = c2.request("GET", f"/pbkt/{k}")
            assert st == 200 and got == b, f"{k}: lost or torn"
        c1 = c.client(1)
        deadline = time.time() + 30
        for k, b in bodies.items():
            while True:
                st, _, got = c1.request("GET", f"/pbkt/{k}")
                if st == 200 and got == b:
                    break
                assert time.time() < deadline, f"{k} through node 1"
                time.sleep(0.5)

"""A decommission on four port nodes survives the SIGKILL of its
coordinator (tests/torch_cluster.py).

The drain, started through node 1, walks batches of one key a node
(MTPU_MIG_BATCH=1) sharded over the four nodes; node 1 is SIGKILLed
once 8 of its 64 keys moved. Its coordinator lease lapses after
MTPU_GRID_LOCK_TTL (4 s here) and a surviving node's elastic janitor
(every MTPU_ELASTIC_JANITOR_S, 1 s here) wins it and resumes the walk
from the checkpoint: the drain ends "complete" with nothing failed,
every key reads back byte for byte through every survivor and lists
once, and the drained pool's drives hold none of them. The JAX
package's counterpart SIGKILLs a rebalance's coordinator
(tests/test_elastic.py, slow; its port is in
tests/test_torch_elastic_chaos.py). Tolerance: none.
"""

import os
import time

from tests.torch_cluster import (TorchCluster, admin, disk_holds,
                                 put_retry, status_doc, wait_status)


def test_cluster_sigkill_coordinator_decommission_resumes(tmp_path):
    env = {"MTPU_GRID_LOCK_TTL": "4", "MTPU_ELASTIC_JANITOR_S": "1",
           "MTPU_MIG_BATCH": "1"}
    bodies = {f"k{i:03d}": os.urandom(3_000 + i) for i in range(64)}
    with TorchCluster(tmp_path, nodes=4, pools=[2, 2], env=env) as c:
        c0, c1 = c.client(0), c.client(1)
        assert c0.request("PUT", "/dbkt")[0] == 200
        for k, b in bodies.items():
            put_retry(c0, f"/dbkt/{k}", b)
        holder = 0 if any(disk_holds(c, n, 0, "k000")
                          for n in range(4)) else 1
        st, b = admin(c1, "decommission", "POST", {"pool": str(holder)})
        assert st == 200, b
        deadline = time.time() + 60
        doc = None
        while time.time() < deadline:
            doc = status_doc(c1, "decommission-status")
            if doc and doc.get("migrated", 0) >= 8:
                break
            time.sleep(0.1)
        assert doc and doc["status"] == "draining", doc
        assert doc["migrated"] < len(bodies), doc
        c.kill(1)
        survivors = [c.client(i) for i in (0, 2, 3)]
        doc = wait_status(survivors[1], "decommission-status",
                          ("complete", "failed"), 120)
        assert doc["status"] == "complete" and doc["failed"] == 0, doc
        for cli in survivors:
            for k, b in bodies.items():
                st, _, got = cli.request("GET", f"/dbkt/{k}")
                assert st == 200 and got == b, f"{k}: lost or torn"
        st, _, lst = survivors[2].request("GET", "/dbkt",
                                          query={"max-keys": "1000"})
        assert st == 200
        for k in bodies:
            assert lst.count(f"<Key>{k}</Key>".encode()) == 1, k
        assert not any(disk_holds(c, n, holder, k)
                       for n in (0, 2, 3) for k in bodies)

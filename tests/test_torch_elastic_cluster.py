"""Port nodes with their caches on through a decommission
(tests/torch_cluster.py), the counterpart of tests/test_elastic.py's
test_cluster_migrated_key_never_served_from_stale_cache.

Nodes 1 and 2 warm their fileinfo, hot and listing caches against the
source copy of a key; a decommission of its pool, started through node
0 and polled through node 1 (any node answers), moves it. The bump of
migrate_key reaches every node (acked) before the source copy goes, so
the warm nodes serve the migrated bytes, never a 404 or the removed
copy, list the key once, and the drained pool's drives no longer hold
it. Tolerance: none.
"""

import os

from tests.torch_cluster import (TorchCluster, admin, disk_holds,
                                 put_retry, wait_status)


def test_cluster_migrated_key_never_served_from_stale_cache(tmp_path):
    body = os.urandom(64 * 1024)
    with TorchCluster(tmp_path, nodes=3, pools=[2, 2]) as c:
        c0, c1, c2 = c.client(0), c.client(1), c.client(2)
        assert c0.request("PUT", "/ebkt")[0] == 200
        put_retry(c0, "/ebkt/mig", body)
        holder = 0 if any(disk_holds(c, n, 0, "mig")
                          for n in range(3)) else 1
        for cli in (c1, c2):
            for _ in range(2):          # the second a cache hit
                st, _, got = cli.request("GET", "/ebkt/mig")
                assert st == 200 and got == body
            assert cli.request("HEAD", "/ebkt/mig")[0] == 200
            assert cli.request("GET", "/ebkt")[0] == 200
        st, b = admin(c0, "decommission", "POST", {"pool": str(holder)})
        assert st == 200, b
        doc = wait_status(c1, "decommission-status", ("complete",), 90)
        assert doc["failed"] == 0 and doc["migrated"] == 1, doc
        for cli in (c1, c2):
            st, _, got = cli.request("GET", "/ebkt/mig")
            assert st == 200, "a cache served the migrated-away copy"
            assert got == body
            assert cli.request("HEAD", "/ebkt/mig")[0] == 200
        st, _, lst = c2.request("GET", "/ebkt")
        assert st == 200 and lst.count(b"<Key>mig</Key>") == 1
        assert not any(disk_holds(c, n, holder, "mig") for n in range(3))
        # Every node answers the status, and a stop reaches them all.
        for cli in (c0, c2):
            assert wait_status(cli, "decommission-status", ("complete",),
                               10)["migrated"] == 1
        assert admin(c2, "decommission-cancel", "POST")[0] == 200

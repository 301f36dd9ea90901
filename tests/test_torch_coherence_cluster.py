"""Port nodes of two workers each serving with their caches on
(tests/torch_cluster.py): the cross-node coherence in the N x M
topology, beside tests/test_cluster.py's chaos cases.

Every node's worker 0 arms its peer (`GET /minio/admin/v3/info`) and its
sibling's gate (FileGate over worker 0's published verdict) opens;
overwrites through either node (a sibling worker's bump is relayed to
its worker 0 over loopback) read back through both workers of the other
with 0 stale bodies, while the fileinfo and hot caches there serve
hits; with a node
SIGKILLed the survivor's gates shut, and after its restart both re-arm
through a resync and still serve 0 stale. Tolerance: none.
"""

import json
import os
import time

from tests.torch_cluster import TorchCluster, put_retry


def _info(cli) -> dict:
    st, _, body = cli.request("GET", "/minio/admin/v3/info")
    assert st == 200, body
    return json.loads(body)


def _poll_workers(cli, n: int = 24) -> dict:
    """pid -> the latest info from each worker that answered (fresh
    connections spread over the node's workers)."""
    out = {}
    for _ in range(n):
        doc = _info(cli)
        out[doc["pid"]] = doc
    return out


def _wait_armed(cli, peers: int, timeout: float = 60) -> dict:
    """Until worker 0 reports every peer armed and a sibling its gate
    open; worker 0's info."""
    deadline = time.time() + timeout
    w0 = sib = None
    while time.time() < deadline:
        for doc in _poll_workers(cli, 8).values():
            coh = doc["coherence"]
            if doc["worker"] == "0" and coh.get("armed") == peers:
                w0 = doc
            if doc["worker"] != "0" and coh.get("gate") is True:
                sib = doc
        if w0 is not None and sib is not None:
            return w0
        time.sleep(0.3)
    raise AssertionError(f"not armed: worker 0 {w0}, sibling {sib}")


def test_two_workers_a_node_serve_coherent_caches(tmp_path):
    with TorchCluster(tmp_path, nodes=2, drives_per_node=2, workers=2,
                      env={"MTPU_FILEINFO_CACHE": "on",
                           "MTPU_HOT_CACHE": "on"}) as c:
        c0, c1 = c.client(0), c.client(1)
        for cli in (c0, c1):
            _wait_armed(cli, 1)
        assert c0.request("PUT", "/cbkt")[0] == 200
        stale = 0
        for r in range(6):
            body = os.urandom(20_000 + r)
            writer, reader = (c0, c1) if r % 2 == 0 else (c1, c0)
            put_retry(writer, "/cbkt/obj", body)
            for _ in range(8):          # both workers, repeat reads
                st, _, got = reader.request("GET", "/cbkt/obj")
                assert st == 200
                stale += got != body
        assert stale == 0
        hits = {"fi": 0, "hot": 0}
        workers = set()
        for doc in _poll_workers(c1).values():
            workers.add(doc["worker"])
            hits["fi"] += doc["fi_cache"]["hits"] + \
                doc["fi_cache"]["stat_hits"]
            hits["hot"] += doc["hot_cache"]["hits"]
        assert workers == {"0", "1"}
        assert hits["fi"] + hits["hot"] > 0, hits
        # A node down: the survivor's gates shut at once (lost
        # connection), in worker 0 and in its sibling.
        c.kill(1)
        deadline = time.time() + 20
        while True:
            docs = _poll_workers(c0, 8).values()
            shut = [d for d in docs
                    if not d["coherence"].get("coherent",
                                              d["coherence"].get("gate"))]
            if len(shut) == len(docs) and {d["worker"] for d in docs} \
                    == {"0", "1"}:
                break
            assert time.time() < deadline, list(docs)
            time.sleep(0.3)
        c.restart(1)
        w0 = _wait_armed(c0, 1)
        assert w0["coherence"]["resyncs"] >= 2
        body = os.urandom(30_000)
        put_retry(c0, "/cbkt/obj", body)
        for _ in range(8):
            st, _, got = c.client(1).request("GET", "/cbkt/obj")
            assert st == 200 and got == body

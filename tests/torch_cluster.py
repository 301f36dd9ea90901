"""The cluster harness of tests/cluster.py, booting the port's server.

`TorchCluster(Cluster)` spawns `python -m minio_tpu_torch.server
--device cpu` nodes on loopback with the same endpoints, drives, chaos
files and logs as the JAX package's Cluster, so one test drives both
packages through the same steps.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from tests.cluster import REPO_ROOT, Cluster


class TorchCluster(Cluster):
    """N port server processes sharing one erasure layout on loopback."""

    def spawn(self, i: int) -> None:
        self._gen[i] += 1
        env = dict(os.environ,
                   PYTHONPATH=REPO_ROOT,
                   MTPU_GRID_CHAOS=self.chaos_path(i),
                   # tests/cluster.py's test-scale re-arm and breaker.
                   MTPU_GRID_SYNC_S="0.5",
                   MTPU_GRID_COOLDOWN="0.25",
                   **self.env)
        cmd = [sys.executable, "-m", "minio_tpu_torch.server",
               "--address", self.address(i), "--device", "cpu",
               *self.extra, *(self.pool_args or self.endpoints)]
        log = open(self.log_path(i), "wb")
        self.procs[i] = subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT, env=env,
                                         cwd=REPO_ROOT,
                                         start_new_session=True)


# -- helpers of the port's elastic cluster cases (tests/test_elastic.py's)

def put_retry(cli, path: str, body: bytes, deadline_s: float = 45) -> None:
    """PUT until 200 (a node mid-failover answers 503 or resets)."""
    deadline = time.time() + deadline_s
    while True:
        try:
            st, _, b = cli.request("PUT", path, body=body)
        except Exception as e:  # noqa: BLE001 - conn reset mid-failover
            st, b = 0, str(e).encode()
        if st == 200:
            return
        assert time.time() < deadline, f"PUT {path}: {st} {b[:300]}"
        time.sleep(0.5)


def admin(cli, verb: str, method: str = "GET", query=None):
    st, _, body = cli.request(method, f"/minio/admin/v3/{verb}",
                              query=query or {})
    return st, body


def status_doc(cli, verb: str):
    """A status verb's JSON, or None (empty body, error, node down)."""
    try:
        st, body = admin(cli, verb)
    except Exception:  # noqa: BLE001 - node mid-failover
        return None
    if st != 200 or not body or body == b"null":
        return None
    return json.loads(body)


def wait_status(cli, verb: str, want, deadline_s: float) -> dict:
    """Poll a status verb until its "status" is one of `want`."""
    deadline = time.time() + deadline_s
    doc = None
    while time.time() < deadline:
        doc = status_doc(cli, verb)
        if doc and doc.get("status") in want:
            return doc
        time.sleep(0.5)
    raise AssertionError(f"{verb} never reached {want}: {doc}")


def disk_holds(cluster, node: int, pool: int, key: str) -> bool:
    """Whether a drive of (node, pool) holds the key's journal."""
    for d in range(64):
        p = os.path.join(cluster.root, f"n{node}", f"p{pool}d{d}")
        if not os.path.isdir(p):
            return False
        for dirpath, _dirs, files in os.walk(p):
            if key in dirpath.split(os.sep) and "xl.meta" in files:
                return True
    return False

"""The cluster harness of tests/cluster.py, booting the port's server.

`TorchCluster(Cluster)` spawns `python -m minio_tpu_torch.server
--device cpu` nodes on loopback with the same endpoints, drives, chaos
files and logs as the JAX package's Cluster, so one test drives both
packages through the same steps.
"""

from __future__ import annotations

import os
import subprocess
import sys

from tests.cluster import REPO_ROOT, Cluster


class TorchCluster(Cluster):
    """N port server processes sharing one erasure layout on loopback."""

    def spawn(self, i: int) -> None:
        self._gen[i] += 1
        env = dict(os.environ,
                   PYTHONPATH=REPO_ROOT,
                   MTPU_GRID_CHAOS=self.chaos_path(i),
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

"""Admin profiling: start/stop CPU profiles, bundle results.

The port of minio_tpu/s3/profiling.py (the reference's
StartProfilingHandler / DownloadProfilingDataHandler,
cmd/admin-handlers.go:1021): an admin starts a profile, load runs, and
the download returns a zip of per-node profile data: the marshaled
stats (loadable with pstats.Stats) and a rendered text summary a node.

On Python 3.12 cProfile is one process-wide sys.monitoring tool, not a
per-thread hook: the profile enabled by start() sees every thread of
the process (request handlers, drive workers, the kernel lane), and a
second Profile cannot be enabled beside it ("Another profiling tool is
already active"). So the capture here is that one profile, from start
to stop; there are no per-request captures (the JAX package's
`request_profile` enables a second Profile inside the running one and
raises on 3.12), and the server's dispatch wraps nothing.

In distributed mode the start/stop fan out over the grid
(PROFILE_HANDLER) so the bundle covers every peer, the way the
reference's NotificationSys collects remote profiles.
"""

from __future__ import annotations

import base64
import cProfile
import io
import marshal
import pstats
import threading
import time
import zipfile

PROFILE_HANDLER = "peer.profile"


class ProfileError(Exception):
    pass


class Profiler:
    """One node's profile capture (CPU, cProfile, every thread)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._prof: cProfile.Profile | None = None
        self._started_ns = 0

    def start(self) -> None:
        with self._mu:
            if self._prof is not None:
                raise ProfileError("a profile is already running")
            prof = cProfile.Profile()
            try:
                prof.enable()
            except ValueError as e:
                # Another tool holds the process's profiler slot.
                raise ProfileError(str(e)) from None
            self._prof = prof
            self._started_ns = time.time_ns()

    def stop(self) -> dict:
        """Stop and return {"stats": marshaled pstats bytes,
        "text": rendered summary, "duration_s": float}."""
        with self._mu:
            if self._prof is None:
                raise ProfileError("no profile is running")
            prof, self._prof = self._prof, None
        prof.disable()
        stats = pstats.Stats(prof)
        out = io.StringIO()
        stats.stream = out
        stats.sort_stats("cumulative").print_stats(60)
        return {
            "stats": marshal.dumps(stats.stats),
            "text": out.getvalue(),
            "duration_s": (time.time_ns() - self._started_ns) / 1e9,
        }

    @property
    def running(self) -> bool:
        with self._mu:
            return self._prof is not None


def bundle(per_node: dict[str, dict]) -> bytes:
    """zip bytes: <node>/profile.pstats + <node>/profile.txt a node
    (the shape of the reference's profiling zip download)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for node, rec in per_node.items():
            z.writestr(f"{node}/profile.pstats", rec.get("stats", b""))
            z.writestr(f"{node}/profile.txt", rec.get("text", ""))
    return buf.getvalue()


def make_profile_handler(profiler: Profiler):
    """Grid handler: peers start/stop their local profiler on request
    (the receiving half of the cluster-wide fan-out)."""

    def handler(payload):
        action = (payload or {}).get("action", "")
        if action == "start":
            try:
                profiler.start()
            except ProfileError:
                pass                      # already running: converged
            return {"ok": True}
        if action == "stop":
            try:
                rec = profiler.stop()
            except ProfileError:
                return {"ok": False}
            return {"ok": True, "text": rec["text"],
                    "duration_s": rec["duration_s"],
                    "stats_b64": base64.b64encode(rec["stats"]).decode()}
        return {"ok": False}

    return handler

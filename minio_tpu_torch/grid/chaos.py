"""Grid chaos injection for the cluster harness.

The port of minio_tpu/grid/chaos.py. A node process started with
`MTPU_GRID_CHAOS=<path>` reads that JSON file before every grid frame it
sends or accepts, so a test (tests/torch_cluster.py) can partition,
delay or hang a LIVE node from outside the process:

    {"mode": "blackhole"}            every grid connect, send and
                                     accept fails: a hard partition
    {"mode": "drop"}                 inbound request frames vanish:
                                     callers time out
    {"mode": "delay", "seconds": s}  every frame pays `s` seconds
    {"drive_delay": s}               storage RPC handlers sleep `s`
                                     first: a hung remote drive

Modes compose with drive_delay in one file. The file is stat()ed at most
every 50 ms; a process without the variable pays one module-global
check.
"""

from __future__ import annotations

import json
import os
import time

ENV = "MTPU_GRID_CHAOS"

_PATH = os.environ.get(ENV) or None
_POLL_S = 0.05
_mtime: float = -1.0
_polled_at: float = 0.0
_cfg: dict = {}


class ChaosInjected(Exception):
    """Raised on blackholed operations (mapped to GridError upstream)."""


def _load() -> dict:
    global _mtime, _polled_at, _cfg
    now = time.monotonic()
    if now - _polled_at < _POLL_S:
        return _cfg
    _polled_at = now
    try:
        mtime = os.stat(_PATH).st_mtime_ns
    except OSError:
        _mtime, _cfg = -1.0, {}
        return _cfg
    if mtime == _mtime:
        return _cfg
    _mtime = mtime
    try:
        with open(_PATH, encoding="utf-8") as fh:
            loaded = json.load(fh)
        _cfg = loaded if isinstance(loaded, dict) else {}
    except (OSError, ValueError):
        _cfg = {}
    return _cfg


def net(point: str) -> None:
    """Gate one network step. `point` is "connect", "send" or "recv";
    blackhole raises at every point, delay sleeps at send/recv."""
    if _PATH is None:
        return
    cfg = _load()
    mode = cfg.get("mode")
    if mode == "blackhole":
        raise ChaosInjected(f"grid chaos blackhole ({point})")
    if mode == "delay" and point != "connect":
        try:
            time.sleep(float(cfg.get("seconds", 0.05)))
        except (TypeError, ValueError):
            pass


def drop_inbound() -> bool:
    """True when an inbound request frame should vanish silently
    (callers time out instead of seeing a connection error)."""
    if _PATH is None:
        return False
    return _load().get("mode") == "drop"


def drive_delay() -> float:
    """Seconds every storage RPC handler should hang before running."""
    if _PATH is None:
        return 0.0
    try:
        return float(_load().get("drive_delay", 0.0) or 0.0)
    except (TypeError, ValueError):
        return 0.0


def _reset_for_tests() -> None:
    """Re-read the env var (tests monkeypatch it after import)."""
    global _PATH, _mtime, _polled_at, _cfg
    _PATH = os.environ.get(ENV) or None
    _mtime, _polled_at, _cfg = -1.0, 0.0, {}

"""Programmable fault injection for storage drives.

The port's copy of minio_tpu/storage/naughty.py (reference naughtyDisk,
cmd/naughty-disk_test.go:33), for the tests and chip_smoke.py: wraps any
drive with the storage API and fails calls on a programmed schedule, so
quorum paths and the health wrapper's breaker meet DETERMINISTIC failure
sequences instead of killed processes.

Schedules:
  * per-call-number: {3: OSError("boom")} fails the 3rd call (1-based,
    counted across all ops) and passes others through;
  * per-op: fail_ops={"create_file": OSError(...)} fails every call of
    that op;
  * default_err: if set, ANY call not matched above raises it (the
    reference's odd "default error" mode).
Counters are exposed for assertions; `calls` records (op, args) tuples.
"""

from __future__ import annotations

import threading
from typing import Optional


class NaughtyDisk:
    def __init__(self, disk, fail_calls: Optional[dict] = None,
                 fail_ops: Optional[dict] = None,
                 default_err: Optional[Exception] = None):
        self._disk = disk
        self.fail_calls = dict(fail_calls or {})
        self.fail_ops = dict(fail_ops or {})
        self.default_err = default_err
        self.call_count = 0
        self.calls: list = []
        self._mu = threading.Lock()

    @property
    def wrapped(self):
        return self._disk

    @property
    def endpoint(self):
        return getattr(self._disk, "endpoint", "naughty")

    @property
    def root(self):
        return getattr(self._disk, "root", None)

    def _maybe_fail(self, op: str, args) -> None:
        with self._mu:
            self.call_count += 1
            n = self.call_count
            self.calls.append((op, args))
            err = self.fail_calls.get(n)
        if err is not None:
            raise err
        err = self.fail_ops.get(op)
        if err is not None:
            raise err
        if self.default_err is not None:
            raise self.default_err

    def __getattr__(self, name: str):
        attr = getattr(self._disk, name)
        if not callable(attr):
            return attr

        def wrapped(*args, **kwargs):
            self._maybe_fail(name, args)
            return attr(*args, **kwargs)
        return wrapped

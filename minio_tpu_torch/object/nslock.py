"""Namespace locking: per-(bucket, object) reader/writer locks.

The port of minio_tpu/object/nslock.py (reference nsLockMap,
cmd/namespace-lock.go:157-231): every mutating object operation (PUT,
copy, multipart complete, delete, heal) takes the write lock of its key,
and a GET takes the read lock and holds it until its stream is drained
or closed, so an overwrite can never pull the data dirs out from under
a read in flight. Entries are refcounted and leave the map when the last
holder releases.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class LockTimeout(Exception):
    """The lock was not acquired within its deadline."""


class _RWLock:
    """Writer-preferring reader/writer lock with timeouts."""

    __slots__ = ("_cond", "_readers", "_writer", "_writers_waiting", "ref")

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self.ref = 0  # guarded by the owning map's mutex

    def acquire_read(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            # Readers queue behind waiting writers, so a stream of GETs
            # cannot starve a PUT.
            while self._writer or self._writers_waiting:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    return False
            self._readers += 1
            return True

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        return False
                self._writer = True
                return True
            finally:
                self._writers_waiting -= 1
                if not self._writer:
                    # A writer that gave up: readers it held back go on.
                    self._cond.notify_all()

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class NSLockMap:
    """Refcounted map of (volume, path) -> reader/writer lock."""

    DEFAULT_TIMEOUT = 60.0

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._locks: dict[tuple[str, str], _RWLock] = {}

    def _enter(self, key: tuple[str, str]) -> _RWLock:
        with self._mu:
            lk = self._locks.get(key)
            if lk is None:
                lk = self._locks[key] = _RWLock()
            lk.ref += 1
            return lk

    def _exit(self, key: tuple[str, str], lk: _RWLock) -> None:
        with self._mu:
            lk.ref -= 1
            if lk.ref == 0:
                self._locks.pop(key, None)

    @contextmanager
    def write(self, volume: str, path: str,
              timeout: float = DEFAULT_TIMEOUT):
        key = (volume, path)
        lk = self._enter(key)
        try:
            if not lk.acquire_write(timeout):
                raise LockTimeout(f"write lock {volume}/{path}")
            try:
                yield
            finally:
                lk.release_write()
        finally:
            self._exit(key, lk)

    @contextmanager
    def read(self, volume: str, path: str,
             timeout: float = DEFAULT_TIMEOUT):
        key = (volume, path)
        lk = self._enter(key)
        try:
            if not lk.acquire_read(timeout):
                raise LockTimeout(f"read lock {volume}/{path}")
            try:
                yield
            finally:
                lk.release_read()
        finally:
            self._exit(key, lk)

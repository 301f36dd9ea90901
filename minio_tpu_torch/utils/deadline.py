"""Per-request deadline budgets, propagated across fan-out threads.

A copy of minio_tpu/utils/deadline.py. A request gets one monotonic
budget; every layer below consumes from it, so a hung drive or a slow
device dispatch bounds the WHOLE request instead of stacking timeouts
per layer. The stripe batcher (ops/batcher.py) reads the calling
thread's deadline to cull members whose budget is spent before their
coalesced dispatch.

Python threads have no context inheritance, so propagation is explicit:
`current()` reads the calling thread's binding and fan-out helpers
re-`bind()` it inside their worker threads.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional


class DeadlineExceeded(Exception):
    """The request's deadline budget is exhausted.

    Deliberately NOT a storage error: the drive did nothing wrong, the
    REQUEST ran out of time (the S3 layer maps it to 408
    RequestTimeout)."""


class Deadline:
    """A fixed point in monotonic time the request must not outlive."""

    __slots__ = ("expires_at",)

    def __init__(self, seconds: float):
        self.expires_at = time.monotonic() + seconds

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self) -> None:
        if self.expired():
            raise DeadlineExceeded("request deadline exceeded")

    def clamp(self, timeout: Optional[float]) -> float:
        """Smaller of `timeout` and the remaining budget (never
        negative: a 0 timeout fails the wait immediately, which is the
        correct shape for an exhausted budget)."""
        rem = max(0.0, self.remaining())
        if timeout is None:
            return rem
        return min(timeout, rem)


_local = threading.local()


def current() -> Optional[Deadline]:
    return getattr(_local, "deadline", None)


@contextlib.contextmanager
def bind(dl: Optional[Deadline]):
    """Bind `dl` as the calling thread's deadline for the block.
    Binding None is a no-op passthrough (callers thread an optional
    deadline without branching)."""
    prev = getattr(_local, "deadline", None)
    _local.deadline = dl if dl is not None else prev
    try:
        yield dl
    finally:
        _local.deadline = prev


@contextlib.contextmanager
def shield():
    """Run a block with NO deadline bound (bind(None) is a passthrough,
    not an unbind): for cleanup work that must complete even though the
    request's own budget is spent."""
    prev = getattr(_local, "deadline", None)
    _local.deadline = None
    try:
        yield
    finally:
        _local.deadline = prev


def clamp(timeout: Optional[float]) -> Optional[float]:
    """Clamp `timeout` to the current thread's remaining budget;
    passthrough when no deadline is bound."""
    dl = current()
    if dl is None:
        return timeout
    return dl.clamp(timeout)


def check() -> None:
    """Raise DeadlineExceeded if the bound budget is exhausted."""
    dl = current()
    if dl is not None:
        dl.check()

"""The kernel lane: one serial queue that owns device dispatches.

The port of the accelerator lane of minio_tpu/io/engine.py (EngineSaturated,
DriveQueue, kernel_lane). The card is one shared resource, like a drive:
concurrent device dispatches (the stripe batchers of several routes and
EC configs) contend for it, and uncoordinated submission from many
request threads interleaves copies and launches. One process-wide
single-worker DriveQueue serialises every batched device dispatch and
keeps its wait (time parked behind the lane) and service (the dispatch
itself) times, so "is the card the wall" reads off the same stats a
drive queue gives.

The lane's worker calls into CUDA, so it must not be left running when
the interpreter exits: `shutdown_kernel_lane()` closes the lane and
joins its worker (ErasureSet.close() calls it); the next `kernel_lane()`
starts a fresh one.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time as _time_mod
from concurrent.futures import Future

from minio_tpu_torch.utils.latency import Histogram

IDLE_EXIT_S = 10.0


class EngineSaturated(Exception):
    """A queue is full, or closed, and sheds the submission."""


class DriveQueue:
    """One bounded submission queue + a fixed worker crew."""

    def __init__(self, name: str, workers: int, depth: int):
        self.name = name
        self.max_workers = max(1, workers)
        self.depth = max(1, depth)
        self._q: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._mu = threading.Lock()
        self._alive = 0
        self._threads: list[threading.Thread] = []
        self._closed = False
        self.in_flight = 0
        self.submitted_total = 0
        self.rejected_total = 0
        # Service time (the op itself) split from queue wait (time parked
        # behind the crew): the split that tells a convoyed queue from a
        # slow op.
        self.service_hist = Histogram()
        self.wait_hist = Histogram()

    def submit(self, fn) -> Future:
        """Queue `fn`; returns its Future, which carries `wait_s` (time
        queued) and `service_s` (time in fn) once resolved. A full or
        closed queue sheds immediately with EngineSaturated."""
        f: Future = Future()
        self._enqueue((f, fn, _time_mod.perf_counter()))
        return f

    def _enqueue(self, item) -> None:
        if self._closed:
            raise EngineSaturated(f"queue {self.name}: engine closed")
        if self._q.qsize() >= self.depth:
            with self._mu:
                self.rejected_total += 1
            raise EngineSaturated(
                f"queue {self.name}: submission queue full "
                f"({self.depth} deep)")
        self._q.put(item)
        spawn = None
        with self._mu:
            self.submitted_total += 1
            # Spawn a worker when the backlog outruns the live crew
            # (workers idle-exit; the crew regrows on demand).
            if not self._closed and self._alive < self.max_workers \
                    and (self._alive == 0 or not self._q.empty()):
                self._alive += 1
                spawn = threading.Thread(target=self._work, daemon=True,
                                         name=f"io-{self.name}")
                self._threads = [t for t in self._threads if t.is_alive()]
                self._threads.append(spawn)
        if spawn is not None:
            spawn.start()

    def _work(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=IDLE_EXIT_S)
            except queue_mod.Empty:
                with self._mu:
                    # Re-check under the lock: a submit landing between
                    # the timeout and here must not strand its item with
                    # a crew of zero.
                    if self._q.empty() or self._closed:
                        self._alive -= 1
                        return
                continue
            if item is None:
                with self._mu:
                    self._alive -= 1
                return
            f, fn, t_sub = item
            if not f.set_running_or_notify_cancel():
                continue
            with self._mu:
                self.in_flight += 1
            t0 = _time_mod.perf_counter()
            result = exc = None
            try:
                result = fn()
            except BaseException as e:  # noqa: BLE001 - ferried to caller
                exc = e
            t1 = _time_mod.perf_counter()
            with self._mu:
                self.in_flight -= 1
            self.service_hist.observe(t1 - t0)
            self.wait_hist.observe(t0 - t_sub)
            # This op's own split rides on its future, set before the
            # caller can wake, so callers can keep it per user of the queue.
            f.wait_s, f.service_s = t0 - t_sub, t1 - t0
            if exc is None:
                f.set_result(result)
            else:
                f.set_exception(exc)

    def close(self) -> None:
        """Refuse new submissions; workers finish what is queued (the
        close sentinels sit behind it) and exit."""
        with self._mu:
            self._closed = True
            alive = self._alive
        for _ in range(alive):
            self._q.put(None)

    def join(self, timeout: float | None = None) -> None:
        """Wait for the workers to exit (after close())."""
        with self._mu:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)

    def stats(self) -> dict:
        with self._mu:
            out = {
                "queued": self._q.qsize(),
                "in_flight": self.in_flight,
                "depth": self.depth,
                "workers": self._alive,
                "submitted_total": self.submitted_total,
                "rejected_total": self.rejected_total,
            }
        out["service_hist"] = self.service_hist.state()
        out["wait_hist"] = self.wait_hist.state()
        return out


# -- the accelerator lane -----------------------------------------------------

_kernel_lane: DriveQueue | None = None
_kernel_mu = threading.Lock()


def kernel_lane() -> DriveQueue:
    """The process-wide device-dispatch queue (1 worker, deep enough that
    coalesced bursts never shed: a shed dispatch would fail whole
    batches, unlike one drive op counted against quorum)."""
    global _kernel_lane
    lane = _kernel_lane
    if lane is None:
        with _kernel_mu:
            if _kernel_lane is None:
                _kernel_lane = DriveQueue("kernel", workers=1, depth=1024)
            lane = _kernel_lane
    return lane


def shutdown_kernel_lane(timeout: float | None = 60.0) -> None:
    """Close the lane, let it finish what is queued, and join its worker.
    A later kernel_lane() starts a fresh lane; a submission racing the
    close gets EngineSaturated (the batcher then dispatches directly)."""
    global _kernel_lane
    with _kernel_mu:
        lane, _kernel_lane = _kernel_lane, None
    if lane is not None:
        lane.close()
        lane.join(timeout)

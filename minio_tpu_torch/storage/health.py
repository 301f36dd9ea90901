"""Drive health wrapper: per-call deadlines and a circuit breaker.

The port of minio_tpu/storage/health.py (reference xlStorageDiskIDCheck,
cmd/xl-storage-disk-id-check.go): every storage call of a wrapped drive
runs on the wrapper's daemon pool under a deadline; consecutive faults of
the drive itself (deadlines missed, I/O errors) open a breaker that fails
calls at once while it is open, and a half-open probe readmits the drive
after a cooldown. A quorum fan-out over wrapped drives therefore stays
bounded when a drive hangs instead of dying.

Domain errors (a missing file, volume or version, a corrupt journal) are
the drive answering correctly and never count against it. A request's
own deadline (utils/deadline.py) clamps each call; an expiry inside that
clamp is the request's, not the drive's, unless the drive stays silent
for whole seconds several calls in a row.

A drive on another node (storage/remote.py) is wrapped like a local
one. Its grid transport faults arrive as StorageError and count against
it; its handler's errors arrive as the exception the owner raised, so a
missing file there is a domain error here as well.

Four things differ from the JAX package, all because of what the
port's callers do. A generator op's step pulls a batch of items, not
one. The pool grows when every worker is busy: a streamed PUT holds one
create_file a drive for its whole body, so a fixed pool of 8 would
stall 9 concurrent streamed PUTs on one another across drives. For the
same reason create_file's bulk deadline bounds the drive's own work,
not the body's arrival: it runs only while the drive holds a chunk,
from one pull of its chunk iterable to the next, so a slow client is
never a slow drive. And a call that outlives its deadline raises with
the still-running call attached as `pending` (a Future): a caller whose
buffers that call reads or fills keeps them from their pool until it
ends.

While tracing is armed (utils/tracing.ACTIVE) every call is one
`storage` span `disk.<op>` tagged with the drive: the per-drive
attribution layer of a request's span tree. It covers admission, the
pool's wait and the op; the trace scope is re-bound inside the pool's
worker, so a remote drive's grid call below it parents under it.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

from minio_tpu_torch.storage.local import (DiskAccessDenied, FaultyDisk,
                                           VolumeExists, VolumeNotEmpty,
                                           VolumeNotFound)
from minio_tpu_torch.storage.meta import (FileNotFoundErr, MetaError,
                                          VersionNotFoundErr)
from minio_tpu_torch.utils import deadline as deadline_mod
from minio_tpu_torch.utils import tracing
from minio_tpu_torch.utils.deadline import DeadlineExceeded

# Errors that mean "the drive answered correctly": never breaker fuel.
# The builtin FileNotFoundError is absent on purpose: LocalStorage turns
# every ordinary missing object into FileNotFoundErr, so a raw one means
# the drive root itself went away.
_DOMAIN_ERRORS = (FileNotFoundErr, VersionNotFoundErr, MetaError,
                  VolumeNotFound, VolumeExists, VolumeNotEmpty,
                  DiskAccessDenied, IsADirectoryError,
                  NotADirectoryError, ValueError, KeyError)

# Bulk transfers get the longer deadline; commit_group commits a whole
# coalesced batch (many journals and one WAL fdatasync) in one call.
_BULK_OPS = {"create_file", "read_file", "read_file_into", "rename_data",
             "commit_group"}
# Ops that return generators: each step goes through the deadline and
# the breaker, not only the (instant) creation of the generator.
_GENERATOR_OPS = {"walk_scan"}


class _Expired(Exception):
    """A drive call's deadline passed; `clamped` when the request's own
    deadline was the nearer one, `window` the time the call had."""

    def __init__(self, clamped: bool, window: float):
        super().__init__()
        self.clamped = clamped
        self.window = window


class _PullClock:
    """create_file's chunk iterable, timed from the drive's side: the
    clock runs while the drive holds a chunk (`since`, the moment it got
    it) and stops while the drive waits inside the source for the next
    one (`since` None). Once the call is abandoned the drive is handed
    no further chunk, so the caller's thread alone drains the source
    from then on."""

    def __init__(self, chunks):
        self._it = iter(chunks)
        self.cond = threading.Condition()
        self.since: "float | None" = time.monotonic()
        self.abandoned = False

    def __iter__(self):
        return self

    def __next__(self):
        with self.cond:
            if self.abandoned:
                raise FaultyDisk("create_file abandoned past its deadline")
            self.since = None
        try:
            return next(self._it)
        finally:
            with self.cond:
                self.since = time.monotonic()
                self.cond.notify_all()

    def wake(self, _fut=None) -> None:
        with self.cond:
            self.cond.notify_all()

    def wait(self, fut: Future, base: float, end: "float | None"):
        """fut's result, or _Expired once the drive has held one chunk
        (or its final flush) for `base` seconds, or holds one past the
        request's end `end` (monotonic)."""
        fut.add_done_callback(self.wake)
        with self.cond:
            while not fut.done():
                if self.since is None:
                    self.cond.wait()
                    continue
                stop = self.since + base
                clamped = end is not None and end < stop
                if clamped:
                    stop = end
                left = stop - time.monotonic()
                if left <= 0:
                    self.abandoned = True
                    raise _Expired(clamped, stop - self.since)
                self.cond.wait(left)
        return fut.result()


class _DaemonPool:
    """An executor of daemon threads (a call hung on a dead drive must
    not hold up the interpreter's exit), at least `workers` of them and
    one more whenever every one is busy."""

    def __init__(self, workers: int):
        self._q: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self._mu = threading.Lock()
        self._threads = 0
        self._busy = 0
        for _ in range(workers):
            self._spawn()

    def _spawn(self) -> None:
        self._threads += 1
        threading.Thread(target=self._work, daemon=True,
                         name="drive-call").start()

    def submit(self, fn, *args, **kwargs) -> Future:
        f: Future = Future()
        with self._mu:
            self._busy += 1
            if self._busy > self._threads:
                self._spawn()
        self._q.put((f, fn, args, kwargs))
        return f

    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            f, fn, args, kwargs = item
            try:
                if f.set_running_or_notify_cancel():
                    try:
                        f.set_result(fn(*args, **kwargs))
                    except BaseException as e:  # noqa: BLE001 - to caller
                        f.set_exception(e)
            finally:
                with self._mu:
                    self._busy -= 1

    def shutdown(self) -> None:
        with self._mu:
            n = self._threads
        for _ in range(n):
            self._q.put(None)


class DiskHealthWrapper:
    """Wraps a drive (anything with the storage API) with deadlines and a
    breaker.

    op_timeout / bulk_timeout: per-call deadlines in seconds.
    trip_after: consecutive faults that open the breaker.
    cooldown: seconds the breaker stays open before a half-open probe.
    """

    # A clamped expiry counts toward suspicion only when the drive had
    # at least this long to answer: 50 ms of silence proves nothing,
    # whole seconds of it trip_after times in a row do.
    _SUSPICION_WINDOW = 1.0

    def __init__(self, disk, op_timeout: float = 10.0,
                 bulk_timeout: float = 120.0, trip_after: int = 3,
                 cooldown: float = 5.0):
        self._disk = disk
        self._op_timeout = op_timeout
        self._bulk_timeout = bulk_timeout
        self._trip_after = trip_after
        self._cooldown = cooldown
        self._mu = threading.Lock()
        self._consecutive = 0
        self._open_since: float = 0.0     # 0 = closed
        self._half_open_probe = False
        # Consecutive clamped expiries with a window of at least
        # _SUSPICION_WINDOW: without them a request budget always
        # shorter than the op timeout would keep a dead drive online.
        self._clamped_streak = 0
        # op -> [count, errors, total seconds]
        self.op_stats: dict[str, list] = {}
        self._pool = _DaemonPool(workers=8)

    # -- introspection ---------------------------------------------------

    @property
    def endpoint(self):
        return getattr(self._disk, "endpoint", "")

    @property
    def root(self):
        return getattr(self._disk, "root", None)

    def is_online(self) -> bool:
        with self._mu:
            return self._open_since == 0.0

    def health_info(self) -> dict:
        with self._mu:
            return {
                "online": self._open_since == 0.0,
                "consecutive_faults": self._consecutive,
                "ops": {op: {"count": s[0], "errors": s[1],
                             "avg_ms": round(1000 * s[2] / s[0], 3)
                             if s[0] else 0.0}
                        for op, s in self.op_stats.items()},
            }

    # -- breaker ---------------------------------------------------------

    def _admit(self) -> None:
        """Fail fast while the breaker is open; let one probe through
        after the cooldown (half-open)."""
        with self._mu:
            if self._open_since == 0.0:
                return
            if time.monotonic() - self._open_since < self._cooldown:
                raise FaultyDisk(f"drive {self.endpoint}: breaker open")
            if self._half_open_probe:
                raise FaultyDisk(
                    f"drive {self.endpoint}: breaker half-open, probing")
            self._half_open_probe = True

    def _record(self, op: str, seconds: float, failed: bool) -> None:
        with self._mu:
            s = self.op_stats.setdefault(op, [0, 0, 0.0])
            s[0] += 1
            s[1] += 1 if failed else 0
            s[2] += seconds

    def _fault(self) -> None:
        with self._mu:
            self._consecutive += 1
            self._half_open_probe = False
            if self._open_since != 0.0:
                # A failed half-open probe restarts the cooldown, or
                # every request after it would probe and wait out the
                # full op timeout.
                self._open_since = time.monotonic()
            elif self._consecutive >= self._trip_after:
                self._open_since = time.monotonic()

    def _ok(self) -> None:
        with self._mu:
            self._consecutive = 0
            self._clamped_streak = 0
            self._open_since = 0.0
            self._half_open_probe = False

    def _clamped_expiry(self, window: float) -> None:
        """An expiry inside the request's clamp: frees the probe slot;
        trip_after of them in a row with generous windows open the
        breaker as a fault episode would."""
        with self._mu:
            self._half_open_probe = False
            if window < self._SUSPICION_WINDOW:
                return
            self._clamped_streak += 1
            if self._clamped_streak >= self._trip_after:
                self._clamped_streak = 0
                self._consecutive = max(self._consecutive + 1,
                                        self._trip_after)
                self._open_since = time.monotonic()

    def _probe_inconclusive(self) -> None:
        """A probe ended by the request's budget proved nothing: free the
        slot so the next caller can probe."""
        with self._mu:
            self._half_open_probe = False

    # -- call path -------------------------------------------------------

    def _call(self, op: str, fn, args, kwargs,
              clock: "_PullClock | None" = None):
        if tracing.ACTIVE:
            with tracing.span("storage", f"disk.{op}",
                              {"drive": str(self.endpoint or getattr(
                                  self._disk, "root", "") or "")}):
                return self._call_inner(op, fn, args, kwargs, clock)
        return self._call_inner(op, fn, args, kwargs, clock)

    def _call_inner(self, op: str, fn, args, kwargs,
                    clock: "_PullClock | None" = None):
        # An exhausted budget fails before _admit, so it cannot take the
        # half-open probe slot.
        dl = deadline_mod.current()
        if dl is not None and dl.expired():
            raise DeadlineExceeded(
                f"request deadline exceeded before {op} on {self.endpoint}")
        self._admit()
        base = self._bulk_timeout if op in _BULK_OPS else self._op_timeout
        t0 = time.monotonic()
        end = None if dl is None else t0 + dl.remaining()
        tctx, tparent = tracing.capture() if tracing.ACTIVE else (None, 0)
        if dl is None and tctx is None:
            fut: Future = self._pool.submit(fn, *args, **kwargs)
        else:
            # The budget and the trace scope are bound again inside the
            # worker, so the layers below it keep consuming the one and
            # parenting under the other.
            def run(_dl=dl, _tc=tctx, _tp=tparent):
                with deadline_mod.bind(_dl), tracing.bind(_tc, _tp):
                    return fn(*args, **kwargs)
            fut = self._pool.submit(run)
        try:
            if clock is not None:
                result = clock.wait(fut, base, end)
            else:
                timeout = base if end is None else min(base, end - t0)
                try:
                    result = fut.result(timeout=timeout)
                except FutureTimeout:
                    raise _Expired(timeout < base, timeout) from None
        except _Expired as ex:
            self._record(op, time.monotonic() - t0, failed=True)
            if ex.clamped:
                self._clamped_expiry(ex.window)
                err: Exception = DeadlineExceeded(
                    f"request deadline exceeded during {op} on "
                    f"{self.endpoint}")
            else:
                self._fault()
                err = FaultyDisk(
                    f"drive {self.endpoint}: {op} exceeded {ex.window}s")
            err.pending = fut
            raise err from None
        except DeadlineExceeded:
            # Raised below this layer: the request's problem.
            self._record(op, time.monotonic() - t0, failed=True)
            self._probe_inconclusive()
            raise
        except _DOMAIN_ERRORS:
            self._record(op, time.monotonic() - t0, failed=False)
            self._ok()
            raise
        except Exception:
            self._record(op, time.monotonic() - t0, failed=True)
            self._fault()
            raise
        self._record(op, time.monotonic() - t0, failed=False)
        self._ok()
        return result

    # Items a generator op's step pulls in one deadline-bounded call.
    _ITER_BATCH = 64

    def _guarded_iter(self, name: str, attr, args, kwargs):
        """A generator op stepped through the deadline: making the
        generator is instant, its I/O happens in the steps. A step pulls
        up to _ITER_BATCH items in one call (the JAX package pulls one):
        a listing's walk reads a journal an item, and a pool handoff an
        item doubled the first walk's time."""
        it = iter(attr(*args, **kwargs))

        def step():
            out = []
            for item in it:
                out.append(item)
                if len(out) == self._ITER_BATCH:
                    break
            return out

        while True:
            items = self._call(name, step, (), {})
            yield from items
            if len(items) < self._ITER_BATCH:
                return

    def __getattr__(self, name: str):
        attr = getattr(self._disk, name)
        if not callable(attr):
            return attr
        cache = self.__dict__.setdefault("_bound_cache", {})
        hit = cache.get(name)
        if hit is not None:
            return hit
        if name in _GENERATOR_OPS:
            def bound(*args, **kwargs):
                return self._guarded_iter(name, attr, args, kwargs)
        elif name == "create_file":
            def bound(volume, path, chunks, *args, **kwargs):
                clock = _PullClock(chunks)
                return self._call(name, attr, (volume, path, clock, *args),
                                  kwargs, clock)
        else:
            def bound(*args, **kwargs):
                return self._call(name, attr, args, kwargs)
        cache[name] = bound
        return bound

    def close(self) -> None:
        self._pool.shutdown()


def wrap_disks(disks, **kwargs) -> list:
    """Health-wrap a drive list; OfflineDisk slots (which fail at once
    already), None and wrapped drives pass through."""
    out = []
    for d in disks:
        if d is None or type(d).__name__ == "OfflineDisk" \
                or isinstance(d, DiskHealthWrapper):
            out.append(d)
        else:
            out.append(DiskHealthWrapper(d, **kwargs))
    return out

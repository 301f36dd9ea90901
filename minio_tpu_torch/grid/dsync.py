"""dsync: distributed reader/writer quorum locks.

The port of minio_tpu/grid/dsync.py (reference internal/dsync): a
DRWMutex takes the lock on every node's lock server and holds it iff a
quorum granted it (write quorum n//2+1, read quorum n - n//2, so the two
always overlap: internal/dsync/drwmutex.go:218-234); held locks refresh
continuously, and a refresh that loses quorum calls the loss callback
(drwmutex.go:256-300). Each node runs a LockServer (the reference's
localLocker, cmd/local-locker.go:63) whose entries expire after a TTL,
so the locks of a crashed node free themselves. A lock not had within
its timeout raises object/nslock.LockTimeout, which S3 answers with 503
SlowDown.

Environment:
  MTPU_GRID_LOCK_TTL      seconds a lock server keeps an entry its
                          holder stopped refreshing (default 30)
  MTPU_GRID_LOCK_REFRESH  seconds between a holder's refreshes
                          (default 8, at most TTL/3)
"""

from __future__ import annotations

import random
import threading
import time
import uuid as uuid_mod
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

from minio_tpu_torch.grid.client import GridClient
from minio_tpu_torch.grid.wire import GridError
from minio_tpu_torch.object.nslock import LockTimeout
from minio_tpu_torch.utils import deadline as deadline_mod
from minio_tpu_torch.utils.env import env_float as _env_float
from minio_tpu_torch.utils.latency import Histogram


# Holder-liveness window: a SIGKILLed holder's entries expire on every
# surviving lock server within LOCK_TTL of its last refresh, so a
# blocked writer proceeds within that bounded window instead of
# wedging the namespace forever. Refresh must outpace expiry — the
# interval is clamped to TTL/3 so a mis-set pair can never let a
# healthy holder's entries lapse between refreshes.
LOCK_TTL = _env_float("MTPU_GRID_LOCK_TTL", 30.0)
REFRESH_INTERVAL = min(_env_float("MTPU_GRID_LOCK_REFRESH", 8.0),
                       LOCK_TTL / 3.0)

# Shared worker pools and one refresher for every held lock, not a
# thread a locker a round and a thread a held lock. TWO pools, because
# refresh tasks BLOCK on their fan-out futures: on one bounded pool,
# enough held locks would fill every worker with refresh tasks whose
# nested RPCs never get a thread, and every healthy lock would report
# quorum loss. Fan-out RPCs are leaf tasks on their own pool, so they
# always drain.
_rpc_pool = None
_refresh_pool = None
_pool_mu = threading.Lock()


def _shared_rpc_pool():
    global _rpc_pool
    with _pool_mu:
        if _rpc_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _rpc_pool = ThreadPoolExecutor(max_workers=32,
                                           thread_name_prefix="dsync-rpc")
        return _rpc_pool


def _shared_refresh_pool():
    global _refresh_pool
    with _pool_mu:
        if _refresh_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _refresh_pool = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="dsync-refresh")
        return _refresh_pool


class _RefreshDaemon:
    """ONE background thread scheduling refreshes for every held
    DRWMutex (instead of one thread per held lock). Individual refresh
    rounds run concurrently on the refresh pool so one slow peer cannot
    starve the other locks' refresh deadlines."""

    _instance = None
    _imu = threading.Lock()

    @classmethod
    def get(cls) -> "_RefreshDaemon":
        with cls._imu:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._mu = threading.Lock()
        self._locks: set = set()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dsync-refreshd")
        self._thread.start()

    def register(self, m: "DRWMutex") -> None:
        with self._mu:
            self._locks.add(m)

    def unregister(self, m: "DRWMutex") -> None:
        with self._mu:
            self._locks.discard(m)

    def _loop(self) -> None:
        while True:
            time.sleep(REFRESH_INTERVAL)
            with self._mu:
                held = list(self._locks)
            for m in held:
                # Dedup in-flight rounds: a slow peer must not let the
                # queue back up past LOCK_TTL (an un-refreshed server
                # entry expires and hands the lock to someone else
                # while this holder still trusts it).
                if not getattr(m, "_refresh_inflight", False):
                    m._refresh_inflight = True
                    try:
                        _shared_refresh_pool().submit(m._refresh_once)
                    except RuntimeError:
                        # Interpreter shutting down: the pool refuses
                        # new futures; the daemon dies with the process.
                        m._refresh_inflight = False
                        return


class LockServer:
    """Per-node lock table with TTL expiry."""

    def __init__(self, ttl: Optional[float] = None):
        self.ttl = ttl if ttl is not None else LOCK_TTL
        self._mu = threading.Lock()
        # resource -> {"writer": uid|None, "wexp": ts,
        #              "readers": {uid: expiry}}
        self._res: dict[str, dict] = {}
        # TTL expirations of entries whose holder stopped refreshing
        # (crashed/SIGKILLed/partitioned) — the liveness counter the
        # lock-leak regression tests assert on.
        self.expired_total = 0

    def _entry(self, resource: str) -> dict:
        e = self._res.get(resource)
        if e is None:
            e = self._res[resource] = {"writer": None, "wexp": 0.0,
                                       "readers": {}}
        return e

    def _expire(self, e: dict, now: float) -> None:
        if e["writer"] is not None and e["wexp"] < now:
            e["writer"] = None
            self.expired_total += 1
        live = {u: x for u, x in e["readers"].items() if x >= now}
        self.expired_total += len(e["readers"]) - len(live)
        e["readers"] = live

    def stats(self) -> dict:
        with self._mu:
            now = time.monotonic()
            writers = sum(1 for e in self._res.values()
                          if e["writer"] is not None and e["wexp"] >= now)
            readers = sum(len(e["readers"]) for e in self._res.values())
            return {"resources": len(self._res), "writers": writers,
                    "readers": readers, "expired_total": self.expired_total,
                    "ttl": self.ttl}

    def try_lock(self, resource: str, uid: str, write: bool) -> bool:
        now = time.monotonic()
        with self._mu:
            e = self._entry(resource)
            self._expire(e, now)
            if write:
                if (e["writer"] in (None, uid)) and not e["readers"]:
                    e["writer"] = uid
                    e["wexp"] = now + self.ttl
                    return True
                return False
            if e["writer"] is None:
                e["readers"][uid] = now + self.ttl
                return True
            return False

    def unlock(self, resource: str, uid: str, write: bool) -> bool:
        with self._mu:
            e = self._res.get(resource)
            if e is None:
                return False
            if write and e["writer"] == uid:
                e["writer"] = None
            else:
                e["readers"].pop(uid, None)
            if e["writer"] is None and not e["readers"]:
                self._res.pop(resource, None)
            return True

    def refresh(self, resource: str, uid: str, write: bool) -> bool:
        now = time.monotonic()
        with self._mu:
            e = self._res.get(resource)
            if e is None:
                return False
            self._expire(e, now)
            if write:
                if e["writer"] != uid:
                    return False
                e["wexp"] = now + self.ttl
                return True
            if uid not in e["readers"]:
                return False
            e["readers"][uid] = now + self.ttl
            return True

    # expose over the grid ---------------------------------------------

    def register_into(self, srv) -> None:
        srv.register("lock.try", lambda p: self.try_lock(p["r"], p["u"],
                                                         p["w"]))
        srv.register("lock.unlock", lambda p: self.unlock(p["r"], p["u"],
                                                          p["w"]))
        srv.register("lock.refresh", lambda p: self.refresh(p["r"], p["u"],
                                                            p["w"]))


class LocalLocker:
    """In-process locker for this node's own LockServer (the reference's
    local fast path, cmd/namespace-lock.go localLockInstance)."""

    def __init__(self, server: LockServer):
        self.server = server

    def try_lock(self, resource, uid, write) -> bool:
        return self.server.try_lock(resource, uid, write)

    def unlock(self, resource, uid, write) -> bool:
        return self.server.unlock(resource, uid, write)

    def refresh(self, resource, uid, write) -> bool:
        return self.server.refresh(resource, uid, write)


class RemoteLocker:
    """Locker on a peer node, reached over the grid."""

    def __init__(self, client: GridClient):
        self.client = client

    def _call(self, op: str, resource: str, uid: str, write: bool):
        """True/False = the peer ANSWERED (vote); None = unreachable
        (breaker open, dead node, partition) — the distinction lets
        DRWMutex fail FAST when a lock quorum cannot possibly form,
        instead of spinning try-rounds against dead peers until its
        timeout."""
        try:
            return bool(self.client.call(
                f"lock.{op}", {"r": resource, "u": uid, "w": write},
                timeout=5.0))
        except GridError:
            return None

    def try_lock(self, resource, uid, write):
        return self._call("try", resource, uid, write)

    def unlock(self, resource, uid, write):
        return self._call("unlock", resource, uid, write)

    def refresh(self, resource, uid, write):
        return self._call("refresh", resource, uid, write)


class DRWMutex:
    """Quorum RW lock over a set of lockers."""

    def __init__(self, lockers: Sequence, resource: str,
                 on_lost: Optional[Callable[[], None]] = None):
        self.lockers = list(lockers)
        self.resource = resource
        self.on_lost = on_lost
        self.uid = str(uuid_mod.uuid4())
        self._write = False
        self._held = False
        # Set when lock() gave up because too few lock servers even
        # ANSWERED to form a quorum (fast-fail path, not contention).
        self.quorum_unreachable = False
        self._stop_refresh = threading.Event()

    def _quorum(self, write: bool) -> int:
        # Read quorum must overlap every possible write quorum:
        # write = n//2 + 1, read = n - n//2 (ceil), so read + write > n
        # for all n (reference: internal/dsync/drwmutex.go:218-234).
        n = len(self.lockers)
        return n // 2 + 1 if write else n - n // 2

    def _fanout(self, op: str, write: bool) -> tuple[int, int, bool]:
        """(granted, reachable, concluded): grants are True votes;
        reachable counts lockers that ANSWERED (True or False) — None
        means the locker could not be reached at all. `concluded` is
        True only when every fan-out task actually RAN to completion
        inside the window: a task still queued behind a saturated
        shared pool proves nothing about its locker, so callers must
        never fast-fail on reachability evidence from an unconcluded
        round."""
        results: list = [None] * len(self.lockers)
        ran = [False] * len(self.lockers)

        def run(i, lk):
            try:
                results[i] = getattr(lk, op)(self.resource, self.uid, write)
            except Exception:  # noqa: BLE001 - dead locker == vote lost
                results[i] = None
            ran[i] = True
        pool = _shared_rpc_pool()
        futs = [pool.submit(run, i, lk)
                for i, lk in enumerate(self.lockers)]
        deadline = time.monotonic() + 6.0
        for f in futs:
            try:
                f.result(timeout=max(0.0, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 - timeout == vote lost
                pass
        granted = sum(1 for r in results if r is True)
        reachable = sum(1 for r in results if r is not None)
        return granted, reachable, all(ran)

    def lock(self, write: bool = True, timeout: float = 60.0) -> bool:
        # Never spin past the caller's request deadline: the lock
        # attempt is part of a budgeted request (utils/deadline.py), and
        # a lock that cannot be had inside the budget is a fast 503,
        # not a wedged handler.
        dl = deadline_mod.current()
        if dl is not None:
            timeout = min(timeout, max(0.0, dl.remaining()))
        deadline = time.monotonic() + timeout
        quorum = self._quorum(write)
        while True:
            got, reachable, concluded = self._fanout("try_lock", write)
            if got >= quorum:
                self._write = write
                self._held = True
                self._start_refresh()
                return True
            # Failed round: release any partial grants, back off, retry
            # (reference: releaseAll + retry loop, drwmutex.go:218).
            self._fanout("unlock", write)
            if concluded and reachable < quorum:
                # A quorum cannot POSSIBLY form — too many lock
                # servers are dead or partitioned (their breakers make
                # this round microseconds, not connect timeouts).
                # Retrying until the timeout cannot help and wedges
                # every writer for the full window; fail fast and let
                # the client retry against an honest 503.
                self.quorum_unreachable = True
                return False
            if time.monotonic() >= deadline:
                return False
            time.sleep(random.uniform(0.02, 0.1))

    def unlock(self) -> None:
        if not self._held:
            return
        self._held = False
        self._stop_refresh.set()
        _RefreshDaemon.get().unregister(self)
        self._fanout("unlock", self._write)

    def _start_refresh(self) -> None:
        self._stop_refresh.clear()
        _RefreshDaemon.get().register(self)

    def _refresh_once(self) -> None:
        """One refresh round, driven by the shared daemon."""
        try:
            self._refresh_round()
        finally:
            self._refresh_inflight = False

    def _refresh_round(self) -> None:
        if self._stop_refresh.is_set() or not self._held:
            _RefreshDaemon.get().unregister(self)
            return
        granted, _, _ = self._fanout("refresh", self._write)
        if granted < self._quorum(self._write):
            # Quorum lost (network partition, peer restarts): the
            # holder must stop trusting its lock (reference loss
            # callback cancels the op's context).
            self._held = False
            _RefreshDaemon.get().unregister(self)
            if self.on_lost is not None:
                try:
                    self.on_lost()
                except Exception:  # noqa: BLE001
                    pass


# The namespace locks this process took (with how long each took to be
# granted) and was refused; the server's exit summary prints them.
ACQUIRE = Histogram()
REFUSED = 0


class DistNSLock:
    """Namespace-lock interface (object/nslock.NSLockMap's) backed by
    dsync quorum locks — drop-in for ErasureSet.ns in distributed mode
    (reference: distLockInstance, cmd/namespace-lock.go:157)."""

    def __init__(self, lockers: Sequence):
        self.lockers = list(lockers)

    @contextmanager
    def _held(self, volume: str, path: str, write: bool, timeout: float):
        global REFUSED
        m = DRWMutex(self.lockers, f"{volume}/{path}")
        t0 = time.monotonic()
        if not m.lock(write=write, timeout=timeout):
            REFUSED += 1
            raise LockTimeout(
                f"dist {'write' if write else 'read'} lock {volume}/{path}"
                + (" (lock quorum unreachable)"
                   if m.quorum_unreachable else ""))
        ACQUIRE.observe(time.monotonic() - t0)
        try:
            yield
        finally:
            m.unlock()

    def write(self, volume: str, path: str, timeout: float = 60.0):
        return self._held(volume, path, True, timeout)

    def read(self, volume: str, path: str, timeout: float = 60.0):
        return self._held(volume, path, False, timeout)

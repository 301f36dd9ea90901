"""Cross-request stripe batching onto the card.

The port of minio_tpu/ops/batcher.py (StripeBatcher). Stripe windows from
MANY concurrent requests coalesce into ONE device dispatch: the batch
dimension becomes "stripes from many requests", and the results
demultiplex back to the waiting request threads, whose shard writes then
proceed as for a solo request.

The coalesced window is staged into ONE pooled host buffer (io/bufpool;
pinned memory for a set on the card), padded with zero rows to a fixed
power-of-two bucket, and handed to the route's device function, which
copies it to the card with a non-blocking copy on the kernel lane's
stream. Every batched dispatch in the process runs through the shared
io/engine kernel lane (the card is one resource, like a drive), which
keeps each dispatch's wait and service time.

Routes, one batcher instance per route and config:
  * "put"          encode + frame windows (ops/hh_device.make_mesh_framer),
  * "get"          framed-window bitrot verification
                   (ops/hh_device.make_mesh_deframer; members are
                   [B, k, 32+shard] stacked on-disk frames),
  * "reconstruct"  decode-matrix application for degraded reads
                   (ops/rs_device.make_mesh_matrix; members are
                   [B, k, shard] survivor stripes).
  * "transform"    kept in ROUTES for the stats' shape; the port has no
                   transform plane yet.
Non-put routes plug in a `split_fn` that demultiplexes the shared result
back to member-sized results, and a `concat_fn` that splices oversized
windows' chunked results. Members whose trailing shapes differ never share
a staging buffer: the dispatcher drains same-shape runs per batch.

A lone request with nobody to coalesce with never waits: frame() runs a
solo window straight through the batch path (_run_batch) when it is at
least min_device_blocks, and otherwise bypasses to the host function. The
accumulation window is adaptive: it opens at the base wait, stretches
while bursts fill whole buckets, shrinks toward zero while traffic is
sparse, dispatches early once one card-filling batch is pending, and never
holds a member past its request deadline (members whose budget is spent
are culled before dispatch and fail alone).

Two departures from the JAX batcher, both so that nothing hides the card:
  * MTPU_BATCH_FORCE defaults to "device": no calibration probe runs
    unless a caller asks for "auto";
  * under "auto", a device exception in the probe is not turned into a
    host verdict: it is kept and raised to the callers of frame().
A device exception in a batched dispatch is delivered to every member
of that dispatch, as in the JAX batcher; nothing retries it on the host.

Environment:
  MTPU_BATCH_FORCE    device|host|auto (default device): the calibration
                      verdict. A comma list of route=value pairs pins
                      each route, e.g. "put=device,get=host" (unnamed
                      routes keep the default).
  MTPU_BATCH_WAIT_MS  base accumulation window in ms (default 2).
  MTPU_GET_BATCH_WAIT_MS
                      base window of the get/reconstruct routes
                      (default: MTPU_BATCH_WAIT_MS).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Callable, Optional

import numpy as np

from minio_tpu_torch.io.bufpool import LeasedRows, leases_of
from minio_tpu_torch.io.engine import EngineSaturated, kernel_lane
from minio_tpu_torch.utils import deadline as deadline_mod
from minio_tpu_torch.utils.deadline import DeadlineExceeded
from minio_tpu_torch.utils.latency import Histogram

# Batch-dim padding buckets. On the TPU each bucket is one compiled shape;
# on the card the kernels take any batch, and the buckets bound the
# staging-buffer shapes (whether padding pays there is an open question).
_BUCKETS = (8, 16, 32, 64, 128, 256)
# Base accumulation window (first window of a burst); the adaptive
# controller moves the live value between _MIN_WAIT_S and this.
_MAX_WAIT_S = 0.002
_MIN_WAIT_S = 0.00025
# Cap per dispatched batch (the largest bucket).
_MAX_BATCH_BLOCKS = 256
# Stripe blocks per device that fill it: the accumulation window stops
# waiting the moment the pending total reaches this depth.
_PER_CHIP_BLOCKS = 32
# A member must dispatch at least this long before its deadline.
_DEADLINE_SLACK_S = 0.005
DEFAULT_FORCE = "device"


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _env_wait_s(route: str = "put") -> float:
    raw = os.environ.get("MTPU_BATCH_WAIT_MS", "")
    if route in ("get", "reconstruct"):
        raw = os.environ.get("MTPU_GET_BATCH_WAIT_MS", "") or raw
    try:
        return max(0.0, float(raw or 2.0)) / 1000.0
    except ValueError:
        return _MAX_WAIT_S


def batch_force_mode(route: str = "put") -> str:
    """The MTPU_BATCH_FORCE verdict for `route`: "device" (the default),
    "host", or "auto". A bare value pins every route; a comma list of
    `route=value` pairs pins each independently."""
    v = os.environ.get("MTPU_BATCH_FORCE", DEFAULT_FORCE).strip().lower()
    if "=" in v:
        out = DEFAULT_FORCE
        for part in v.split(","):
            r, _, m = part.partition("=")
            if r.strip() == route and m.strip() in ("device", "host",
                                                    "auto"):
                out = m.strip()
        return out
    return v if v in ("device", "host", "auto") else DEFAULT_FORCE


def _default_concat(rows, chunk):
    """Oversized-window splice for the PUT rows contract: per-drive
    lists of per-block piece tuples concatenate drive-wise, and the
    leases both hold pass to the result."""
    return LeasedRows([r + c for r, c in zip(rows, chunk)],
                      leases_of(rows) + leases_of(chunk))


class _Pending:
    __slots__ = ("stacked", "count", "rows", "exc", "event", "expires_at",
                 "t_enq", "route_taken")

    def __init__(self, stacked: np.ndarray,
                 dl: Optional[deadline_mod.Deadline]):
        self.stacked = stacked
        self.count = stacked.shape[0]
        self.rows = None
        self.exc: Optional[BaseException] = None
        self.event = threading.Event()
        self.expires_at = dl.expires_at if dl is not None else None
        self.t_enq = time.perf_counter()
        self.route_taken = "host"      # resolved by _run_batch


# Live batchers, for process-wide occupancy stats.
_REGISTRY: "weakref.WeakSet[StripeBatcher]" = weakref.WeakSet()

ROUTES = ("put", "get", "reconstruct", "transform")


_HISTS = ("wait_hist", "lane_round_trip_hist", "lane_wait_hist",
          "lane_service_hist")


def _route_zero() -> dict:
    return {
        "dispatches": {"device": 0, "host": 0},
        "requests": {"device": 0, "host": 0, "bypass": 0},
        "buckets": {},
        "batched_blocks": 0,
        "capacity_blocks": 0,
        "deadline_failures": 0,
        "max_members": 0,
        "multi_member_dispatches": 0,
        "wait_hist": None,
        "lane_round_trip_hist": None,
        "lane_wait_hist": None,
        "lane_service_hist": None,
        "fill_ratio": 0.0,
    }


def merge_route_stats(stats: list[dict]) -> dict:
    """Sum per-batcher stats() into per-route totals: dispatch, request
    and bucket counters, fill accounting, deadline culls, the most
    members one dispatch carried, and the merged histograms (coalescing
    wait; kernel-lane round trip, queue wait and service)."""
    out = {r: _route_zero() for r in ROUTES}
    hists: dict[tuple, list] = {}
    for st in stats:
        route = st.get("route", "put")
        agg = out.setdefault(route, _route_zero())
        for key in ("device", "host"):
            agg["dispatches"][key] += st["dispatches"][key]
        for key in ("device", "host", "bypass"):
            agg["requests"][key] += st["requests"][key]
        for b, v in st["buckets"].items():
            agg["buckets"][b] = agg["buckets"].get(b, 0) + v
        for key in ("batched_blocks", "capacity_blocks", "deadline_failures",
                    "multi_member_dispatches"):
            agg[key] += st[key]
        agg["max_members"] = max(agg["max_members"], st["max_members"])
        for key in _HISTS:
            hists.setdefault((route, key), []).append(st[key])
    for r, agg in out.items():
        for key in _HISTS:
            agg[key] = Histogram.merge(hists.get((r, key), []))
        cap = agg["capacity_blocks"]
        agg["fill_ratio"] = (agg["batched_blocks"] / cap) if cap else 0.0
    return out


def aggregate_stats() -> dict:
    """Occupancy stats across every live batcher in the process, per
    route, with each route's MTPU_BATCH_FORCE verdict."""
    sbs = list(_REGISTRY)
    return {
        "routes": merge_route_stats([sb.stats() for sb in sbs]),
        "mesh_devices": max([sb.mesh_devices for sb in sbs], default=0),
        "forced": {r: batch_force_mode(r) for r in ROUTES},
    }


class StripeBatcher:
    """Coalesces concurrent frame() calls of one route and EC config.

    device_fn(stacked [B, k, L] u8) -> the route's result for the whole
    batch (for "put": per-drive rows, the make_mesh_framer run()
    contract); host_fn(stacked) -> the same through the host codec. Both
    must be thread-safe. `pool` (io/bufpool.BufferPool) backs the
    coalesced staging buffer; its lease is held for the whole dispatch,
    so a buffer is never recycled under an in-flight host-to-device
    copy.
    """

    def __init__(self, device_fn: Callable, host_fn: Callable,
                 probe_fn: Optional[Callable] = None,
                 min_device_blocks: int = 8,
                 max_wait_s: Optional[float] = None,
                 pool=None, name: str = "", route: str = "put",
                 split_fn: Optional[Callable] = None,
                 concat_fn: Optional[Callable] = None):
        self._device_fn = device_fn
        self._host_fn = host_fn
        self._min_device_blocks = min_device_blocks
        self._max_wait = _env_wait_s(route) if max_wait_s is None \
            else max_wait_s
        self._cur_wait = self._max_wait
        self._pool = pool
        self.name = name
        self.route = route
        # split_fn(result, off, count, member_stacked) -> member result
        # (None = the PUT per-drive rows contract); concat_fn splices
        # chunked oversized-window results back together.
        self._split_fn = split_fn
        self._concat = concat_fn if concat_fn is not None \
            else _default_concat
        self.mesh_devices = max(1, int(getattr(device_fn, "mesh_devices",
                                               1) or 1))
        self._mu = threading.Condition()
        self._pending: list[_Pending] = []
        self._deadline = 0.0            # current window's dispatch-by time
        self._inflight = 0              # frame() calls currently active
        self._dispatcher: Optional[threading.Thread] = None
        self._closed = False
        # Calibration: None = unknown (host until probed), True/False.
        self._device_ok: Optional[bool] = None
        self._probe_fn = probe_fn
        self._probe_started = False
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_exc: Optional[BaseException] = None
        forced = batch_force_mode(route)
        if forced != "auto":
            self._probe_started = True
            self._device_ok = forced == "device"
        self._stat_mu = threading.Lock()
        self._dispatches = {"device": 0, "host": 0}
        self._requests = {"device": 0, "host": 0, "bypass": 0}
        # Calibrated-host bypass count: bumped without _stat_mu on the
        # pass-through, folded into stats() reads.
        self._bypass_approx = 0
        self._bucket_dispatches: dict[int, int] = {}
        self._batched_blocks = 0
        self._capacity_blocks = 0
        self._deadline_failures = 0
        self._max_members = 0
        self._multi_member_dispatches = 0
        self._wait_hist = Histogram()
        # Per-calling-thread record of the last frame() dispatch path
        # (device|host|bypass), so callers count their windows honestly.
        self._local = threading.local()
        # This batcher's device dispatches on the kernel lane: round trip
        # (submit to result), and its parts, the wait queued behind other
        # dispatches and the service (the device function itself); the
        # rest of a round trip is the two thread handoffs.
        self._lane_rt_hist = Histogram()
        self._lane_wait_hist = Histogram()
        self._lane_service_hist = Histogram()
        _REGISTRY.add(self)

    # -- calibration ----------------------------------------------------

    def _default_probe(self, sample: np.ndarray) -> bool:
        """Time device vs host on one representative batch; True when
        the device round trip wins. A device exception propagates."""
        stacked = np.zeros(
            (_bucket(max(self._min_device_blocks, self.mesh_devices)),)
            + sample.shape[1:], dtype=np.uint8)
        for h in leases_of(self._device_fn(stacked)):   # warm-up
            h.release()
        t0 = time.perf_counter()
        out = self._device_fn(stacked)
        t_dev = time.perf_counter() - t0
        for h in leases_of(out):
            h.release()
        t0 = time.perf_counter()
        self._host_fn(stacked)
        t_host = time.perf_counter() - t0
        return t_dev < t_host

    def _ensure_probe(self, sample: np.ndarray) -> None:
        with self._mu:
            # Check-and-set under the lock: two racing first users would
            # otherwise run two probes whose timings pollute each other.
            if self._probe_started:
                return
            self._probe_started = True

        def probe():
            try:
                if self._probe_fn is not None:
                    ok = bool(self._probe_fn())
                else:
                    ok = self._default_probe(sample)
            except BaseException as e:  # noqa: BLE001 - raised by frame()
                with self._mu:
                    self._probe_exc = e
                return
            with self._mu:
                self._device_ok = ok

        # Non-daemon: a daemon probe mid-device-call at interpreter exit
        # can abort the process inside the CUDA runtime; close() joins it.
        self._probe_thread = threading.Thread(
            target=probe, daemon=False, name="stripe-batcher-probe")
        self._probe_thread.start()

    def _raise_probe_error(self) -> None:
        exc = self._probe_exc
        if exc is not None:
            raise RuntimeError(
                f"stripe batcher {self.name or self.route}: the device "
                "calibration probe failed") from exc

    def worth_batching(self, blocks: int) -> bool:
        """True when frame(`blocks`) could take the device route right
        now: calibration has not resolved to host, and either the window
        alone is device-sized or other requests are in flight."""
        if self._device_ok is False:
            return False
        return blocks >= self._min_device_blocks or self._inflight > 0 \
            or bool(self._pending)

    def force(self, device_ok: bool) -> None:
        """Pin the calibration verdict (bench/tests): no probe runs."""
        with self._mu:
            self._probe_started = True
            self._device_ok = bool(device_ok)

    # -- observability --------------------------------------------------

    def stats(self) -> dict:
        with self._stat_mu:
            requests = dict(self._requests)
            requests["bypass"] += self._bypass_approx
            return {
                "name": self.name,
                "route": self.route,
                "mesh_devices": self.mesh_devices,
                "dispatches": dict(self._dispatches),
                "requests": requests,
                "buckets": dict(self._bucket_dispatches),
                "batched_blocks": self._batched_blocks,
                "capacity_blocks": self._capacity_blocks,
                "deadline_failures": self._deadline_failures,
                "max_members": self._max_members,
                "multi_member_dispatches": self._multi_member_dispatches,
                "wait_hist": self._wait_hist.state(),
                "lane_round_trip_hist": self._lane_rt_hist.state(),
                "lane_wait_hist": self._lane_wait_hist.state(),
                "lane_service_hist": self._lane_service_hist.state(),
                "window_s": self._cur_wait,
            }

    def _note_request(self, route: str, n: int = 1) -> None:
        with self._stat_mu:
            self._requests[route] += n

    # -- submission -----------------------------------------------------

    def frame(self, stacked: np.ndarray):
        """Run one request's window [B, k, L] through the route; blocks
        until the (possibly coalesced) result is ready. Returns the result
        for exactly this window's blocks. Raises DeadlineExceeded without
        touching the device when the caller's budget is already spent."""
        if self._device_ok is False:
            # Calibration resolved (or pinned) to host: a pass-through to
            # the host function with no lock and no queue hop.
            self._bypass_approx += 1
            self._local.route = "bypass"
            return self._host_fn(stacked)
        self._raise_probe_error()
        if stacked.shape[0] > _MAX_BATCH_BLOCKS:
            # An oversized window never reaches _stage as one pending:
            # the staging buffer is at most _BUCKETS[-1] rows. Dispatch
            # bucket-sized chunks through the same path and splice.
            rows = None
            routes = set()
            for off in range(0, stacked.shape[0], _MAX_BATCH_BLOCKS):
                chunk = self.frame(stacked[off:off + _MAX_BATCH_BLOCKS])
                routes.add(self.last_route())
                rows = chunk if rows is None else self._concat(rows, chunk)
            self._local.route = "device" if "device" in routes \
                else routes.pop()
            return rows
        dl = deadline_mod.current()
        if dl is not None and dl.expired():
            with self._stat_mu:
                self._deadline_failures += 1
            raise DeadlineExceeded("request deadline exceeded")
        big = stacked.shape[0] >= self._min_device_blocks
        with self._mu:
            self._inflight += 1
            solo = self._inflight == 1 and not self._pending
        try:
            if big or not solo:
                # Worth calibrating: the window alone is device-sized, or
                # there is company to coalesce with.
                self._ensure_probe(stacked)
            if solo:
                if big and self._device_ok:
                    # A single device-sized window needs no queue: it runs
                    # straight through the shared batch path (staging,
                    # padding buckets, kernel lane).
                    p = _Pending(stacked, dl)
                    self._run_batch([p])
                    self._local.route = p.route_taken
                    if p.exc is not None:
                        raise p.exc
                    return p.rows
                self._note_request("bypass")
                self._local.route = "bypass"
                return self._host_fn(stacked)
            if self._device_ok is not True:
                self._note_request("host")
                self._local.route = "host"
                return self._host_fn(stacked)
            return self._enqueue(stacked, dl)
        finally:
            with self._mu:
                self._inflight -= 1

    def _enqueue(self, stacked: np.ndarray, dl):
        p = _Pending(stacked, dl)
        with self._mu:
            if not self._pending:
                self._deadline = time.monotonic() + self._cur_wait
            self._pending.append(p)
            # _dispatcher is cleared (under this lock) by the loop BEFORE
            # it exits, so is_alive() never claims a thread that already
            # decided to die with our entry unseen.
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, daemon=True,
                    name="stripe-batcher")
                self._dispatcher.start()
            # Always wake the dispatcher: parked in its idle poll, an
            # un-notified append would stretch the window to 200 ms.
            self._mu.notify_all()
        p.event.wait()
        self._local.route = p.route_taken
        if p.exc is not None:
            raise p.exc
        return p.rows

    def last_route(self) -> str:
        """The dispatch path the CALLING thread's last frame() took:
        "device", "host" (a coalesced batch below min_device_blocks, or
        calibration unresolved), or "bypass" (host pass-through)."""
        return getattr(self._local, "route", "host")

    # -- dispatch -------------------------------------------------------

    def _fill_target(self) -> int:
        """Pending blocks that fill the device: stop accumulating the
        moment one dispatch can feed it at working depth."""
        return min(_MAX_BATCH_BLOCKS,
                   max(self._min_device_blocks,
                       self.mesh_devices * _PER_CHIP_BLOCKS))

    def _adapt_window(self, fill_ratio: float) -> None:
        """Buckets dispatching full mean the burst outruns the window:
        stretch it; sparse dispatches mean waiting only adds latency:
        shrink toward pass-through."""
        if fill_ratio >= 0.75:
            self._cur_wait = min(self._max_wait, self._cur_wait * 1.5)
        elif fill_ratio < 0.25:
            self._cur_wait = max(_MIN_WAIT_S, self._cur_wait * 0.5)

    def _dispatch_loop(self) -> None:
        while True:
            with self._mu:
                while not self._pending and not self._closed:
                    self._mu.wait(timeout=0.2)
                    if not self._pending and self._inflight == 0:
                        # Idle: clear the handle BEFORE dying (still under
                        # the lock) so a racing _enqueue starts a fresh
                        # dispatcher.
                        self._dispatcher = None
                        return
                if self._closed and not self._pending:
                    self._dispatcher = None
                    return
                now = time.monotonic()
                total = sum(p.count for p in self._pending)
                # The window closes at the adaptive deadline, when the
                # device can be fed at full depth, or in time for the
                # EARLIEST member deadline.
                bound = self._deadline
                expiries = [p.expires_at for p in self._pending
                            if p.expires_at is not None]
                if expiries:
                    bound = min(bound, min(expiries) - _DEADLINE_SLACK_S)
                if total < self._fill_target() and now < bound \
                        and not self._closed:
                    self._mu.wait(timeout=bound - now)
                    continue
                # Drain at most one bucket's worth of one member shape
                # per dispatch; the rest keeps its place for the next
                # round.
                batch, rest = [], []
                taken = 0
                for p in self._pending:
                    c = p.count
                    if batch and (taken + c > _MAX_BATCH_BLOCKS
                                  or p.stacked.shape[1:]
                                  != batch[0].stacked.shape[1:]):
                        rest.append(p)
                    else:
                        batch.append(p)
                        taken += c
                self._pending = rest
                if rest:
                    self._deadline = now      # no extra wait for them
            self._run_batch(batch)

    def _stage(self, live: list[_Pending], bucket: int):
        """(lease, stacked [bucket, k, L]): members copied into ONE pooled
        staging buffer, zero-padded to the bucket. The caller holds the
        lease for the whole dispatch. Returns (None, member array) when a
        lone member already fills the bucket exactly."""
        if len(live) == 1 and live[0].count == bucket:
            return None, live[0].stacked
        shape = (bucket,) + live[0].stacked.shape[1:]
        if self._pool is not None:
            # The pool serves any size (an oversized request unpooled), so
            # an error here is an allocation fault and fails the dispatch.
            lease = self._pool.lease(int(np.prod(shape)))
            stacked = lease.ndarray(shape)
        else:
            lease, stacked = None, np.empty(shape, dtype=np.uint8)
        off = 0
        for p in live:
            stacked[off:off + p.count] = p.stacked
            off += p.count
        if off < bucket:
            # Zero the pad rows: a recycled buffer carries stale bytes,
            # and deterministic pads keep batched output the same run to
            # run (the pad rows' results are sliced off either way).
            stacked[off:] = 0
        return lease, stacked

    def _lane_dispatch(self, stacked: np.ndarray):
        """Run the device function through the process-wide kernel lane
        (serialised device access), keeping the dispatch's round trip,
        queue wait and service; a direct call (no wait) if the lane is
        saturated or closed."""
        t0 = time.perf_counter()
        try:
            fut = kernel_lane().submit(lambda: self._device_fn(stacked))
        except EngineSaturated:
            fut = None
        try:
            return self._device_fn(stacked) if fut is None else fut.result()
        finally:
            rt = time.perf_counter() - t0
            self._lane_rt_hist.observe(rt)
            self._lane_wait_hist.observe(0.0 if fut is None else fut.wait_s)
            self._lane_service_hist.observe(rt if fut is None
                                            else fut.service_s)

    def _run_batch(self, batch: list[_Pending]) -> None:
        # Cull members whose budget is already spent: they fail ALONE
        # and never poison batch-mates.
        now = time.monotonic()
        live, dead = [], []
        for p in batch:
            if p.expires_at is not None \
                    and now >= p.expires_at - 1e-9:
                dead.append(p)
            else:
                live.append(p)
        if dead:
            with self._stat_mu:
                self._deadline_failures += len(dead)
            for p in dead:
                p.exc = DeadlineExceeded(
                    "request deadline exceeded before batch dispatch")
                p.event.set()
        if not live:
            return
        counts = [p.count for p in live]
        total = sum(counts)
        bucket = _bucket(max(total, self.mesh_devices))
        route = "host"
        t0 = time.perf_counter()
        try:
            if total >= self._min_device_blocks and self._device_ok:
                route = "device"
                lease, stacked = self._stage(live, bucket)
                try:
                    rows_all = self._lane_dispatch(stacked)
                finally:
                    # The device function returns host arrays: its copy
                    # back synchronises the lane's stream, so every copy
                    # that read the staging buffer is done here, and not
                    # before.
                    if lease is not None:
                        lease.release()
                if self._split_fn is not None:
                    off = 0
                    for p, c in zip(live, counts):
                        p.rows = self._split_fn(rows_all, off, c,
                                                p.stacked)
                        off += c
                else:
                    k = live[0].stacked.shape[1]
                    staged = lease is not None or len(live) > 1
                    held = leases_of(rows_all)
                    off = 0
                    try:
                        for p, c in zip(live, counts):
                            rows = [drive[off:off + c] for drive in rows_all]
                            if staged:
                                # Re-point data drives onto each member's
                                # OWN window: the framer's data blocks view
                                # the shared staging buffer, whose lease
                                # just went back to the pool; digests and
                                # parity stay in the framer's leases.
                                for i in range(k):
                                    rows[i] = [(dig, p.stacked[bi, i])
                                               for bi, (dig, _blk)
                                               in enumerate(rows[i])]
                            # Each member holds its own reference on the
                            # leases its digests and parity view.
                            p.rows = LeasedRows(
                                rows, [h.retain() for h in held])
                            off += c
                    finally:
                        for h in held:
                            h.release()
                with self._stat_mu:
                    self._dispatches["device"] += 1
                    self._requests["device"] += len(live)
                    self._bucket_dispatches[bucket] = \
                        self._bucket_dispatches.get(bucket, 0) + 1
                    self._batched_blocks += total
                    self._capacity_blocks += bucket
                    self._max_members = max(self._max_members, len(live))
                    self._multi_member_dispatches += len(live) > 1
                self._adapt_window(total / bucket)
            else:
                for p in live:
                    p.rows = self._host_fn(p.stacked)
                with self._stat_mu:
                    self._dispatches["host"] += 1
                    self._requests["host"] += len(live)
                self._adapt_window(total / bucket)
        except BaseException as e:  # noqa: BLE001 - deliver to waiters
            for p in live:
                p.exc = e
        finally:
            # The JAX batcher also fans one `kernel` span into each
            # member's trace here (tracing.record_into); the port has no
            # tracing plane yet.
            for p in live:
                p.route_taken = route
                self._wait_hist.observe(max(0.0, t0 - p.t_enq))
                p.event.set()

    def close(self, timeout: float | None = 60.0) -> None:
        """Dispatch what is pending, then stop the dispatcher and join it
        and any calibration probe."""
        with self._mu:
            self._closed = True
            self._mu.notify_all()
            threads = [t for t in (self._dispatcher, self._probe_thread)
                       if t is not None]
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout)

"""Request-scoped span-tree tracing, threaded through every layer.

The port's copy of minio_tpu/utils/tracing.py, the deep half of the
observability pair (the shallow half, one top-level record a request,
is s3/trace.py). One cheap span context rides the same thread-local
channel the deadline budget rides (utils/deadline.py), and every layer
a request traverses (the erasure fan-out, each drive call through the
health wrapper, a grid RPC, the kernel lane's dispatch on the card)
records a span into the request's bounded ring. As in Dapper (Sigelman
et al., 2010) the context is armed only while somebody watches: a trace
subscriber asking for internal types, or a slow-op threshold. Disarmed,
every call site costs ONE module-attribute check (`tracing.ACTIVE`) and
builds no span, record or trace field.

Span records are plain dicts:
    {"type": "storage", "name": "disk.read_file", "span": 3,
     "parent": 1, "start": <epoch s>, "duration_ms": 1.25,
     "tags": {...}}
Parent linkage crosses threads explicitly: a fan-out captures (ctx,
parent span id) at submission and re-`bind()`s it inside the worker,
beside the deadline's re-bind.

Slow-op log: any span (armed by MTPU_SLOW_OP_MS > 0, with or without a
subscriber) that crosses the threshold emits one record carrying its
ancestry (a slow GET names the slow drive) into a bounded ring that
admin info and the trace stream (`"slow": true`) show, and to stderr.

Environment:
  MTPU_SLOW_OP_MS        slow-op threshold in ms (0/unset = off)
  MTPU_TRACE_MAX_SPANS   a request's span ring (default 512)
  MTPU_TRACE_REMOTE_MAX  spans a grid reply ships back (default 128)
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import uuid
from typing import Optional

# Every trace type a span may carry; admin trace filters on these.
TRACE_TYPES = ("s3", "storage", "grid", "kernel", "scanner", "heal",
               "repl")

# -- node identity ----------------------------------------------------------
# The node's self-declared identity ("host:port" of its S3 plane, the
# same string PeerCoherence uses). Stamped on slow-op records and trace
# entries so cluster-merged streams stay attributable. Empty until the
# distributed boot calls set_node(); single-node deployments stay
# unstamped.

NODE = ""


def set_node(node_id: str) -> None:
    global NODE
    NODE = str(node_id or "")

# -- arming -----------------------------------------------------------------
# ACTIVE is THE fast-path gate: call sites check it before touching any
# span machinery. It is true while any source (a trace subscriber
# wanting internal types, a remote worker relay, a configured slow-op
# threshold, a bench harness) holds an arm() token.

ACTIVE = False
_arm_mu = threading.Lock()
_arm_sources: set = set()
_slow_ms = 0.0


def _refresh_locked() -> None:
    global ACTIVE
    ACTIVE = bool(_arm_sources) or _slow_ms > 0


def arm(source) -> None:
    """Arm span collection on behalf of `source` (any hashable)."""
    with _arm_mu:
        _arm_sources.add(source)
        _refresh_locked()


def disarm(source) -> None:
    with _arm_mu:
        _arm_sources.discard(source)
        _refresh_locked()


def slow_ms() -> float:
    return _slow_ms


def set_slow_ms(ms: float) -> None:
    """Set the slow-op threshold (tests / config hot-apply); ms <= 0
    disables. Arms span collection on its own."""
    global _slow_ms
    with _arm_mu:
        _slow_ms = max(0.0, float(ms))
        _refresh_locked()


def _env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except ValueError:
        return default


def _env_int(key: str, default: int) -> int:
    try:
        v = int(os.environ.get(key, "") or default)
        return v if v > 0 else default
    except ValueError:
        return default


set_slow_ms(_env_float("MTPU_SLOW_OP_MS", 0.0))
MAX_SPANS = _env_int("MTPU_TRACE_MAX_SPANS", 512)


# -- slow-op ring -----------------------------------------------------------

SLOW_RING = 256
# stderr lines per second cap: an aggressive threshold (every span
# over 1 ms) must degrade to a sampled log, not a flood that can wedge
# the data path behind an undrained stderr pipe. The ring and the
# total counter still capture every record.
SLOW_LOG_PER_S = 20
_slow_mu = threading.Lock()
_slow_ops: collections.deque = collections.deque(maxlen=SLOW_RING)
slow_total = 0
_slow_log_sec = 0
_slow_log_n = 0


def slow_ops() -> list[dict]:
    """Snapshot of the most recent slow-op records (newest last)."""
    with _slow_mu:
        return list(_slow_ops)


def slow_event(type_: str, name: str, ms: float = 0.0,
               tags: Optional[dict] = None) -> None:
    """Record one event on the slow-op channel UNCONDITIONALLY (no
    MTPU_SLOW_OP_MS threshold): for rare operational failures — a peer
    that would not ack an invalidation, a swallowed best-effort
    broadcast — that must reach the ring, the counters, and stderr
    even on a box with slow-op sampling disarmed. The rate limiter
    still bounds stderr volume."""
    _record_slow({"type": type_, "name": name, "ms": round(ms, 3),
                  "time": time.time(), "event": True,
                  "tags": dict(tags or {})})


def _record_slow(rec: dict) -> None:
    global slow_total, _slow_log_sec, _slow_log_n
    if NODE and "node" not in rec:
        rec["node"] = NODE
    sec = int(time.time())
    with _slow_mu:
        _slow_ops.append(rec)
        slow_total += 1
        if sec != _slow_log_sec:
            _slow_log_sec = sec
            _slow_log_n = 0
        _slow_log_n += 1
        emit = _slow_log_n <= SLOW_LOG_PER_S
    if not emit:
        return
    try:
        print("mtpu slow-op: " + json.dumps(rec), file=sys.stderr,
              flush=True)
    except Exception:  # noqa: BLE001 - telemetry must not raise
        pass


# -- publisher hook ---------------------------------------------------------
# Background spans (scanner/heal cycles with no request context) and
# slow-op records publish straight to the live broadcaster via this
# hook; the S3 server sets it at boot (last server wins in-process —
# only tests run several).

_publisher = None


def set_publisher(fn) -> None:
    global _publisher
    _publisher = fn


def publish_entry(entry: dict) -> None:
    pub = _publisher
    if pub is not None:
        try:
            pub(entry)
        except Exception:  # noqa: BLE001 - telemetry must not raise
            pass


# -- the context ------------------------------------------------------------

class TraceContext:
    """One request's span ring. Span id 0 is the (implicit) root — the
    top-level S3 entry the server publishes at request end."""

    __slots__ = ("trace_id", "spans", "dropped", "_mu", "_next", "start",
                 "_open")

    def __init__(self, trace_id: str = ""):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.spans: list[dict] = []
        self.dropped = 0
        self._mu = threading.Lock()
        self._next = 1
        self.start = time.time()
        # Spans currently in flight: sid -> (name, parent). A child
        # exits BEFORE its parent, so slow-op ancestry must see parents
        # that have no completed record yet.
        self._open: dict[int, tuple] = {}

    def add(self, rec: dict) -> None:
        with self._mu:
            if len(self.spans) >= MAX_SPANS:
                self.dropped += 1
                return
            self.spans.append(rec)

    def next_id(self) -> int:
        with self._mu:
            sid = self._next
            self._next += 1
            return sid

    def open_span(self, sid: int, name: str, parent: int) -> None:
        with self._mu:
            self._open[sid] = (name, parent)

    def close_span(self, sid: int) -> None:
        with self._mu:
            self._open.pop(sid, None)

    def ancestry(self, parent: int) -> list[str]:
        """Names of the span's ancestors, root-first ('<root>' for span
        id 0). Used by slow-op records so one line names the path."""
        with self._mu:
            by_id = {s["span"]: (s["name"], s["parent"])
                     for s in self.spans}
            by_id.update(self._open)
        chain: list[str] = []
        seen = set()
        cur = parent
        while cur and cur in by_id and cur not in seen:
            seen.add(cur)
            name, nxt = by_id[cur]
            chain.append(name)
            cur = nxt
        chain.append("<root>")
        chain.reverse()
        return chain


_local = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_local, "ctx", None)


def current_parent() -> int:
    return getattr(_local, "parent", 0)


def capture() -> tuple[Optional[TraceContext], int]:
    """(ctx, parent span id) of the calling thread — what a fan-out
    helper captures at submission to re-bind() inside its worker."""
    return current(), current_parent()


class _Bind:
    """Context manager binding (ctx, parent) as the calling thread's
    trace scope. bind(None) is a passthrough, mirroring deadline.bind."""

    __slots__ = ("_ctx", "_parent", "_prev")

    def __init__(self, ctx, parent):
        self._ctx = ctx
        self._parent = parent

    def __enter__(self):
        self._prev = (getattr(_local, "ctx", None),
                      getattr(_local, "parent", 0))
        if self._ctx is not None:
            _local.ctx = self._ctx
            _local.parent = self._parent
        return self._ctx

    def __exit__(self, *exc):
        _local.ctx, _local.parent = self._prev
        return False


def bind(ctx: Optional[TraceContext], parent: int = 0) -> _Bind:
    return _Bind(ctx, parent)


# -- spans ------------------------------------------------------------------

class _NoopSpan:
    """Shared, stateless, reentrant no-op for the disarmed path."""

    __slots__ = ()
    tags: Optional[dict] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kv):
        pass


NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_ctx", "_type", "_name", "tags", "_sid", "_parent",
                 "_t0", "_wall", "_prev_parent")

    def __init__(self, ctx, type_, name, tags):
        self._ctx = ctx
        self._type = type_
        self._name = name
        self.tags = tags

    def tag(self, **kv):
        if self.tags is None:
            self.tags = {}
        self.tags.update(kv)

    def __enter__(self):
        ctx = self._ctx
        self._sid = ctx.next_id()
        self._parent = getattr(_local, "parent", 0)
        ctx.open_span(self._sid, self._name, self._parent)
        _local.parent = self._sid
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        _local.parent = self._parent
        self._ctx.close_span(self._sid)
        rec = {"type": self._type, "name": self._name,
               "span": self._sid, "parent": self._parent,
               "start": self._wall, "duration_ms": round(dur_ms, 3)}
        if self.tags:
            rec["tags"] = self.tags
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        thr = _slow_ms
        if thr > 0 and dur_ms >= thr:
            # Slow markers ride the span record itself: the ONE place
            # the span is published (request end / _OpSpan exit)
            # carries them — publishing here too would stream every
            # slow span twice under the same trace/span id.
            rec["slow"] = True
            rec["threshold_ms"] = thr
            rec["ancestry"] = self._ctx.ancestry(self._parent)
            slow = dict(rec)
            slow["trace"] = self._ctx.trace_id
            _record_slow(slow)
        self._ctx.add(rec)
        return False


def span(type_: str, name: str, tags: Optional[dict] = None):
    """A child span of the calling thread's bound context; the shared
    no-op when tracing is disarmed or no context is bound. Call sites
    on the hottest paths should pre-guard with `if tracing.ACTIVE:`."""
    if not ACTIVE:
        return NOOP
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        return NOOP
    return _Span(ctx, type_, name, tags)


class _OpSpan:
    """A standalone single-span trace for background work (scanner
    cycles, heals outside any request): creates a throwaway context,
    records the one span, publishes it directly at exit."""

    __slots__ = ("_ctx", "_bind", "_span")

    def __init__(self, type_, name, tags):
        self._ctx = TraceContext()
        self._bind = bind(self._ctx, 0)
        self._span = _Span(self._ctx, type_, name, tags)

    def __enter__(self):
        self._bind.__enter__()
        self._span.__enter__()
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._span.__exit__(exc_type, exc, tb)
        self._bind.__exit__(exc_type, exc, tb)
        for rec in self._ctx.spans:
            publish_entry(_entry_from(rec, self._ctx.trace_id))
        return False


def op_span(type_: str, name: str, tags: Optional[dict] = None):
    """span() when a request context is bound; a standalone published
    trace otherwise (background scanner/heal work); NOOP disarmed."""
    if not ACTIVE:
        return NOOP
    if getattr(_local, "ctx", None) is not None:
        return _Span(_local.ctx, type_, name, tags)
    return _OpSpan(type_, name, tags)


def record(type_: str, name: str, start_wall: float, duration_ms: float,
           tags: Optional[dict] = None, parent: Optional[int] = None) -> None:
    """Record an already-measured span (call sites that time manually,
    e.g. grid streams). No-op without a bound context. Over-threshold
    records feed the slow-op log exactly like _Span exits do."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None or not ACTIVE:
        return
    record_into(ctx, current_parent() if parent is None else parent,
                type_, name, start_wall, duration_ms, tags)


def record_into(ctx: Optional[TraceContext], parent: int, type_: str,
                name: str, start_wall: float, duration_ms: float,
                tags: Optional[dict] = None) -> None:
    """record() into an explicitly captured (ctx, parent) scope.

    For work executed on a thread bound to no single request — e.g. one
    coalesced device dispatch serving many PUTs at once: the batcher
    captures each member's scope at submission and fans the ONE kernel
    span into every member's span tree, so each request's trace shows
    the shared dispatch it rode (with per-batch tags), not a gap."""
    if ctx is None or not ACTIVE:
        return
    record_span(ctx, parent, type_, name, start_wall, duration_ms, tags)


def record_span(ctx: TraceContext, parent: int, type_: str, name: str,
                start_wall: float, duration_ms: float,
                tags: Optional[dict] = None) -> int:
    """record_into(), returning the allocated span id so the caller can
    hang children (a grid call's stitched remote subtree) under it."""
    sid = ctx.next_id()
    rec = {"type": type_, "name": name, "span": sid, "parent": parent,
           "start": start_wall, "duration_ms": round(duration_ms, 3)}
    if tags:
        rec["tags"] = tags
    thr = _slow_ms
    if thr > 0 and rec["duration_ms"] >= thr:
        rec["slow"] = True
        rec["threshold_ms"] = thr
        rec["ancestry"] = ctx.ancestry(parent)
        slow = dict(rec)
        slow["trace"] = ctx.trace_id
        _record_slow(slow)
    ctx.add(rec)
    return sid


# -- cross-node propagation -------------------------------------------------
# A grid peer executing an armed call records its spans into a local
# TraceContext seeded with the caller's trace id, then ships the
# completed subtree back piggybacked on the reply (export_spans — wire-
# safe copies, capped). The caller grafts them under an explicit `wire`
# span (stitch_wire) that splits serialize / transit / peer-queue-wait
# / peer-service, remapping the remote span ids into its own sequence.

# Cap on spans shipped back per reply: bounds the piggyback bytes the
# way MAX_SPANS bounds the local ring.
REMOTE_MAX = _env_int("MTPU_TRACE_REMOTE_MAX", 128)

_WIRE_KEYS = ("type", "name", "span", "parent", "start", "duration_ms",
              "tags", "error", "slow", "threshold_ms")


def export_spans(ctx: TraceContext, limit: Optional[int] = None) -> dict:
    """The context's spans as a wire-safe payload: plain-dict copies
    (ancestry stripped — the caller re-derives paths in its own tree),
    capped at `limit` (default REMOTE_MAX) with the overflow counted
    in `dropped` alongside spans the ring itself already shed."""
    cap = REMOTE_MAX if limit is None else max(0, int(limit))
    with ctx._mu:
        spans = list(ctx.spans)
        dropped = ctx.dropped
    if len(spans) > cap:
        dropped += len(spans) - cap
        spans = spans[:cap]
    out = []
    for rec in spans:
        out.append({k: rec[k] for k in _WIRE_KEYS if k in rec})
    return {"spans": out, "dropped": dropped}


def stitch_wire(ctx: TraceContext, parent: int, start_wall: float,
                duration_ms: float, tags: Optional[dict],
                shipped: Optional[dict]) -> int:
    """Graft a peer's shipped subtree into the caller's tree under an
    explicit `wire` span. `tags` carries the timing split (serialize_ms
    / transit_ms / peer_queue_ms / peer_service_ms, plus peer identity
    or a transport fault annotation); `shipped` is the peer's
    export_spans() payload (None when the call faulted before a reply).
    Returns the wire span id."""
    wire_sid = record_span(ctx, parent, "grid", "wire", start_wall,
                           duration_ms, tags)
    if not shipped:
        return wire_sid
    remote = shipped.get("spans") or []
    node = shipped.get("node", "")
    # Remap remote span ids into the caller's sequence in ascending
    # order so every parent is remapped before its children (remote
    # ids are allocated monotonically).
    sid_map: dict[int, int] = {}
    for rec in sorted(remote, key=lambda r: r.get("span", 0)):
        try:
            new = dict(rec)
            new["span"] = sid_map[rec["span"]] = ctx.next_id()
            new["parent"] = sid_map.get(rec.get("parent", 0), wire_sid)
            if node:
                new["node"] = node
            ctx.add(new)
        except Exception:  # noqa: BLE001 - a malformed remote span
            pass           # must not break the caller's request
    extra = shipped.get("dropped", 0)
    if extra:
        with ctx._mu:
            ctx.dropped += int(extra)
    return wire_sid


# -- entry conversion -------------------------------------------------------

def _iso_ms(epoch: float) -> str:
    whole = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(epoch))
    return f"{whole}.{int(epoch * 1000) % 1000:03d}Z"


def _entry_from(rec: dict, trace_id: str) -> dict:
    entry = {
        "version": "1",
        "trace_type": rec["type"],
        "time": _iso_ms(rec["start"]),
        "api": rec["name"],
        "trace": trace_id,
        "span": rec["span"],
        "parent": rec["parent"],
        "durationMs": rec["duration_ms"],
    }
    for k in ("tags", "error", "slow", "threshold_ms", "ancestry",
              "node"):
        if k in rec:
            entry[k] = rec[k]
    if NODE and "node" not in entry:
        entry["node"] = NODE
    return entry


def entries_from(ctx: TraceContext, worker: int = 0) -> list[dict]:
    """The request's child spans rendered as trace entries (the root
    s3 entry is built by the server from make_entry and carries span
    id 0)."""
    with ctx._mu:
        spans = list(ctx.spans)
    out = []
    for rec in spans:
        e = _entry_from(rec, ctx.trace_id)
        e["worker"] = worker
        out.append(e)
    if ctx.dropped:
        # Truncation marker: `broadcast` bypasses subscriber type
        # filters — a storage-only stream must still learn its span
        # tree is incomplete.
        out.append({"version": "1", "trace_type": "s3",
                    "broadcast": True,
                    "time": _iso_ms(time.time()), "api": "trace.dropped",
                    "trace": ctx.trace_id, "span": -1, "parent": 0,
                    "durationMs": 0.0, "worker": worker,
                    "tags": {"dropped_spans": ctx.dropped}})
    return out

"""Grid client: one muxed connection a remote node.

The port of minio_tpu/grid/client.py (reference grid.Connection /
muxClient, internal/grid/connection.go, muxclient.go): every call from
this process to one peer shares one TCP connection; the grid poller
(grid/loop.py) demultiplexes replies to per-call queues. A lost
connection fails every call in flight on it (the storage layer treats
that as a drive fault and its quorum logic absorbs it) and the next call
reconnects.

Peer health rides a per-peer breaker, the twin of the drive breaker
(storage/health.py): `trip_after` consecutive TRANSPORT faults open it,
calls then fail in microseconds instead of paying a connect timeout
each, and one half-open probe a cooldown closes it when the peer is
back. The cooldown doubles (jittered, bounded) across failed probes, so
a long-dead peer is probed ever more lazily while a restarting one comes
back within one base cooldown. A RemoteCallError never trips it: the
peer answered, and its handler's exception is the caller's.

Environment:
  MTPU_GRID_TRIP_AFTER    consecutive transport faults that open the
                          breaker (default 3)
  MTPU_GRID_COOLDOWN      base breaker cooldown seconds (default 0.5)

The doubled cooldown stops at COOLDOWN_MAX seconds.

While tracing is armed and a request's trace is bound, a call or stream
is one `grid.<handler>` span; its request frame carries the trace
context ("tc", grid/wire.py), the peer ships its span subtree back
("ts"), and the subtree is stitched under a `wire` span that splits
serialize, transit, peer queue and peer service time. A call that a
dead peer or a timeout cut closes its `wire` span with a `fault` tag.
Disarmed, the one `tracing.ACTIVE` check is a call's whole tracing cost
and its frames carry no trace bytes.
"""

from __future__ import annotations

import itertools
import queue
import random
import socket
import threading
import time
from typing import Iterator, Optional

from minio_tpu_torch.grid import chaos, loop, wire
from minio_tpu_torch.grid.wire import GridError, RemoteCallError
from minio_tpu_torch.utils import deadline as deadline_mod
from minio_tpu_torch.utils import tracing
from minio_tpu_torch.utils.deadline import DeadlineExceeded
from minio_tpu_torch.utils.env import env_num as _env_num

_SENTINEL_ERR = "__conn_lost__"
COOLDOWN_MAX = 15.0


class GridClient:
    def __init__(self, host: str, port: int, connect_timeout: float = 5.0,
                 call_timeout: float = 60.0, send_retries: int = 2,
                 retry_backoff: float = 0.05,
                 trip_after: Optional[int] = None,
                 cooldown: Optional[float] = None,
                 cooldown_max: Optional[float] = None):
        self.host = host
        self.port = port
        self.connect_timeout = connect_timeout
        self.call_timeout = call_timeout
        # Send-phase retries: connect/reset failures BEFORE a reply
        # could exist are transient (peer restarting, conn replaced)
        # and safe to retry — the request was never processed. Reply
        # timeouts and remote errors are NEVER retried here, and no
        # retry runs against an exhausted request deadline.
        self.send_retries = max(0, send_retries)
        self.retry_backoff = retry_backoff
        self._sock: Optional[socket.socket] = None
        self._mu = threading.Lock()          # guards connect + state maps
        # Socket writes serialize on their own lock, held per FRAME only:
        # registering new calls (and timing out old ones) never waits on
        # another call's in-flight sendall, and bulk transfers chunked
        # into frames let lock RPCs interleave between chunks
        # (reference: the grid/HTTP-stream split with frame-granular
        # scheduling, internal/grid/README.md).
        self._wmu = threading.Lock()
        self._mux = itertools.count(1)
        # mux -> (socket it was sent on, reply queue): a dying socket's
        # reader must only fail calls sent on THAT socket, never calls
        # already re-registered on a newer connection.
        self._pending: dict[int, tuple[socket.socket, "queue.Queue[dict]"]] \
            = {}
        # mux -> Credit for client-push (sink) streams; T_WIN grants
        # from the peer land here, never in the reply queue.
        self._credits: dict[int, loop.Credit] = {}
        # Monotonic stamp of the last frame received on the CURRENT
        # connection: a per-call timeout while other frames are still
        # flowing is that stream's problem (slow/hung handler), not
        # peer death — it must not feed the breaker or disturb the
        # other in-flight streams on the shared connection.
        self._last_rx = 0.0
        # -- circuit breaker (the drive-health breaker's twin) ----------
        self.trip_after = trip_after if trip_after is not None \
            else _env_num("MTPU_GRID_TRIP_AFTER", 3, int)
        self.cooldown = cooldown if cooldown is not None \
            else _env_num("MTPU_GRID_COOLDOWN", 0.5)
        self.cooldown_max = cooldown_max if cooldown_max is not None \
            else COOLDOWN_MAX
        self._consecutive = 0
        self._open_since = 0.0               # 0 = closed
        self._open_for = 0.0                 # current (jittered) cooldown
        self._probe_streak = 0               # consecutive failed probes
        self._half_open_probe = False
        self._probe_started = 0.0
        self._probe_owner = 0                # thread holding the probe
        # Monotonic counters (stats()).
        self.connects_total = 0
        self.reconnects_total = 0
        self._conn_attempted = False
        self.rpc_errors_total = 0
        self.breaker_opens_total = 0
        # Calls the open breaker failed without touching the network,
        # and the wall-clock times (time.time()) it opened at: what a
        # node's clean stop prints, to time the switch after a peer dies.
        self.fast_fails_total = 0
        self.opened_at: list[float] = []
        # Called when a live connection dies: the coherence plane
        # (grid/coherence.py) disarms the peer at once, not at its next
        # sync tick.
        self.on_conn_lost: list = []

    # -- breaker ---------------------------------------------------------

    # A half-open probe that never reports back (its caller's deadline
    # expired mid-call, or an abandoned stream) releases its slot after
    # this long, so one lost probe can never wedge the breaker open
    # against a healthy peer forever.
    PROBE_TTL = 30.0

    def _admit(self) -> None:
        """Fail fast while the breaker is open; let one probe through
        per cooldown window (half-open)."""
        with self._mu:
            if self._open_since == 0.0:
                return
            now = time.monotonic()
            if now - self._open_since < self._open_for:
                self.fast_fails_total += 1
                raise GridError(
                    f"peer {self.host}:{self.port}: circuit open")
            if self._half_open_probe and \
                    now - self._probe_started < self.PROBE_TTL:
                self.fast_fails_total += 1
                raise GridError(
                    f"peer {self.host}:{self.port}: circuit half-open, "
                    "probing")
            self._half_open_probe = True
            self._probe_started = now
            self._probe_owner = threading.get_ident()

    def _fault(self) -> None:
        with self._mu:
            self._consecutive += 1
            self.rpc_errors_total += 1
            if self._open_since != 0.0:
                # Failed half-open PROBE: restart the cooldown, doubled
                # (jittered, bounded) — the reconnect backoff. Without
                # the restart every call after the first cooldown would
                # become a probe and eat a connect timeout. Only the
                # probe OWNER's failure counts: stragglers admitted
                # before the breaker opened fault here as their
                # timeouts land, and letting them take this branch
                # would inflate the backoff toward the ceiling and
                # release a live probe's slot mid-flight.
                if not self._half_open_probe or \
                        self._probe_owner != threading.get_ident():
                    return
                self._half_open_probe = False
                self._probe_streak += 1
                self._open_since = time.monotonic()
                self._open_for = min(
                    self.cooldown * (2 ** self._probe_streak),
                    self.cooldown_max) * (0.75 + random.random() / 2)
            elif self._consecutive >= self.trip_after:
                self.breaker_opens_total += 1
                self.opened_at.append(time.time())
                self._open_since = time.monotonic()
                self._probe_streak = 0
                self._open_for = self.cooldown * \
                    (0.75 + random.random() / 2)

    def _ok(self) -> None:
        with self._mu:
            self._consecutive = 0
            self._open_since = 0.0
            self._open_for = 0.0
            self._probe_streak = 0
            self._half_open_probe = False

    def breaker_state(self) -> str:
        with self._mu:
            if self._open_since == 0.0:
                return "closed"
            if time.monotonic() - self._open_since >= self._open_for:
                return "half-open"
            return "open"

    def stats(self) -> dict:
        return {"peer": f"{self.host}:{self.port}",
                "state": self.breaker_state(),
                "connects": self.connects_total,
                "reconnects": self.reconnects_total,
                "rpc_errors": self.rpc_errors_total,
                "breaker_opens": self.breaker_opens_total,
                "fast_fails": self.fast_fails_total,
                "opened_at": list(self.opened_at)}

    # -- connection management -----------------------------------------

    def _connect_locked(self) -> None:
        if self._sock is not None:
            return
        # A "reconnect" is any successful connect that was not the
        # client's very first attempt — whether the previous connection
        # died or earlier attempts never got through.
        was_attempted = self._conn_attempted
        self._conn_attempted = True
        try:
            chaos.net("connect")
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.connect_timeout)
        except (OSError, chaos.ChaosInjected) as e:
            raise GridError(f"connect {self.host}:{self.port}: {e}") from None
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self.connects_total += 1
        if was_attempted:
            self.reconnects_total += 1
        self._last_rx = time.monotonic()
        # The process-wide grid poller owns the read side: no reader
        # thread a peer connection.
        loop.poller().register(
            s, on_msg=lambda m: self._on_frame(s, m),
            on_close=lambda: self._drop_conn(s))

    def _drop_conn(self, s) -> None:
        with self._mu:
            if self._sock is s:
                self._sock = None
            dead = [mux for mux, (sk, _) in self._pending.items() if sk is s]
            pending = [self._pending.pop(mux)[1] for mux in dead]
            credits = [self._credits.pop(mux) for mux in dead
                       if mux in self._credits]
        for q in pending:
            q.put({"t": wire.T_ERR, "e": _SENTINEL_ERR, "msg": "conn lost"})
        for cr in credits:
            cr.close()          # wake push senders parked on credit
        loop.discard(s)
        try:
            s.close()
        except OSError:
            pass
        for cb in self.on_conn_lost:
            try:
                cb()
            except Exception:  # noqa: BLE001 - observers must not break I/O
                pass

    def _on_frame(self, s, msg: dict) -> None:
        """Route one received frame (the poller's callback). Raw bulk
        frames arrive carrying a pooled lease; if no call claims them
        (the stream was abandoned) the lease is released here."""
        self._last_rx = time.monotonic()
        chaos.net("recv")
        t = msg.get("t")
        if t == wire.T_PING:
            with self._wmu:
                with self._mu:
                    live = self._sock is s
                if live:
                    s.sendall(wire.pack_frame({"t": wire.T_PONG}))
            return
        if t == wire.T_PONG:
            return
        if t == wire.T_WIN:
            with self._mu:
                cr = self._credits.get(msg.get("m"))
            if cr is not None:
                cr.grant(msg.get("n", 0))
            return
        ent = self._pending.get(msg.get("m"))
        if ent is not None:
            ent[1].put(msg)
        else:
            lease = msg.get("lease")
            if lease is not None:
                lease.release()

    def close(self) -> None:
        with self._mu:
            s, self._sock = self._sock, None
        if s is not None:
            loop.discard(s)
            try:
                s.close()
            except OSError:
                pass

    # -- calls ---------------------------------------------------------

    def _send(self, msg: dict, mux: int, q, tstats=None) -> None:
        if tstats is None:
            frame = wire.pack_frame(msg)
        else:
            # An armed call times the encode, so that its wire span can
            # split serialize out of transit.
            t_ser = time.perf_counter()
            frame = wire.pack_frame(msg)
            tstats["ser"] = time.perf_counter() - t_ser
        with self._mu:
            self._connect_locked()
            s = self._sock
            self._pending[mux] = (s, q)
        try:
            with self._wmu:
                chaos.net("send")
                # Re-check under the write lock: a concurrent failure
                # may have replaced the connection after registration.
                with self._mu:
                    if self._sock is not s:
                        raise OSError("connection replaced")
                s.sendall(frame)
        except (OSError, chaos.ChaosInjected) as e:
            with self._mu:
                self._pending.pop(mux, None)
            # Drop the connection fully (close the socket so the parked
            # reader thread exits, fail other calls in flight on it).
            self._drop_conn(s)
            raise GridError(
                f"send to {self.host}:{self.port}: {e}") from None

    def _finish(self, mux: int) -> None:
        with self._mu:
            self._pending.pop(mux, None)

    def _send_with_retry(self, kind: int, handler: str, payload,
                         window: Optional[int] = None,
                         tc: Optional[dict] = None, tstats=None):
        """Send one request frame, retrying transient connect/send
        failures with jittered exponential backoff. Returns (mux, q).

        Only the SEND phase retries: a frame that failed to leave (or
        a connection that died while it left) was never answered, so
        re-sending cannot double-apply. Retries stop the moment the
        bound request deadline cannot afford another attempt — and the
        moment the breaker opens (a dead peer costs ONE fast failure,
        not a connect timeout per attempt per call)."""
        dl = deadline_mod.current()
        last: Optional[GridError] = None
        for attempt in range(self.send_retries + 1):
            if attempt:
                delay = self.retry_backoff * (2 ** (attempt - 1)) \
                    * (0.5 + random.random())
                if dl is not None and dl.remaining() <= delay:
                    break           # no budget for a backoff: surface
                time.sleep(delay)
            if dl is not None and dl.expired():
                raise DeadlineExceeded(
                    f"deadline exceeded calling {handler} on "
                    f"{self.host}:{self.port}")
            self._admit()
            mux = next(self._mux)
            q: "queue.Queue[dict]" = queue.Queue()
            msg = {"t": kind, "m": mux, "h": handler, "p": payload}
            if window:
                msg["w"] = window
            if tc is not None:
                msg["tc"] = tc
            try:
                self._send(msg, mux, q, tstats)
                return mux, q
            except RemoteCallError:
                raise
            except GridError as e:
                self._fault()
                last = e
        raise last if last is not None else GridError(
            f"send {handler} to {self.host}:{self.port} failed")

    def _rx_live(self, mux: int, window: float) -> bool:
        """True when the call's connection is still the current one
        AND received any frame within `window` seconds — the transport
        is provably alive, so this call's timeout is its own handler's
        problem (slow stream, hung verb), not peer death."""
        with self._mu:
            ent = self._pending.get(mux)
            if ent is None or ent[0] is not self._sock:
                return False
        return (time.monotonic() - self._last_rx) < window

    def _recv(self, q, handler: str, wait: Optional[float],
              mux: Optional[int] = None):
        """One reply frame, waiting at most min(wait, deadline left)."""
        wait = wait or self.call_timeout
        dl = deadline_mod.current()
        eff = wait if dl is None else dl.clamp(wait)
        try:
            return q.get(timeout=eff)
        except queue.Empty:
            if dl is not None and eff < wait:
                # The caller's budget ran out before the peer's window
                # did — the request's problem, never breaker fuel. If
                # THIS thread holds the half-open probe slot, release
                # it (no verdict either way) so the next call can
                # probe; a non-probe call must not release someone
                # else's slot (two concurrent probes would each pay a
                # connect timeout and double the backoff). Probes
                # whose stream is pulled from another thread fall to
                # the PROBE_TTL backstop in _admit.
                with self._mu:
                    if self._half_open_probe and \
                            self._probe_owner == threading.get_ident():
                        self._half_open_probe = False
                raise DeadlineExceeded(
                    f"deadline exceeded awaiting {handler} from "
                    f"{self.host}:{self.port}") from None
            if mux is not None and self._rx_live(mux, max(eff, 1.0)):
                # Per-STREAM failure accounting: other frames are still
                # flowing on the shared connection, so only THIS call
                # failed. Counted, but never breaker fuel — tripping
                # the breaker here would fail the unrelated in-flight
                # streams sharing the socket for one slow handler.
                with self._mu:
                    self.rpc_errors_total += 1
                raise GridError(
                    f"call {handler} to {self.host}:{self.port} timed "
                    "out (connection live)") from None
            self._fault()
            raise GridError(
                f"call {handler} to {self.host}:{self.port} timed out") \
                from None

    def call(self, handler: str, payload=None,
             timeout: Optional[float] = None):
        """Unary call; raises RemoteCallError with the remote's code.
        Disarmed, the `tracing.ACTIVE` check is its whole tracing cost."""
        if tracing.ACTIVE and tracing.current() is not None:
            return self._call_traced(handler, payload, timeout)
        mux, q = self._send_with_retry(wire.T_REQ, handler, payload)
        try:
            msg = self._recv(q, handler, timeout, mux)
            if msg["t"] == wire.T_RESP:
                self._ok()
                return msg.get("p")
            code = msg.get("e", "Internal")
            if code == _SENTINEL_ERR:
                self._fault()
                raise GridError("connection lost mid-call")
            # The peer ANSWERED — its handler raised. Healthy
            # transport; never breaker fuel.
            self._ok()
            raise RemoteCallError(code, msg.get("msg", ""))
        finally:
            self._finish(mux)

    @staticmethod
    def _trace_tc(ctx, parent: int) -> dict:
        tc = {"i": ctx.trace_id, "s": parent, "a": 1}
        if tracing.NODE:
            tc["n"] = tracing.NODE
        return tc

    def _wire_tags(self, total_ms: float, ser_ms: float, ts,
                   fault: Optional[str]) -> dict:
        """The `wire` span's tags: the peer, and the timing split from
        the reply's piggyback, or the fault that cut the call."""
        tags = {"peer": f"{self.host}:{self.port}"}
        if ser_ms is not None:
            tags["serialize_ms"] = round(ser_ms, 3)
        if fault is not None:
            tags["fault"] = fault
        elif ts:
            q_ms = float(ts.get("q", 0.0))
            v_ms = float(ts.get("v", 0.0))
            tags["peer_queue_ms"] = round(q_ms, 3)
            tags["peer_service_ms"] = round(v_ms, 3)
            tags["transit_ms"] = round(
                max(0.0, total_ms - (ser_ms or 0.0) - q_ms - v_ms), 3)
        return tags

    def _stitch(self, ctx, t_wall: float, t0: float, tstats: dict,
                ts: Optional[dict], fault: Optional[str] = None) -> None:
        """Record the `wire` span under the current parent (the call's
        grid.<handler> span) and graft the peer's shipped subtree into
        it; with `fault` (the transport cut the call) the fault is
        annotated instead, so a partition still closes the tree."""
        total_ms = (time.monotonic() - t0) * 1000.0
        tags = self._wire_tags(total_ms, tstats.get("ser", 0.0) * 1000.0,
                               ts, fault)
        tracing.stitch_wire(ctx, tracing.current_parent(), t_wall,
                            total_ms, tags, None if fault else ts)

    def _call_traced(self, handler: str, payload,
                     timeout: Optional[float]):
        """call() under an armed, bound trace: the request frame
        carries the trace context, the peer runs its handler's spans
        under it and ships the subtree back, and the reply is stitched
        into this request's tree. A stale reply never stitches:
        _finish() unregisters the mux before its queue is dropped."""
        ctx = tracing.current()
        with tracing.span("grid", f"grid.{handler}",
                          {"peer": f"{self.host}:{self.port}"}):
            tc = self._trace_tc(ctx, tracing.current_parent())
            tstats: dict = {}
            t_wall = time.time()
            t0 = time.monotonic()
            try:
                mux, q = self._send_with_retry(
                    wire.T_REQ, handler, payload, tc=tc, tstats=tstats)
            except (DeadlineExceeded, GridError) as e:
                self._stitch(ctx, t_wall, t0, tstats, None,
                             fault=type(e).__name__)
                raise
            try:
                try:
                    msg = self._recv(q, handler, timeout, mux)
                except (DeadlineExceeded, GridError) as e:
                    self._stitch(ctx, t_wall, t0, tstats, None,
                                 fault=type(e).__name__)
                    raise
                if msg["t"] == wire.T_RESP:
                    self._stitch(ctx, t_wall, t0, tstats, msg.get("ts"))
                    self._ok()
                    return msg.get("p")
                code = msg.get("e", "Internal")
                if code == _SENTINEL_ERR:
                    self._stitch(ctx, t_wall, t0, tstats, None,
                                 fault="conn_lost")
                    self._fault()
                    raise GridError("connection lost mid-call")
                # The peer answered: its handler raised, and its spans
                # up to the raise still stitch.
                self._stitch(ctx, t_wall, t0, tstats, msg.get("ts"))
                self._ok()
                raise RemoteCallError(code, msg.get("msg", ""))
            finally:
                self._finish(mux)

    def _grant(self, s, mux: int, n: int) -> None:
        """Replenish a response stream's credit window (best-effort:
        a failed grant means the connection is dying and the stream
        will fail through its sentinel)."""
        try:
            frame = wire.pack_frame({"t": wire.T_WIN, "m": mux, "n": n})
            with self._wmu:
                with self._mu:
                    if self._sock is not s:
                        return
                s.sendall(frame)
        except OSError:
            pass

    def stream(self, handler: str, payload=None,
               timeout: Optional[float] = None,
               raw: bool = False) -> Iterator:
        """Streaming call: yields items until EOF. Raises on error.

        The open frame advertises a credit window and consumed chunks
        are acknowledged back (T_WIN) as this iterator is pulled: a
        stream nobody drains stalls the SENDER after one window instead
        of ballooning frames into this process, and bulk streams can't
        head-of-line-block lock traffic. With raw=True, raw bulk frames
        are yielded as (payload, lease) pairs: payload is a memoryview
        into a pooled buffer and the caller MUST release() the lease.
        With raw=False they are flattened to bytes and the lease is
        released here.

        Armed and bound, the open frame carries the trace context and
        the peer ships its subtree back on the EOF or error frame. The
        `grid.<handler>` span is recorded at close (a generator's `with`
        would leave the thread's parent pointing into this stream
        between pulls); it covers the send through the EOF or
        abandonment, with the chunk count in its tags."""
        window = loop.STREAM_WINDOW
        t_wall = time.time()
        t0 = time.monotonic()
        chunks = 0
        ctx, parent = tracing.capture() if tracing.ACTIVE else (None, 0)
        tc = self._trace_tc(ctx, parent) if ctx is not None else None
        ts: Optional[dict] = None
        fault: Optional[str] = None
        try:
            mux, q = self._send_with_retry(wire.T_SREQ, handler, payload,
                                           window=window, tc=tc)
        except (DeadlineExceeded, GridError) as e:
            if ctx is not None:
                self._stream_spans(ctx, parent, handler, t_wall, t0, 0,
                                   None, type(e).__name__)
            raise
        with self._mu:
            ent = self._pending.get(mux)
        s = ent[0] if ent is not None else None
        pulled = 0
        try:
            while True:
                msg = self._recv(q, handler, timeout, mux)
                t = msg["t"]
                if t == wire.T_CHUNK:
                    chunks += 1
                    pulled += 1
                    if pulled >= max(1, window // 2):
                        self._grant(s, mux, pulled)
                        pulled = 0
                    lease = msg.get("lease")
                    if msg.get("raw"):
                        if raw:
                            yield msg.get("p"), lease
                        else:
                            p = bytes(msg.get("p") or b"")
                            if lease is not None:
                                lease.release()
                            yield p
                    else:
                        yield msg.get("p")
                elif t == wire.T_EOF:
                    ts = msg.get("ts")
                    self._ok()
                    return
                else:
                    ts = msg.get("ts")
                    code = msg.get("e", "Internal")
                    if code == _SENTINEL_ERR:
                        ts, fault = None, "conn_lost"
                        self._fault()
                        raise GridError("connection lost mid-stream")
                    self._ok()
                    raise RemoteCallError(code, msg.get("msg", ""))
        except RemoteCallError:
            raise               # the peer answered: its subtree stitches
        except (DeadlineExceeded, GridError) as e:
            if fault is None:
                ts, fault = None, type(e).__name__
            raise
        finally:
            self._finish(mux)
            if ctx is not None:
                self._stream_spans(ctx, parent, handler, t_wall, t0,
                                   chunks, ts, fault)

    def _stream_spans(self, ctx, parent: int, handler: str, t_wall: float,
                      t0: float, chunks: int, ts, fault) -> None:
        """A stream's grid.<handler> span and, under it, its `wire` span
        with the peer's subtree (or the fault that cut it)."""
        dur = (time.monotonic() - t0) * 1000.0
        peer = f"{self.host}:{self.port}"
        sid = tracing.record_span(
            ctx, parent, "grid", f"grid.{handler}", t_wall, dur,
            tags={"peer": peer, "stream": 1, "chunks": chunks})
        tracing.stitch_wire(ctx, sid, t_wall, dur,
                            self._wire_tags(dur, None, ts, fault),
                            None if fault else ts)

    def push_raw(self, handler: str, payload, items,
                 timeout: Optional[float] = None):
        """Client-push stream: open a sink stream, ship `items`
        (bytes-like buffers) as raw bulk frames sliced straight off
        memoryviews, then await the handler's unary result.
        Flow-controlled: the receiver grants credit as its handler
        drains frames, so a slow remote drive stalls this sender instead
        of ballooning its staging queues."""
        window = loop.STREAM_WINDOW
        stall = loop.STREAM_STALL_S
        mux, q = self._send_with_retry(wire.T_SREQ, handler, payload,
                                       window=window)
        with self._mu:
            ent = self._pending.get(mux)
            s = ent[0] if ent is not None else None
            credit = loop.Credit(window)
            self._credits[mux] = credit
        try:
            try:
                for item in items:
                    loop.send_raw_buf(s, self._wmu, mux, item, credit, stall)
                eof = wire.pack_frame({"t": wire.T_EOF, "m": mux})
                with self._wmu:
                    chaos.net("send")
                    s.sendall(eof)
            except (OSError, chaos.ChaosInjected) as e:
                self._drop_conn(s)
                self._fault()
                raise GridError(
                    f"push {handler} to {self.host}:{self.port}: {e}") \
                    from None
            msg = self._recv(q, handler, timeout, mux)
            if msg["t"] == wire.T_RESP:
                self._ok()
                return msg.get("p")
            code = msg.get("e", "Internal")
            if code == _SENTINEL_ERR:
                self._fault()
                raise GridError("connection lost mid-push")
            self._ok()
            raise RemoteCallError(code, msg.get("msg", ""))
        finally:
            self._finish(mux)
            with self._mu:
                self._credits.pop(mux, None)

    def ping(self, timeout: float = 2.0) -> bool:
        try:
            self.call("grid.ping", None, timeout=timeout)
            return True
        except GridError:
            return False


# One client per peer address, shared process-wide (the reference's
# "single connection per node pair").
_clients: dict[tuple[str, int], GridClient] = {}
_clients_mu = threading.Lock()


def client_for(host: str, port: int) -> GridClient:
    key = (host, port)
    with _clients_mu:
        c = _clients.get(key)
        if c is None:
            c = _clients[key] = GridClient(host, port)
        return c


def peer_stats() -> list[dict]:
    """Breaker and counter snapshot of every shared peer client."""
    with _clients_mu:
        clients = list(_clients.values())
    return [c.stats() for c in clients]

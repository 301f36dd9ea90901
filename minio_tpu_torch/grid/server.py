"""Grid server: accepts peer connections, dispatches registered handlers.

The port of minio_tpu/grid/server.py (reference handler registry and
muxServer, internal/grid/handlers.go:42-101, muxserver.go). Unary
handlers return a payload of the control frames' subset
(utils/mpack.py); stream handlers are generators whose items go out as
chunk frames, or as raw bulk frames for wire.RawFile (os.sendfile
straight from the drive's fd) and wire.RawBytes items. Sink handlers
take a client-push stream of bulk frames and return one unary result.
A handler's exception goes back as the wire code of its class
(ERROR_CODES, which storage/remote.py and dsync extend), so the remote
client raises the storage exception the local call would have.

Accepted connections park on the process-wide grid poller
(grid/loop.py), and a response stream opened with a credit window ("w"
in the open frame) pauses after `window` unacknowledged frames: a walk
whose client stopped draining stalls in its worker slot instead of
head-of-line-blocking lock traffic.

A request frame that carries a trace context ("tc", an armed caller)
runs its handler under a context seeded with the caller's trace id,
armed for that call alone; the handler's spans ship back on the reply,
the EOF or the error frame ("ts", at most MTPU_TRACE_REMOTE_MAX
spans), with the frame's wait for a worker and the handler's service
time. A frame without "tc" costs no tracing work at all.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

from minio_tpu_torch.grid import chaos, loop, wire
from minio_tpu_torch.utils import tracing

# exception class -> wire code (extended by storage/remote.py, dsync).
ERROR_CODES: dict[type, str] = {}


def register_error(exc_type: type, code: str) -> None:
    ERROR_CODES[exc_type] = code


def _code_for(e: Exception) -> str:
    for t in type(e).__mro__:
        if t in ERROR_CODES:
            return ERROR_CODES[t]
    return "Internal"


class _ConnState:
    """Per-connection server state shared by the frame source (poller
    callback or reader thread) and the handler pool."""

    __slots__ = ("sock", "wlock", "sinks", "credits", "mu")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.wlock = threading.Lock()
        self.mu = threading.Lock()
        # mux -> input queue for a running sink handler
        self.sinks: dict[int, "queue_mod.Queue[dict]"] = {}
        # mux -> Credit for a flow-controlled response stream
        self.credits: dict[int, loop.Credit] = {}

    def send(self, msg: dict) -> None:
        blob = wire.pack_frame(msg)
        with self.wlock:
            chaos.net("send")
            self.sock.sendall(blob)

    def close(self) -> None:
        """Fail everything parked on this connection: sink handlers
        get a conn-lost sentinel, stream senders parked on credit wake
        with failure."""
        with self.mu:
            sinks = list(self.sinks.values())
            credits = list(self.credits.values())
            self.sinks.clear()
            self.credits.clear()
        for q in sinks:
            q.put({"t": wire.T_ERR, "e": "Internal",
                   "msg": "connection lost"})
        for cr in credits:
            cr.close()


class GridServer:
    def __init__(self, port: int, host: str = "0.0.0.0",
                 max_workers: int = 32):
        self.host = host
        self.port = port
        self._handlers: dict[str, Callable] = {}
        self._streams: dict[str, Callable] = {}
        self._sinks: dict[str, Callable] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._conns: dict[socket.socket, _ConnState] = {}
        self.register("grid.ping", lambda p: "pong")

    def register(self, name: str, fn: Callable) -> None:
        self._handlers[name] = fn

    def register_stream(self, name: str, fn: Callable) -> None:
        self._streams[name] = fn

    def register_sink(self, name: str, fn: Callable) -> None:
        """fn(payload, frames) -> result: `frames` iterates the pushed
        bulk payloads (memoryviews into pooled leases, released as the
        iterator advances); the return value answers the push as one
        unary result."""
        self._sinks[name] = fn

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(64)
        self._sock = s
        if self.port == 0:
            self.port = s.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        self._stopping.set()
        if self._sock is not None:
            try:
                # shutdown() wakes the thread blocked in accept(); a bare
                # close() would leave the fd (and the LISTEN socket) alive
                # until accept returned.
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for conn, state in list(self._conns.items()):
            # shutdown() before close(): it sends the FIN at once, so
            # peers see the connection end instead of parking on a
            # half-dead one.
            loop.discard(conn)
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            state.close()
        self._pool.shutdown(wait=False)

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            state = _ConnState(conn)
            self._conns[conn] = state
            # The shared epoll poller owns the read side: no reader
            # thread an accepted connection.
            loop.poller().register(
                conn,
                on_msg=lambda m, st=state: self._handle_msg(st, m),
                on_close=lambda st=state: self._conn_closed(st))

    # -- per-connection ------------------------------------------------

    def _conn_closed(self, state: _ConnState) -> None:
        self._conns.pop(state.sock, None)
        state.close()
        try:
            state.sock.close()
        except OSError:
            pass

    def _handle_msg(self, state: _ConnState, msg: dict) -> None:
        """One inbound frame (the poller's callback). Raises to drop
        the connection."""
        # Node-level chaos (tests/torch_cluster.py): a blackholed
        # node's server side drops the connection; "drop" mode swallows
        # request frames silently so callers time out (the
        # asymmetric-partition shape).
        chaos.net("recv")
        t = msg.get("t")
        if t in (wire.T_REQ, wire.T_SREQ) and chaos.drop_inbound():
            return
        if t in (wire.T_REQ, wire.T_SREQ) and "tc" in msg:
            # An armed caller: the frame's receipt, so that the reply
            # reports its wait for a worker apart from the handler.
            msg["_rx"] = time.monotonic()
        if t == wire.T_PING:
            state.send({"t": wire.T_PONG})
        elif t == wire.T_REQ:
            self._pool.submit(self._run_unary, state.send, msg)
        elif t == wire.T_SREQ:
            if msg.get("h", "") in self._sinks:
                q: "queue_mod.Queue[dict]" = queue_mod.Queue()
                with state.mu:
                    state.sinks[msg.get("m")] = q
                self._pool.submit(self._run_sink, state, msg, q)
            else:
                self._pool.submit(self._run_stream, state, msg)
        elif t == wire.T_WIN:
            with state.mu:
                cr = state.credits.get(msg.get("m"))
            if cr is not None:
                cr.grant(msg.get("n", 0))
        elif t in (wire.T_CHUNK, wire.T_EOF):
            # Client-push frames for a running sink handler.
            with state.mu:
                q = state.sinks.get(msg.get("m"))
            if q is not None:
                q.put(msg)
            else:
                lease = msg.get("lease")
                if lease is not None:
                    lease.release()

    def _run_unary(self, send, msg: dict) -> None:
        mux = msg.get("m")
        fn = self._handlers.get(msg.get("h", ""))
        try:
            if fn is None:
                send({"t": wire.T_ERR, "m": mux, "e": "NoSuchHandler",
                      "msg": str(msg.get("h"))})
                return
            if "tc" not in msg:
                out = fn(msg.get("p"))
                send({"t": wire.T_RESP, "m": mux, "p": out})
                return
            tctx, t_start, q_ms = self._trace_open(msg)
            err = None
            try:
                with tracing.bind(tctx, 0):
                    out = fn(msg.get("p"))
            except Exception as e:  # noqa: BLE001 - shipped as T_ERR
                err = e
            finally:
                tracing.disarm(tctx)
            ts = self._trace_ship(tctx, t_start, q_ms)
            if err is None:
                send({"t": wire.T_RESP, "m": mux, "p": out, "ts": ts})
            else:
                send({"t": wire.T_ERR, "m": mux, "e": _code_for(err),
                      "msg": str(err)[:512], "ts": ts})
        except Exception as e:  # noqa: BLE001 - mapped onto the wire
            try:
                send({"t": wire.T_ERR, "m": mux, "e": _code_for(e),
                      "msg": str(e)[:512]})
            except OSError:
                pass

    @staticmethod
    def _trace_open(msg: dict):
        """(ctx, start, queue ms) of an armed caller's call: a context
        seeded with the caller's trace id, armed for this call only
        (the context is its own arm token)."""
        tc = msg.get("tc") or {}
        rx = msg.get("_rx")
        ctx = tracing.TraceContext(trace_id=str(tc.get("i", "")))
        t_start = time.monotonic()
        q_ms = (t_start - rx) * 1000.0 if rx is not None else 0.0
        tracing.arm(ctx)
        return ctx, t_start, q_ms

    @staticmethod
    def _trace_ship(ctx, t_start: float, q_ms: float) -> dict:
        """The reply's "ts": the handler's spans (capped), its queue
        wait and service, and this node's name."""
        ts = tracing.export_spans(ctx)
        ts["q"] = round(max(0.0, q_ms), 3)
        ts["v"] = round((time.monotonic() - t_start) * 1000.0, 3)
        if tracing.NODE:
            ts["node"] = tracing.NODE
        return ts

    # -- response streams ----------------------------------------------

    def _run_stream(self, state: _ConnState, msg: dict) -> None:
        mux = msg.get("m")
        fn = self._streams.get(msg.get("h", ""))
        window = msg.get("w")
        credit: Optional[loop.Credit] = None
        if window:
            credit = loop.Credit(int(window))
            with state.mu:
                state.credits[mux] = credit
        stall = loop.STREAM_STALL_S
        # An armed caller: the generator's spans record under the
        # shipped context and go back on the EOF or error frame.
        tctx = None
        t_start = q_ms = 0.0
        if "tc" in msg and fn is not None:
            tctx, t_start, q_ms = self._trace_open(msg)
        try:
            if fn is None:
                state.send({"t": wire.T_ERR, "m": mux,
                            "e": "NoSuchHandler", "msg": str(msg.get("h"))})
                return
            with tracing.bind(tctx, 0):
                for item in fn(msg.get("p")):
                    if isinstance(item, wire.RawFile):
                        self._send_raw_file(state, mux, item, credit,
                                            stall)
                    elif isinstance(item, wire.RawBytes):
                        loop.send_raw_buf(state.sock, state.wlock, mux,
                                          item.data, credit, stall)
                    else:
                        if credit is not None and not credit.take(stall):
                            raise wire.GridError(
                                "stream credit stall "
                                "(receiver not draining)")
                        state.send({"t": wire.T_CHUNK, "m": mux,
                                    "p": item})
            eof = {"t": wire.T_EOF, "m": mux}
            if tctx is not None:
                eof["ts"] = self._trace_ship(tctx, t_start, q_ms)
            state.send(eof)
        except Exception as e:  # noqa: BLE001 - mapped onto the wire
            try:
                errf = {"t": wire.T_ERR, "m": mux, "e": _code_for(e),
                        "msg": str(e)[:512]}
                if tctx is not None:
                    errf["ts"] = self._trace_ship(tctx, t_start, q_ms)
                state.send(errf)
            except OSError:
                pass
        finally:
            if tctx is not None:
                tracing.disarm(tctx)
            if credit is not None:
                with state.mu:
                    state.credits.pop(mux, None)

    @staticmethod
    def _send_raw_file(state: _ConnState, mux: int, item: wire.RawFile,
                       credit: Optional[loop.Credit],
                       stall: float) -> None:
        with open(item.path, "rb") as f:
            length = item.length
            if length < 0:
                length = max(0,
                             os.fstat(f.fileno()).st_size - item.offset)
            loop.send_raw_fd(state.sock, state.wlock, mux, f.fileno(),
                             item.offset, length, credit, stall)

    # -- client-push sinks ---------------------------------------------

    def _run_sink(self, state: _ConnState, msg: dict,
                  q: "queue_mod.Queue[dict]") -> None:
        mux = msg.get("m")
        fn = self._sinks[msg.get("h", "")]
        window = int(msg.get("w") or 0)
        stall = loop.STREAM_STALL_S
        consumed = [0]

        def granted() -> None:
            # Replenish the pusher's window as frames are drained,
            # batched at half a window (best-effort: a failed grant
            # means the connection is dying).
            consumed[0] += 1
            if window and consumed[0] >= max(1, window // 2):
                n, consumed[0] = consumed[0], 0
                try:
                    state.send({"t": wire.T_WIN, "m": mux, "n": n})
                except OSError:
                    pass

        try:
            out = fn(msg.get("p"), self._sink_frames(q, stall, granted))
            state.send({"t": wire.T_RESP, "m": mux, "p": out})
        except Exception as e:  # noqa: BLE001 - mapped onto the wire
            try:
                state.send({"t": wire.T_ERR, "m": mux, "e": _code_for(e),
                            "msg": str(e)[:512]})
            except OSError:
                pass
        finally:
            with state.mu:
                state.sinks.pop(mux, None)
            # Release leases of frames the handler never consumed.
            while True:
                try:
                    m2 = q.get_nowait()
                except queue_mod.Empty:
                    break
                lease = m2.get("lease")
                if lease is not None:
                    lease.release()

    @staticmethod
    def _sink_frames(q: "queue_mod.Queue[dict]", stall: float,
                     granted: Callable[[], None]) -> Iterator:
        """Iterate pushed payloads; each frame's pooled lease is
        released when the consumer advances past it."""
        while True:
            try:
                msg = q.get(timeout=stall)
            except queue_mod.Empty:
                raise wire.GridError(
                    "push stream stalled (sender gone?)") from None
            t = msg.get("t")
            if t == wire.T_EOF:
                return
            if t == wire.T_ERR:
                raise wire.GridError(msg.get("msg", "push stream failed"))
            lease = msg.get("lease")
            try:
                yield msg.get("p")
            finally:
                if lease is not None:
                    lease.release()
            granted()

"""Event-loop connection plane: an epoll front end for many connections.

The port of minio_tpu/s3/eventloop.py. The thread-per-connection front
end (ThreadingHTTPServer) spends a thread on every OPEN connection: at
an SDK connection pool's fan-in the connection count, not the cost of a
request, is the wall. This module serves each process (each pre-forked
worker of io/workers.py) from one epoll loop:

  * idle connections PARK in one epoll set at the cost of a file
    descriptor and a small Python object: their pooled recv buffer
    (s3/hotloop.ConnReader) is returned whenever it is empty, so idle
    keep-alive connections hold no recv lease;
  * a readable socket drains non-blocking into its ConnReader until a
    COMPLETE request head is framed; only then does the request go to a
    bounded executor running the handler (a partial head never holds a
    thread: a slowloris client is reaped by the idle deadline while
    parked);
  * a framed plain GET of an object resident in the hot-object cache is
    answered on the loop thread itself (the handler's loop_hot_probe),
    with non-blocking sends and the rest of a response left to EPOLLOUT;
  * keep-alive turnaround RE-PARKS the descriptor instead of pinning a
    thread; pipelined requests already buffered are served back to back
    on one dispatch, 32 at most;
  * a response's FINAL write stops at EAGAIN: the remainder is copied
    (a GET's pooled windows return when its stream closes) and handed to
    the loop's EPOLLOUT drain, and the executor thread goes back to the
    pool (`offload_final`);
  * past MTPU_MAX_CONNS open connections the loop answers an accept with
    an immediate 503 + Retry-After and closes it, before any byte is
    read, so request admission (s3/admission.py) never sees the flood;
  * shutdown() stops accepting, closes the parked connections, and lets
    the dispatched requests and the response tails in flight finish (up
    to DRAIN_S seconds) before the loop stops.

No call to the card or the drives runs on the loop thread: the handler's
work runs on the executor, the hot probe copies nothing but the
resident entry's buffers to the socket.

A dispatched request reads its body and writes its response under the
same deadline, between bytes: a body that stalls past it closes its
connection and gives the executor thread back, so stalled uploads cannot
hold every thread while other requests (health probes, admin) wait.

Environment:
  MTPU_HTTP_EVENTLOOP  "off"/"0"/"false" serves thread-per-connection
                       instead (non-Linux hosts always do)
  MTPU_MAX_CONNS       open-connection cap a process (default: the soft
                       RLIMIT_NOFILE less 512, at least 64)
  MTPU_HTTP_KEEPALIVE_S  idle deadline of a parked connection and of a
                       dispatched request's body reads, the thread
                       path's too (default 75; <= 0 never reaps)
"""

from __future__ import annotations

import collections
import os
import queue
import select
import socket
import sys
import threading
import time

from minio_tpu_torch.s3 import hotloop
from minio_tpu_torch.utils.env import env_int
from minio_tpu_torch.utils.latency import Histogram

_LISTEN_BACKLOG = 1024
_REAP_INTERVAL = 1.0
# Pipelined requests served a dispatch before the connection gives its
# executor thread back (fairness under a pipelining client).
_PIPELINE_BURST = 32
# Seconds shutdown() lets dispatched requests and response tails finish.
DRAIN_S = 10.0
# Executor threads a process: the handlers of requests in flight.
EXECUTOR_THREADS = max(8, 4 * (os.cpu_count() or 1))

# The answer to an accept past MTPU_MAX_CONNS, sent before any byte is
# read.
_SHED_RESPONSE = (b"HTTP/1.1 503 Service Unavailable\r\n"
                  b"Retry-After: 1\r\nContent-Length: 0\r\n"
                  b"Connection: close\r\n\r\n")

# _Conn states.
_PARKED = 0        # in the epoll set, waiting for bytes
_DISPATCHED = 1    # an executor thread owns the socket
_WRITING = 2       # the loop owns a response tail (EPOLLOUT drain)


def loop_enabled() -> bool:
    """MTPU_HTTP_EVENTLOOP kill switch and platform gate (epoll is
    Linux; other platforms keep the thread path)."""
    if os.environ.get("MTPU_HTTP_EVENTLOOP", "").lower() in ("off", "0",
                                                             "false"):
        return False
    return hasattr(select, "epoll")


def default_max_conns() -> int:
    """The connection cap: the soft fd limit less headroom for drives,
    pools and the grid."""
    try:
        import resource
        soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    except (ImportError, OSError, ValueError):
        soft = 1024
    if soft <= 0 or soft >= (1 << 30):      # RLIM_INFINITY
        soft = 1 << 20
    return max(64, soft - 512)


_EXIT = object()                 # _Executor's release sentinel


class _Executor:
    """Bounded lazy pool of DAEMON threads (ThreadPoolExecutor threads
    are not daemons and would hold the interpreter's exit; the drain on
    stop is the server's, not thread joins)."""

    def __init__(self, max_workers: int):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._max = max(1, max_workers)
        self._mu = threading.Lock()
        self.threads = 0
        self._idle = 0
        self._pending = 0

    def submit(self, fn) -> None:
        # Spawn while queued tasks outnumber the threads waiting in
        # get(): a burst of submits must not queue behind one idle
        # thread that has not woken yet.
        with self._mu:
            self._pending += 1
            spawn = self._pending > self._idle and self.threads < self._max
            if spawn:
                self.threads += 1
        if spawn:
            try:
                threading.Thread(target=self._run, daemon=True,
                                 name="loop-exec").start()
            except RuntimeError:
                # No thread to be had: with one live thread the task
                # still drains; with none the dispatch fails (the caller
                # closes that connection only).
                with self._mu:
                    self.threads -= 1
                    if self.threads == 0:
                        self._pending -= 1
                        raise
        self._q.put(fn)

    def _run(self) -> None:
        while True:
            with self._mu:
                self._idle += 1
            fn = self._q.get()
            if fn is _EXIT:
                with self._mu:
                    self._idle -= 1
                    self.threads -= 1
                return
            with self._mu:
                self._idle -= 1
                self._pending -= 1
            try:
                fn()
            except Exception:  # noqa: BLE001 - a task must not kill a thread
                pass

    def shutdown(self) -> None:
        """One exit sentinel a live thread, queued behind the tasks left
        (FIFO), once the loop no longer submits."""
        with self._mu:
            n = self.threads
        for _ in range(n):
            self._q.put(_EXIT)

    def depth(self) -> int:
        return self._q.qsize()


class _Conn:
    __slots__ = ("sock", "fd", "handler", "reader", "state", "registered",
                 "last_activity", "pending", "close_after_write")

    def __init__(self, sock, fd, handler, reader):
        self.sock = sock
        self.fd = fd
        self.handler = handler
        self.reader = reader               # hotloop.ConnReader
        self.state = _PARKED
        self.registered = False
        self.last_activity = time.monotonic()
        self.pending = None                # a loop-owned response tail
        self.close_after_write = False


class EventLoopServer:
    """epoll accept and dispatch, with the subset of ThreadingHTTPServer
    that S3Server drives (server_address, serve_forever, shutdown,
    server_close). The handler class gives the loop its hooks:
    `loop_keepalive_s` (the idle deadline) and `loop_hot_probe`
    (handler, head) -> (bufs, close) or None."""

    def __init__(self, server_address, HandlerClass, reuse_port: bool,
                 keepalive_s: float | None):
        self.handler_cls = HandlerClass
        self.keepalive_s = keepalive_s
        self.max_conns = env_int("MTPU_MAX_CONNS", default_max_conns())
        self._hot_probe = getattr(HandlerClass, "loop_hot_probe", None)
        self.socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self.socket.bind(server_address)
        self.server_address = self.socket.getsockname()
        self.socket.listen(_LISTEN_BACKLOG)
        self.socket.setblocking(False)
        self._epoll = select.epoll()
        self._wr, self._ww = os.pipe()
        os.set_blocking(self._wr, False)
        self._executor = _Executor(EXECUTOR_THREADS)
        self._mu = threading.Lock()
        self._conns: dict[int, _Conn] = {}
        self._inbox: collections.deque = collections.deque()
        self._running = False
        self._started = False
        self._draining = False           # shutdown(): accept no more
        self._stopping = False           # the loop leaves at its next tick
        self._drain_deadline = 0.0
        self._closed = False
        self._done = threading.Event()
        # Counters: the loop thread writes most; reads are snapshots.
        self.loop_lag = Histogram()
        self.accepted_total = 0
        self.shed_total = 0
        self.reparks_total = 0
        self.reaped_idle_total = 0
        self.dispatch_total = 0
        self.hot_hits_total = 0
        self.offloads_total = 0

    # -- loop ------------------------------------------------------------

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        ep = self._epoll
        lfd = self.socket.fileno()
        with self._mu:
            if self._draining or self._closed:
                self._done.set()
                return
            self._running = self._started = True
        ep.register(lfd, select.EPOLLIN)
        ep.register(self._wr, select.EPOLLIN)
        last_reap = time.monotonic()
        try:
            while not self._stopping:
                try:
                    events = ep.poll(poll_interval)
                except InterruptedError:
                    continue
                t0 = time.monotonic()
                had_events = bool(events) or bool(self._inbox)
                for fd, ev in events:
                    try:
                        if fd == lfd:
                            self._accept_burst()
                        elif fd == self._wr:
                            self._drain_wakeup()
                        else:
                            self._on_event(fd, ev)
                    except Exception:  # noqa: BLE001 - one conn only
                        self._oops(fd)
                self._process_inbox()
                now = time.monotonic()
                if had_events:
                    # How long this tick's ready events waited on the
                    # loop thread: the dispatch latency the plane adds.
                    self.loop_lag.observe(now - t0)
                if self._draining:
                    self._drain_tick(now)
                elif self.keepalive_s is not None \
                        and now - last_reap >= _REAP_INTERVAL:
                    last_reap = now
                    self._reap_idle(now)
        finally:
            self._running = False
            self._teardown()
            self._done.set()

    def _oops(self, fd: int) -> None:
        """Containment: the loop survives any one socket's failure."""
        with self._mu:
            conn = self._conns.get(fd)
        if conn is not None:
            self._destroy(conn)

    def _drain_wakeup(self) -> None:
        try:
            while os.read(self._wr, 4096):
                pass
        except OSError:
            pass

    def _wake(self) -> bool:
        try:
            os.write(self._ww, b"x")
        except OSError:
            return False
        return True

    def _post(self, item) -> bool:
        """Hand a connection back to the loop thread; False once the
        loop is gone (the caller cleans up inline)."""
        with self._mu:
            if self._stopping or not self._running:
                return False
            self._inbox.append(item)
        return self._wake()

    def _process_inbox(self) -> None:
        while True:
            try:
                op, conn = self._inbox.popleft()
            except IndexError:
                return
            try:
                if op == "park":
                    self._park(conn)
                elif op == "write":
                    self._begin_write(conn)
                elif op == "close":
                    self._destroy(conn)
            except Exception:  # noqa: BLE001 - one conn only
                self._oops(conn.fd)

    # -- accept and shed -------------------------------------------------

    def _accept_burst(self) -> None:
        # Bounded a tick: an accept storm must not starve the parked
        # connections' events (level-triggered epoll re-arms the rest).
        for _ in range(256):
            if self._draining:
                return
            try:
                s, addr = self.socket.accept()
            except OSError:             # EAGAIN included
                return
            with self._mu:
                n_conns = len(self._conns)
            if n_conns >= self.max_conns:
                self._shed(s)
                continue
            self.accepted_total += 1
            s.setblocking(False)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = self._new_conn(s, addr)
            if conn is None:
                s.close()
                continue
            with self._mu:
                self._conns[conn.fd] = conn
            self._register(conn, select.EPOLLIN)

    def _shed(self, s: socket.socket) -> None:
        """Connection-level backpressure: 503 and close; no handler, no
        buffer, no thread."""
        self.shed_total += 1
        try:
            s.setblocking(False)
            s.send(_SHED_RESPONSE)
        except OSError:
            pass
        finally:
            s.close()

    def _new_conn(self, s, addr):
        h = self.handler_cls.__new__(self.handler_cls)
        h.request = s
        h.client_address = addr
        h.server = self
        h.close_connection = True
        try:
            h.setup()
        except Exception:  # noqa: BLE001 - a connection's setup failure
            return None
        conn = _Conn(s, s.fileno(), h, h._conn)
        h._loop_conn = conn
        return conn

    # -- epoll bookkeeping -----------------------------------------------

    def _register(self, conn: _Conn, mask) -> None:
        if conn.registered:
            self._epoll.modify(conn.fd, mask)
        else:
            self._epoll.register(conn.fd, mask)
            conn.registered = True

    def _unregister(self, conn: _Conn) -> None:
        if conn.registered:
            conn.registered = False
            try:
                self._epoll.unregister(conn.fd)
            except (OSError, ValueError):
                # ValueError: the epoll set is already closed.
                pass

    # -- read side -------------------------------------------------------

    def _on_event(self, fd: int, ev) -> None:
        with self._mu:
            conn = self._conns.get(fd)
        if conn is None:
            try:
                self._epoll.unregister(fd)
            except OSError:
                pass
            return
        if conn.state == _WRITING:
            if ev & (select.EPOLLHUP | select.EPOLLERR):
                self._destroy(conn)
            else:
                self._drain_pending(conn)
            return
        if conn.state != _PARKED:
            return
        if ev & select.EPOLLERR:
            self._destroy(conn)
            return
        self._read_ready(conn, ev)

    def _read_ready(self, conn: _Conn, ev) -> None:
        reader = conn.reader
        n = reader.fill_nb()
        if n == 0:
            if reader.buffered:
                # EOF mid-head: the stock parser's error path decides.
                self._dispatch(conn, "fallback", None)
            else:
                self._destroy(conn)        # a clean close between requests
            return
        if n is None:
            if ev & select.EPOLLHUP:
                self._destroy(conn)
            return
        conn.last_activity = time.monotonic()
        self._advance(conn)

    def _advance(self, conn: _Conn) -> None:
        """Frame or stay parked: dispatch once a complete head (or a
        prefix the framer refuses) is buffered. Each framed head is
        first offered to the hot probe: a hit is answered here and the
        next pipelined head framed at once, as many as one dispatch
        would serve."""
        served = 0
        while True:
            status, head = conn.reader.try_parse_head()
            if status == "head":
                if served < _PIPELINE_BURST:
                    hot = self._try_hot(conn, head)
                    if hot == "served":
                        served += 1
                        continue
                    if hot == "done":
                        return
                self._dispatch(conn, "head", head)
                return
            if status == "fallback":
                self._dispatch(conn, "fallback", None)
                return
            # "more": stay parked; the idle deadline covers slow heads.
            # After hot hits, return the recv buffer as a re-park does.
            if served and not conn.reader.buffered:
                conn.reader.hibernate()
            return

    def _try_hot(self, conn: _Conn, head) -> str | None:
        """Answer one framed request from the hot-object cache on the
        loop thread. None when the probe declines (the caller dispatches
        this head), "served" when the response went out whole and the
        connection stays parked, "done" when the connection was closed
        or handed to the EPOLLOUT drain."""
        probe = self._hot_probe
        if probe is None:
            return None
        try:
            res = probe(conn.handler, head)
        except Exception:  # noqa: BLE001 - a probe failure: full handler
            return None
        if res is None:
            return None
        bufs, close = res
        self.hot_hits_total += 1
        conn.last_activity = time.monotonic()
        try:
            _, rest = hotloop.send_nb(conn.sock, bufs)
        except OSError:
            self._destroy(conn)
            return "done"
        if rest:
            # A slow reader: the rest becomes a loop-owned tail. No copy:
            # a cache entry's buffers are immutable bytes it keeps alive.
            conn.pending = rest
            conn.close_after_write = close
            conn.state = _WRITING
            self._register(conn, select.EPOLLOUT)
            return "done"
        if close:
            self._destroy(conn)
            return "done"
        return "served"

    def _dispatch(self, conn: _Conn, mode: str, head) -> None:
        conn.state = _DISPATCHED
        self._unregister(conn)
        self.dispatch_total += 1
        self._executor.submit(lambda: self._serve(conn, mode, head))

    # -- executor side ---------------------------------------------------

    def _serve(self, conn: _Conn, mode: str, head) -> None:
        """One dispatch: the framed request and the pipelined ones
        already buffered, then the connection back to the loop: re-park,
        tail write or close."""
        h = conn.handler
        sock = conn.sock
        broken = False
        try:
            # Body reads and response writes block, each within the idle
            # deadline: a stalled body gives this thread back.
            sock.settimeout(self.keepalive_s)
            for _ in range(_PIPELINE_BURST):
                if mode == "head":
                    h._dispatch_head(head)
                else:
                    # The framer declined the buffered bytes: the
                    # handler's thread-path entry re-runs the decision on
                    # the same bytes and falls back to the stock parser.
                    h.handle_one_request()
                if h.close_connection or conn.pending is not None:
                    break
                mode, head = self._next_buffered(conn)
                if mode is None:
                    break
        except Exception:  # noqa: BLE001 - a dead client or handler
            broken = True
        if conn.pending is not None and not broken:
            conn.close_after_write = h.close_connection
            if not self._post(("write", conn)):
                self._destroy(conn)
            return
        if broken or h.close_connection:
            if not self._post(("close", conn)):
                self._destroy(conn)
            return
        conn.last_activity = time.monotonic()
        if not conn.reader.buffered:
            # An idle keep-alive connection parks holding no lease.
            conn.reader.hibernate()
        try:
            sock.setblocking(False)
        except OSError:
            self._destroy(conn)
            return
        if not self._post(("park", conn)):
            self._destroy(conn)

    @staticmethod
    def _next_buffered(conn: _Conn):
        """After a request: is another complete head buffered? (mode,
        head) to serve it on this thread, (None, None) to re-park."""
        reader = conn.reader
        if not reader.buffered:
            return None, None
        status, head = reader.try_parse_head()
        if status == "head":
            return "head", head
        if status == "fallback":
            return "fallback", None
        return None, None                  # a partial next head: park

    # -- loop-owned response tails ---------------------------------------

    def offload_final(self, conn: _Conn, bufs) -> None:
        """A response's FINAL gathered write (executor side), EAGAIN
        aware: send what the socket takes now and COPY the rest (pooled
        views die when their stream closes) onto the connection for the
        loop's EPOLLOUT drain. Raises like send_gathered on a dead
        peer."""
        if conn.pending is not None:
            # A tail is already waiting: these bytes queue behind it.
            conn.pending += [memoryview(bytes(b)) for b in bufs if len(b)]
            return
        sock = conn.sock
        sock.setblocking(False)
        try:
            _, rest = hotloop.send_nb(sock, bufs)
        finally:
            try:
                sock.settimeout(self.keepalive_s)
            except OSError:
                pass
        if rest:
            with self._mu:
                self.offloads_total += 1
            conn.pending = [memoryview(bytes(b)) for b in rest]

    def _begin_write(self, conn: _Conn) -> None:
        conn.state = _WRITING
        # From here the LOOP owns the socket: every send must EAGAIN, not
        # block the loop thread.
        try:
            conn.sock.setblocking(False)
        except OSError:
            self._destroy(conn)
            return
        self._drain_pending(conn)

    def _drain_pending(self, conn: _Conn) -> None:
        try:
            _, rest = hotloop.send_nb(conn.sock, conn.pending or [])
        except OSError:
            self._destroy(conn)
            return
        if rest:
            conn.pending = rest
            conn.last_activity = time.monotonic()
            self._register(conn, select.EPOLLOUT)
            return
        conn.pending = None
        if conn.close_after_write or self._draining:
            self._destroy(conn)
            return
        # The tail went out: back to a parked keep-alive connection.
        conn.state = _PARKED
        conn.last_activity = time.monotonic()
        self.reparks_total += 1
        if not conn.reader.buffered:
            conn.reader.hibernate()
        self._register(conn, select.EPOLLIN)
        if conn.reader.buffered:
            self._advance(conn)

    def _park(self, conn: _Conn) -> None:
        if self._draining:
            self._destroy(conn)
            return
        conn.state = _PARKED
        self.reparks_total += 1
        self._register(conn, select.EPOLLIN)

    # -- reaping, drain and teardown -------------------------------------

    def _reap_idle(self, now: float) -> None:
        ks = self.keepalive_s
        with self._mu:
            conns = list(self._conns.values())
        for conn in conns:
            if conn.state != _DISPATCHED \
                    and now - conn.last_activity > ks:
                # Idle keep-alive, a partial head (slowloris) and a
                # stalled tail write all age out on one deadline.
                self.reaped_idle_total += 1
                self._destroy(conn)

    def _drain_tick(self, now: float) -> None:
        """shutdown()'s drain, on the loop thread: the listener closed,
        parked connections closed, then the loop runs until no request
        is dispatched and no tail is being written (or the deadline)."""
        if not self._closed:
            try:
                self._epoll.unregister(self.socket.fileno())
            except (OSError, ValueError):
                pass
            self.server_close()
        with self._mu:
            conns = list(self._conns.values())
        busy = 0
        for conn in conns:
            if conn.state == _PARKED:
                self._destroy(conn)
            else:
                busy += 1
        if not busy or now >= self._drain_deadline:
            with self._mu:
                self._stopping = True

    def _destroy(self, conn: _Conn) -> None:
        """Close one connection: epoll, the handler's teardown (its recv
        lease), the socket. The loop thread, or after the loop stopped
        the executor thread that owns it."""
        with self._mu:
            live = self._conns.pop(conn.fd, None) is not None
        if not live:
            return
        self._unregister(conn)
        try:
            conn.handler.finish()
        except Exception:  # noqa: BLE001 - a dead socket's teardown
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _teardown(self) -> None:
        self._process_inbox()
        with self._mu:
            conns = list(self._conns.values())
        for conn in conns:
            if conn.state != _DISPATCHED:
                # A request still in flight keeps its socket; its
                # executor thread cleans up when it ends (_post refuses).
                self._destroy(conn)
        self.server_close()
        self._close_loop_fds()

    def _close_loop_fds(self) -> None:
        try:
            self._epoll.close()
        except OSError:
            pass
        for fd in (self._wr, self._ww):
            try:
                os.close(fd)
            except OSError:
                pass

    def shutdown(self) -> None:
        """Stop accepting and close the parked connections; let the
        dispatched requests and the response tails finish (up to
        DRAIN_S); then stop the loop and release the executor."""
        with self._mu:
            self._draining = True
            self._drain_deadline = time.monotonic() + DRAIN_S
            running = self._running
        if running:
            self._wake()
            if not self._done.wait(timeout=DRAIN_S + 10):
                print("eventloop: the loop did not stop in "
                      f"{DRAIN_S + 10:.0f} s", file=sys.stderr)
        self._executor.shutdown()

    def server_close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            started = self._started
        try:
            self.socket.close()
        except OSError:
            pass
        if not started:
            # The loop never ran: its epoll set and pipe go here.
            self._close_loop_fds()

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            conns = list(self._conns.values())
        parked = sum(1 for c in conns if c.state == _PARKED)
        writing = sum(1 for c in conns if c.state == _WRITING)
        return {
            "enabled": True,
            "parked": parked,
            "active": len(conns) - parked,
            "writing": writing,
            "max_conns": self.max_conns,
            "accepted_total": self.accepted_total,
            "shed_total": self.shed_total,
            "reparks_total": self.reparks_total,
            "reaped_idle_total": self.reaped_idle_total,
            "dispatch_total": self.dispatch_total,
            "hot_hits_total": self.hot_hits_total,
            "offloads_total": self.offloads_total,
            "executor_threads": self._executor.threads,
            "executor_queue": self._executor.depth(),
            "recv_leases": hotloop.recv_pool().stats()["outstanding"],
            "loop_lag": self.loop_lag.state(),
        }

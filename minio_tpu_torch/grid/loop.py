"""Grid epoll plane: one poller thread for every grid connection.

The port of minio_tpu/grid/loop.py. Every grid socket of the process,
client connections out and server connections in, registers on one
epoll set serviced by one thread. The poller owns all reads: it
reassembles control frames and raw bulk frames (grid/wire.py), lands a
raw payload in a lease of io/bufpool's host pool with recv_into, and
hands each frame to its connection's callback (the client's demux, the
server's dispatch). Writes are blocking sendall under per-connection
write locks held one frame (or one raw slice) at a time, so lock RPCs
interleave between a bulk transfer's slices.

Also here: the raw-frame send helpers. `send_raw_fd` ships a file
region from its fd with os.sendfile, `send_raw_buf` an in-memory buffer
off memoryview slices. Both take one credit a slice when the stream is
flow-controlled (`Credit`, replenished by T_WIN frames), so a receiver
that stops draining stalls the sender.

The poller thread starts with the first registered socket, never at
import: a pre-forked server forks before any grid socket exists
(io/workers.py).
"""

from __future__ import annotations

import os
import select
import threading
import time
from typing import Callable, Optional

from minio_tpu_torch.grid import chaos, wire
from minio_tpu_torch.io.bufpool import global_pool
from minio_tpu_torch.utils import mpack

_RECV = 256 << 10

# Per-stream credit window, in frames of at most 1 MiB each.
STREAM_WINDOW = 32
# Seconds a flow-controlled sender waits for credit before it fails the
# stream.
STREAM_STALL_S = 60.0


class Credit:
    """Counting credit window for one stream. The sender takes one
    credit per frame; the receiver grants credits back (T_WIN) as its
    consumer drains frames. close() releases waiters with failure —
    connection loss must not leave senders parked until the stall
    timeout."""

    __slots__ = ("_cv", "_n", "closed", "waits")

    def __init__(self, n: int):
        self._cv = threading.Condition()
        self._n = int(n)
        self.closed = False
        self.waits = 0

    def grant(self, k: int) -> None:
        with self._cv:
            self._n += int(k)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self.closed = True
            self._cv.notify_all()

    def take(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._n <= 0 and not self.closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.waits += 1
                self._cv.wait(left)
            if self.closed or self._n <= 0:
                return False
            self._n -= 1
            return True


class _Conn:
    """Per-connection frame reassembly (control + raw). A raw
    payload whose header has been parsed streams the rest of its bytes
    straight into a pooled lease via recv_into — no intermediate
    bytes object for the bulk of a transfer."""

    __slots__ = ("sock", "fd", "on_msg", "on_close", "buf",
                 "raw_lease", "raw_view", "raw_mux", "raw_need",
                 "raw_have")

    def __init__(self, sock, on_msg: Callable[[dict], None],
                 on_close: Optional[Callable[[], None]]):
        self.sock = sock
        self.fd = sock.fileno()
        self.on_msg = on_msg
        self.on_close = on_close
        self.buf = bytearray()
        self.raw_lease = None
        self.raw_view: Optional[memoryview] = None
        self.raw_mux = 0
        self.raw_need = 0
        self.raw_have = 0

    def on_readable(self, poller: "GridPoller") -> None:
        if self.raw_lease is not None and not self.buf \
                and self.raw_have < self.raw_need:
            n = self.sock.recv_into(
                self.raw_view[self.raw_have:self.raw_need])
            if not n:
                raise wire.GridError("connection closed")
            self.raw_have += n
            poller.raw_rx_bytes_total += n
            if self.raw_have == self.raw_need:
                self._deliver_raw(poller)
            return
        data = self.sock.recv(_RECV)
        if not data:
            raise wire.GridError("connection closed")
        self.buf += data
        self._parse(poller)

    def _parse(self, poller: "GridPoller") -> None:
        buf = self.buf
        while True:
            if self.raw_lease is not None:
                take = min(len(buf), self.raw_need - self.raw_have)
                if take:
                    self.raw_view[self.raw_have:self.raw_have + take] = \
                        buf[:take]
                    del buf[:take]
                    self.raw_have += take
                    poller.raw_rx_bytes_total += take
                if self.raw_have < self.raw_need:
                    return
                self._deliver_raw(poller)
                continue
            if len(buf) < 4:
                return
            (word,) = wire._LEN.unpack_from(buf, 0)
            if word & wire._RAW_BIT:
                if len(buf) < 8:
                    return
                need = (word & ~wire._RAW_BIT) - 4
                if need < 0 or need > wire.MAX_FRAME:
                    raise wire.GridError(f"oversized raw frame: {word}")
                (self.raw_mux,) = wire._LEN.unpack_from(buf, 4)
                del buf[:8]
                self.raw_need = need
                self.raw_have = 0
                self.raw_lease = global_pool().lease(max(need, 1))
                self.raw_view = memoryview(self.raw_lease.ndarray(
                    (need,))) if need else None
                if need == 0:
                    self._deliver_raw(poller)
                continue
            if word > wire.MAX_FRAME:
                raise wire.GridError(f"oversized frame: {word}")
            if len(buf) < 4 + word:
                return
            try:
                msg = mpack.unpackb(bytes(buf[4:4 + word]))
            except mpack.PackError as e:
                raise wire.GridError(f"malformed frame: {e}") from None
            del buf[:4 + word]
            poller.frames_total += 1
            self.on_msg(msg)

    def _deliver_raw(self, poller: "GridPoller") -> None:
        lease, view = self.raw_lease, self.raw_view
        self.raw_lease = self.raw_view = None
        poller.raw_rx_frames_total += 1
        # The callback owns the lease from here: it must release() it
        # (or hand it to a consumer that will).
        self.on_msg({"t": wire.T_CHUNK, "m": self.raw_mux,
                     "p": view if view is not None else b"",
                     "lease": lease, "raw": True})


class GridPoller:
    """One epoll set + one thread for every registered grid socket."""

    def __init__(self):
        self._ep = select.epoll()
        self._conns: dict[int, _Conn] = {}
        self._mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.frames_total = 0
        self.raw_rx_frames_total = 0
        self.raw_rx_bytes_total = 0
        self.conns_dropped_total = 0

    def register(self, sock, on_msg: Callable[[dict], None],
                 on_close: Optional[Callable[[], None]] = None) -> None:
        conn = _Conn(sock, on_msg, on_close)
        with self._mu:
            self._conns[conn.fd] = conn
            self._ep.register(conn.fd, select.EPOLLIN)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="grid-poller", daemon=True)
                self._thread.start()

    def discard(self, sock) -> None:
        """Forget a socket without closing it or firing on_close (the
        caller is tearing the connection down itself)."""
        try:
            fd = sock.fileno()
        except OSError:
            fd = -1
        with self._mu:
            conn = self._conns.pop(fd, None) if fd >= 0 else None
            if conn is None:
                for k, c in list(self._conns.items()):
                    if c.sock is sock:
                        conn = self._conns.pop(k)
                        fd = k
                        break
            if conn is None:
                return
            try:
                self._ep.unregister(fd)
            except (OSError, ValueError):
                pass
        lease, conn.raw_lease = conn.raw_lease, None
        if lease is not None:
            lease.release()

    def conns(self) -> int:
        with self._mu:
            return len(self._conns)

    def _run(self) -> None:
        while not self._stopping:
            try:
                events = self._ep.poll(1.0)
            except (OSError, ValueError):
                if self._stopping:
                    return
                time.sleep(0.05)
                continue
            for fd, _ev in events:
                with self._mu:
                    conn = self._conns.get(fd)
                if conn is None:
                    continue
                try:
                    conn.on_readable(self)
                except Exception:  # noqa: BLE001 - one conn, not the loop
                    self._drop(conn)

    def _drop(self, conn: _Conn) -> None:
        self.conns_dropped_total += 1
        self.discard(conn.sock)
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.on_close is not None:
            try:
                conn.on_close()
            except Exception:  # noqa: BLE001 - observers must not kill loop
                pass


_POLLER: Optional[GridPoller] = None
_POLLER_MU = threading.Lock()


def poller() -> GridPoller:
    global _POLLER
    if _POLLER is None:
        with _POLLER_MU:
            if _POLLER is None:
                _POLLER = GridPoller()
    return _POLLER


def discard(sock) -> None:
    """Forget `sock` if a poller exists; never instantiates one."""
    p = _POLLER
    if p is not None:
        p.discard(sock)


# -- raw-frame send helpers (shared by grid server and client) ----------

# Send-side transfer counters (module-level; += under the GIL is
# metrics-grade, matching the per-client counters elsewhere).
sendfile_transfers_total = 0
sendfile_bytes_total = 0
raw_tx_frames_total = 0
raw_tx_bytes_total = 0
credit_stalls_total = 0


def _take_credit(credit: Optional[Credit], stall: float) -> None:
    global credit_stalls_total
    if credit is not None and not credit.take(stall):
        credit_stalls_total += 1
        raise wire.GridError("stream credit stall (receiver not draining)")


def send_raw_fd(sock, wlock, mux: int, fd: int, offset: int, length: int,
                credit: Optional[Credit] = None,
                stall: Optional[float] = None) -> int:
    """Ship [offset, offset+length) of `fd` to `sock` as raw frames via
    os.sendfile — the payload never surfaces into Python. One wlock
    hold and one credit per slice, so small control frames (lock
    RPCs) interleave between slices of a bulk transfer.
    A zero-length source still emits one empty raw frame, so the
    receiver sees one chunk as it would for any other file."""
    global sendfile_transfers_total, sendfile_bytes_total
    global raw_tx_frames_total, raw_tx_bytes_total
    stall = STREAM_STALL_S if stall is None else stall
    frames = 0
    while length > 0 or frames == 0:
        n = min(length, wire.RAW_SLICE)
        _take_credit(credit, stall)
        with wlock:
            chaos.net("send")
            sock.sendall(wire.pack_raw_header(mux, n))
            off = offset
            end = offset + n
            while off < end:
                sent = os.sendfile(sock.fileno(), fd, off, end - off)
                if sent == 0:
                    raise wire.GridError("sendfile: source truncated")
                off += sent
        offset += n
        length -= n
        frames += 1
        sendfile_bytes_total += n
        raw_tx_frames_total += 1
        raw_tx_bytes_total += n
    sendfile_transfers_total += 1
    return frames


def send_raw_buf(sock, wlock, mux: int, data,
                 credit: Optional[Credit] = None,
                 stall: Optional[float] = None) -> int:
    """Ship an in-memory buffer as raw frames (no encode, no
    per-chunk bytes copies — sendall works straight off memoryview
    slices). Same slice/credit/wlock granularity as send_raw_fd."""
    global raw_tx_frames_total, raw_tx_bytes_total
    stall = STREAM_STALL_S if stall is None else stall
    view = memoryview(data)
    if view.ndim != 1 or view.itemsize != 1:
        view = view.cast("B")
    total = len(view)
    off = 0
    frames = 0
    while off < total or frames == 0:
        n = min(total - off, wire.RAW_SLICE)
        _take_credit(credit, stall)
        with wlock:
            chaos.net("send")
            sock.sendall(wire.pack_raw_header(mux, n))
            if n:
                sock.sendall(view[off:off + n])
        off += n
        frames += 1
        raw_tx_frames_total += 1
        raw_tx_bytes_total += n
    return frames


def stats() -> dict:
    """Counter snapshot for the Prometheus render and admin info."""
    p = _POLLER
    return {
        "conns": p.conns() if p is not None else 0,
        "frames": p.frames_total if p is not None else 0,
        "raw_rx_frames": p.raw_rx_frames_total if p is not None else 0,
        "raw_rx_bytes": p.raw_rx_bytes_total if p is not None else 0,
        "conns_dropped": p.conns_dropped_total if p is not None else 0,
        "raw_tx_frames": raw_tx_frames_total,
        "raw_tx_bytes": raw_tx_bytes_total,
        "sendfile_transfers": sendfile_transfers_total,
        "sendfile_bytes": sendfile_bytes_total,
        "credit_stalls": credit_stalls_total,
    }

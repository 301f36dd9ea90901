"""Serve hot loop: request-head framing over pooled connection buffers.

The port of minio_tpu/s3/hotloop.py. The stdlib front end's
per-request cost is a readline per header, an email.Message build and a
fresh BufferedReader per connection. This module replaces that path for
the S3 handler (s3/server.py):

  * RecvPool: a small pool of host recv buffers (bytearrays). They never
    go to the card, so they are neither pinned nor io/bufpool tensors:
    the framer searches them with bytearray.find. Every lease is
    counted (`outstanding`) and returned on close.
  * ConnReader: one pooled recv buffer per connection, kept across
    keep-alive requests. It serves the rfile surface
    (read/readline/readinto) for every body reader and the stock
    parser, and frames request heads straight out of its buffer
    (`frame_head`, the verdicts of the JAX package's native
    `mtpu_http_head`). The buffer is lazy and hibernates: an idle
    keep-alive connection holds no lease.
  * FastHeaders: the flat lowercase dict the framer produces, with the
    subset of email.Message the handlers use. Header-name strings are
    interned per connection.
  * send_gathered / send_nb: writev-style response writes (one sendmsg
    of [head, body views, ...]); send_nb stops at EAGAIN and returns the
    views left, for the event loop's EPOLLOUT drain.

A head the framer refuses (obs-fold, a bare LF, a head larger than the
buffer) falls back to the stdlib parser on the same buffered bytes.
"""

from __future__ import annotations

import re
import socket
import threading

MAX_HEADERS = 100
RECV_BUF = 64 << 10
# Verdicts of frame_head (mtpu_http_head's return codes).
_INCOMPLETE = 0
_MALFORMED = -1
_TOO_MANY = -2

# The byte classes of mtpu_http_head's scans.
_METHOD = re.compile(rb"[\x21-\x7e]*")          # no CTL, space or DEL
_TO_SP_CR = re.compile(rb"[^ \r]*")
_TARGET = re.compile(rb"[^ \r\n]*")
_NAME = re.compile(rb"[^:\r]*")
_OWS = re.compile(rb"[ \t]*")
_VALUE = re.compile(rb"[^\r\n]*")
_BAD_NAME = re.compile(rb"[^\x21-\x7e]")
_HEX = re.compile(rb"[0-9a-fA-F]*")
_EXT_KEY = re.compile(rb"[^=;]*")
_EXT_VAL = re.compile(rb"[^;]*")

_MAX_CHUNK_HEADER = 4096
_MAX_CHUNK = 16 << 20


def frame_head(buf: bytearray, start: int, end: int, out: list) -> int:
    """Frame one HTTP/1.x request head out of buf[start:end], as
    mtpu_http_head does (minio_tpu/native/native.cc): header names are
    lowercased in place and `out` gets [method_off, method_len,
    target_off, target_len, version (10 | 11), nheaders, then name_off,
    name_len, val_off, val_len per header] (absolute offsets). Returns
    the head's length through its CRLFCRLF, _INCOMPLETE without one,
    _MALFORMED, or _TOO_MANY past MAX_HEADERS."""
    e4 = buf.find(b"\r\n\r\n", start, end)
    if e4 < 0:
        return _INCOMPLETE
    head_end = e4 + 4
    # Request line: METHOD SP request-target SP HTTP/1.x CRLF.
    p = _TO_SP_CR.match(buf, start, head_end).end()
    if p >= head_end or buf[p] != 32 or p == start or p - start > 32:
        return _MALFORMED
    if _METHOD.match(buf, start, p).end() != p:
        return _MALFORMED
    method_len = p - start
    t0 = p + 1
    p = _TARGET.match(buf, t0, head_end).end()
    if p >= head_end or buf[p] != 32 or p == t0:
        return _MALFORMED
    target_len = p - t0
    p += 1
    if p + 10 > head_end or buf[p:p + 7] != b"HTTP/1.":
        return _MALFORMED
    v = buf[p + 7]
    if v not in (48, 49):
        return _MALFORMED
    p += 8
    if buf[p] != 13 or buf[p + 1] != 10:
        return _MALFORMED
    p += 2
    fields = []
    while p < head_end:
        c = buf[p]
        if c == 13:                       # the blank line ends the head
            if p + 2 != head_end or buf[p + 1] != 10:
                return _MALFORMED
            break
        if len(fields) >= 4 * MAX_HEADERS:
            return _TOO_MANY
        if c == 32 or c == 9:             # obs-fold: refused
            return _MALFORMED
        n0 = p
        p = _NAME.match(buf, n0, head_end).end()
        if p >= head_end or buf[p] != 58 or p == n0:
            return _MALFORMED
        bad = _BAD_NAME.search(buf, n0, p)
        # Lowercased as scanned, up to a byte that refuses the head.
        stop = p if bad is None else bad.start()
        buf[n0:stop] = buf[n0:stop].lower()
        if bad is not None:
            return _MALFORMED
        name_len = p - n0
        v0 = _OWS.match(buf, p + 1, head_end).end()
        p = _VALUE.match(buf, v0, head_end).end()
        # A bare LF inside a value is refused (a smuggling primitive).
        if p + 1 >= head_end or buf[p] != 13 or buf[p + 1] != 10:
            return _MALFORMED
        v1 = p
        while v1 > v0 and buf[v1 - 1] in (32, 9):
            v1 -= 1
        fields += (n0, name_len, v0, v1 - v0)
        p += 2
    out[:] = [start, method_len, t0, target_len, 11 if v == 49 else 10,
              len(fields) // 4, *fields]
    return head_end - start


def chunk_head(buf: bytearray, end: int, pos: int, out: list) -> int:
    """Scan one aws-chunked frame header (`hex-size[;ext]\\r\\n`) at
    buf[pos:end], as mtpu_chunk_head does: `out` gets [header length
    through its CRLF, chunk size, absolute offset of the chunk-signature
    value (0 if none), its length]. Returns 1, 0 when incomplete, -1
    when malformed or past the 4 KiB header / 16 MiB chunk bounds."""
    if pos > end:
        return -1
    avail = end - pos
    nl = buf.find(b"\r\n", pos, pos + min(avail, _MAX_CHUNK_HEADER))
    if nl < 0:
        return -1 if avail > _MAX_CHUNK_HEADER else 0
    p = _HEX.match(buf, pos, nl).end()
    if p == pos:
        return -1
    # The native scan refuses as soon as the running size passes the
    # bound; leading zeros keep the value small, so the value decides.
    size = int(buf[pos:p], 16)
    if size > _MAX_CHUNK:
        return -1
    sig_off = sig_len = 0
    while p < nl and buf[p] == 59:        # ';'
        k0 = p + 1
        k1 = p = _EXT_KEY.match(buf, k0, nl).end()
        val0 = vlen = 0
        if p < nl and buf[p] == 61:       # '='
            val0 = p + 1
            p = _EXT_VAL.match(buf, val0, nl).end()
            vlen = p - val0
        if buf[k0:k1] == b"chunk-signature":
            sig_off, sig_len = val0, vlen
    if p != nl:
        return -1
    out[:] = [nl + 2 - pos, size, sig_off, sig_len]
    return 1


# ---------------------------------------------------------------------------
# the recv buffer pool
# ---------------------------------------------------------------------------

_MIN_CLASS = 16                  # 64 KiB
_MAX_CLASS = 25                  # 32 MiB (a 16 MiB chunk plus its fill)
_KEEP_SMALL = 256                # idle 64 KiB buffers kept
_KEEP_LARGE = 8                  # idle buffers kept of each larger class


class RecvLease:
    """One leased recv buffer (`raw`, a bytearray of at least `size`
    bytes); release() once."""

    __slots__ = ("raw", "size", "_pool", "_cls", "_live")

    def __init__(self, pool: "RecvPool", raw: bytearray, cls: int,
                 size: int):
        self.raw = raw
        self.size = size
        self._pool = pool
        self._cls = cls
        self._live = True

    def release(self) -> None:
        if self._live:
            self._live = False
            self._pool._return(self.raw, self._cls)
            self.raw = None


class RecvPool:
    """Free lists of recv buffers by power-of-two class (64 KiB to
    32 MiB; larger requests are served unpooled), with counted leases.
    Idle buffers kept: _KEEP_SMALL of 64 KiB (the per-connection
    buffers), _KEEP_LARGE of each larger class. Thread-safe."""

    def __init__(self):
        self._mu = threading.Lock()
        self._free: dict[int, list] = {}
        self.hits = 0
        self.misses = 0
        self.outstanding = 0

    def lease(self, size: int) -> RecvLease:
        cls = max(_MIN_CLASS, (max(size, 1) - 1).bit_length())
        pooled = cls <= _MAX_CLASS
        with self._mu:
            free = self._free.get(cls)
            raw = free.pop() if pooled and free else None
            if raw is not None:
                self.hits += 1
            else:
                self.misses += 1
            self.outstanding += 1
        if raw is None:
            raw = bytearray(1 << cls if pooled else size)
        return RecvLease(self, raw, cls if pooled else -1, size)

    def _return(self, raw: bytearray, cls: int) -> None:
        with self._mu:
            self.outstanding -= 1
            if cls < 0:
                return
            free = self._free.setdefault(cls, [])
            keep = _KEEP_SMALL if cls == _MIN_CLASS else _KEEP_LARGE
            if len(free) < keep:
                free.append(raw)

    def stats(self) -> dict:
        with self._mu:
            return {"hits": self.hits, "misses": self.misses,
                    "outstanding": self.outstanding,
                    "idle": sum(len(f) for f in self._free.values())}


_POOL: RecvPool | None = None
_POOL_MU = threading.Lock()


def recv_pool() -> RecvPool:
    """The process's recv buffer pool, made on first use (in a
    pre-forked worker: after the fork)."""
    global _POOL
    if _POOL is None:
        with _POOL_MU:
            if _POOL is None:
                _POOL = RecvPool()
    return _POOL


# ---------------------------------------------------------------------------
# the connection reader
# ---------------------------------------------------------------------------

class FastHeaders:
    """Case-insensitive view over the framer's flat lowercase dict (`d`):
    the subset of email.Message the handler uses."""

    __slots__ = ("d",)

    def __init__(self, d: dict):
        self.d = d

    def get(self, name, default=None):
        return self.d.get(name.lower(), default)


class _Fallback(Exception):
    """The framer declined this head; the stdlib parser takes it."""


_STALLED = "no bytes within the idle deadline"


class RecvStalled(TimeoutError):
    """A read of the connection waited out its socket's deadline (the
    idle deadline, MTPU_HTTP_KEEPALIVE_S): the client stalled. Raised by
    ConnReader in place of socket.timeout, so the handler can tell a
    stalled client from a timeout of its own calls."""


class ConnReader:
    """Pooled-buffer connection reader, kept across keep-alive requests.
    File-like for every body and stock-parse consumer (read(n) blocks
    for n bytes or EOF), while parse_head frames heads out of the
    buffer between requests.

    The recv buffer is leased on the first byte and returned by
    hibernate() whenever it is empty: the event loop parks an idle
    keep-alive connection holding no lease."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._pool = recv_pool()
        self._lease = None
        self._raw = None
        self._cap = RECV_BUF
        self._mv = None
        self._out: list = []
        self._start = 0
        self._end = 0
        self._closed = False
        # Header-name interning for this connection: bytes -> str.
        self.name_cache: dict[bytes, str] = {}

    # -- buffer plumbing -------------------------------------------------

    def _ensure(self) -> None:
        """Lease the recv buffer (first use, or after hibernate())."""
        if self._raw is not None:
            return
        if self._closed:
            # A lease taken after close() would never be returned.
            raise ValueError("read on closed ConnReader")
        self._lease = self._pool.lease(RECV_BUF)
        self._raw = self._lease.raw
        self._cap = len(self._raw)
        self._mv = memoryview(self._raw)
        self._start = self._end = 0

    def _drop_lease(self) -> None:
        # The view goes first: an exported buffer must not reach the
        # free list.
        self._mv.release()
        self._mv = None
        self._raw = None
        lease, self._lease = self._lease, None
        lease.release()

    def hibernate(self) -> bool:
        """Return the recv buffer if nothing is buffered. True when the
        reader now holds no lease; False when buffered bytes pin it."""
        if self._raw is None:
            return True
        if self._end - self._start:
            return False
        self._drop_lease()
        return True

    def _compact(self) -> None:
        if self._start:
            n = self._end - self._start
            self._mv[:n] = self._mv[self._start:self._end]
            self._start, self._end = 0, n

    def _fill(self) -> int:
        """recv into the buffer's tail: bytes added (0 at EOF or with
        the buffer full)."""
        self._ensure()
        if self._end == self._cap:
            self._compact()
            if self._end == self._cap:
                return 0
        n = self._recv_into(self._mv[self._end:], self._cap - self._end)
        self._end += n
        return n

    def _recv_into(self, view, n: int) -> int:
        try:
            return self._sock.recv_into(view, n)
        except socket.timeout:
            raise RecvStalled(_STALLED) from None

    def fill_nb(self):
        """The event loop's fill (socket non-blocking): bytes added
        (> 0), 0 at EOF, None when the read would block or the buffer is
        full."""
        self._ensure()
        if self._end == self._cap:
            self._compact()
            if self._end == self._cap:
                return None
        try:
            n = self._sock.recv_into(self._mv[self._end:],
                                     self._cap - self._end)
        except (BlockingIOError, InterruptedError):
            return None
        self._end += n
        return n

    @property
    def buffered(self) -> int:
        return self._end - self._start

    # -- rfile surface ---------------------------------------------------

    def read(self, n: int) -> bytes:
        """Up to n bytes (fewer only at EOF); bodies are Content-Length
        or chunk framed, so no caller reads to EOF."""
        if n <= 0:
            return b""
        have = self.buffered
        if have >= n:
            out = bytes(self._mv[self._start:self._start + n])
            self._start += n
            if self._start == self._end:
                self._start = self._end = 0
            return out
        parts = []
        if have:
            parts.append(bytes(self._mv[self._start:self._end]))
            self._start = self._end = 0
            n -= have
        # A large remainder is received in caller-sized pieces, not
        # bounced through the 64 KiB buffer.
        while n > 0:
            try:
                chunk = self._sock.recv(min(n, 1 << 20))
            except socket.timeout:
                raise RecvStalled(_STALLED) from None
            if not chunk:
                break
            parts.append(chunk)
            n -= len(chunk)
        return b"".join(parts)

    def readinto(self, b) -> int:
        mv = memoryview(b).cast("B")
        want = len(mv)
        done = have = min(self.buffered, want)
        if have:
            mv[:have] = self._mv[self._start:self._start + have]
            self._start += have
            if self._start == self._end:
                self._start = self._end = 0
        while done < want:
            n = self._recv_into(mv[done:], want - done)
            if not n:
                break
            done += n
        return done

    def readline(self, limit: int = 65537) -> bytes:
        self._ensure()
        while True:
            nl = self._raw.find(b"\n", self._start, self._end)
            if nl >= 0:
                take = min(nl + 1 - self._start, limit)
                out = bytes(self._mv[self._start:self._start + take])
                self._start += take
                if self._start == self._end:
                    self._start = self._end = 0
                return out
            if self.buffered >= limit:
                out = bytes(self._mv[self._start:self._start + limit])
                self._start += limit
                return out
            if not self._fill():
                out = bytes(self._mv[self._start:self._end])
                self._start = self._end = 0
                return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._raw is not None:
            self._drop_lease()

    # -- head framing ----------------------------------------------------

    def parse_head(self):
        """Frame one request head out of the connection buffer, reading
        the socket as needed. Returns (headers, method, target, version,
        http11) with the head consumed, None at a clean EOF before any
        byte of a request, or raises _Fallback when the stock parser
        should take the request (its bytes stay buffered)."""
        while True:
            if self.buffered:
                self._compact()
                n = frame_head(self._raw, 0, self._end, self._out)
                if n > 0:
                    return self._build_head(n)
                if n != _INCOMPLETE:
                    raise _Fallback()
                if self._end == self._cap:
                    raise _Fallback()      # head larger than the buffer
            if not self._fill():
                if self.buffered:
                    raise _Fallback()      # EOF mid-head: stock error path
                return None                # clean close between requests

    def _build_head(self, head_len: int):
        out = self._out
        mv = self._mv
        method = bytes(mv[out[0]:out[0] + out[1]]).decode("latin-1")
        target = bytes(mv[out[2]:out[2] + out[3]]).decode("latin-1")
        version = "HTTP/1.1" if out[4] == 11 else "HTTP/1.0"
        cache = self.name_cache
        d: dict[str, str] = {}
        for i in range(out[5]):
            base = 6 + 4 * i
            nb = bytes(mv[out[base]:out[base] + out[base + 1]])
            name = cache.get(nb)
            if name is None:
                name = nb.decode("latin-1")
                if len(cache) < 256:
                    cache[nb] = name
            val = bytes(mv[out[base + 2]:out[base + 2] + out[base + 3]]) \
                .decode("latin-1")
            # Repeats fold with a comma, as SigV4 canonicalizes them.
            d[name] = d[name] + "," + val if name in d else val
        self._start += head_len
        if self._start == self._end:
            self._start = self._end = 0
        return d, method, target, version, out[4] == 11

    def try_parse_head(self):
        """Frame one head from the bytes already buffered, never
        touching the socket (the event loop's probe). Returns ("head",
        head) with the head consumed, ("more", None) when more bytes are
        needed, or ("fallback", None) when the stock parser must take
        the request (bytes stay buffered)."""
        if not self.buffered:
            return ("more", None)
        self._compact()
        n = frame_head(self._raw, 0, self._end, self._out)
        if n > 0:
            return ("head", self._build_head(n))
        if n != _INCOMPLETE:
            return ("fallback", None)
        if self._end == self._cap:
            return ("fallback", None)      # head larger than the buffer
        return ("more", None)


# ---------------------------------------------------------------------------
# gathered writes
# ---------------------------------------------------------------------------

def _advance(bufs: list, sent: int) -> list:
    """The views of `bufs` left after `sent` bytes went out."""
    rest = []
    for b in bufs:
        if sent >= len(b):
            sent -= len(b)
            continue
        rest.append(b[sent:] if sent else b)
        sent = 0
    return rest


def send_gathered(sock: socket.socket, bufs) -> int:
    """writev-style send of several buffers (blocking socket); returns
    the bytes sent. On a dead peer it raises like sendall, with the
    bytes that went out before as the exception's `mtpu_sent`."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b)
            for b in bufs if len(b)]
    total = sum(len(b) for b in bufs)
    done = 0
    try:
        while bufs:
            sent = sock.sendmsg(bufs)
            done += sent
            bufs = _advance(bufs, sent)
    except Exception as e:           # noqa: BLE001 - annotate progress
        e.mtpu_sent = done
        raise
    return total


def send_nb(sock: socket.socket, bufs) -> tuple[int, list]:
    """EAGAIN-aware gathered send on a NON-blocking socket: sendmsg
    until done or the kernel buffer fills. Returns (bytes sent, the
    views left), the list empty when everything went out. Raises with
    `mtpu_sent` on a dead peer, like send_gathered."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b)
            for b in bufs if len(b)]
    done = 0
    try:
        while bufs:
            try:
                sent = sock.sendmsg(bufs)
            except (BlockingIOError, InterruptedError):
                return done, bufs
            done += sent
            bufs = _advance(bufs, sent)
    except Exception as e:           # noqa: BLE001 - annotate progress
        e.mtpu_sent = done
        raise
    return done, []

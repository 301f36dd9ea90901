"""Sized byte streams for the streaming PUT path.

The port of minio_tpu/utils/streams.py. A PUT body is never held whole:
the object layer pulls it window by window from a `Payload`, a sized
source with a `finish()` hook that runs exactly once after the last byte
is consumed. The content checks that need the whole body (the signed
x-amz-content-sha256, the aws-chunked final chunk and trailers, the
declared x-amz-checksum-*) live in that hook, so a tampered body is
refused before the object commits (reference internal/hash/reader.go).

`Payload.readinto(view)` fills a caller's buffer, a pooled (pinned)
window for the object layer, straight from the socket reader; the
readers below pass `readinto` through where their source has it.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional


class StreamError(Exception):
    """The body ended early or a streaming integrity check failed."""


class Payload:
    """A sized byte source for the PUT path.

    reader: an object with read(n) -> bytes (fewer at will; b'' at EOF),
        and optionally readinto(view) -> int.
    size: the exact number of payload bytes the reader delivers.
    finish: an optional hook called once after `size` bytes were
        consumed; raising aborts the upload before the commit.
    """

    def __init__(self, reader, size: int,
                 finish: Optional[Callable[[], None]] = None):
        if size < 0:
            raise ValueError("payload size must be known and non-negative")
        self.size = size
        self._reader = reader
        self._finish = finish
        self._remaining = size
        self._finished = False

    @property
    def remaining(self) -> int:
        return self._remaining

    @classmethod
    def wrap(cls, data) -> "Payload":
        """bytes-like or Payload -> Payload."""
        if isinstance(data, Payload):
            return data
        return cls(_BytesReader(data), memoryview(data).nbytes)

    def read(self, n: int) -> bytes:
        """Up to n payload bytes; b'' at the end. Runs the finish hook on
        the read that consumes the final byte (and on the first read of
        an empty payload)."""
        if self._remaining <= 0:
            self._run_finish()
            return b""
        if n <= 0:
            return b""
        chunk = self._reader.read(min(n, self._remaining))
        if not chunk:
            raise StreamError(
                f"body ended {self._remaining} bytes short of declared size")
        self._remaining -= len(chunk)
        if self._remaining == 0:
            self._run_finish()
        return chunk

    def read_exact(self, n: int) -> bytes:
        """Exactly min(n, remaining) bytes."""
        parts = []
        want = n
        while want > 0:
            chunk = self.read(want)
            if not chunk:
                break
            parts.append(chunk)
            want -= len(chunk)
        if not parts:
            # Nothing left (or an empty payload): the finish hook still
            # runs, so a 0-byte body is verified too.
            self.read(0)
            return b""
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def read_all(self) -> bytes:
        return self.read_exact(self._remaining)

    def readinto(self, view) -> int:
        """Fill `view` with exactly min(len(view), remaining) payload
        bytes and return that count; StreamError if the body ends
        short. The finish hook runs as in read()."""
        view = memoryview(view).cast("B")
        want = min(len(view), self._remaining)
        if want <= 0:
            if self._remaining <= 0:
                self._run_finish()
            return 0
        into = getattr(self._reader, "readinto", None)
        got = 0
        while got < want:
            if into is not None:
                n = into(view[got:want])
            else:
                chunk = self._reader.read(want - got)
                n = len(chunk)
                view[got:got + n] = chunk
            if not n:
                raise StreamError(f"body ended {self._remaining - got} bytes "
                                  "short of declared size")
            got += n
        self._remaining -= got
        if self._remaining == 0:
            self._run_finish()
        return got

    def _run_finish(self):
        if not self._finished:
            self._finished = True
            if self._finish is not None:
                self._finish()


class _BytesReader:
    def __init__(self, data):
        self._mv = memoryview(data).cast("B")
        self._pos = 0

    def read(self, n: int) -> bytes:
        chunk = self._mv[self._pos:self._pos + n]
        self._pos += len(chunk)
        return bytes(chunk)

    def readinto(self, view) -> int:
        chunk = self._mv[self._pos:self._pos + len(view)]
        view[:len(chunk)] = chunk
        self._pos += len(chunk)
        return len(chunk)


class ChunkReader:
    """A reader over an iterator of bytes-like chunks, each valid only
    until the next is pulled (ErasureSet.get_object_stream's windows):
    readinto copies out of the current chunk before pulling another, so a
    copy's source streams into its destination's buffers with one copy.
    close() closes the iterator, which returns its leases.

    With `length`, the iterator is closed as soon as that many bytes have
    been copied out (at once for a length of 0): a GET stream then drops
    its key's read lock before the reader's consumer commits, so a copy onto its own key (or of an
    older version over the latest) does not wait on its own source."""

    def __init__(self, chunks, length: Optional[int] = None):
        self._chunks = chunks
        self._cur = memoryview(b"")
        self._left = length
        if length == 0:
            self.close()

    def readinto(self, view) -> int:
        while not len(self._cur):
            if self._left == 0:
                return 0
            nxt = next(self._chunks, None)
            if nxt is None:
                return 0
            self._cur = memoryview(nxt).cast("B")
        n = min(len(view), len(self._cur))
        view[:n] = self._cur[:n]
        self._cur = self._cur[n:]
        if self._left is not None:
            self._left -= n
            if self._left <= 0:
                self._left = 0
                self.close()
        return n

    def read(self, n: int) -> bytes:
        buf = bytearray(n)
        return bytes(buf[:self.readinto(memoryview(buf))])

    def close(self) -> None:
        self._cur = memoryview(b"")
        self._chunks.close()


class HashingReader:
    """Feeds every byte that passes to a digest, so the content hash the
    client signed is checked the moment the body ends, with no second
    pass (reference internal/hash/reader.go)."""

    def __init__(self, reader, algorithm: str = "sha256"):
        self._reader = reader
        self.digest = hashlib.new(algorithm)

    def read(self, n: int) -> bytes:
        chunk = self._reader.read(n)
        if chunk:
            self.digest.update(chunk)
        return chunk

    def readinto(self, view) -> int:
        n = self._reader.readinto(view)
        if n:
            self.digest.update(view[:n])
        return n

    def hexdigest(self) -> str:
        return self.digest.hexdigest()


class LimitedReader:
    """At most `limit` bytes from an underlying file-like reader."""

    def __init__(self, raw, limit: int):
        self._raw = raw
        self._remaining = limit

    def read(self, n: int) -> bytes:
        if self._remaining <= 0:
            return b""
        chunk = self._raw.read(min(n, self._remaining))
        self._remaining -= len(chunk)
        return chunk

    def readinto(self, b) -> int:
        """The limit-capped readinto: a pooled window fills straight
        from the socket reader, with no bytes object between."""
        if self._remaining <= 0:
            return 0
        mv = memoryview(b).cast("B")
        want = min(len(mv), self._remaining)
        into = getattr(self._raw, "readinto", None)
        if into is not None:
            n = into(mv[:want]) or 0
        else:
            chunk = self._raw.read(want)
            n = len(chunk)
            mv[:n] = chunk
        self._remaining -= n
        return n


class HttpChunkedReader:
    """Incremental `Transfer-Encoding: chunked` decoder over a buffered
    socket file (.readline()/.read()). Consumes the terminal 0-chunk and
    the trailer lines, so a keep-alive connection sees a clean request
    boundary."""

    def __init__(self, rfile, max_size: int = 5 * (1 << 40)):
        self._rfile = rfile
        self._max = max_size
        self._seen = 0
        self._left = 0          # unread bytes of the current chunk
        self._done = False

    def _next_chunk(self) -> None:
        line = self._rfile.readline()
        if not line:
            raise StreamError("truncated chunked body")
        try:
            size = int(line.strip().split(b";")[0], 16)
        except ValueError:
            raise StreamError("bad chunk size") from None
        self._seen += size
        if self._seen > self._max:
            raise StreamError("chunked body exceeds size limit")
        if size == 0:
            # Trailer section: zero or more header lines, then CRLF.
            while True:
                t = self._rfile.readline()
                if not t or t in (b"\r\n", b"\n"):
                    break
            self._done = True
        else:
            self._left = size

    def read(self, n: int) -> bytes:
        while self._left == 0:
            if self._done:
                return b""
            self._next_chunk()
        take = min(n, self._left)
        data = self._rfile.read(take)
        if len(data) != take:
            raise StreamError("truncated chunk data")
        self._left -= take
        if self._left == 0:
            self._rfile.read(2)   # the chunk-terminating CRLF
        return data

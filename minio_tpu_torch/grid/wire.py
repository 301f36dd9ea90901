"""Wire framing of the grid mesh: control frames and raw bulk frames.

The port of minio_tpu/grid/wire.py. A control frame is a 4-byte
big-endian length and one MessagePack map (utils/mpack.py):

    {"t": TYPE, "m": mux_id, ...}

      T_REQ    {"h": handler, "p": payload}      unary call
      T_RESP   {"p": payload}                    unary result
      T_ERR    {"e": code, "msg": str}           call failed
      T_SREQ   {"h": handler, "p": payload,      open a stream
                "w": window}                     (initial credit, frames)
      T_CHUNK  {"p": item}                       one stream item
      T_EOF    {}                                stream end
      T_PING / T_PONG                            keepalive
      T_WIN    {"n": credits}                    grant stream credits

These are the frames the JAX grid's untraced callers emit, byte for
byte; the port has no tracing plane, so it sends no "tc" and no "ts".

A raw frame is the same length word with the high bit set, a 4-byte
mux id, then ``(length & 0x7fffffff) - 4`` payload bytes:

    [len | 0x80000000][mux][payload ...]

Raw frames carry bulk stream bytes (shard files) with no encode or
decode on either side: the sender ships them from the drive's fd with
os.sendfile or off a memoryview, the receiver lands them in a pooled
lease (grid/loop.py). A raw frame is a T_CHUNK whose item is its
payload bytes.
"""

from __future__ import annotations

import struct

from minio_tpu_torch.utils import mpack

T_REQ = 0
T_RESP = 1
T_ERR = 2
T_SREQ = 3
T_CHUNK = 4
T_EOF = 5
T_PING = 6
T_PONG = 7
T_WIN = 8

# A single frame never exceeds this; callers chunk larger payloads.
MAX_FRAME = 32 << 20
_LEN = struct.Struct(">I")
_RAW_BIT = 0x80000000
_RAW_HDR = struct.Struct(">II")

# Raw payload slice of the sendfile/send loops: one write-lock hold a
# slice, so small control frames interleave between slices.
RAW_SLICE = 1 << 20


class RawFile:
    """Stream item shipped as raw frames straight from the file with
    os.sendfile. length < 0 means to the end of the file."""

    __slots__ = ("path", "offset", "length")

    def __init__(self, path: str, offset: int = 0, length: int = -1):
        self.path = path
        self.offset = offset
        self.length = length


class RawBytes:
    """Stream item shipped as raw frames from an in-memory buffer."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data


class GridError(Exception):
    """Transport-level failure (connect, frame, timeout)."""


class RemoteCallError(GridError):
    """The remote handler raised; `code` maps back to a local exception."""

    def __init__(self, code: str, msg: str = ""):
        self.code = code
        super().__init__(f"{code}: {msg}" if msg else code)


def pack_frame(msg: dict) -> bytes:
    blob = mpack.packb(msg)
    if len(blob) > MAX_FRAME:
        raise GridError(f"frame too large: {len(blob)} bytes")
    return _LEN.pack(len(blob)) + blob


def pack_raw_header(mux: int, payload_len: int) -> bytes:
    """Header of a raw bulk frame: [len|RAW_BIT][mux]. The length word
    counts the mux field and the payload bytes that follow."""
    if payload_len > MAX_FRAME:
        raise GridError(f"raw frame too large: {payload_len} bytes")
    return _RAW_HDR.pack((payload_len + 4) | _RAW_BIT, mux)


def read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise GridError("connection closed")
        buf += got
    return bytes(buf)


def read_frame(sock) -> dict:
    """One frame read off a blocking socket. A raw frame comes back as
    ``{"t": T_CHUNK, "m": mux, "p": bytes, "raw": True}``."""
    (length,) = _LEN.unpack(read_exact(sock, 4))
    if length & _RAW_BIT:
        payload_len = (length & ~_RAW_BIT) - 4
        if payload_len < 0 or payload_len > MAX_FRAME:
            raise GridError(f"oversized raw frame: {length}")
        (mux,) = _LEN.unpack(read_exact(sock, 4))
        return {"t": T_CHUNK, "m": mux, "p": read_exact(sock, payload_len),
                "raw": True}
    if length > MAX_FRAME:
        raise GridError(f"oversized frame: {length}")
    try:
        return mpack.unpackb(read_exact(sock, length))
    except mpack.PackError as e:
        raise GridError(f"malformed frame: {e}") from None

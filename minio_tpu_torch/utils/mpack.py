"""The MessagePack subset the grid's control frames carry.

The port's own encoder and decoder for what grid/wire.pack_frame emits:
nil, bool, int (to 64 bits), float (float64), str, bin, array and map.
`packb(x)` gives the bytes of msgpack-python's `packb(x,
use_bin_type=True)` for every such value (smallest integer form,
unsigned for non-negative ints; str8 for 32-255 byte strings; bytes,
bytearray and memoryview as bin; list and tuple as array), and
`unpackb(blob)` what its `unpackb(blob, raw=False,
strict_map_key=False)` gives (arrays as lists, bin as bytes; float32
is read too). So the port's control frames are the JAX grid's frames
byte for byte (minio_tpu/grid/wire.py).
"""

from __future__ import annotations

import struct

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


class PackError(ValueError):
    """A value outside the subset, or a malformed blob."""


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + _B.pack(v)
        elif v <= 0xFFFF:
            out += b"\xcd" + _H.pack(v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + _I.pack(v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q.pack(v)
        else:
            raise PackError(f"integer {v} does not fit 64 bits")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + _b.pack(v)
    elif v >= -0x8000:
        out += b"\xd1" + _h.pack(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _i.pack(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(v)
    else:
        raise PackError(f"integer {v} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, c8: bytes, c16: bytes,
              c32: bytes, out: bytearray) -> None:
    if n < fix_max:
        out.append(fix | n)
    elif c8 and n <= 0xFF:
        out += c8 + _B.pack(n)
    elif n <= 0xFFFF:
        out += c16 + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += c32 + _I.pack(n)
    else:
        raise PackError(f"length {n} does not fit 32 bits")


def _pack(x, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, int):
        _pack_int(int(x), out)
    elif isinstance(x, float):
        out += b"\xcb" + _d.pack(x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, b"\xd9", b"\xda", b"\xdb", out)
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = memoryview(x).cast("B") if isinstance(x, memoryview) else x
        n = len(b)
        if n <= 0xFF:
            out += b"\xc4" + _B.pack(n)
        elif n <= 0xFFFF:
            out += b"\xc5" + _H.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xc6" + _I.pack(n)
        else:
            raise PackError(f"bin of {n} bytes does not fit 32 bits")
        out += b
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), 0x90, 16, b"", b"\xdc", b"\xdd", out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        _pack_len(len(x), 0x80, 16, b"", b"\xde", b"\xdf", out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise PackError(f"cannot pack {type(x).__name__}")


def packb(x) -> bytes:
    out = bytearray()
    _pack(x, out)
    return bytes(out)


def unpackb(blob) -> object:
    """The one value `blob` holds; trailing bytes are an error."""
    data = bytes(blob)
    val, pos = _unpack(data, 0)
    if pos != len(data):
        raise PackError(f"{len(data) - pos} trailing bytes")
    return val


def _need(data: bytes, pos: int, n: int) -> None:
    if pos + n > len(data):
        raise PackError("truncated blob")


def _unpack(data: bytes, pos: int):
    _need(data, pos, 1)
    c = data[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if c <= 0x8F:
        return _map(data, pos, c & 0x0F)
    if c <= 0x9F:
        return _array(data, pos, c & 0x0F)
    if c <= 0xBF:
        return _str(data, pos, c & 0x1F)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    fixed = _FIXED.get(c)
    if fixed is not None:
        st = fixed
        _need(data, pos, st.size)
        return st.unpack_from(data, pos)[0], pos + st.size
    sized = _SIZED.get(c)
    if sized is None:
        raise PackError(f"type byte 0x{c:02x} is outside the subset")
    st, kind = sized
    _need(data, pos, st.size)
    n = st.unpack_from(data, pos)[0]
    pos += st.size
    if kind == "bin":
        _need(data, pos, n)
        return data[pos:pos + n], pos + n
    if kind == "str":
        return _str(data, pos, n)
    if kind == "array":
        return _array(data, pos, n)
    return _map(data, pos, n)


def _str(data: bytes, pos: int, n: int):
    _need(data, pos, n)
    try:
        return data[pos:pos + n].decode("utf-8"), pos + n
    except UnicodeDecodeError as e:
        raise PackError(f"bad utf-8 in str: {e}") from None


def _array(data: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos)
        out.append(v)
    return out, pos


def _map(data: bytes, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        out[k] = v
    return out, pos


_FIXED = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h,
          0xD2: _i, 0xD3: _q, 0xCA: _f, 0xCB: _d}
_SIZED = {0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
          0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
          0xDC: (_H, "array"), 0xDD: (_I, "array"),
          0xDE: (_H, "map"), 0xDF: (_I, "map")}

"""The port's serve hot loop (s3/hotloop.py, s3/sigv4.PooledChunkedReader)
against the JAX package's, on the CPU.

  * the head framer: heads made from a numpy seed and fixed edge cases
    (split at every byte, a bare LF, duplicate headers, more headers
    than the limit, obs-fold, an empty target, a bad version) go through
    the port's `frame_head` and `ConnReader` and through the JAX
    package's native `mtpu_http_head` and its `ConnReader`: the same
    verdict, method, target, version, header mapping, head length and
    bytes left in the buffer (names lowercased in place as the native
    scan leaves them);
  * the aws-chunked frame scan: `chunk_head` against `mtpu_chunk_head`
    on the same frame headers;
  * the pooled aws-chunked reader: the wires of tests/test_native_http.py
    (signed, signed trailers, unsigned trailer, a tampered chunk or
    trailer signature, a truncated body, reads dribbled 1, 7, 311, 977
    bytes at a time, a source without readinto, a chunk larger than the
    buffer) through the JAX package's PooledChunkedReader and the
    port's: equal bytes, trailers and errors, and the port's lease
    returned;
  * the recv pool's lease accounting, gathered sends on a dead peer and
    the EAGAIN stop of send_nb.

Tolerance: none (bytes compare equal).
"""

import ctypes
import hashlib
import hmac
import io
import socket

import numpy as np
import pytest

from minio_tpu.s3 import hotloop as ref_hotloop
from minio_tpu.s3 import sigv4 as ref_sigv4
from minio_tpu_torch.s3 import hotloop, sigv4

LIB = ref_hotloop.lib()
SECRET = "minioadmin"
AMZ_DATE = "20260803T120000Z"
DATE = AMZ_DATE[:8]
REGION = "us-east-1"
SCOPE = f"{DATE}/{REGION}/s3/aws4_request"
SEED_SIG = "a" * 64
RNG = np.random.default_rng(17)


@pytest.fixture(scope="module", autouse=True)
def _native():
    assert LIB is not None, "the JAX package's native library must load"


# ---------------------------------------------------------------------------
# the head framer
# ---------------------------------------------------------------------------

def _ref_frame(raw: bytes):
    buf = bytearray(raw)
    arr = (ctypes.c_uint8 * max(1, len(buf))).from_buffer(
        buf if buf else bytearray(1))
    out = (ctypes.c_int32 * (6 + 4 * hotloop.MAX_HEADERS))()
    n = int(LIB.mtpu_http_head(arr, len(buf), out, hotloop.MAX_HEADERS))
    fields = list(out[:6 + 4 * out[5]]) if n > 0 else []
    return n, fields, bytes(buf)


def _port_frame(raw: bytes):
    buf = bytearray(raw)
    out: list = []
    n = hotloop.frame_head(buf, 0, len(buf), out)
    return n, (out if n > 0 else []), bytes(buf)


def _load(reader, data: bytes):
    """Put `data` into a ConnReader's buffer as a fill would."""
    reader._ensure()
    reader._mv[:len(data)] = data
    reader._start, reader._end = 0, len(data)


def _left(reader) -> bytes:
    return bytes(reader._mv[reader._start:reader._end]) \
        if reader._mv is not None else b""


def _try_both(data: bytes):
    """try_parse_head of both packages' ConnReader on the same buffered
    bytes: (verdict, head, bytes left) of each."""
    a, b = socket.socketpair()
    try:
        ref = ref_hotloop.ConnReader(a)
        port = hotloop.ConnReader(b)
        try:
            _load(ref, data)
            _load(port, data)
            rs, rh = ref.try_parse_head(LIB)
            ps, ph = port.try_parse_head()
            return (rs, rh, _left(ref)), (ps, ph, _left(port))
        finally:
            ref.close()
            port.close()
    finally:
        a.close()
        b.close()


def _seeded_head(rng) -> bytes:
    methods = [b"GET", b"PUT", b"HEAD", b"DELETE", b"POST", b"OPTIONS"]
    names = [b"Host", b"X-Amz-Date", b"x-amz-content-sha256",
             b"Authorization", b"Content-Length", b"Range", b"User-Agent",
             b"X-Amz-Meta-Colour", b"Connection", b"Expect",
             b"x-amz-checksum-crc32", b"ACCEPT-ENCODING"]
    head = methods[rng.integers(len(methods))] + b" /b" \
        + bytes(rng.integers(97, 123, rng.integers(1, 40), dtype=np.uint8)) \
        + (b"?uploads=" if rng.random() < 0.3 else b"") \
        + (b" HTTP/1.1\r\n" if rng.random() < 0.9 else b" HTTP/1.0\r\n")
    for _ in range(rng.integers(0, 14)):
        name = names[rng.integers(len(names))]
        ows = b" " * int(rng.integers(0, 3)) + b"\t" * int(rng.integers(0, 2))
        value = bytes(rng.integers(33, 127, rng.integers(0, 60),
                                   dtype=np.uint8))
        head += name + b":" + ows + value + ows[::-1] + b"\r\n"
    return head + b"\r\n"


SEEDED = [_seeded_head(RNG) for _ in range(40)]
FIXED = {
    "golden": b"PUT /b/k?uploads= HTTP/1.1\r\nHost: h:9000\r\n"
              b"X-Amz-Content-SHA256:  abc \r\n\r\nBODY",
    "no headers": b"GET / HTTP/1.1\r\n\r\n",
    "http10": b"GET /x HTTP/1.0\r\nConnection: keep-alive\r\n\r\n",
    "duplicates": b"GET / HTTP/1.1\r\nCache-Control: a\r\n"
                  b"cache-control: b\r\nCACHE-CONTROL:c\r\n\r\n",
    "pipelined": b"GET /a HTTP/1.1\r\nHost: x\r\n\r\n"
                 b"GET /b HTTP/1.1\r\nHost: x\r\n\r\n",
    "bare lf in value": b"GET / HTTP/1.1\r\nx-a: a\nx-evil: b\r\n\r\n",
    "bare lf in target": b"GET /x\ny HTTP/1.1\r\nHost: h\r\n\r\n",
    "bare lf after line": b"GET / HTTP/1.1\nHost: h\r\n\r\n",
    "obs-fold": b"GET / HTTP/1.1\r\nA: 1\r\n folded\r\n\r\n",
    "space in name": b"GET / HTTP/1.1\r\nBad Name: 1\r\n\r\n",
    "ctl in name": b"GET / HTTP/1.1\r\nOk: 1\r\nX-Bad\x01Name: 1\r\n\r\n",
    "empty target": b"GET  HTTP/1.1\r\nHost: h\r\n\r\n",
    "no version": b"GET /\r\n\r\n",
    "http2": b"GET / HTTP/2.0\r\n\r\n",
    "empty name": b"GET / HTTP/1.1\r\n: v\r\n\r\n",
    "no colon": b"GET / HTTP/1.1\r\nHost\r\n\r\n",
    "long method": b"A" * 33 + b" / HTTP/1.1\r\n\r\n",
    "too many": b"GET / HTTP/1.1\r\n" + b"".join(
        b"H%d: v\r\n" % i for i in range(hotloop.MAX_HEADERS + 1)) + b"\r\n",
    "at the limit": b"GET / HTTP/1.1\r\n" + b"".join(
        b"H%d: v\r\n" % i for i in range(hotloop.MAX_HEADERS)) + b"\r\n",
    "incomplete": b"GET / HTTP/1.1\r\nHost: h\r\n",
    "empty": b"",
}


@pytest.mark.parametrize("raw", SEEDED + list(FIXED.values()),
                         ids=[f"seed{i}" for i in range(len(SEEDED))]
                         + list(FIXED))
def test_frame_head_matches_native(raw):
    """Verdict, offsets and the buffer after the scan (names lowercased
    in place, as far as the scan went) equal mtpu_http_head's."""
    assert _port_frame(raw) == _ref_frame(raw)


@pytest.mark.parametrize("raw", SEEDED[:10] + list(FIXED.values()),
                         ids=[f"seed{i}" for i in range(10)] + list(FIXED))
def test_conn_reader_try_parse_matches(raw):
    """The ConnReaders' verdict, parsed head and bytes left are equal,
    with a body's first bytes buffered behind the head."""
    ref, port = _try_both(raw + b"\x00body")
    assert port == ref


@pytest.mark.parametrize("name", ["golden", "duplicates", "too many",
                                  "obs-fold"])
def test_split_at_every_byte(name):
    """Each prefix of a head (and of the next request's first bytes) is
    judged the same: "more" until the head is whole, then the head."""
    raw = FIXED[name] + b"GET /next HTTP/1.1\r\n"
    for k in range(len(raw) + 1):
        ref, port = _try_both(raw[:k])
        assert port == ref, k


def _parse_both(wire: bytes):
    """parse_head of both packages reading a socket: the head (or None
    at a clean EOF, or "fallback") and the bytes left buffered."""
    out = []
    for mod, args in ((ref_hotloop, (LIB,)), (hotloop, ())):
        a, b = socket.socketpair()
        try:
            a.sendall(wire)
            a.shutdown(socket.SHUT_WR)
            r = mod.ConnReader(b)
            try:
                try:
                    got = r.parse_head(*args)
                except mod._Fallback:
                    got = "fallback"
                out.append((got, _left(r)))
            finally:
                r.close()
        finally:
            a.close()
            b.close()
    return out


@pytest.mark.parametrize("name", ["golden", "duplicates", "pipelined",
                                  "obs-fold", "incomplete", "empty"])
def test_parse_head_from_socket_matches(name):
    ref, port = _parse_both(FIXED[name])
    assert port == ref


def test_readline_read_readinto_after_head():
    """The rfile surface serves the bytes a fill took past the head."""
    a, b = socket.socketpair()
    try:
        a.sendall(b"PUT /b/k HTTP/1.1\r\nContent-Length: 11\r\n\r\n"
                  b"hello world" b"line one\r\nrest")
        a.shutdown(socket.SHUT_WR)
        r = hotloop.ConnReader(b)
        d, method, target, _, http11 = r.parse_head()
        assert (method, target, http11, d["content-length"]) == \
            ("PUT", "/b/k", True, "11")
        view = bytearray(5)
        assert r.readinto(view) == 5 and bytes(view) == b"hello"
        assert r.read(6) == b" world"
        assert r.readline() == b"line one\r\n"
        assert r.read(100) == b"rest"
        r.close()
        with pytest.raises(ValueError):
            r._ensure()
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the aws-chunked frame scan
# ---------------------------------------------------------------------------

def _ref_chunk(raw: bytes, pos=0):
    buf = bytearray(raw) or bytearray(1)
    arr = (ctypes.c_uint8 * len(buf)).from_buffer(buf)
    out = (ctypes.c_int64 * 4)()
    r = int(LIB.mtpu_chunk_head(arr, len(raw), pos, out))
    return r, (list(out) if r == 1 else [])


def _port_chunk(raw: bytes, pos=0):
    out: list = []
    r = hotloop.chunk_head(bytearray(raw), len(raw), pos, out)
    return r, (out if r == 1 else [])


CHUNK_HEADS = [
    b"0\r\n", b"10000;chunk-signature=" + b"ab" * 32 + b"\r\n",
    b"1000000\r\n", b"1000001\r\n", b"00000000001000000\r\n",
    b"zz;chunk-signature=00\r\n", b"10 ;chunk-signature=ab\r\n",
    b"a;foo=bar;chunk-signature=cd\r\n", b"a;chunk-signature\r\n",
    b"a;chunk-signaturex=1\r\n", b"a;chunk-signature=;x\r\n",
    b"F;=x\r\n", b"1f;;\r\n", b"12", b"12;chunk-sig", b"x" * 5000,
    b"1" + b";" * 4090 + b"\r\n", b"1" + b";" * 4096 + b"\r\n",
]


@pytest.mark.parametrize("raw", CHUNK_HEADS, ids=range(len(CHUNK_HEADS)))
def test_chunk_head_matches_native(raw):
    assert _port_chunk(raw) == _ref_chunk(raw)
    framed = b"junk" + raw
    assert _port_chunk(framed, 4) == _ref_chunk(framed, 4)


# ---------------------------------------------------------------------------
# the pooled aws-chunked reader
# ---------------------------------------------------------------------------

def _auths(payload_hash=sigv4.STREAMING_PAYLOAD):
    kw = dict(signed_headers=["host"], signature=SEED_SIG,
              amz_date=AMZ_DATE, payload_hash=payload_hash)
    return (sigv4.ParsedAuth(credential=sigv4.Credential(
                "minioadmin", DATE, REGION, "s3"), **kw),
            ref_sigv4.ParsedAuth(credential=ref_sigv4.Credential(
                access_key="minioadmin", date=DATE, region=REGION,
                service="s3"), **kw))


def _chunk_body(body: bytes, chunk=64 * 1024, trailers=None,
                tamper_chunk=False, tamper_trailer=False,
                signed=True) -> bytes:
    """tests/test_native_http.py's aws-chunked wire, chained from
    SEED_SIG (unsigned: no chunk signatures)."""
    key = sigv4.signing_key(SECRET, DATE, REGION)
    out = bytearray()
    prev = SEED_SIG
    chunks = [body[i:i + chunk] for i in range(0, len(body), chunk)]
    for j, data in enumerate(chunks + [b""]):
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", AMZ_DATE, SCOPE,
                         prev, sigv4.EMPTY_SHA256,
                         hashlib.sha256(data).hexdigest()])
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        prev = sig
        if tamper_chunk and j == len(chunks) // 2:
            sig = ("f" if sig[0] != "f" else "0") + sig[1:]
        ext = f";chunk-signature={sig}" if signed else ""
        out += f"{len(data):x}{ext}\r\n".encode() + data + b"\r\n"
    if trailers is not None:
        out = out[:-2]
        raw = bytearray()
        for name, value in trailers.items():
            out += f"{name}:{value}\r\n".encode()
            raw += f"{name}:{value}\n".encode()
        if signed:
            sts = "\n".join(["AWS4-HMAC-SHA256-TRAILER", AMZ_DATE, SCOPE,
                             prev, hashlib.sha256(bytes(raw)).hexdigest()])
            tsig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            if tamper_trailer:
                tsig = ("f" if tsig[0] != "f" else "0") + tsig[1:]
            out += f"x-amz-trailer-signature:{tsig}\r\n".encode()
        out += b"\r\n"
    return bytes(out)


class Dribble:
    """A raw source returning at most `step` bytes a read."""

    def __init__(self, data: bytes, step: int, with_readinto=True):
        self._data = data
        self._pos = 0
        self._step = step
        if not with_readinto:
            self.readinto = None      # the readers probe with getattr

    def read(self, n: int) -> bytes:
        take = min(n, self._step, len(self._data) - self._pos)
        out = self._data[self._pos:self._pos + take]
        self._pos += take
        return out

    def readinto(self, mv) -> int:
        take = min(len(mv), self._step, len(self._data) - self._pos)
        mv[:take] = self._data[self._pos:self._pos + take]
        self._pos += take
        return take


def _decode(reader, n=8192):
    """(decoded bytes, trailers, error code or None) of a reader, its
    lease returned."""
    out = bytearray()
    try:
        while True:
            c = reader.read(n)
            if not c:
                break
            out += c
        reader.finalize()
        return bytes(out), reader.trailers, None
    except (sigv4.SigError, ref_sigv4.SigError) as e:
        return bytes(out), None, e.code
    finally:
        reader.close()


def _decode_both(wire, payload_hash=sigv4.STREAMING_PAYLOAD, step=977,
                 with_readinto=True, verify=True):
    mine, ref = _auths(payload_hash)
    pool = hotloop.recv_pool()
    before = pool.stats()["outstanding"]
    got = _decode(sigv4.PooledChunkedReader(
        Dribble(wire, step, with_readinto), mine, SECRET, verify))
    assert pool.stats()["outstanding"] == before
    want = _decode(ref_sigv4.PooledChunkedReader(
        Dribble(wire, step, with_readinto), ref, SECRET, verify, lib=LIB))
    return got, want


@pytest.mark.parametrize("size,step", [
    (size, step) for size in (0, 1, 100, 64 * 1024, 64 * 1024 + 1, 300_003)
    for step in (1, 7, 977, 1 << 20) if not (size > 100_000 and step < 7)])
def test_pooled_identity_across_read_boundaries(size, step):
    body = RNG.bytes(size)
    got, want = _decode_both(_chunk_body(body), step=step)
    assert got == want and got[0] == body and got[2] is None


def test_pooled_small_chunks_straddle_headers():
    body = RNG.bytes(997)
    got, want = _decode_both(_chunk_body(body, chunk=13), step=7)
    assert got == want and got[0] == body


def test_pooled_no_readinto_source():
    body = RNG.bytes(50_000)
    got, want = _decode_both(_chunk_body(body), with_readinto=False)
    assert got == want and got[0] == body


def test_pooled_signed_trailers():
    body = RNG.bytes(123_456)
    trailers = {"x-amz-checksum-crc32c": "wdBjLg=="}
    got, want = _decode_both(_chunk_body(body, trailers=trailers),
                             sigv4.STREAMING_PAYLOAD_TRAILER, step=311)
    assert got == want == (body, trailers, None)


def test_pooled_unsigned_trailer():
    body = RNG.bytes(70_000)
    trailers = {"x-amz-checksum-crc32": "AAAAAA=="}
    got, want = _decode_both(
        _chunk_body(body, trailers=trailers, signed=False),
        sigv4.STREAMING_UNSIGNED_TRAILER, step=977, verify=False)
    assert got == want == (body, trailers, None)


@pytest.mark.parametrize("case", ["chunk", "trailer", "truncated"])
def test_pooled_rejections(case):
    if case == "chunk":
        wire, ph = _chunk_body(RNG.bytes(200_000), tamper_chunk=True), \
            sigv4.STREAMING_PAYLOAD
    elif case == "trailer":
        wire, ph = _chunk_body(RNG.bytes(10_000),
                               trailers={"x-amz-checksum-crc32": "AAAAAA=="},
                               tamper_trailer=True), \
            sigv4.STREAMING_PAYLOAD_TRAILER
    else:
        wire, ph = _chunk_body(RNG.bytes(100_000))[:-40], \
            sigv4.STREAMING_PAYLOAD
    got, want = _decode_both(wire, ph, step=311 if case == "trailer"
                             else 977)
    assert got == want
    assert got[2] == {"chunk": "SignatureDoesNotMatch",
                      "trailer": "SignatureDoesNotMatch",
                      "truncated": "IncompleteBody"}[case]


def test_pooled_grows_for_a_large_chunk():
    """A 1 MiB chunk, larger than the 256 KiB lease: the reader swaps to
    a larger lease mid-frame and stays byte for byte the JAX reader's."""
    body = RNG.bytes((1 << 20) + 17)
    got, want = _decode_both(_chunk_body(body, chunk=1 << 20), step=1 << 16)
    assert got == want and got[0] == body


def test_pooled_reader_returns_lease():
    pool = hotloop.recv_pool()
    before = pool.stats()["outstanding"]
    body = RNG.bytes(100_000)
    mine, _ = _auths()
    r = sigv4.PooledChunkedReader(Dribble(_chunk_body(body), 977), mine,
                                  SECRET)
    out = bytearray()
    while c := r.read(8192):
        out += c
    r.finalize()
    assert bytes(out) == body
    assert pool.stats()["outstanding"] == before + 1
    r.close()
    r.close()                                   # idempotent
    assert pool.stats()["outstanding"] == before


def test_decode_chunked_payload_in_memory():
    body = RNG.bytes(5000)
    mine, ref = _auths()
    wire = _chunk_body(body, chunk=1024)
    assert sigv4.decode_chunked_payload(wire, mine, SECRET) == \
        ref_sigv4.decode_chunked_payload(wire, ref, SECRET) == body
    r = ref_sigv4.ChunkedPayloadReader(io.BytesIO(wire), ref, SECRET)
    assert r.read(1 << 20) == body[:1024]


# ---------------------------------------------------------------------------
# the pool and the sends
# ---------------------------------------------------------------------------

def test_recv_pool_accounting():
    pool = hotloop.RecvPool()
    a = pool.lease(100)
    b = pool.lease(hotloop.RECV_BUF)
    big = pool.lease(1 << 20)
    huge = pool.lease(64 << 20)                 # past the classes: unpooled
    assert len(a.raw) == len(b.raw) == hotloop.RECV_BUF
    assert len(big.raw) == 1 << 20 and len(huge.raw) == 64 << 20
    assert pool.stats()["outstanding"] == 4
    for lease in (a, b, big, huge):
        lease.release()
    a.release()                                 # a second release: no-op
    st = pool.stats()
    assert st["outstanding"] == 0 and st["idle"] == 3
    pool.lease(10).release()
    assert pool.stats()["hits"] == 1


def test_send_gathered_annotates_progress_on_dead_peer():
    a, b = socket.socketpair()
    b.close()
    try:
        with pytest.raises(OSError) as ei:
            hotloop.send_gathered(a, [b"HTTP/1.1 200 OK\r\n\r\n", b"body"])
        assert getattr(ei.value, "mtpu_sent", None) == 0
    finally:
        a.close()


def test_send_nb_stops_at_eagain():
    """On a full socket send_nb returns the views left, which a later
    call finishes: the peer reads every byte in order."""
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        a.setblocking(False)
        payload = [b"head", RNG.bytes(1 << 20), b"", RNG.bytes(333)]
        sent, rest = hotloop.send_nb(a, payload)
        assert rest and sent < sum(map(len, payload))
        got = bytearray()
        while rest:
            got += b.recv(1 << 20)
            more, rest = hotloop.send_nb(a, rest)
            sent += more
        want = b"".join(payload)
        while len(got) < len(want):
            got += b.recv(1 << 20)
        assert bytes(got) == want and sent == len(want)
    finally:
        a.close()
        b.close()

"""AWS Signature Version 4: header-signed request verification and signing.

The slice's subset of minio_tpu/s3/sigv4.py (itself the public AWS SigV4
scheme, as the reference implements it in cmd/signature-v4.go):
canonical request -> string-to-sign -> HMAC chain, for requests signed
in the Authorization header, and the aws-chunked streaming bodies
(`PooledChunkedReader`: per-chunk signatures chained from the seed
signature, signed trailers, decoded as the body streams). `sign_headers`
is the client side, used by the port's own tools and tests.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import io
import urllib.parse
from dataclasses import dataclass
from typing import Optional

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_PAYLOAD_TRAILER = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER"
STREAMING_UNSIGNED_TRAILER = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"
# x-amz-content-sha256 values whose body is aws-chunked framing: the raw
# body's SHA-256 is never compared, the decoded chunks are checked instead.
STREAMING_HASHES = (STREAMING_PAYLOAD, STREAMING_PAYLOAD_TRAILER,
                    STREAMING_UNSIGNED_TRAILER)
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class SigError(Exception):
    """Maps to S3 SignatureDoesNotMatch / AccessDenied family errors."""

    def __init__(self, code: str, msg: str = ""):
        self.code = code
        super().__init__(msg or code)


@dataclass
class Credential:
    access_key: str
    date: str        # YYYYMMDD
    region: str
    service: str

    @classmethod
    def parse(cls, scope: str) -> "Credential":
        parts = scope.split("/")
        if len(parts) != 5 or parts[4] != "aws4_request" or parts[3] != "s3":
            raise SigError("AuthorizationHeaderMalformed",
                           f"bad credential scope {scope!r}")
        return cls(access_key=parts[0], date=parts[1], region=parts[2],
                   service=parts[3])

    def scope(self) -> str:
        return f"{self.date}/{self.region}/{self.service}/aws4_request"


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    k = _hmac(b"AWS4" + secret.encode(), date.encode())
    k = _hmac(k, region.encode())
    k = _hmac(k, service.encode())
    return _hmac(k, b"aws4_request")


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query: dict[str, list[str]]) -> str:
    pairs = []
    for key in sorted(query):
        for v in sorted(query[key]):
            pairs.append(f"{uri_encode(key)}={uri_encode(v)}")
    return "&".join(pairs)


def canonical_request(method: str, raw_path: str, query: dict[str, list[str]],
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str) -> str:
    """`raw_path` is the still-percent-encoded URI as sent on the wire."""
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers)
    return "\n".join([method.upper(), raw_path or "/",
                      canonical_query(query), canon_headers,
                      ";".join(signed_headers), payload_hash])


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join([ALGORITHM, amz_date, scope,
                      hashlib.sha256(canon_req.encode()).hexdigest()])


@dataclass
class ParsedAuth:
    credential: Credential
    signed_headers: list[str]
    signature: str
    amz_date: str
    payload_hash: str


def parse_auth_header(headers: dict[str, str]) -> ParsedAuth:
    """Parse `Authorization: AWS4-HMAC-SHA256 Credential=..., ...`."""
    auth = headers.get("authorization", "")
    if not auth.startswith(ALGORITHM):
        raise SigError("AccessDenied", "unsupported authorization scheme")
    fields: dict[str, str] = {}
    for part in auth[len(ALGORITHM):].split(","):
        part = part.strip()
        if "=" in part:
            k, v = part.split("=", 1)
            fields[k.strip()] = v.strip()
    try:
        cred = Credential.parse(fields["Credential"])
        signed = fields["SignedHeaders"].lower().split(";")
        sig = fields["Signature"]
    except KeyError as e:
        raise SigError("AuthorizationHeaderMalformed", str(e)) from None
    if "host" not in signed:
        raise SigError("SignatureDoesNotMatch", "host header not signed")
    return ParsedAuth(credential=cred, signed_headers=signed, signature=sig,
                      amz_date=headers.get("x-amz-date", ""),
                      payload_hash=headers.get("x-amz-content-sha256",
                                               UNSIGNED_PAYLOAD))


def verify_request(method: str, raw_path: str, query: dict[str, list[str]],
                   headers: dict[str, str], secret_for,
                   body_hash: Optional[str] = None) -> ParsedAuth:
    """Verify a header-signed request; `headers` have lowercase names.

    `secret_for(access_key) -> secret | None`. Raises SigError on any
    mismatch, a clock skew beyond 15 minutes, or a body whose sha256
    differs from the signed x-amz-content-sha256 (an aws-chunked body is
    checked by decode_chunked_payload instead)."""
    auth = parse_auth_header(headers)
    secret = secret_for(auth.credential.access_key)
    if secret is None:
        raise SigError("InvalidAccessKeyId", auth.credential.access_key)
    try:
        t0 = datetime.datetime.strptime(auth.amz_date, "%Y%m%dT%H%M%SZ") \
            .replace(tzinfo=datetime.timezone.utc)
    except ValueError:
        raise SigError("AccessDenied", "bad x-amz-date") from None
    now = datetime.datetime.now(datetime.timezone.utc)
    if abs((now - t0).total_seconds()) > 15 * 60:
        raise SigError("AccessDenied", "request time too skewed")
    if body_hash is not None and body_hash != auth.payload_hash \
            and auth.payload_hash not in (UNSIGNED_PAYLOAD, *STREAMING_HASHES):
        raise SigError("XAmzContentSHA256Mismatch", "payload mismatch")
    canon = canonical_request(method, raw_path, query, headers,
                              auth.signed_headers, auth.payload_hash)
    sts = string_to_sign(auth.amz_date, auth.credential.scope(), canon)
    key = signing_key(secret, auth.credential.date, auth.credential.region)
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, auth.signature):
        raise SigError("SignatureDoesNotMatch")
    return auth


class PooledChunkedReader:
    """Incremental aws-chunked decoder over one pooled recv buffer
    (minio_tpu/s3/sigv4.py `PooledChunkedReader`; reference
    cmd/streaming-signature-v4.go s3ChunkedReader).

    Frames `hex-size;chunk-signature=<sig>\r\n<data>\r\n` up to a
    zero-size one are scanned (s3/hotloop.chunk_head, the verdicts of
    the JAX package's native `mtpu_chunk_head`) straight out of a lease
    of s3/hotloop's recv pool that the raw bytes land in once: no
    bytearray append and trim per frame, each chunk's SHA-256 runs over
    a view of the same buffer, and the decoded bytes are copied out
    once, into the caller's window. A chunk larger than the buffer swaps
    it for a larger lease (up to the 16 MiB chunk bound). With
    verify_signatures (every streaming hash but
    STREAMING-UNSIGNED-PAYLOAD-TRAILER), each chunk's signature chains
    from the previous one, starting at the request's seed signature; in
    signed-trailer mode the final zero-size chunk is checked when it
    carries a signature. `finalize()` consumes the final chunk and parses
    the trailer lines into `trailers`, checking x-amz-trailer-signature
    in signed-trailer mode; the PUT path runs it from the payload's
    finish hook, before the commit. Raises SigError:
    SignatureDoesNotMatch for a bad signature, IncompleteBody or
    InvalidChunkSizeError for broken framing. `close()` returns the
    lease; the serve path calls it when the request ends, whatever the
    body's fate.
    """

    _FILL = 64 * 1024
    _LEASE = 256 << 10

    def __init__(self, raw, auth: ParsedAuth, secret: str,
                 verify_signatures: bool = True):
        from minio_tpu_torch.s3.hotloop import recv_pool
        self._raw = raw
        self._auth = auth
        self._verify = verify_signatures
        self._seed_key = signing_key(secret, auth.credential.date,
                                     auth.credential.region,
                                     auth.credential.service)
        self._prev_sig = auth.signature
        self._scope = auth.credential.scope()
        self._pool = recv_pool()
        self._lease = self._pool.lease(self._LEASE)
        self._attach()
        self._out: list = []
        self._pos = 0              # parse cursor
        self._end = 0              # valid bytes
        self._data_lo = 0          # the current chunk's unread span
        self._data_hi = 0
        self._done = False
        self._closed = False
        self.trailers: dict[str, str] = {}

    # -- buffer plumbing -------------------------------------------------

    def _attach(self) -> None:
        self._buf = self._lease.raw
        self._cap = len(self._buf)
        self._mv = memoryview(self._buf)

    def _compact(self) -> None:
        if self._pos:
            n = self._end - self._pos
            self._mv[:n] = self._mv[self._pos:self._end]
            self._pos, self._end = 0, n

    def _grow(self, need: int) -> None:
        """Swap to a larger lease holding [pos, end) (a chunk larger
        than the buffer; bounded by the 16 MiB chunk bound)."""
        data = bytes(self._mv[self._pos:self._end])
        lease = self._pool.lease(need + self._FILL)
        self._mv.release()
        self._lease.release()
        self._lease = lease
        self._attach()
        self._mv[:len(data)] = data
        self._pos, self._end = 0, len(data)

    def _fill(self) -> int:
        """Pull more raw bytes into the buffer's tail (readinto straight
        into it when the source has one)."""
        if self._end == self._cap:
            self._compact()
            if self._end == self._cap:
                return 0
        want = min(self._FILL, self._cap - self._end)
        into = getattr(self._raw, "readinto", None)
        if into is not None:
            n = into(self._mv[self._end:self._end + want]) or 0
        else:
            data = self._raw.read(want)
            n = len(data)
            self._mv[self._end:self._end + n] = data
        self._end += n
        return n

    def _ensure(self, need: int) -> None:
        """Make buf[pos:pos + need) valid (fill, compact or grow)."""
        if need > self._cap:
            self._grow(need)
        while self._end - self._pos < need:
            if self._cap - self._pos < need:
                self._compact()
            if not self._fill():
                raise SigError("IncompleteBody", "short chunk")

    # -- frame parsing ---------------------------------------------------

    def _next_frame(self) -> None:
        from minio_tpu_torch.s3.hotloop import chunk_head
        out = self._out
        while True:
            r = chunk_head(self._buf, self._end, self._pos, out)
            if r == 1:
                break
            if r != 0:
                raise SigError("InvalidChunkSizeError", "bad chunk header")
            if self._end - self._pos > self._cap - 8:
                self._compact()
            if not self._fill():
                raise SigError("IncompleteBody", "truncated chunk header")
        hlen, size, sig_off, sig_len = out
        base = self._pos
        self._ensure(hlen + size + (2 if size else 0))
        if sig_off:
            # _ensure may have moved the frame to offset 0.
            sig_off -= base - self._pos
        doff = self._pos + hlen
        if size and self._buf[doff + size:doff + size + 2] != b"\r\n":
            raise SigError("IncompleteBody", "bad chunk delimiter")
        if self._verify and (
                self._auth.payload_hash == STREAMING_PAYLOAD
                or (self._auth.payload_hash == STREAMING_PAYLOAD_TRAILER
                    and (size > 0 or sig_off > 0))):
            # Signed-trailer mode signs the final 0-chunk too and the
            # trailer signature chains from it; a bare `0` final frame
            # is tolerated, and the chain then ends at the last data
            # chunk.
            got = bytes(self._mv[sig_off:sig_off + sig_len]) \
                .decode("latin-1") if sig_off else ""
            sts = "\n".join([
                "AWS4-HMAC-SHA256-PAYLOAD", self._auth.amz_date,
                self._scope, self._prev_sig, EMPTY_SHA256,
                hashlib.sha256(self._mv[doff:doff + size]).hexdigest()])
            want = hmac.new(self._seed_key, sts.encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, got):
                raise SigError("SignatureDoesNotMatch", "chunk signature")
            self._prev_sig = want
        self._pos = doff + size + (2 if size else 0)
        if size == 0:
            self._done = True
        else:
            self._data_lo, self._data_hi = doff, doff + size

    def read(self, n: int) -> bytes:
        while self._data_lo >= self._data_hi and not self._done:
            self._next_frame()
        take = min(max(n, 0), self._data_hi - self._data_lo)
        out = bytes(self._mv[self._data_lo:self._data_lo + take])
        self._data_lo += take
        return out

    def readinto(self, view) -> int:
        """Decoded bytes straight into `view` (one chunk's worth at
        most); 0 after the final chunk."""
        while self._data_lo >= self._data_hi and not self._done:
            self._next_frame()
        n = min(len(view), self._data_hi - self._data_lo)
        view[:n] = self._mv[self._data_lo:self._data_lo + n]
        self._data_lo += n
        return n

    def finalize(self) -> None:
        """Consume the 0-chunk and the trailers; a further data chunk
        means the body was longer than its declared decoded length.
        Trailer lines parse into `trailers` (SDKs send their default
        upload checksums there, x-amz-checksum-crc32 and the like)."""
        while not self._done:
            self._next_frame()
            if self._data_hi > self._data_lo:
                raise SigError("IncompleteBody",
                               "body exceeds decoded content length")
        self.trailers = {}
        # `name:value\r\n` lines, the x-amz-trailer-signature line among
        # them in signed mode, then a blank line.
        trailer_raw = bytearray()       # the lines as sent, '\n'-ended
        trailer_sig = ""
        while True:
            nl = self._buf.find(b"\r\n", self._pos, self._end)
            if nl < 0:
                if not self._fill():
                    break
                continue
            line = bytes(self._mv[self._pos:nl])
            self._pos = nl + 2
            name, sep, value = line.partition(b":")
            if not sep:
                continue
            lname = name.decode("latin-1").strip().lower()
            if lname == "x-amz-trailer-signature":
                trailer_sig = value.decode("latin-1").strip()
                continue
            trailer_raw += line + b"\n"
            self.trailers[lname] = value.decode("latin-1").strip()
        # Signed-trailer mode authenticates the trailer section too: an
        # AWS4-HMAC-SHA256-TRAILER string to sign over the hash of the
        # trailer lines, chained from the last chunk's signature.
        # Without it a declared trailing checksum could be swapped.
        if self._verify \
                and self._auth.payload_hash == STREAMING_PAYLOAD_TRAILER \
                and (self.trailers or trailer_sig):
            sts = "\n".join([
                "AWS4-HMAC-SHA256-TRAILER", self._auth.amz_date,
                self._scope, self._prev_sig,
                hashlib.sha256(bytes(trailer_raw)).hexdigest()])
            want = hmac.new(self._seed_key, sts.encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, trailer_sig):
                raise SigError("SignatureDoesNotMatch", "trailer signature")

    def close(self) -> None:
        """Return the buffer's lease (idempotent)."""
        if not self._closed:
            self._closed = True
            self._mv.release()
            self._lease.release()


def chunked_reader(raw, auth: ParsedAuth, secret: str,
                   verify_signatures: bool = True) -> PooledChunkedReader:
    """The aws-chunked streaming decoder of the serve path."""
    return PooledChunkedReader(raw, auth, secret, verify_signatures)


def decode_chunked_payload(body, auth: ParsedAuth, secret: str,
                           verify_signatures: bool = True) -> bytearray:
    """Decode a whole aws-chunked body held in memory: the chunks of
    PooledChunkedReader, every signature and the trailers checked as
    it checks them."""
    reader = PooledChunkedReader(io.BytesIO(body), auth, secret,
                                 verify_signatures)
    try:
        out = bytearray()
        while chunk := reader.read(1 << 20):
            out += chunk
        reader.finalize()
        return out
    finally:
        reader.close()


def sign_headers(method: str, host: str, path: str, access_key: str,
                 secret_key: str, payload_hash: str,
                 query: Optional[dict[str, list[str]]] = None,
                 region: str = "us-east-1",
                 extra: Optional[dict[str, str]] = None) -> tuple[str, dict]:
    """Client side: (encoded request URI, headers incl. Authorization)
    for a request to `path` (not yet percent-encoded)."""
    amz_date = datetime.datetime.now(datetime.timezone.utc) \
        .strftime("%Y%m%dT%H%M%SZ")
    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    headers.update({k.lower(): v for k, v in (extra or {}).items()})
    signed = sorted(headers)
    uri = uri_encode(path, encode_slash=False)
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    canon = canonical_request(method, uri, query or {}, headers, signed,
                              payload_hash)
    sig = hmac.new(signing_key(secret_key, amz_date[:8], region),
                   string_to_sign(amz_date, scope, canon).encode(),
                   hashlib.sha256).hexdigest()
    headers["authorization"] = (f"{ALGORITHM} Credential={access_key}/{scope}, "
                                f"SignedHeaders={';'.join(signed)}, "
                                f"Signature={sig}")
    return uri, headers

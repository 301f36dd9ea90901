"""The port's ranged GET/HEAD and aws-chunked PUT against the JAX package's.

Two servers on 12 drives each (EC 8+4), both serving from threads of
this process: the port's, booted through its command line's `boot()` with
`--device cpu`, and the JAX package's S3Server. The same signed requests (tests/s3client.py)
go to both, and every status, `Content-Range`, `Content-Length`, error
code and body must be equal:

  * Range: a table of headers on a 100-byte object and on an object of
    one full erasure window + 777 B, on GET and on HEAD; a range across
    the window boundary read from the port with 4 data drives wiped.
  * aws-chunked: the port's `decode_chunked_payload` against the
    reference's decoder and `ChunkedPayloadReader` on the same bodies;
    over HTTP, streaming-signed, signed-trailer, unsigned-trailer and
    HTTP `Transfer-Encoding: chunked` PUTs read back byte for byte with
    the ETag of a plain PUT; flipped chunk and trailer signatures, wrong
    and missing `x-amz-decoded-content-length`.
  * Multipart: initiate, a plain part, an aws-chunked signed part and a
    part with a declared CRC32 (right and wrong), the part and upload
    listings, complete, GET, HEAD and a range across parts of the
    object; InvalidPart, InvalidPartOrder, EntityTooSmall, NoSuchUpload
    and MalformedXML.

The port's set has its MRF heal queue closed, as the reference's is in
tests/test_torch_object.py: the tests take drives away and put them back
by hand, and a background heal would race them.
"""

import base64
import hashlib
import hmac
import http.client
import io
import os
import re
import threading
import xml.etree.ElementTree as ET
import zlib
from pathlib import Path

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet
from minio_tpu.s3 import sigv4 as ref_sigv4
from minio_tpu.s3.server import S3Server
from minio_tpu.storage.local import LocalStorage
from minio_tpu_torch import server
from minio_tpu_torch.object.erasure_object import (BLOCK_SIZE,
                                                   STREAM_WINDOW_BLOCKS,
                                                   hash_order)
from minio_tpu_torch.s3 import sigv4
from tests.s3client import S3Client

BUCKET = "compat"
WINDOW = STREAM_WINDOW_BLOCKS * BLOCK_SIZE
RNG = np.random.default_rng(6)
OBJECTS = {"small": RNG.bytes(100), "window": RNG.bytes(WINDOW + 777)}
RANGES = ["bytes=0-9", "bytes=-10", "bytes=90-", "bytes=95-200",
          "bytes=100-", "bytes=-0", "bytes=5-2", "items=0-1",
          "bytes=0-1,4-5"]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(port address, port drive paths, reference address), both with
    BUCKET holding OBJECTS."""
    root = tmp_path_factory.mktemp("s3compat")
    drives = [str(root / "port" / f"d{i}") for i in range(12)]
    # No periodic scanner: a case moves shard files away by hand and back,
    # which a scanner cycle in between would heal over.
    port = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                        "--scanner-interval", "0", *drives])
    port.objects._mrf_closed = True
    thread = threading.Thread(target=port.serve_forever, daemon=True)
    thread.start()
    ref = S3Server(ErasureSet([LocalStorage(str(root / "ref" / f"d{i}"))
                               for i in range(12)]), address="127.0.0.1:0")
    ref.start()
    try:
        for addr in (port.address, ref.address):
            c = S3Client(addr, timeout=300)
            assert c.request("PUT", f"/{BUCKET}")[0] == 200
            for key, body in OBJECTS.items():
                assert c.request("PUT", f"/{BUCKET}/{key}", body=body)[0] \
                    == 200
        yield port.address, drives, ref.address
    finally:
        ref.stop()
        port.shutdown()
        thread.join(timeout=30)


def _code(body: bytes) -> str:
    m = re.search(rb"<Code>([^<]*)</Code>", body)
    return m.group(1).decode() if m else ""


def _answer(address: str, method: str, path: str, headers=None, **kw):
    """(status, Content-Range, Content-Length, body or error code)."""
    st, h, body = S3Client(address, timeout=300).request(
        method, path, headers=headers, **kw)
    h = {k.lower(): v for k, v in h.items()}
    if st >= 300:       # error documents differ in their extra fields
        return st, h.get("content-range"), None, _code(body)
    return st, h.get("content-range"), h.get("content-length"), body


# -- C1: ranges ----------------------------------------------------------------


@pytest.mark.parametrize("method", ["GET", "HEAD"])
@pytest.mark.parametrize("rng", RANGES)
@pytest.mark.parametrize("key", sorted(OBJECTS))
def test_range_matches_reference(servers, key, rng, method):
    port, _, ref = servers
    path = f"/{BUCKET}/{key}"
    want = _answer(ref, method, path, {"Range": rng})
    got = _answer(port, method, path, {"Range": rng})
    assert got == want
    if want[0] == 206 and method == "GET":
        lo, hi = map(int, want[1].split()[1].split("/")[0].split("-"))
        assert got[3] == OBJECTS[key][lo:hi + 1]


@pytest.mark.parametrize("method", ["GET", "HEAD"])
def test_range_across_window_boundary_matches_reference(servers, method):
    port, _, ref = servers
    rng = f"bytes={WINDOW - 1000}-{WINDOW + 500}"
    want = _answer(ref, method, f"/{BUCKET}/window", {"Range": rng})
    assert want[0] == 206
    assert _answer(port, method, f"/{BUCKET}/window", {"Range": rng}) == want


def test_range_across_windows_with_four_data_drives_wiped(servers):
    port, drives, _ = servers
    dist = hash_order(f"{BUCKET}/window", 12)
    holders = [i for i in range(12) if dist[i] - 1 < 8][:4]
    moved = []
    try:
        for i in holders:
            src = os.path.join(drives[i], BUCKET, "window")
            os.rename(src, src + ".wiped")
            moved.append(src)
        lo, hi = WINDOW - 3 * BLOCK_SIZE - 5, WINDOW + 700
        st, crange, clen, body = _answer(port, "GET", f"/{BUCKET}/window",
                                         {"Range": f"bytes={lo}-{hi}"})
        assert (st, crange, int(clen)) == \
            (206, f"bytes {lo}-{hi}/{WINDOW + 777}", hi - lo + 1)
        assert body == OBJECTS["window"][lo:hi + 1]
    finally:
        for src in moved:
            os.rename(src + ".wiped", src)


def test_object_stream_reads_only_the_range(tmp_path):
    """get_object_stream(offset, length) on the object layer: the chunks
    are the range, and only the windows covering it are read."""
    from minio_tpu_torch.object import erasure_object as eo
    from minio_tpu_torch.object.types import InvalidRange
    from minio_tpu_torch.storage.local import LocalStorage as PortStorage
    es = eo.ErasureSet([PortStorage(str(tmp_path / f"d{i}"))
                        for i in range(12)], device="cpu")
    try:
        body = RNG.bytes(3 * BLOCK_SIZE + 99)
        es.make_bucket("bkt")
        es.put_object("bkt", "obj", body)
        calls = []
        real = es._read_window
        es._read_window = lambda *a: calls.append(a[-2:]) or real(*a)
        for off, length, blocks in ((BLOCK_SIZE + 7, 10, [(1, 1)]),
                                    (BLOCK_SIZE - 1, 2, [(0, 1)]),
                                    (3 * BLOCK_SIZE, 99, [(3, 3)]),
                                    (5, None, [(0, 3)]), (0, 0, [])):
            calls.clear()
            _, chunks = es.get_object_stream("bkt", "obj", off, length)
            end = len(body) if length is None else off + length
            assert b"".join(chunks) == body[off:end]
            assert calls == blocks
        for off, length in ((len(body), 1), (0, len(body) + 1), (-1, 2)):
            with pytest.raises(InvalidRange):
                es.get_object_stream("bkt", "obj", off, length)
    finally:
        es.close()


# -- C2: aws-chunked bodies ----------------------------------------------------

SECRET = "minioadmin"
AMZ_DATE = "20260803T120000Z"
SCOPE = f"{AMZ_DATE[:8]}/us-east-1/s3/aws4_request"
SEED = "c" * 64


def _auths(payload_hash):
    """The same parsed Authorization for the port's and the reference's
    decoder."""
    out = []
    for mod in (sigv4, ref_sigv4):
        out.append(mod.ParsedAuth(
            credential=mod.Credential(access_key="minioadmin",
                                      date=AMZ_DATE[:8], region="us-east-1",
                                      service="s3"),
            signed_headers=["host"], signature=SEED, amz_date=AMZ_DATE,
            payload_hash=payload_hash))
    return out


def _encode(body: bytes, chunk: int, trailers=None, signed=True,
            flip_chunk=None, flip_trailer=False, sign_final=True,
            seed=SEED, amz_date=AMZ_DATE) -> bytes:
    """aws-chunked framing of body chained from the seed signature, as an
    SDK sends it."""
    key = ref_sigv4.signing_key(SECRET, amz_date[:8], "us-east-1")
    scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
    out, prev = bytearray(), seed
    pieces = [body[i:i + chunk] for i in range(0, len(body), chunk)] + [b""]
    for j, data in enumerate(pieces):
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
                         ref_sigv4.EMPTY_SHA256,
                         hashlib.sha256(data).hexdigest()])
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        sent = signed and bool(data or sign_final)
        prev = sig if sent else prev   # a bare final chunk ends the chain
        if j == flip_chunk:
            sig = ("0" if sig[0] != "0" else "1") + sig[1:]
        ext = f";chunk-signature={sig}" if sent else ""
        out += f"{len(data):x}{ext}\r\n".encode() + data
        out += b"\r\n" if data or trailers is None else b""
    if trailers is not None:
        raw = b"".join(f"{k}:{v}\n".encode() for k, v in trailers.items())
        out += b"".join(f"{k}:{v}\r\n".encode() for k, v in trailers.items())
        if signed:
            sts = "\n".join(["AWS4-HMAC-SHA256-TRAILER", amz_date, scope,
                             prev, hashlib.sha256(raw).hexdigest()])
            tsig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            if flip_trailer:
                tsig = tsig[:-1] + ("0" if tsig[-1] != "0" else "1")
            out += f"x-amz-trailer-signature:{tsig}\r\n".encode()
        out += b"\r\n"
    return bytes(out)


def _ref_reader(raw: bytes, auth, verify: bool) -> bytes:
    r = ref_sigv4.ChunkedPayloadReader(io.BytesIO(raw), auth, SECRET, verify)
    out = bytearray()
    while chunk := r.read(1 << 20):
        out += chunk
    r.finalize()
    return bytes(out)


@pytest.mark.parametrize("size,chunk", [(0, 64), (1, 64), (1000, 64),
                                        (70000, 65536), (200000, 8192)])
def test_decoder_matches_reference(size, chunk):
    body = RNG.bytes(size)
    raw = _encode(body, chunk)
    mine, ref = _auths(sigv4.STREAMING_PAYLOAD)
    got = sigv4.decode_chunked_payload(raw, mine, SECRET)
    assert got == ref_sigv4.decode_chunked_payload(raw, ref, SECRET) == body
    assert _ref_reader(raw, ref, True) == body


@pytest.mark.parametrize("variant", ["signed", "signed bare final",
                                     "unsigned"])
def test_trailer_decoder_matches_reference(variant):
    body = RNG.bytes(5000)
    signed = variant != "unsigned"
    ph = sigv4.STREAMING_PAYLOAD_TRAILER if signed \
        else sigv4.STREAMING_UNSIGNED_TRAILER
    raw = _encode(body, 1024, trailers={"x-amz-checksum-crc32": "AAAAAA=="},
                  signed=signed, sign_final=variant == "signed")
    mine, ref = _auths(ph)
    got = sigv4.decode_chunked_payload(raw, mine, SECRET, signed)
    assert got == ref_sigv4.decode_chunked_payload(raw, ref, SECRET, signed)
    assert got == _ref_reader(raw, ref, signed) == body


@pytest.mark.parametrize("case", ["chunk", "final chunk", "trailer",
                                  "short chunk", "bad size"])
def test_decoder_refuses_as_reference(case):
    body = RNG.bytes(3000)
    ph = sigv4.STREAMING_PAYLOAD_TRAILER if case == "trailer" \
        else sigv4.STREAMING_PAYLOAD
    raw = {"chunk": lambda: _encode(body, 1024, flip_chunk=1),
           "final chunk": lambda: _encode(body, 1024, flip_chunk=3),
           "trailer": lambda: _encode(body, 1024, trailers={"a": "b"},
                                      flip_trailer=True),
           "short chunk": lambda: _encode(body, 1024)[:1500],
           "bad size": lambda: b"zz;chunk-signature=00\r\n"}[case]()
    mine, ref = _auths(ph)
    with pytest.raises(ref_sigv4.SigError) as want:
        _ref_reader(raw, ref, True)
    with pytest.raises(sigv4.SigError) as got:
        sigv4.decode_chunked_payload(raw, mine, SECRET)
    assert got.value.code == want.value.code


class _FlippingClient(S3Client):
    """Flips one hex digit of the second chunk's signature."""

    def _chunk_body(self, *a, **kw):
        out = super()._chunk_body(*a, **kw)
        i = out.index(b"chunk-signature=", out.index(b"chunk-signature=")
                      + 1) + len(b"chunk-signature=")
        return out[:i] + (b"0" if out[i:i + 1] != b"0" else b"1") \
            + out[i + 1:]


def _both(servers, fn):
    port, _, ref = servers
    return fn(port), fn(ref)


@pytest.mark.parametrize("mode", ["chunked", "te_chunked",
                                  "chunked+te_chunked", "trailers"])
def test_chunked_put_reads_back_with_plain_etag(servers, mode):
    body = RNG.bytes(150_000 + len(mode))
    kw = {"chunked": mode != "te_chunked",
          "te_chunked": "te_chunked" in mode}
    if mode == "trailers":
        crc = base64.b64encode(zlib.crc32(body).to_bytes(4, "big")).decode()
        kw["trailers"] = {"x-amz-checksum-crc32": crc}

    def run(addr):
        c = S3Client(addr, timeout=300)
        key = f"/{BUCKET}/put-{mode}"
        st, h, err = c.request("PUT", key, body=body, **kw)
        assert st == 200, err
        st2, h2, _ = c.request("PUT", key + "-plain", body=body)
        st3, _, got = c.request("GET", key)
        assert (st2, st3, got == body) == (200, 200, True)
        return h["ETag"] == h2["ETag"]
    assert _both(servers, run) == (True, True)


def _raw_chunked_put(addr: str, path: str, body: bytes, payload_hash: str,
                     extra: dict, **encode) -> tuple[int, str]:
    """An aws-chunked PUT signed by hand: headers as given in `extra`,
    chunks chained from the request's own signature."""
    uri, headers = sigv4.sign_headers("PUT", addr, path, "minioadmin",
                                      SECRET, payload_hash, extra={
                                          "content-encoding": "aws-chunked",
                                          **extra})
    raw = _encode(body, 65536, seed=headers["authorization"].rsplit(
        "Signature=", 1)[1], amz_date=headers["x-amz-date"], **encode)
    conn = http.client.HTTPConnection(addr, timeout=300)
    try:
        conn.request("PUT", uri, body=raw, headers=headers)
        resp = conn.getresponse()
        return resp.status, _code(resp.read())
    finally:
        conn.close()


def test_unsigned_trailer_put(servers):
    body = RNG.bytes(70_000)

    def run(addr):
        st, _ = _raw_chunked_put(
            addr, f"/{BUCKET}/unsigned-trailer", body,
            sigv4.STREAMING_UNSIGNED_TRAILER,
            {"x-amz-decoded-content-length": str(len(body)),
             "x-amz-trailer": "x-amz-meta-note"},
            trailers={"x-amz-meta-note": "x"}, signed=False)
        _, _, got = S3Client(addr).request("GET", f"/{BUCKET}/unsigned-trailer")
        return st, got == body
    assert _both(servers, run) == ((200, True), (200, True))


@pytest.mark.parametrize("case", ["flipped chunk", "flipped trailer",
                                  "decoded short", "decoded long",
                                  "decoded missing"])
def test_chunked_put_refusals_match_reference(servers, case):
    body = RNG.bytes(100_000)
    key = f"/{BUCKET}/refused-{case.replace(' ', '-')}"
    headers = {"decoded short": {"x-amz-decoded-content-length": "99999"},
               "decoded long": {"x-amz-decoded-content-length": "100001"},
               }.get(case)

    def run(addr):
        if case == "decoded missing":
            st, code = _raw_chunked_put(addr, key, body,
                                        sigv4.STREAMING_PAYLOAD, {})
        else:
            cls = _FlippingClient if case == "flipped chunk" else S3Client
            kw = {"trailers": {"x-amz-meta-a": "b"},
                  "corrupt_trailer_sig": True} \
                if case == "flipped trailer" else {}
            st, _, err = cls(addr, timeout=300).request(
                "PUT", key, body=body, chunked=True, headers=headers, **kw)
            code = _code(err)
        return st, code, S3Client(addr).request("GET", key)[0]
    got, want = _both(servers, run)
    assert got == want
    assert want[0] in (400, 403, 411, 500) and want[2] == 404


def test_verify_request_skips_the_raw_hash_only_for_streaming():
    """The SHA-256 of an aws-chunked body is never compared with its
    payload hash; any other signed hash still is."""
    assert set(sigv4.STREAMING_HASHES) == {
        ref_sigv4.STREAMING_PAYLOAD, ref_sigv4.STREAMING_PAYLOAD_TRAILER,
        ref_sigv4.STREAMING_UNSIGNED_TRAILER}
    for ph, ok in ((sigv4.STREAMING_PAYLOAD, True),
                   (hashlib.sha256(b"x").hexdigest(), False)):
        uri, h = sigv4.sign_headers("PUT", "h:1", "/b/k", "ak", "sk", ph)
        call = lambda: sigv4.verify_request(  # noqa: E731
            "PUT", uri, {}, h, {"ak": "sk"}.get,
            body_hash=hashlib.sha256(b"y").hexdigest())
        if ok:
            call()
        else:
            with pytest.raises(sigv4.SigError, match="payload mismatch"):
                call()


# -- C1: declared checksums ----------------------------------------------------

def _crc32_b64(data: bytes) -> str:
    return base64.b64encode(zlib.crc32(data).to_bytes(4, "big")).decode()


def _sha256_b64(data: bytes) -> str:
    return base64.b64encode(hashlib.sha256(data).digest()).decode()


CK_BODY = RNG.bytes(1000)
CK_CASES = {
    # case: (headers, client options, stored?)
    "crc32 header": ({"x-amz-checksum-crc32": _crc32_b64(CK_BODY)}, {}),
    "sha256 header": ({"x-amz-checksum-sha256": _sha256_b64(CK_BODY)}, {}),
    "sha1 header": ({"x-amz-checksum-sha1": base64.b64encode(
        hashlib.sha1(CK_BODY).digest()).decode()}, {}),
    "crc32 header wrong": ({"x-amz-checksum-crc32": _crc32_b64(b"x")}, {}),
    "two algorithms": ({"x-amz-checksum-crc32": _crc32_b64(CK_BODY),
                        "x-amz-checksum-sha256": _sha256_b64(CK_BODY)}, {}),
    "crc32c header": ({"x-amz-checksum-crc32c": "AAAAAA=="}, {}),
    "signed trailer": ({}, {"chunked": True, "trailers": {
        "x-amz-checksum-crc32": _crc32_b64(CK_BODY)}}),
    "signed trailer wrong": ({}, {"chunked": True, "trailers": {
        "x-amz-checksum-crc32": "AAAAAA=="}}),
    "signed trailer tampered": ({}, {"chunked": True, "trailers": {
        "x-amz-checksum-crc32": _crc32_b64(CK_BODY)},
        "corrupt_trailer_sig": True}),
}


def _stored_checksums(drive: str, ref: bool, key: str) -> dict:
    from minio_tpu_torch.storage.local import LocalStorage as PortStorage
    disk = LocalStorage(drive) if ref else PortStorage(drive)
    try:
        meta = disk.read_version(BUCKET, key, "").metadata
    except Exception:  # noqa: BLE001 - an absent version stores nothing
        return {}
    return {k: v for k, v in meta.items()
            if k.startswith("x-internal-checksum-")}


def _checksum_answers(addr: str, key: str, put) -> tuple:
    """(PUT status, error code, x-amz-checksum-* of the PUT answer, GET
    status with x-amz-checksum-mode: ENABLED, its x-amz-checksum-*, and
    whether its body is the PUT's)."""
    st, code, put_ck = put(addr)
    st2, h2, got = S3Client(addr, timeout=300).request(
        "GET", key, headers={"x-amz-checksum-mode": "ENABLED"})
    get_ck = {k.lower(): v for k, v in h2.items()
              if k.lower().startswith("x-amz-checksum-")}
    return st, code, put_ck, st2, get_ck, st2 == 200 and got


@pytest.mark.parametrize("case", sorted(CK_CASES) + ["zero-byte trailer",
                                                     "crc32c trailer"])
def test_checksum_put_matches_reference(servers, case):
    """Each declared-checksum PUT of tests/test_checksums.py gets the same
    answer from the port as from the JAX package: status, error code,
    the echoed checksum, the checksum-mode GET, and the stored
    x-internal-checksum-* keys of xl.meta on every drive."""
    key = f"/{BUCKET}/ck-{case.replace(' ', '-')}"
    body = b"" if case == "zero-byte trailer" else CK_BODY

    def put(addr):
        if case in CK_CASES:
            headers, kw = CK_CASES[case]
            st, h, err = S3Client(addr, timeout=300).request(
                "PUT", key, body=body, headers=headers, **kw)
            return st, _code(err) if st >= 300 else "", {
                k.lower(): v for k, v in h.items()
                if k.lower().startswith("x-amz-checksum-")}
        algo = "crc32c" if case == "crc32c trailer" else "crc32"
        st, code = _raw_chunked_put(
            addr, key, body, sigv4.STREAMING_UNSIGNED_TRAILER,
            {"x-amz-decoded-content-length": str(len(body)),
             "x-amz-trailer": f"x-amz-checksum-{algo}"},
            trailers={f"x-amz-checksum-{algo}": _crc32_b64(body)},
            signed=False)
        return st, code, {}
    got, want = _both(servers, lambda a: _checksum_answers(a, key, put))
    assert got == want
    assert want[5] in (False, body)
    port_drives = servers[1]
    ref_root = Path(port_drives[0]).parents[1] / "ref"
    for i, drive in enumerate(port_drives):
        assert _stored_checksums(drive, False, key[len(BUCKET) + 2:]) == \
            _stored_checksums(str(ref_root / f"d{i}"), True,
                              key[len(BUCKET) + 2:]), f"drive {i}"


def test_wrong_trailer_checksum_refused_before_commit(servers):
    """C1: a 1000-byte signed-trailer PUT declaring a wrong CRC32 is 400
    XAmzContentChecksumMismatch on the port as on the reference, and
    nothing is committed."""
    key = f"/{BUCKET}/c1-wrong-trailer"

    def run(addr):
        c = S3Client(addr, timeout=300)
        st, _, err = c.request("PUT", key, body=CK_BODY, chunked=True,
                               trailers={"x-amz-checksum-crc32": "AAAAAA=="})
        return st, _code(err), c.request("GET", key)[0]
    assert _both(servers, run) == ((400, "XAmzContentChecksumMismatch", 404),
                                   (400, "XAmzContentChecksumMismatch", 404))


# -- multipart -----------------------------------------------------------------

MIB = 1 << 20
MP_PARTS = (RNG.bytes(5 * MIB), RNG.bytes(5 * MIB), RNG.bytes(1000))


def _tags(body: bytes, tag: str) -> list[str]:
    return [m.decode() for m in re.findall(
        rb"<" + tag.encode() + rb">([^<]*)</" + tag.encode() + rb">", body)]


def _initiate(c, key):
    st, _, body = c.request("POST", f"/{BUCKET}/{key}",
                            query={"uploads": ""})
    assert st == 200, body
    return _tags(body, "UploadId")[0], (st, _tags(body, "Bucket"),
                                        _tags(body, "Key"))


def _put_part(c, key, uid, num, body, **kw):
    st, h, err = c.request("PUT", f"/{BUCKET}/{key}", body=body,
                           query={"partNumber": str(num), "uploadId": uid},
                           **kw)
    h = {k.lower(): v for k, v in h.items()}
    return st, h.get("etag"), _code(err) if st >= 300 else "", {
        k: v for k, v in h.items() if k.startswith("x-amz-checksum-")}


def _complete_xml(parts) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>").encode()


def test_multipart_api_matches_reference(servers):
    """One upload through every multipart route: the statuses, ETags,
    echoed checksums and XML fields equal the JAX server's, and the
    object reads back whole and across a part boundary."""
    key = "mp-api"
    crc = _crc32_b64(MP_PARTS[2])

    def run(addr):
        c = S3Client(addr, timeout=300)
        uid, init = _initiate(c, key)
        answers = [init]
        answers.append(_put_part(c, key, uid, 1, MP_PARTS[0]))
        answers.append(_put_part(c, key, uid, 2, MP_PARTS[1], chunked=True))
        answers.append(_put_part(c, key, uid, 3, MP_PARTS[2],
                                 headers={"x-amz-checksum-crc32": crc}))
        answers.append(_put_part(c, key, uid, 3, MP_PARTS[2], headers={
            "x-amz-checksum-crc32": _crc32_b64(b"x")}))
        st, _, body = c.request("GET", f"/{BUCKET}/{key}",
                                query={"uploadId": uid})
        answers.append((st, _tags(body, "PartNumber"), _tags(body, "ETag"),
                        _tags(body, "Size"), _tags(body, "UploadId") ==
                        [uid]))
        st, _, body = c.request("GET", f"/{BUCKET}", query={"uploads": ""})
        answers.append((st, _tags(body, "Key"), uid in _tags(body,
                                                            "UploadId")))
        etags = [a[1] for a in answers[1:4]]
        st, _, body = c.request("POST", f"/{BUCKET}/{key}",
                                query={"uploadId": uid},
                                body=_complete_xml(zip((1, 2, 3), etags)))
        answers.append((st, _tags(body, "Bucket"), _tags(body, "Key"),
                        _tags(body, "ETag"), _tags(body, "Location")))
        st, h, got = c.request("GET", f"/{BUCKET}/{key}")
        answers.append((st, h.get("ETag"), got == b"".join(MP_PARTS)))
        st, h, _ = c.request("HEAD", f"/{BUCKET}/{key}")
        answers.append((st, h.get("ETag"), h.get("Content-Length")))
        lo, hi = 5 * MIB - 10, 10 * MIB + 20
        st, h, got = c.request("GET", f"/{BUCKET}/{key}",
                               headers={"Range": f"bytes={lo}-{hi}"})
        answers.append((st, h.get("Content-Range"),
                        got == b"".join(MP_PARTS)[lo:hi + 1]))
        st, _, body = c.request("GET", f"/{BUCKET}/{key}",
                                query={"uploadId": uid})
        answers.append((st, _code(body)))
        return answers
    got, want = _both(servers, run)
    assert got == want
    assert want[-5][3][0].strip('"').endswith("-3")
    assert want[3][3] == {"x-amz-checksum-crc32": crc}
    assert want[4][:3] == (400, None, "XAmzContentChecksumMismatch")


MP_REFUSALS = ("InvalidPart", "InvalidPartOrder", "EntityTooSmall",
               "NoSuchUpload part", "NoSuchUpload list", "NoSuchUpload abort",
               "MalformedXML")


@pytest.mark.parametrize("case", MP_REFUSALS)
def test_multipart_refusals_match_reference(servers, case):
    key = f"mp-refuse-{case.replace(' ', '-')}"

    def run(addr):
        c = S3Client(addr, timeout=300)
        uid, _ = _initiate(c, key)
        e1 = _put_part(c, key, uid, 1, MP_PARTS[2])[1]
        e2 = _put_part(c, key, uid, 2, MP_PARTS[2])[1]
        path, q = f"/{BUCKET}/{key}", {"uploadId": uid}
        if case == "InvalidPart":
            ans = c.request("POST", path, query=q,
                            body=_complete_xml([(2, '"' + "0" * 32 + '"')]))
        elif case == "InvalidPartOrder":
            ans = c.request("POST", path, query=q,
                            body=_complete_xml([(2, e2), (1, e1)]))
        elif case == "EntityTooSmall":
            ans = c.request("POST", path, query=q,
                            body=_complete_xml([(1, e1), (2, e2)]))
        elif case == "MalformedXML":
            ans = c.request("POST", path, query=q, body=b"<Complete")
        else:
            st, _, _ = c.request("DELETE", path, query=q)
            assert st == 204
            if case == "NoSuchUpload part":
                ans = c.request("PUT", path, body=b"x", query={
                    "partNumber": "3", "uploadId": uid})
            elif case == "NoSuchUpload list":
                ans = c.request("GET", path, query=q)
            else:
                ans = c.request("DELETE", path, query=q)
        return ans[0], _code(ans[2])
    got, want = _both(servers, run)
    assert got == want
    assert want[1] == case.split()[0]


# -- the bucket namespace --------------------------------------------------------

_DATES = {"LastModified", "CreationDate", "Initiated"}
_VIDS = {"VersionId", "NextVersionIdMarker", "VersionIdMarker",
         "DeleteMarkerVersionId", "UploadId"}
ENABLE = (b"<VersioningConfiguration><Status>Enabled</Status>"
          b"</VersioningConfiguration>")
SUSPEND = ENABLE.replace(b"Enabled", b"Suspended")


class _Namespace:
    """One server's answers, canonical: XML as (tag, text, children)
    with dates blanked and version and upload ids named by their order
    of appearance, errors as their code; the headers that matter."""

    def __init__(self, addr):
        self.c = S3Client(addr, timeout=300)
        self.ids: dict = {}
        self.answers: list = []

    def vid(self, v: str) -> str:
        if not v or v == "null":
            return v
        return self.ids.setdefault(v, f"v{len(self.ids)}")

    def real(self, name: str) -> str:
        """The server's own version id behind an order name."""
        return next(v for v, n in self.ids.items() if n == name)

    def _xml(self, e):
        tag = e.tag.split("}")[-1]
        text = (e.text or "").strip()
        if tag in _DATES:
            text = "<date>"
        elif tag in _VIDS:
            text = self.vid(text)
        return tag, text, [self._xml(c) for c in e]

    def __call__(self, method, path, **kw):
        st, h, body = self.c.request(method, path, **kw)
        h = {k.lower(): v for k, v in h.items()}
        if st >= 300:
            ans = (st, _code(body))
        else:
            doc = self._xml(ET.fromstring(body)) if body.startswith(b"<?xml") \
                else hashlib.md5(body).hexdigest()
            ans = (st, doc, h.get("etag"), h.get("x-amz-delete-marker"),
                   self.vid(h.get("x-amz-version-id", "")))
        self.answers.append((method, path, ans))
        return ans


def _run_both(servers, scenario):
    port, _, ref = servers
    got, want = _Namespace(port), _Namespace(ref)
    for ns in (got, want):
        scenario(ns)
    assert len(got.answers) == len(want.answers)
    for g, w in zip(got.answers, want.answers):
        assert g == w
    return want.answers


def _page_versions(ns, bucket, max_keys):
    """ListObjectVersions pages through both markers."""
    q = {"versions": "", "max-keys": str(max_keys)}
    while True:
        st, doc, *_ = ns("GET", f"/{bucket}", query=q)
        fields = {c[0]: c[1] for c in doc[2]}
        if fields.get("IsTruncated") != "true":
            return
        q = {"versions": "", "max-keys": str(max_keys),
             "key-marker": fields["NextKeyMarker"],
             "version-id-marker": ns.real(fields["NextVersionIdMarker"])
             if fields["NextVersionIdMarker"] != "null" else "null"}


def test_versioning_routes_match_reference(servers):
    """GET/PUT ?versioning, versioned PUT, GET and HEAD by versionId,
    a delete marker (404 on GET, 405 on HEAD of its id), its removal,
    NoSuchVersion, ListObjectVersions in pages of 2, Suspended PUTs, a
    versioned multipart upload and DeleteBucket."""
    bodies = [RNG.bytes(n) for n in (3000, 150_000, 2 * MIB + 3)]

    def scenario(ns):
        b = "nsvers"
        ns("PUT", f"/{b}")
        ns("GET", f"/{b}", query={"versioning": ""})
        ns("PUT", f"/{b}", query={"versioning": ""}, body=b"<Versioning")
        ns("PUT", f"/{b}", query={"versioning": ""},
           body=ENABLE.replace(b"Enabled", b"On"))
        ns("PUT", f"/{b}", query={"versioning": ""}, body=ENABLE)
        ns("GET", f"/{b}", query={"versioning": ""})
        for body in bodies:
            ns("PUT", f"/{b}/k", body=body)
        for v in ("v0", "v1", "v2"):
            ns("GET", f"/{b}/k", query={"versionId": ns.real(v)})
            ns("HEAD", f"/{b}/k", query={"versionId": ns.real(v)})
        ns("GET", f"/{b}/k", query={"versionId":
                                    "00000000-0000-4000-8000-000000000000"})
        ns("DELETE", f"/{b}/k")
        ns("GET", f"/{b}/k")
        ns("HEAD", f"/{b}/k", query={"versionId": ns.real("v3")})
        ns("DELETE", f"/{b}/gone")                 # a marker for no key
        _page_versions(ns, b, 2)
        ns("DELETE", f"/{b}/k", query={"versionId": ns.real("v3")})
        ns("GET", f"/{b}/k")
        ns("DELETE", f"/{b}/k", query={"versionId": ns.real("v0")})
        _page_versions(ns, b, 1000)
        st, doc, *_ = ns("POST", f"/{b}/mp", query={"uploads": ""})
        uid = ns.real(next(c[1] for c in doc[2] if c[0] == "UploadId"))
        etag = ns("PUT", f"/{b}/mp", body=bodies[0],
                  query={"partNumber": "1", "uploadId": uid})[2]
        ns("POST", f"/{b}/mp", query={"uploadId": uid},
           body=_complete_xml([(1, etag)]))
        ns("PUT", f"/{b}", query={"versioning": ""}, body=SUSPEND)
        ns("GET", f"/{b}", query={"versioning": ""})
        ns("PUT", f"/{b}/k", body=bodies[0])
        ns("PUT", f"/{b}/k", body=bodies[1])
        ns("DELETE", f"/{b}/mp")
        _page_versions(ns, b, 1000)
        ns("DELETE", f"/{b}")
        ns("GET", "/")
    answers = _run_both(servers, scenario)
    errors = [a[2] for a in answers if a[2][0] >= 300]
    assert errors == [(400, "MalformedXML"), (400, "MalformedXML"),
                      (404, "NoSuchVersion"), (404, "NoSuchKey"),
                      (405, ""), (409, "BucketNotEmpty")]   # HEAD: no body


LIST_KEYS = ["a", "a/b", "a/b/c", "a-x", "b/1", "b/2", "b/3/x", "c d",
             "photos/2024/jan.jpg", "photos/2025/feb.jpg", "zz"]


@pytest.mark.parametrize("query", [
    {}, {"max-keys": "3"}, {"delimiter": "/"},
    {"delimiter": "/", "max-keys": "2"}, {"prefix": "b/"},
    {"prefix": "photos/", "delimiter": "/"}, {"marker": "b/1"},
    {"marker": "b/2", "delimiter": "/"}, {"list-type": "2", "max-keys": "4"},
    {"list-type": "2", "delimiter": "/", "max-keys": "2"},
    {"list-type": "2", "start-after": "a/b", "max-keys": "3"},
    {"list-type": "2", "prefix": "a", "delimiter": "/"}],
    ids=lambda q: "&".join(f"{k}={v}" for k, v in q.items()) or "plain")
def test_list_objects_routes_match_reference(servers, query):
    """ListObjects V1 and V2, paged to the end through NextMarker or
    the continuation token."""
    def scenario(ns):
        b = "nslist"
        if ns("PUT", f"/{b}")[0] == 200:
            for k in LIST_KEYS:
                ns("PUT", f"/{b}/{k}", body=k.encode())
        q = dict(query)
        while True:
            st, doc, *_ = ns("GET", f"/{b}", query=q)
            fields = {c[0]: c[1] for c in doc[2]}
            if fields.get("IsTruncated") != "true":
                return
            if q.get("list-type") == "2":
                q["continuation-token"] = fields["NextContinuationToken"]
            else:
                q["marker"] = fields["NextMarker"]
    _run_both(servers, scenario)


def test_bucket_routes_match_reference(servers):
    """ListBuckets, DeleteObjects (verbose and Quiet, a missing key, a
    named version), DeleteBucket (409 while not empty, 404 unknown, 204
    empty) and the answers on a bucket that is gone."""
    def scenario(ns):
        b = "nsbkt"
        ns("PUT", f"/{b}")
        for k in ("x1", "x2", "x3", "x4"):
            ns("PUT", f"/{b}/{k}", body=k.encode() * 10)
        ns("GET", "/")
        ns("DELETE", f"/{b}")
        ns("DELETE", "/nsnosuchbucket")
        ns("POST", f"/{b}", query={"delete": ""}, body=(
            b"<Delete><Object><Key>x1</Key></Object>"
            b"<Object><Key>missing</Key></Object>"
            b"<Object><Key>x2</Key><VersionId>null</VersionId></Object>"
            b"</Delete>"))
        ns("POST", f"/{b}", query={"delete": ""}, body=(
            b"<Delete><Quiet>true</Quiet><Object><Key>x3</Key></Object>"
            b"<Object><Key>x4</Key></Object></Delete>"))
        ns("POST", f"/{b}", query={"delete": ""}, body=b"<Delete")
        ns("GET", f"/{b}", query={"list-type": "2"})
        ns("DELETE", f"/{b}")
        ns("GET", f"/{b}", query={"versioning": ""})
        ns("GET", f"/{b}", query={"list-type": "2"})
        ns("GET", f"/{b}", query={"versions": ""})
        ns("GET", "/")
    answers = _run_both(servers, scenario)
    errors = [a[2] for a in answers if a[2][0] >= 300]
    assert errors == [(409, "BucketNotEmpty"), (404, "NoSuchBucket"),
                      (400, "MalformedXML"), (404, "NoSuchBucket"),
                      (404, "NoSuchBucket"), (404, "NoSuchBucket")]


def test_delete_marker_headers(servers):
    """A read that meets a delete marker answers AWS's headers on the
    port: x-amz-delete-marker and the marker's version id, on the 404 of
    the key and on the 405 of the marker named by its id."""
    port, _, _ = servers
    c = S3Client(port, timeout=300)
    assert c.request("PUT", "/nsmarker")[0] == 200
    assert c.request("PUT", "/nsmarker", query={"versioning": ""},
                     body=ENABLE)[0] == 200
    assert c.request("PUT", "/nsmarker/k", body=b"x")[0] == 200
    st, h, _ = c.request("DELETE", "/nsmarker/k")
    h = {k.lower(): v for k, v in h.items()}
    assert (st, h["x-amz-delete-marker"]) == (204, "true")
    marker = h["x-amz-version-id"]
    for method, query, status in (("GET", None, 404),
                                  ("HEAD", {"versionId": marker}, 405)):
        st, h, _ = c.request(method, "/nsmarker/k", query=query)
        h = {k.lower(): v for k, v in h.items()}
        assert (st, h.get("x-amz-delete-marker"),
                h.get("x-amz-version-id")) == (status, "true", marker)

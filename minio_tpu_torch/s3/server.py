"""A minimal S3 front end over one ErasureSet.

`http.server.ThreadingHTTPServer`, one thread per connection, HTTP/1.1
keep-alive. It serves PUT/HEAD bucket and PUT/GET/HEAD/DELETE object,
every request authenticated with header SigV4 (s3/sigv4.py; a wrong
signature is 403 SignatureDoesNotMatch), errors rendered as S3 XML
(reference cmd/api-errors.go).

An object PUT body is never held whole: `_make_payload` (the port of
minio_tpu/s3/server.py's) hands the object layer a utils.streams.Payload
that it reads window by window from the socket. A signed body's SHA-256
runs as it streams and is checked in the payload's finish hook, before
the commit (400 XAmzContentSHA256Mismatch, nothing committed); under
UNSIGNED-PAYLOAD no hash runs. aws-chunked bodies (the three streaming
payload hashes, also inside `Transfer-Encoding: chunked`) decode as they
stream, every chunk and trailer signature checked. A declared
x-amz-checksum-crc32, -sha1 or -sha256, in a header or an aws-chunked
trailer, is checked in the same hook (400 XAmzContentChecksumMismatch),
stored with the version, and returned on the PUT response and on GET or
HEAD with `x-amz-checksum-mode: ENABLED`; CRC32C and CRC64NVME answer
501 NotImplemented (s3/checksum.py). A plain `Transfer-Encoding:
chunked` body with no declared size is buffered, as in the JAX package.
GET bodies stream one erasure window at a time with one window read
ahead; a `Range: bytes=` GET or HEAD answers 206 with the erasure blocks
of that range only.

Multipart uploads (object/multipart.py), as minio_tpu/s3/server.py
serves them: `POST ?uploads` initiates, `PUT ?partNumber&uploadId`
uploads a part (streamed and checked as an object PUT is), `POST
?uploadId` completes from the XML part list, `DELETE ?uploadId` aborts,
`GET ?uploadId` lists the parts and `GET /<bucket>?uploads` the uploads.
The admin heal, `POST /minio/admin/v3/heal[?deep=true]`, starts a sweep of
the set (object/scanner.heal_set) in the background and `GET` on the same
path polls it; both are SigV4-signed by the root credential. The rest of
the S3 surface is minio_tpu/s3/server.py's and comes in later slices.
"""

from __future__ import annotations

import datetime
import email.utils
import hashlib
import json
import re
import sys
import threading
import traceback
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

from minio_tpu_torch.object import types as ot
from minio_tpu_torch.object.erasure_object import _resolve_range
from minio_tpu_torch.s3 import checksum as ck
from minio_tpu_torch.s3 import sigv4
from minio_tpu_torch.utils.streams import (HashingReader, HttpChunkedReader,
                                           LimitedReader, Payload)

# code -> (http status, message)
ERRORS = {
    "AccessDenied": (403, "Access Denied."),
    "InvalidAccessKeyId": (403, "The Access Key Id you provided does not exist in our records."),
    "SignatureDoesNotMatch": (403, "The request signature we calculated does not match the signature you provided."),
    "AuthorizationHeaderMalformed": (400, "The authorization header is malformed."),
    "XAmzContentSHA256Mismatch": (400, "The provided 'x-amz-content-sha256' header does not match what was computed."),
    "XAmzContentChecksumMismatch": (400, "The provided checksum does not match the computed checksum."),
    "InvalidRequest": (400, "Invalid Request"),
    "IncompleteBody": (400, "You did not provide the number of bytes specified by the Content-Length HTTP header."),
    "InvalidChunkSizeError": (400, "Invalid chunk size."),
    "InvalidRange": (416, "The requested range is not satisfiable."),
    "InvalidArgument": (400, "Invalid argument."),
    "MissingContentLength": (411, "You must provide the Content-Length HTTP header."),
    "InvalidBucketName": (400, "The specified bucket is not valid."),
    "NoSuchBucket": (404, "The specified bucket does not exist."),
    "BucketAlreadyOwnedByYou": (409, "Your previous request to create the named bucket succeeded and you already own it."),
    "NoSuchKey": (404, "The specified key does not exist."),
    "SlowDownRead": (503, "Resource requested is unreadable, please reduce your request rate"),
    "SlowDownWrite": (503, "Resource requested is unwritable, please reduce your request rate"),
    "NotImplemented": (501, "A header you provided implies functionality that is not implemented."),
    "InternalError": (500, "We encountered an internal error, please try again."),
    "MalformedXML": (400, "The XML you provided was not well-formed or did not validate against our published schema."),
    "NoSuchUpload": (404, "The specified multipart upload does not exist."),
    "InvalidPart": (400, "One or more of the specified parts could not be found."),
    "InvalidPartOrder": (400, "The list of parts was not in ascending order."),
    "EntityTooSmall": (400, "Your proposed upload is smaller than the minimum allowed object size."),
}

_OBJECT_ERRORS = {
    ot.BucketNotFound: "NoSuchBucket",
    ot.BucketExists: "BucketAlreadyOwnedByYou",
    ot.ObjectNotFound: "NoSuchKey",
    ot.InvalidRange: "InvalidRange",
    ot.ReadQuorumError: "SlowDownRead",
    ot.WriteQuorumError: "SlowDownWrite",
    ot.InvalidArgument: "InvalidArgument",
    ot.UploadNotFound: "NoSuchUpload",
    ot.InvalidPart: "InvalidPart",
    ot.InvalidPartOrder: "InvalidPartOrder",
    ot.EntityTooSmall: "EntityTooSmall",
}

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
ADMIN_PREFIX = "/minio/admin/v3/"

_BUCKET_RE = re.compile(r"^[a-z0-9][a-z0-9.-]{1,61}[a-z0-9]$")


class S3Error(Exception):
    def __init__(self, code: str, msg: str = ""):
        self.code = code
        self.status, default = ERRORS[code]
        super().__init__(msg or default)


def _http_date(ns: int) -> str:
    return email.utils.formatdate(ns / 1e9, usegmt=True)


def _iso8601(ns: int) -> str:
    return datetime.datetime.fromtimestamp(
        ns / 1e9, tz=datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root)


def _el(parent, tag: str, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _range_spec(rng: str):
    """Range header -> (start|None, end|None) spec, or None if absent
    (minio_tpu/s3/server.py `_range_spec`)."""
    if not rng:
        return None
    if not rng.startswith("bytes="):
        raise S3Error("InvalidArgument")
    spec = rng[len("bytes="):]
    if "," in spec:
        raise S3Error("NotImplemented", "multiple ranges")
    lo, _, hi = spec.partition("-")
    try:
        if lo == "":
            return (None, int(hi))
        return (int(lo), int(hi) if hi else None)
    except ValueError:
        raise S3Error("InvalidArgument") from None


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops the connects of a burst of
    # concurrent clients (each then waits a SYN retry); the stripe batcher
    # wants those requests to arrive together.
    request_queue_size = 128


class S3Server:
    """S3 over HTTP for one object layer (an ErasureSet)."""

    def __init__(self, objects, address: tuple[str, int],
                 credentials: dict[str, str]):
        self.objects = objects
        self.credentials = dict(credentials)
        server = self

        class Handler(_Handler):
            s3 = server
        self.httpd = _HTTPServer(address, Handler)
        self.httpd.daemon_threads = True
        # The admin heal sweep: one at a time, its state for GET heal.
        self.heal_status: dict = {"state": "idle"}
        self._heal_lock = threading.Lock()
        self._heal_thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving (from another thread), wait for a heal sweep in
        flight, and release the drives."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._heal_thread is not None:
            self._heal_thread.join()
        self.objects.close()

    def start_heal(self, deep: bool) -> dict:
        """Start a heal sweep of the set in the background unless one is
        running (minio_tpu/s3/server.py `_admin_heal`); its status."""
        from minio_tpu_torch.object.scanner import heal_set

        def run():
            try:
                self.heal_status = {"state": "done", "deep": deep,
                                    **heal_set(self.objects, deep=deep)}
            except Exception as e:  # noqa: BLE001 - surfaced in the status
                self.heal_status = {"state": "failed", "deep": deep,
                                    "error": str(e)[:300]}

        with self._heal_lock:
            if self._heal_thread is None or not self._heal_thread.is_alive():
                self.heal_status = {"state": "running", "deep": deep}
                self._heal_thread = threading.Thread(target=run, daemon=True,
                                                     name="admin-heal")
                self._heal_thread.start()
        return dict(self.heal_status)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "minio_tpu_torch"
    s3: S3Server

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def do_PUT(self):
        self._dispatch("PUT")

    def do_GET(self):
        self._dispatch("GET")

    def do_HEAD(self):
        self._dispatch("HEAD")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def do_POST(self):
        self._dispatch("POST")

    # ------------------------------------------------------------------

    def _dispatch(self, method: str) -> None:
        raw_path, _, qs = self.path.partition("?")
        self._resource = urllib.parse.unquote(raw_path)
        self._query = urllib.parse.parse_qs(qs, keep_blank_values=True)
        bucket, _, key = self._resource.lstrip("/").partition("/")
        admin = self._resource.startswith(ADMIN_PREFIX)
        data_put = method == "PUT" and bool(key) and not admin
        done = False
        try:
            headers = {k.lower(): v for k, v in self.headers.items()}
            # An object PUT streams its body (checked as it streams, by
            # the payload's finish hook); any other body is small and
            # read whole, its hash checked before the handler runs.
            body = b"" if data_put else self._read_body(method, headers)
            streaming = headers.get("x-amz-content-sha256") \
                in sigv4.STREAMING_HASHES
            auth = sigv4.verify_request(
                method, raw_path,
                self._query, headers, self.s3.credentials.get,
                body_hash=hashlib.sha256(body).hexdigest()
                if method in ("PUT", "POST") and not data_put
                and not streaming else None)
            if method == "PUT" and streaming and not data_put:
                body = self._decode_aws_chunked(body, auth, headers)
            if admin:
                self._admin(method, self._resource[len(ADMIN_PREFIX):])
                done = True
                return
            if not bucket:
                raise S3Error("NotImplemented", "ListBuckets")
            if not _BUCKET_RE.match(bucket):
                raise S3Error("InvalidBucketName")
            handler = getattr(self, f"_{method.lower()}_"
                              f"{'object' if key else 'bucket'}", None)
            if handler is None:
                raise S3Error("NotImplemented", f"{method} on this resource")
            if data_put:
                body = self._make_payload(auth, headers)
            handler(bucket, key, body, headers)
            done = True
        except sigv4.SigError as e:
            self._error(S3Error(e.code if e.code in ERRORS else "AccessDenied",
                                str(e)), method)
        except S3Error as e:
            self._error(e, method)
        except ot.ObjectError as e:
            code = next((c for t, c in _OBJECT_ERRORS.items()
                         if isinstance(e, t)), "InternalError")
            self._error(S3Error(code), method)
        except Exception:  # noqa: BLE001 - request boundary: log, answer 500
            traceback.print_exc(file=sys.stderr)
            self._error(S3Error("InternalError"), method)
        finally:
            if data_put and not done:
                # A refused object PUT may leave its body unread: the
                # connection cannot carry another request.
                self.close_connection = True

    def _make_payload(self, auth, headers: dict) -> Payload:
        """The sized streaming payload of an object PUT (the port of
        minio_tpu/s3/server.py `_make_payload`): the body is never
        materialized; content verification (SHA-256 or chunk signatures)
        runs as it streams and refuses in the finish hook, before the
        commit."""
        te = headers.get("transfer-encoding", "").lower()
        if auth.payload_hash in sigv4.STREAMING_HASHES:
            declared = headers.get("x-amz-decoded-content-length")
            if declared is None:
                raise S3Error("MissingContentLength")
            if "chunked" in te:
                # aws-chunked inside HTTP chunked (the SDKs' shape for a
                # stream of unknown length): strip the transfer framing
                # first, as the bytes come.
                raw = HttpChunkedReader(self.rfile)
            else:
                raw = LimitedReader(self.rfile,
                                    int(headers.get("content-length") or 0))
            reader = sigv4.chunked_reader(
                raw, auth, self.s3.credentials[auth.credential.access_key],
                verify_signatures=auth.payload_hash
                != sigv4.STREAMING_UNSIGNED_TRAILER)
            return self._apply_checksums(
                Payload(reader, int(declared), finish=reader.finalize),
                headers, trailers=reader)
        if "content-length" not in headers:
            if "chunked" not in te:
                raise S3Error("MissingContentLength")
            # Plain HTTP chunked (no declared size): buffered, as in the
            # JAX package; rare for S3 clients.
            body = self._read_http_chunked()
            if auth.payload_hash != sigv4.UNSIGNED_PAYLOAD and \
                    hashlib.sha256(body).hexdigest() != auth.payload_hash:
                raise S3Error("XAmzContentSHA256Mismatch")
            return self._apply_checksums(Payload.wrap(body), headers)
        length = int(headers["content-length"])
        raw = LimitedReader(self.rfile, length)
        if auth.payload_hash == sigv4.UNSIGNED_PAYLOAD:
            return self._apply_checksums(Payload(raw, length), headers)
        hasher = HashingReader(raw)
        want = auth.payload_hash

        def fin():
            if hasher.hexdigest() != want:
                raise S3Error("XAmzContentSHA256Mismatch")
        return self._apply_checksums(Payload(hasher, length, finish=fin),
                                     headers)

    @staticmethod
    def _apply_checksums(payload: Payload, headers: dict,
                         trailers=None) -> Payload:
        """Wrap the payload in the checksums the request declares, in
        headers or as aws-chunked trailers (`trailers`: the chunked
        reader, whose finalize() parses them), after the port of
        minio_tpu/s3/server.py `_apply_checksums`. The check runs in the
        finish hook, before the commit; the verified values go into the
        returned payload's `internal_metadata` (what the object layer
        stores) and `checksum_headers` (what the PUT answers)."""
        try:
            declared = dict(ck.declared_algos(headers))
            t_algos = ck.trailer_algos(headers)
            algos = ck.single_algo(declared, t_algos)
        except ck.ChecksumError as e:
            raise S3Error(e.code, str(e)) from None
        if not algos:
            payload.internal_metadata, payload.checksum_headers = {}, {}
            return payload
        reader = ck.ChecksumingReader(payload, algos)
        meta: dict = {}
        hdrs: dict = {}

        def fin():
            # A zero-byte body finishes the outer payload without pulling
            # the inner one, whose own finish parses the trailers: drive
            # it here (it runs once, whatever the body's size).
            payload.read(0)
            expected = dict(declared)
            got = getattr(trailers, "trailers", {}) or {}
            for a in t_algos:
                expected.setdefault(a, got.get(ck.H_PREFIX + a))
            try:
                meta.update(ck.verify_and_meta(reader, expected))
            except ck.ChecksumError as e:
                raise S3Error(e.code, str(e)) from None
            hdrs.update(ck.response_headers(meta))
        out = Payload(reader, payload.size, finish=fin)
        out.internal_metadata, out.checksum_headers = meta, hdrs
        return out

    def _read_body(self, method: str, headers: dict) -> bytes:
        if method == "POST" and "content-length" not in headers \
                and "chunked" not in headers.get("transfer-encoding", ""):
            return b""
        if method not in ("PUT", "POST"):
            return b""
        if "content-length" not in headers:
            if "chunked" in headers.get("transfer-encoding", "").lower():
                return self._read_http_chunked()
            raise S3Error("MissingContentLength")
        return self._read_exact(int(headers["content-length"]))

    def _read_exact(self, length: int) -> bytearray:
        body = bytearray(length)
        view, got = memoryview(body), 0
        while got < length:
            n = self.rfile.readinto(view[got:])
            if not n:
                self.close_connection = True
                raise S3Error("IncompleteBody")
            got += n
        return body

    def _read_http_chunked(self) -> bytearray:
        """A `Transfer-Encoding: chunked` body (RFC 9112 section 7.1):
        hex-size lines and data up to the zero-size chunk, then trailer
        fields up to a blank line, which are dropped."""
        body = bytearray()
        while True:
            line = self.rfile.readline(4096)
            if not line.endswith(b"\n"):
                self.close_connection = True
                raise S3Error("IncompleteBody")
            try:
                size = int(line.split(b";", 1)[0], 16)
            except ValueError:
                self.close_connection = True
                raise S3Error("IncompleteBody") from None
            if size <= 0:
                break
            body += self._read_exact(size)
            if self.rfile.readline(4096).strip():
                self.close_connection = True
                raise S3Error("IncompleteBody")
        while self.rfile.readline(4096).strip():
            pass
        return body

    def _decode_aws_chunked(self, raw, auth, headers: dict) -> bytearray:
        """The decoded body of an aws-chunked PUT, every signature checked
        and its size held to x-amz-decoded-content-length. As the JAX
        package's server answers: no declared size is 411; a body longer
        than declared is 400 IncompleteBody; a shorter one is 500
        InternalError (its sized reader runs dry)."""
        declared = headers.get("x-amz-decoded-content-length")
        if declared is None:
            raise S3Error("MissingContentLength")
        declared = int(declared)
        body = sigv4.decode_chunked_payload(
            raw, auth, self.s3.credentials[auth.credential.access_key],
            verify_signatures=auth.payload_hash
            != sigv4.STREAMING_UNSIGNED_TRAILER)
        if len(body) > declared:
            raise S3Error("IncompleteBody",
                          "body exceeds decoded content length")
        if len(body) < declared:
            raise S3Error("InternalError", f"body ended {declared - len(body)}"
                          " bytes short of declared size")
        return body

    def _send(self, status: int, headers: dict, body: bytes = b"",
              length: int | None = None) -> None:
        self.send_response(status)
        headers = {"x-amz-request-id": uuid.uuid4().hex[:16].upper(),
                   "Content-Length": str(len(body) if length is None
                                         else length), **headers}
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _error(self, err: S3Error, method: str) -> None:
        xml = ('<?xml version="1.0" encoding="UTF-8"?>\n<Error>'
               f"<Code>{err.code}</Code><Message>{escape(str(err))}</Message>"
               f"<Resource>{escape(self._resource)}</Resource></Error>"
               ).encode()
        self._send(err.status, {"Content-Type": "application/xml"},
                   b"" if method == "HEAD" else xml,
                   length=len(xml))

    @staticmethod
    def _object_headers(info) -> dict:
        h = {"ETag": f'"{info.etag}"', "Last-Modified": _http_date(info.mod_time),
             "Content-Type": info.content_type or "application/octet-stream",
             "Accept-Ranges": "bytes"}
        h.update({f"x-amz-meta-{k}": v for k, v in info.user_metadata.items()})
        return h

    # -- buckets ----------------------------------------------------------

    def _put_bucket(self, bucket, _key, _body, _headers):
        self.s3.objects.make_bucket(bucket)
        self._send(200, {"Location": f"/{bucket}"})

    def _head_bucket(self, bucket, _key, _body, _headers):
        if not self.s3.objects.bucket_exists(bucket):
            raise ot.BucketNotFound(bucket)
        self._send(200, {})

    def _get_bucket(self, bucket, _key, _body, _headers):
        if "uploads" not in self._query:
            raise S3Error("NotImplemented", "GET on this resource")
        prefix = self._query.get("prefix", [""])[0]
        root = ET.Element("ListMultipartUploadsResult", xmlns=XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "Prefix", prefix)
        _el(root, "IsTruncated", "false")
        for rec in self.s3.objects.list_multipart_uploads(bucket, prefix):
            ue = _el(root, "Upload")
            _el(ue, "Key", rec.get("object", ""))
            _el(ue, "UploadId", rec.get("upload_id", ""))
            _el(ue, "Initiated", _iso8601(rec.get("initiated", 0)))
            _el(ue, "StorageClass", "STANDARD")
        self._send_xml(root)

    def _send_xml(self, root: ET.Element, headers: dict | None = None):
        self._send(200, {"Content-Type": "application/xml",
                         **(headers or {})}, _xml(root))

    # -- admin ------------------------------------------------------------

    def _admin(self, method: str, op: str) -> None:
        """The admin API's heal (minio_tpu/s3/server.py `_admin_op`): POST
        starts a sweep, GET polls it."""
        if op != "heal" or method not in ("POST", "GET"):
            raise S3Error("NotImplemented", f"admin {method} {op}")
        if method == "POST":
            status = self.s3.start_heal(
                self._query.get("deep", [""])[0] in ("true", "1"))
        else:
            status = dict(self.s3.heal_status)
        self._send(200, {"Content-Type": "application/json"},
                   json.dumps(status).encode())

    # -- multipart --------------------------------------------------------

    def _post_object(self, bucket, key, body, headers):
        if "uploads" in self._query:
            meta = {k[len("x-amz-meta-"):]: v for k, v in headers.items()
                    if k.startswith("x-amz-meta-")}
            uid = self.s3.objects.new_multipart_upload(
                bucket, key, headers.get("content-type", ""), meta)
            root = ET.Element("InitiateMultipartUploadResult", xmlns=XMLNS)
            _el(root, "Bucket", bucket)
            _el(root, "Key", key)
            _el(root, "UploadId", uid)
            return self._send_xml(root)
        if "uploadId" not in self._query:
            raise S3Error("NotImplemented", "POST on this resource")
        try:
            tree = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        ns = f"{{{XMLNS}}}"
        parts = []
        for pe in tree.findall(f"{ns}Part") or tree.findall("Part"):
            num = pe.findtext(f"{ns}PartNumber") or pe.findtext("PartNumber")
            etag = pe.findtext(f"{ns}ETag") or pe.findtext("ETag") or ""
            try:
                parts.append((int(num), etag))
            except (TypeError, ValueError):
                raise S3Error("MalformedXML") from None
        info = self.s3.objects.complete_multipart_upload(
            bucket, key, self._query["uploadId"][0], parts)
        root = ET.Element("CompleteMultipartUploadResult", xmlns=XMLNS)
        _el(root, "Location", f"/{bucket}/{key}")
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "ETag", f'"{info.etag}"')
        self._send_xml(root)

    def _put_part(self, bucket, key, payload):
        try:
            part_num = int(self._query["partNumber"][0])
        except (ValueError, KeyError):
            raise S3Error("InvalidArgument") from None
        part = self.s3.objects.put_object_part(
            bucket, key, self._query.get("uploadId", [""])[0], part_num,
            payload)
        self._send(200, {"ETag": f'"{part.etag}"',
                         **payload.checksum_headers})

    def _list_parts(self, bucket, key):
        uid = self._query["uploadId"][0]
        try:
            marker = int(self._query.get("part-number-marker", ["0"])[0]
                         or 0)
            max_parts = int(self._query.get("max-parts", ["1000"])[0]
                            or 1000)
        except ValueError:
            raise S3Error("InvalidArgument") from None
        parts = self.s3.objects.list_parts(bucket, key, uid, marker,
                                           max_parts)
        root = ET.Element("ListPartsResult", xmlns=XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "UploadId", uid)
        _el(root, "PartNumberMarker", marker)
        _el(root, "MaxParts", max_parts)
        _el(root, "IsTruncated", "false")
        for p in parts:
            pe = _el(root, "Part")
            _el(pe, "PartNumber", p["number"])
            _el(pe, "ETag", f'"{p["etag"]}"')
            _el(pe, "Size", p["size"])
            _el(pe, "LastModified", _iso8601(p["mod_time"]))
        self._send_xml(root)

    # -- objects ----------------------------------------------------------

    def _put_object(self, bucket, key, payload, headers):
        if "partNumber" in self._query:
            return self._put_part(bucket, key, payload)
        meta = {k[len("x-amz-meta-"):]: v for k, v in headers.items()
                if k.startswith("x-amz-meta-")}
        info = self.s3.objects.put_object(
            bucket, key, payload,
            content_type=headers.get("content-type", ""),
            user_metadata=meta, internal_metadata=payload.internal_metadata)
        self._send(200, {"ETag": f'"{info.etag}"',
                         **payload.checksum_headers})

    @staticmethod
    def _resolve(spec, info, bucket, key) -> tuple:
        """(spec, offset, length) of a parsed Range spec on the object;
        spec None reads it whole. As the JAX package: 416 InvalidRange
        for a range the object cannot satisfy, and a suffix range of an
        empty object is a whole-object read."""
        if spec is None:
            return None, 0, info.size
        start, length = _resolve_range(spec, info.size, bucket, key)
        if info.size == 0 and spec[0] is None:
            return None, 0, 0
        return spec, start, length

    def _answer(self, info, spec, start, length,
                headers_in: dict) -> tuple[int, dict]:
        """Status and headers of a GET or HEAD: 206 with Content-Range for
        a range, else 200; the stored checksums when the request asks
        with x-amz-checksum-mode: ENABLED."""
        headers = self._object_headers(info)
        if headers_in.get("x-amz-checksum-mode", "").upper() == "ENABLED":
            headers.update(ck.response_headers(info.internal_metadata))
        if spec is None:
            return 200, headers
        headers["Content-Range"] = \
            f"bytes {start}-{start + length - 1}/{info.size}"
        return 206, headers

    def _head_object(self, bucket, key, _body, headers):
        spec = _range_spec(headers.get("range", ""))
        info = self.s3.objects.get_object_info(bucket, key)
        spec, start, length = self._resolve(spec, info, bucket, key)
        self._send(*self._answer(info, spec, start, length, headers),
                   length=length)

    def _get_object(self, bucket, key, _body, headers):
        if "uploadId" in self._query:
            return self._list_parts(bucket, key)
        spec = _range_spec(headers.get("range", ""))
        start, length = 0, None
        if spec is not None:
            spec, start, length = self._resolve(
                spec, self.s3.objects.get_object_info(bucket, key), bucket,
                key)
        info, chunks = self.s3.objects.get_object_stream(bucket, key, start,
                                                         length)
        if length is None:
            length = info.size
        try:
            first = next(chunks, b"")      # errors before the head is sent
            self._send(*self._answer(info, spec, start, length, headers),
                       length=length)
            try:
                # Each chunk views a pooled lease that returns at the
                # next pull, so it is on the wire before then.
                self.wfile.write(first)
                for chunk in chunks:
                    self.wfile.write(chunk)
            except Exception:  # noqa: BLE001 - head already sent
                # A failure mid-body can only cut the connection (the
                # client sees a short body), never send a second response.
                traceback.print_exc(file=sys.stderr)
                self.close_connection = True
        finally:
            chunks.close()        # returns the leases of a cut response

    def _delete_object(self, bucket, key, _body, _headers):
        if "uploadId" in self._query:
            self.s3.objects.abort_multipart_upload(
                bucket, key, self._query["uploadId"][0])
        else:
            self.s3.objects.delete_object(bucket, key)
        self._send(204, {})

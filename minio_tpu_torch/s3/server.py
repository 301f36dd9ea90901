"""A minimal S3 front end over one ErasureSet.

`http.server.ThreadingHTTPServer`, one thread per connection, HTTP/1.1
keep-alive. It serves PUT/HEAD bucket and PUT/GET/HEAD/DELETE object,
every request authenticated with header SigV4 (s3/sigv4.py; a wrong
signature is 403 SignatureDoesNotMatch), errors rendered as S3 XML
(reference cmd/api-errors.go). GET bodies stream one erasure window at a
time. The rest of the S3 surface is minio_tpu/s3/server.py's and comes
in later slices.
"""

from __future__ import annotations

import email.utils
import hashlib
import re
import sys
import traceback
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

from minio_tpu_torch.object import types as ot
from minio_tpu_torch.s3 import sigv4

# code -> (http status, message)
ERRORS = {
    "AccessDenied": (403, "Access Denied."),
    "InvalidAccessKeyId": (403, "The Access Key Id you provided does not exist in our records."),
    "SignatureDoesNotMatch": (403, "The request signature we calculated does not match the signature you provided."),
    "AuthorizationHeaderMalformed": (400, "The authorization header is malformed."),
    "XAmzContentSHA256Mismatch": (400, "The provided 'x-amz-content-sha256' header does not match what was computed."),
    "IncompleteBody": (400, "You did not provide the number of bytes specified by the Content-Length HTTP header."),
    "MissingContentLength": (411, "You must provide the Content-Length HTTP header."),
    "InvalidBucketName": (400, "The specified bucket is not valid."),
    "NoSuchBucket": (404, "The specified bucket does not exist."),
    "BucketAlreadyOwnedByYou": (409, "Your previous request to create the named bucket succeeded and you already own it."),
    "NoSuchKey": (404, "The specified key does not exist."),
    "SlowDownRead": (503, "Resource requested is unreadable, please reduce your request rate"),
    "SlowDownWrite": (503, "Resource requested is unwritable, please reduce your request rate"),
    "NotImplemented": (501, "A header you provided implies functionality that is not implemented."),
    "InternalError": (500, "We encountered an internal error, please try again."),
}

_OBJECT_ERRORS = {
    ot.BucketNotFound: "NoSuchBucket",
    ot.BucketExists: "BucketAlreadyOwnedByYou",
    ot.ObjectNotFound: "NoSuchKey",
    ot.ReadQuorumError: "SlowDownRead",
    ot.WriteQuorumError: "SlowDownWrite",
}

_BUCKET_RE = re.compile(r"^[a-z0-9][a-z0-9.-]{1,61}[a-z0-9]$")


class S3Error(Exception):
    def __init__(self, code: str, msg: str = ""):
        self.code = code
        self.status, default = ERRORS[code]
        super().__init__(msg or default)


def _http_date(ns: int) -> str:
    return email.utils.formatdate(ns / 1e9, usegmt=True)


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

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving (from another thread) and release the drives."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self.objects.close()


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
        try:
            headers = {k.lower(): v for k, v in self.headers.items()}
            body = self._read_body(method, headers)
            sigv4.verify_request(
                method, raw_path,
                urllib.parse.parse_qs(qs, keep_blank_values=True), headers,
                self.s3.credentials.get,
                body_hash=hashlib.sha256(body).hexdigest()
                if method == "PUT" else None)
            bucket, _, key = self._resource.lstrip("/").partition("/")
            if not bucket:
                raise S3Error("NotImplemented", "ListBuckets")
            if not _BUCKET_RE.match(bucket):
                raise S3Error("InvalidBucketName")
            handler = getattr(self, f"_{method.lower()}_"
                              f"{'object' if key else 'bucket'}", None)
            if handler is None:
                raise S3Error("NotImplemented", f"{method} on this resource")
            handler(bucket, key, body, headers)
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

    def _read_body(self, method: str, headers: dict) -> bytes:
        if method != "PUT":
            return b""
        if "content-length" not in headers:
            raise S3Error("MissingContentLength")
        length = int(headers["content-length"])
        body = bytearray(length)
        view, got = memoryview(body), 0
        while got < length:
            n = self.rfile.readinto(view[got:])
            if not n:
                self.close_connection = True
                raise S3Error("IncompleteBody")
            got += n
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

    # -- objects ----------------------------------------------------------

    def _put_object(self, bucket, key, body, headers):
        meta = {k[len("x-amz-meta-"):]: v for k, v in headers.items()
                if k.startswith("x-amz-meta-")}
        info = self.s3.objects.put_object(
            bucket, key, body, content_type=headers.get("content-type", ""),
            user_metadata=meta)
        self._send(200, {"ETag": f'"{info.etag}"'})

    def _head_object(self, bucket, key, _body, _headers):
        info = self.s3.objects.get_object_info(bucket, key)
        self._send(200, self._object_headers(info), length=info.size)

    def _get_object(self, bucket, key, _body, _headers):
        info, chunks = self.s3.objects.get_object_stream(bucket, key)
        first = next(chunks, b"")          # errors before the head is sent
        self._send(200, self._object_headers(info), length=info.size)
        try:
            self.wfile.write(first)
            for chunk in chunks:
                self.wfile.write(chunk)
        except Exception:  # noqa: BLE001 - head already sent
            # A failure mid-body can only cut the connection (the client
            # sees a short body), never send a second response.
            traceback.print_exc(file=sys.stderr)
            self.close_connection = True

    def _delete_object(self, bucket, key, _body, _headers):
        self.s3.objects.delete_object(bucket, key)
        self._send(204, {})

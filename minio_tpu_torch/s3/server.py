"""A minimal S3 front end over the object layer.

The layer is object/pools.ServerPools (pools of erasure sets, as the
server boots it), or one pool's ErasureSets, or a lone ErasureSet.

Connections are served by s3/eventloop.py's EventLoopServer, as the JAX
package's server boots: one epoll loop parks idle keep-alive
connections (no thread, no recv buffer), frames request heads out of
each connection's pooled recv buffer (s3/hotloop.py), answers a plain
signed GET of a hot-cache resident object on the loop thread
(`_hot_probe`), and runs every other request on a bounded executor.
MTPU_HTTP_EVENTLOOP=off (and a host without epoll) serves one thread a
connection (`_HTTPServer`); both front ends frame heads the same way and
close an idle keep-alive connection after MTPU_HTTP_KEEPALIVE_S (75 s).
It serves PUT/HEAD/DELETE bucket and PUT/GET/HEAD/DELETE object, every
request authenticated with header SigV4 (s3/sigv4.py; a wrong signature
is 403 SignatureDoesNotMatch), errors rendered as S3 XML (reference
cmd/api-errors.go).

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
every set (object/scanner.heal_set) in the background and `GET` on the
same path polls it, with the bulk heals of replaced drives under
`drive_heal`. The pool verbs of minio_tpu/s3/server.py drive
object/decom.py and object/rebalance.py: `POST decommission?pool=N`,
`GET decommission-status`, `POST decommission-cancel`, `POST
rebalance-start`, `GET rebalance-status`, `POST rebalance-stop` (400
InvalidArgument for a refused start, 501 on a layer of one set); on a
distributed deployment any node answers them (a status asks the peers
for a live walk's state, a stop reaches every peer). All admin calls are SigV4-signed by the root credential. The health probes
are not signed: `/minio/health/live` answers 200 while the server
serves, and `/minio/health/ready` 200, or 503 with one `degraded_sets`
entry (set, drives online, write quorum, healing drives) for each set
where fewer drives answer than its write quorum or a replaced drive is
still being refilled.

Observability, as minio_tpu/s3/server.py serves it: every request is
recorded once (s3/metrics.Metrics, utils/slo.SLOEngine, and while
somebody watches a trace entry whose span tree the request built),
whichever path answered it (pooled windows, the hot short circuit on the
loop, a tail the loop drains). `GET /minio/v2/metrics/cluster` is the
unsigned Prometheus scrape (a fleet merges every worker's registry, a
distributed node every node's unless `?cluster=false`); the admin
`trace` streams the records (`?types=`, `?count=`, `?cluster=true`),
`speedtest` times PUTs and GETs through the object layer, and
`start-profiling` / `download-profiling` capture a CPU profile of every
node (s3/profiling.py).

The bucket namespace, as minio_tpu/s3/server.py serves it: `GET /` lists
the buckets; `GET /<bucket>` is ListObjects V1, or V2 with
`?list-type=2` (continuation tokens); `GET ?versions` is
ListObjectVersions (key and version-id markers); `GET`/`PUT ?versioning`
read and set the versioning state (Enabled, Suspended); `DELETE
/<bucket>` removes an empty bucket (409 BucketNotEmpty otherwise); `POST
?delete` is DeleteObjects (up to 1000 keys, Quiet). `?versionId` names a
version on GET, HEAD and DELETE; a versioned bucket's DELETE without one
writes a delete marker. PUT, GET, HEAD, complete and copy answer
`x-amz-version-id`, a DELETE that made a marker `x-amz-delete-marker`,
and so does a GET or HEAD that met a marker (404 NoSuchKey, or 405
MethodNotAllowed when the marker was named). CopyObject
(`x-amz-copy-source`, metadata directive COPY or REPLACE) and
UploadPartCopy (`x-amz-copy-source-range`) stream the source version
into the destination window by window. Any other bucket subresource
(policy, lifecycle, tagging, object lock, replication, ...) answers 501;
tagging, lock, SSE and quota headers on object requests are ignored. The
rest of the S3 surface is minio_tpu/s3/server.py's and comes in later
slices.
"""

from __future__ import annotations

import base64
import datetime
import email.utils
import hashlib
import itertools
import json
import os
import re
import socket
import sys
import threading
import time
import traceback
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from xml.sax.saxutils import escape

from minio_tpu_torch.object import types as ot
from minio_tpu_torch.object.decom import DecomError
from minio_tpu_torch.object.erasure_object import _resolve_range, object_info
from minio_tpu_torch.object import hotcache as hotcache_mod
from minio_tpu_torch.object.hotcache import HotObjectCache
from minio_tpu_torch.object.nslock import LockTimeout
from minio_tpu_torch.object.pools import layer_sets
from minio_tpu_torch.object.rebalance import RebalanceError
from minio_tpu_torch.s3 import checksum as ck
from minio_tpu_torch.s3 import eventloop as eventloop_mod
from minio_tpu_torch.s3 import hotloop, sigv4
from minio_tpu_torch.s3 import metrics as metrics_mod
from minio_tpu_torch.s3 import profiling as prof_mod
from minio_tpu_torch.s3.admission import (AdmissionController, AdmissionShed,
                                          class_for, path_class)
from minio_tpu_torch.s3.trace import TraceBroadcaster, make_entry
from minio_tpu_torch.storage.health import DiskHealthWrapper
from minio_tpu_torch.utils import deadline as deadline_mod
from minio_tpu_torch.utils import tracing
from minio_tpu_torch.utils.slo import SLOEngine
from minio_tpu_torch.utils.streams import (ChunkReader, HashingReader,
                                           HttpChunkedReader, LimitedReader,
                                           Payload)

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
    "SlowDown": (503, "Please reduce your request rate."),
    "RequestTimeout": (408, "The request did not complete within the allotted time, please reduce your request rate."),
    "NotImplemented": (501, "A header you provided implies functionality that is not implemented."),
    "InternalError": (500, "We encountered an internal error, please try again."),
    "MalformedXML": (400, "The XML you provided was not well-formed or did not validate against our published schema."),
    "NoSuchUpload": (404, "The specified multipart upload does not exist."),
    "InvalidPart": (400, "One or more of the specified parts could not be found."),
    "InvalidPartOrder": (400, "The list of parts was not in ascending order."),
    "EntityTooSmall": (400, "Your proposed upload is smaller than the minimum allowed object size."),
    "BucketNotEmpty": (409, "The bucket you tried to delete is not empty."),
    "NoSuchVersion": (404, "The specified version does not exist."),
    "MethodNotAllowed": (405, "The specified method is not allowed against this resource."),
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
    ot.BucketNotEmpty: "BucketNotEmpty",
    ot.VersionNotFound: "NoSuchVersion",
    ot.MethodNotAllowed: "MethodNotAllowed",
    LockTimeout: "SlowDown",
    deadline_mod.DeadlineExceeded: "RequestTimeout",
}

# Query parameters of the bucket GETs served here (listings, versioning,
# uploads). A bucket request with any other subresource (policy,
# lifecycle, tagging, object-lock, replication, ...) answers 501.
_BUCKET_GET_PARAMS = frozenset((
    "prefix", "delimiter", "marker", "max-keys", "list-type",
    "continuation-token", "start-after", "encoding-type", "fetch-owner",
    "versions", "key-marker", "version-id-marker", "versioning",
    "uploads"))

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
ADMIN_PREFIX = "/minio/admin/v3/"
HEALTH_LIVE = "/minio/health/live"
HEALTH_READY = "/minio/health/ready"

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


def _b64e(s: str) -> str:
    return base64.urlsafe_b64encode(s.encode()).decode()


def _b64d(s: str) -> str:
    try:
        return base64.urlsafe_b64decode(s.encode()).decode()
    except Exception:  # noqa: BLE001 - any malformed token
        raise S3Error("InvalidArgument", "bad continuation token") from None


def _copy_source(headers: dict) -> tuple[str, str, str]:
    """(bucket, key, version id) of x-amz-copy-source
    (`/bucket/key[?versionId=...]`, URL-encoded)."""
    src = urllib.parse.unquote(headers["x-amz-copy-source"])
    src, _, vid = src.partition("?versionId=")
    src = src.lstrip("/")
    if "/" not in src:
        raise S3Error("InvalidArgument", "bad copy source")
    bucket, key = src.split("/", 1)
    return bucket, key, vid


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
    daemon_threads = True


class _ReusePortHTTPServer(_HTTPServer):
    """Joins an SO_REUSEPORT group: every pre-forked worker
    (io/workers.py) binds the same (host, port) and the kernel spreads
    accepted connections across their accept queues, no proxy hop
    (minio_tpu/s3/server.py `_ReusePortHTTPServer`)."""

    def server_bind(self):
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def _keepalive_seconds():
    """MTPU_HTTP_KEEPALIVE_S: the idle deadline between a client's bytes,
    of the thread path (a timeout on the connection's reads and writes)
    and of the event loop's parked and dispatched connections alike.
    None: no idle deadline."""
    try:
        keepalive_s = float(
            os.environ.get("MTPU_HTTP_KEEPALIVE_S", "") or 75.0)
    except ValueError:
        keepalive_s = 75.0
    if keepalive_s <= 0:
        # settimeout(0) would make the socket non-blocking.
        return None
    return keepalive_s


# Requests the loop's hot probe leaves to the handler, unchanged
# (minio_tpu/s3/server.py `_HOT_DECLINE`).
_HOT_DECLINE = ("transfer-encoding", "expect",
                "range", "if-match", "if-none-match",
                "if-modified-since", "if-unmodified-since",
                "x-amz-checksum-mode", "x-amz-security-token",
                "x-amz-server-side-encryption-customer-algorithm",
                "x-amz-server-side-encryption-customer-key")
_REQUEST_ID = b"\r\nx-amz-request-id: "


def _request_id() -> str:
    return uuid.uuid4().hex[:16].upper()


def _hot_probe(handler, head):
    """(bufs, close_connection) for a plain signed GET of an object the
    hot cache holds with its response head, else None (the request then
    dispatches to the handler as it came). The event loop runs it on its
    own thread (minio_tpu/s3/server.py `_hot_probe`): a RAM copy of the
    entry's head template, with Date and x-amz-request-id stamped anew,
    and its body; no object-layer call, no admission slot. The cache's
    get() reads the per-set coherence gates, so a distributed node's shut
    gate declines here too. The port has only root credentials, so a
    request whose signature verifies needs no policy walk; one that does
    not declines, and the handler answers its error."""
    t0 = time.perf_counter()
    srv = handler.s3
    hc = srv.hot_cache
    if not hc.enabled:
        return None
    d, method, target, _version, http11 = head
    if method != "GET" or "?" in target or "authorization" not in d:
        return None
    # A GET with a body would unframe the connection: the probe reads no
    # body. An explicit zero length is fine.
    if d.get("content-length", "0").strip() not in ("", "0"):
        return None
    for hk in _HOT_DECLINE:
        if hk in d:
            return None
    bucket, _, key = urllib.parse.unquote(target).lstrip("/").partition("/")
    if not bucket or not key:
        return None
    entry = hc.get(bucket, key)
    if entry is None or entry.head_prefix is None:
        return None
    try:
        auth = sigv4.verify_request("GET", target, {}, d,
                                    srv.credentials.get)
    except Exception:  # noqa: BLE001 - any auth failure: the handler
        return None
    suffix = entry.head_suffix
    bufs = [entry.head_prefix, hotcache_mod.date_bytes()]
    if suffix.startswith(_REQUEST_ID):
        end = suffix.index(b"\r\n", len(_REQUEST_ID))
        bufs += [_REQUEST_ID, _request_id().encode(), suffix[end:]]
    else:
        bufs.append(suffix)
    bufs.append(entry.body)
    conntype = d.get("connection", "").lower()
    if conntype == "close":
        close = True
    elif http11:
        close = False
    else:
        close = conntype != "keep-alive"
    # The loop path never enters _dispatch: its accounting (metrics,
    # path split, keep-alive reuse, SLO, trace and audit) is here.
    handler._count_request()
    handler._account("GET", target, bucket, key, "GET:object", 200,
                     time.perf_counter() - t0, 0, len(entry.body),
                     auth.credential.access_key, None, "hotcache")
    return bufs, close


def _trace_relay(name, client, types, out_q, stop) -> None:
    """A `?cluster=true` trace's relay of one peer node: its grid
    `trace.stream`, batches funneled into the merge queue; ends with the
    stream (the response goes on with the other nodes). A full queue
    drops entries: a diagnostics tail."""
    import queue as queue_mod
    try:
        for batch in client.stream("trace.stream", {"types": types},
                                   timeout=10.0):
            if stop.is_set():
                break
            for entry in batch or []:
                if isinstance(entry, dict):
                    entry.setdefault("node", name)
                try:
                    out_q.put_nowait(entry)
                except queue_mod.Full:
                    pass
    except Exception:  # noqa: BLE001 - the peer is gone, the stream cut
        pass


class S3Server:
    """S3 over HTTP for one object layer (see the module docstring). With
    MTPU_REUSE_PORT=1, which the pre-forked fleet sets in each worker,
    it binds its address in an SO_REUSEPORT group: each worker serves
    through its own event loop, built in the worker after the fork."""

    # Seconds stop() waits for the requests in flight.
    DRAIN_S = 10.0

    def __init__(self, objects, address: tuple[str, int],
                 credentials: dict[str, str]):
        self.objects = objects
        self.credentials = dict(credentials)
        server = self

        class Handler(_Handler):
            s3 = server
            loop_keepalive_s = _keepalive_seconds()
            loop_hot_probe = staticmethod(_hot_probe)
        reuse_port = os.environ.get("MTPU_REUSE_PORT", "") \
            in ("1", "on", "true")
        if eventloop_mod.loop_enabled():
            self.httpd = eventloop_mod.EventLoopServer(
                address, Handler, reuse_port=reuse_port,
                keepalive_s=Handler.loop_keepalive_s)
        else:
            cls = _ReusePortHTTPServer if reuse_port else _HTTPServer
            self.httpd = cls(address, Handler)
        # Admission control (s3/admission.py): bounded in-flight
        # requests per class; a worker of a fleet holds its share.
        self.admission = AdmissionController.from_env()
        # Requests in the handler, counted for stop()'s drain
        # (socketserver does not track daemon handler threads).
        self._inflight = 0
        self._inflight_mu = threading.Lock()
        # Hot-object read tier (object/hotcache.py), invalidated through
        # every set's bump funnel; MTPU_HOT_CACHE=off disables it.
        self.hot_cache = HotObjectCache()
        self.hot_cache.attach_layer(objects)
        self._thread: threading.Thread | None = None
        # The admin heal sweep: one at a time, its state for GET heal.
        self.heal_status: dict = {"state": "idle"}
        self._heal_lock = threading.Lock()
        self._heal_thread: threading.Thread | None = None
        # The drive plane's background work, when the server runs it
        # (minio_tpu_torch.server.boot): the periodic scanner and the
        # drive lifecycle manager, stopped before the set closes.
        self.scanner = None
        self.drive_heal = None
        # A distributed node's peers: their grid clients, which the pool
        # verbs ask for a live walk's state and tell to stop one. Its id,
        # and its cross-node coherence (worker 0's PeerCoherence) or, in
        # a sibling worker, the gate it reads (minio_tpu_torch.server).
        self.elastic_peers: list = []
        self.node_id = ""
        self.coherence = None
        self.coherence_gate = None
        # Observability (s3/metrics.py, s3/trace.py, utils/slo.py,
        # s3/profiling.py): the registry every request records into;
        # the live trace broadcaster, which background spans publish to
        # as well; the audit webhook (the boot sets it); the SLO engine
        # (MTPU_SLO); the profiler. A fleet worker's control plane sets
        # cluster_stats and cluster_trace (io/workers.py); a distributed
        # node lists its peers' grid clients in profile_peers
        # [(node, client)] for the cluster metrics, trace and profiles.
        self.metrics = metrics_mod.Metrics()
        self.tracer = TraceBroadcaster()
        tracing.set_publisher(self.tracer.publish)
        self.audit = None
        self.slo = SLOEngine.from_env()
        if self.slo is not None:
            self.slo.start(metrics=self.metrics)
        self.profiler = prof_mod.Profiler()
        self.cluster_stats = None
        self.cluster_trace = None
        self.profile_peers: list = []
        self.worker_id = int(os.environ.get("MTPU_WORKER_ID", "0") or 0)

    @property
    def object_layer(self):
        return self.objects

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    def eventloop_stats(self):
        """The event loop's snapshot (s3/eventloop.py `stats`), or None
        under the thread-per-connection front end."""
        stats = getattr(self.httpd, "stats", None)
        return stats() if stats is not None else None

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def start(self) -> None:
        """Serve from a thread of this process (the caller's thread
        stays free for signals)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True, name="s3-serve")
        self._thread.start()

    def shutdown(self) -> None:
        """Stop serving (from another thread) and release the drives.
        The event loop first lets its dispatched requests and response
        tails finish."""
        self.httpd.shutdown()
        self.close()

    def stop(self) -> None:
        """After start(): stop accepting, let the requests in flight and
        the event loop's response tails finish (up to DRAIN_S seconds),
        then close (minio_tpu/s3/server.py `stop`)."""
        self.httpd.shutdown()
        self.httpd.server_close()
        deadline = time.monotonic() + self.DRAIN_S
        while self._inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        self._thread.join(timeout=self.DRAIN_S)
        self.close()

    def close(self) -> None:
        """After serving: stop the scanner and the drive lifecycle
        manager, wait for a heal sweep in flight, close the set and the
        health wrappers' pools."""
        self.httpd.server_close()
        if self.slo is not None:
            self.slo.stop()
        if self.audit is not None:
            self.audit.stop()
        if self.coherence is not None:
            self.coherence.stop()
        for bg in (self.scanner, self.drive_heal):
            if bg is not None:
                bg.stop()
        if self._heal_thread is not None:
            self._heal_thread.join()
        self.objects.close()
        for d in self.objects.disks:
            if isinstance(d, DiskHealthWrapper):
                d.close()

    def info(self) -> dict:
        """`GET /minio/admin/v3/info`: the node's summary
        (s3/metrics.node_info: drives, usage, heals, admission, the
        last-minute latency a API, the slow-op records, the SLOs, the
        connection plane as `http` (Metrics.http_conn_stats) and
        `connections` (the event loop's), both fleet-merged in worker
        mode, group commit, the workers), and the answering process's
        node, worker and pid, its cross-node coherence (worker 0: the
        protocol's stats; a sibling: its gate's verdict) and its read
        caches' counters summed over the sets."""
        sets = layer_sets(self.objects)

        def summed(stats: list) -> dict:
            out: dict = {}
            for st in stats:
                for k, v in st.items():
                    if isinstance(v, (int, float)) and \
                            not isinstance(v, bool):
                        out[k] = out.get(k, 0) + v
            return out
        if self.coherence is not None:
            coherence = self.coherence.stats()
        elif self.coherence_gate is not None:
            coherence = {"gate": bool(self.coherence_gate())}
        else:
            coherence = None
        info = metrics_mod.node_info(self)
        info.update({"node": self.node_id,
                     "worker": os.environ.get("MTPU_WORKER_ID", ""),
                     "pid": os.getpid(), "coherence": coherence,
                     "fi_cache": summed([s.fi_cache.stats() for s in sets]),
                     "hot_cache": self.hot_cache.stats()})
        return info

    def readiness(self) -> tuple[int, dict]:
        """/minio/health/ready (minio_tpu/s3/server.py `_health_ready`;
        reference ClusterCheckHandler): 503 with an entry for each set
        (numbered across pools) where fewer drives answer than its write
        quorum or a drive is still healing (a replaced drive's bulk
        heal), else 200."""
        degraded = []
        for si, es in enumerate(layer_sets(self.objects)):
            infos, _ = es._fanout([d.disk_info for d in es.disks])
            ok = sum(di is not None for di in infos)
            healing = sum(di is not None and di.healing for di in infos)
            n = len(es.disks)
            parity = es.default_parity
            k = n - parity
            write_quorum = max(k + (1 if k == parity else 0),
                               n // 2 + (1 if n > 1 else 0))
            if ok < write_quorum or healing:
                degraded.append({
                    "set": si, "drives_online": ok, "drives": n,
                    "write_quorum": write_quorum, "healing_drives": healing})
        if degraded:
            return 503, {"ready": False, "degraded_sets": degraded}
        return 200, {"ready": True}

    def start_heal(self, deep: bool) -> dict:
        """Start a heal sweep of every set in the background unless one
        is running (minio_tpu/s3/server.py `_admin_heal`); its status:
        the sets' counts summed."""
        from minio_tpu_torch.object.scanner import heal_set

        def run():
            try:
                total: dict = {}
                for es in layer_sets(self.objects):
                    for k, v in heal_set(es, deep=deep).items():
                        total[k] = total.get(k, 0) + v
                self.heal_status = {"state": "done", "deep": deep, **total}
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
    # The event loop's hooks (s3/eventloop.py), set on each server's
    # handler class: the idle keep-alive deadline (the thread path's
    # too) and the hot-cache short circuit.
    loop_keepalive_s: float | None = None
    loop_hot_probe = None

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    # -- connection plumbing (minio_tpu/s3/server.py's handler) -----------

    def setup(self):
        super().setup()
        self._defer_head = False
        self._deferred_head = None
        self._last_head = b""
        self._body_reader = None
        # Set by the event loop (its _Conn); None on the thread path.
        self._loop_conn = None
        # One pooled reader serves the framer, the stock parser and every
        # body reader of the connection: bytes a fill took past a head
        # (a body's first bytes, the next pipelined request) are read
        # from it.
        try:
            self.rfile.close()
        except OSError:
            pass
        self._conn = self.rfile = hotloop.ConnReader(self.connection)
        self._requests_served = 0
        self._last_status = self._sent_bytes = 0
        self._path_kind = None
        self.s3.metrics.conn_open()

    def finish(self):
        try:
            super().finish()
        finally:
            self._conn.close()
            self.s3.metrics.conn_close()

    def _count_request(self) -> None:
        self._requests_served += 1
        if self._requests_served > 1:
            self.s3.metrics.keepalive_reuse()

    def handle_one_request(self):
        """The thread path's request (and the loop's, for bytes the
        framer refused): frame the head out of the connection buffer and
        dispatch it; a head the framer refuses is parsed by the stdlib
        from the same bytes. The idle deadline holds for every read and
        write of the request, its body's too: a stalled client closes
        its connection."""
        try:
            self.connection.settimeout(self.loop_keepalive_s)
            head = self._conn.parse_head()
        except hotloop._Fallback:
            self.s3.metrics.parse_fallback()
            return self._stock_request()
        except OSError:                   # the idle deadline, a reset
            self.close_connection = True
            return
        if head is None:                  # a clean close between requests
            self.close_connection = True
            return
        self._dispatch_head(head)

    def _dispatch_head(self, head):
        """Serve one framed request head: the thread path's, and the
        event loop's, which frames heads on its thread and hands them
        here on an executor thread."""
        d, method, target, version, http11 = head
        self.command = method
        self.path = target
        self.request_version = version
        self.requestline = f"{method} {target} {version}"
        self.headers = hotloop.FastHeaders(d)
        conntype = d.get("connection", "").lower()
        if conntype == "close":
            self.close_connection = True
        elif http11:
            self.close_connection = False
        else:
            self.close_connection = conntype != "keep-alive"
        if http11 and d.get("expect", "").lower() == "100-continue":
            self.wfile.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        self._count_request()
        mname = "do_" + method
        if not hasattr(self, mname):
            self.send_error(501, f"Unsupported method ({method!r})")
            return
        try:
            getattr(self, mname)()
            self.wfile.flush()
        except (socket.timeout, ConnectionError):
            self.close_connection = True

    def _stock_request(self):
        """The stdlib parse of a head the framer refused, from the same
        buffered bytes; a request it read counts as one served."""
        self.raw_requestline = b""
        rv = super().handle_one_request()
        if self.raw_requestline:
            self._count_request()
        return rv

    def send_response(self, code, message=None):
        self._last_status = code
        super().send_response(code, message)

    def flush_headers(self):
        # The head as it goes on the wire: the hot cache keeps a plain
        # whole-object GET's as its entry's template. While _defer_head
        # is set it waits for the response's first gathered write.
        head = self._last_head = b"".join(getattr(self, "_headers_buffer",
                                                  ()))
        self._headers_buffer = []
        if self._defer_head:
            self._deferred_head, self._defer_head = head, False
        else:
            self.wfile.write(head)

    def _take_head(self) -> bytes:
        head, self._deferred_head = self._deferred_head, None
        self._defer_head = False
        return head or b""

    def _send_bufs(self, bufs, final: bool = False) -> None:
        """Gathered write: one sendmsg of head and body views (pooled GET
        windows go to the wire as they are). `final` marks a response's
        last write: under the event loop a full socket buffer then hands
        the rest to the loop's EPOLLOUT drain (offload_final) and the
        executor thread goes back to the pool."""
        self._sent_bytes += sum(len(b) for b in bufs[1:])
        lc = self._loop_conn
        if final and lc is not None:
            self.server.offload_final(lc, bufs)
        else:
            hotloop.send_gathered(self.connection, bufs)
        if final:
            self.s3.metrics.response_path(self._path_kind or "pooled")

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

    # A shed request's body is read and dropped up to this size, so its
    # client can finish sending and read the 503 (minio_tpu/s3/server.py
    # `_drain_unread_body`).
    _DRAIN_CAP = 8 << 20

    def _dispatch(self, method: str) -> None:
        """Admission first (minio_tpu/s3/server.py `_route`): a request
        that finds no slot of its class (s3/admission.py) answers 503
        SlowDown with Retry-After before any auth or body work; an
        admitted one runs under the request deadline budget, if one is
        configured."""
        raw_path, _, qs = self.path.partition("?")
        srv = self.s3
        pc = path_class(raw_path)
        self._last_status = 0
        self._sent_bytes = 0
        self._auth_key = ""
        self._path_kind = None
        self._resource = urllib.parse.unquote(raw_path)
        t0 = time.perf_counter()
        # The span context: armed only while somebody watches (a trace
        # subscriber wanting internal types, a worker's remote relay, a
        # slow-op threshold); disarmed, the request pays this check.
        tctx = tracing.TraceContext() if tracing.ACTIVE else None
        with srv._inflight_mu:
            srv._inflight += 1
        try:
            try:
                gate = srv.admission.enter(class_for(pc))
            except AdmissionShed as shed:
                self._resource = urllib.parse.unquote(raw_path)
                self._drain_unread_body()
                self.close_connection = True
                self._error(S3Error("SlowDown", str(shed)), method,
                            {"Retry-After": str(shed.retry_after)})
                return
            try:
                budget = srv.admission.request_timeout
                with deadline_mod.bind(deadline_mod.Deadline(budget)
                                       if budget > 0 else None), \
                        tracing.bind(tctx):
                    self._route(method, raw_path, qs, pc)
            finally:
                gate.leave()
        finally:
            with srv._inflight_mu:
                srv._inflight -= 1
            try:
                rx = int(self.headers.get("content-length") or 0)
            except ValueError:
                rx = 0
            bucket, _, key = self._resource.lstrip("/").partition("/")
            if pc != "s3":
                api = f"{method}:{pc}"
            else:
                api = f"{method}:" + ("object" if key else
                                      "bucket" if bucket else "service")
            self._account(method, raw_path, bucket, key, api,
                          self._last_status or 500,
                          time.perf_counter() - t0, rx, self._sent_bytes,
                          self._auth_key, tctx)

    def _account(self, method, path, bucket, key, api, status, dt, rx, tx,
                 access_key, tctx, path_kind=None) -> None:
        """One request's accounting (minio_tpu/s3/server.py's `_route`
        finally): the metrics registry, the SLO engine, and, while
        somebody watches, the trace entry (the root of the request's
        span tree, span 0, with the tree's spans after it when a
        subscriber wants internal types) and the audit record. The hot
        short circuit on the loop passes `path_kind` ("hotcache")."""
        srv = self.s3
        srv.metrics.record(api, status, dt, rx=rx, tx=tx)
        if path_kind is not None:
            srv.metrics.response_path(path_kind)
        if srv.slo is not None:
            srv.slo.observe(api, status)
        if not srv.tracer.active and srv.audit is None:
            return
        entry = make_entry(api, method, path, bucket, key, status, dt,
                           self.client_address[0] if self.client_address
                           else "", access_key, rx=rx, tx=tx)
        entry["worker"] = srv.worker_id
        if srv.node_id:
            entry["node"] = srv.node_id
        if tctx is not None:
            entry["trace_type"] = "s3"
            entry["trace"] = tctx.trace_id
            entry["span"] = 0
            srv.tracer.publish(entry)
            if srv.tracer.wants_internal():
                for se in tracing.entries_from(tctx, worker=srv.worker_id):
                    srv.tracer.publish(se)
        else:
            srv.tracer.publish(entry)
        if srv.audit is not None:
            srv.audit.submit(entry)

    def _drain_unread_body(self) -> None:
        """Discard an unread Content-Length body, bounded by _DRAIN_CAP
        and a 2 s read timeout; a chunked body is left to the close."""
        try:
            remaining = int(self.headers.get("content-length") or 0)
        except ValueError:
            return
        if "chunked" in self.headers.get("transfer-encoding", "").lower() \
                or remaining <= 0 or remaining > self._DRAIN_CAP:
            return
        try:
            self.connection.settimeout(2.0)
            while remaining > 0:
                chunk = self.rfile.read(min(65536, remaining))
                if not chunk:
                    return
                remaining -= len(chunk)
        except OSError:
            pass        # a stalled or gone client; the close handles it

    def _route(self, method: str, raw_path: str, qs: str,
               pc: str = "") -> None:
        if raw_path in (HEALTH_LIVE, HEALTH_READY) and method in ("GET",
                                                                   "HEAD"):
            # Unauthenticated probes (reference healthcheck-handler.go).
            status, doc = (200, None) if raw_path == HEALTH_LIVE \
                else self.s3.readiness()
            body = b"" if doc is None else json.dumps(doc).encode()
            self._send(status, {"Content-Type": "application/json"}
                       if doc is not None else {},
                       b"" if method == "HEAD" else body, length=len(body))
            return
        self._resource = urllib.parse.unquote(raw_path)
        self._query = urllib.parse.parse_qs(qs, keep_blank_values=True)
        if pc == "metrics" and method == "GET":
            # Unsigned, as the JAX package serves it (a scrape).
            return self._metrics()
        bucket, _, key = self._resource.lstrip("/").partition("/")
        admin = self._resource.startswith(ADMIN_PREFIX)
        data_put = method == "PUT" and bool(key) and not admin
        done = False
        try:
            headers = self._headers_lower()
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
            self._auth_key = auth.credential.access_key
            if method == "PUT" and streaming and not data_put:
                body = self._decode_aws_chunked(body, auth, headers)
            if admin:
                self._admin(method, self._resource[len(ADMIN_PREFIX):])
                done = True
                return
            if not bucket:
                if method != "GET":
                    raise S3Error("NotImplemented", f"{method} /")
                self._list_buckets()
                done = True
                return
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
        except (ot.ObjectError, LockTimeout,
                deadline_mod.DeadlineExceeded) as e:
            code = next((c for t, c in _OBJECT_ERRORS.items()
                         if isinstance(e, t)), "InternalError")
            if code == "RequestTimeout":
                self.s3.admission.record_deadline_exceeded()
            headers = {}
            if isinstance(e, ot.MethodNotAllowed) or \
                    getattr(e, "delete_marker", False):
                # A read that met a delete marker (AWS's headers).
                headers = {"x-amz-delete-marker": "true",
                           "x-amz-version-id": e.version_id}
            self._error(S3Error(code), method, headers)
        except hotloop.RecvStalled:
            # The client stalled mid-body past the idle deadline: what is
            # left of its body is unread, so the connection closes.
            self.close_connection = True
            self._error(S3Error("RequestTimeout"), method)
        except Exception:  # noqa: BLE001 - request boundary: log, answer 500
            traceback.print_exc(file=sys.stderr)
            self._error(S3Error("InternalError"), method)
        finally:
            if self._body_reader is not None:
                # The pooled aws-chunked reader's lease, whatever became
                # of the body.
                self._body_reader.close()
                self._body_reader = None
            if data_put and not done:
                # A refused object PUT may leave its body unread: the
                # connection cannot carry another request.
                self.close_connection = True

    def _headers_lower(self) -> dict:
        """The request's headers with lowercase names; a repeated header
        folds with a comma, as the framer folds it (and SigV4
        canonicalizes it), so both parse paths verify alike."""
        d = getattr(self.headers, "d", None)   # FastHeaders: lowercase
        if d is not None:
            return d
        low: dict[str, str] = {}
        for k, v in self.headers.items():
            k = k.lower()
            low[k] = low[k] + "," + v if k in low else v
        return low

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
            reader = self._body_reader = sigv4.chunked_reader(
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

    def _head(self, status: int, headers: dict, length: int) -> bytes:
        """A response's head, held for its first gathered write."""
        self._defer_head = True
        self.send_response(status)
        headers = {"x-amz-request-id": _request_id(),
                   "Content-Length": str(length), **headers}
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        return self._take_head()

    def _send(self, status: int, headers: dict, body: bytes = b"",
              length: int | None = None) -> None:
        head = self._head(status, headers,
                          len(body) if length is None else length)
        self._send_bufs([head, body], final=True)

    def _error(self, err: S3Error, method: str,
               headers: dict | None = None) -> None:
        xml = ('<?xml version="1.0" encoding="UTF-8"?>\n<Error>'
               f"<Code>{err.code}</Code><Message>{escape(str(err))}</Message>"
               f"<Resource>{escape(self._resource)}</Resource></Error>"
               ).encode()
        self._send(err.status, {"Content-Type": "application/xml",
                                **(headers or {})},
                   b"" if method == "HEAD" else xml,
                   length=len(xml))

    @staticmethod
    def _object_headers(info) -> dict:
        h = {"ETag": f'"{info.etag}"', "Last-Modified": _http_date(info.mod_time),
             "Content-Type": info.content_type or "application/octet-stream",
             "Accept-Ranges": "bytes"}
        if info.version_id:
            h["x-amz-version-id"] = info.version_id
        h.update({f"x-amz-meta-{k}": v for k, v in info.user_metadata.items()})
        return h

    def _version_opts(self) -> ot.GetOptions:
        return ot.GetOptions(version_id=self._query.get("versionId",
                                                        [""])[0])

    # -- buckets ----------------------------------------------------------

    def _list_buckets(self):
        """GET / (minio_tpu/s3/server.py `_list_buckets`)."""
        root = ET.Element("ListAllMyBucketsResult", xmlns=XMLNS)
        owner = _el(root, "Owner")
        _el(owner, "ID", "minio-tpu")
        _el(owner, "DisplayName", "minio-tpu")
        bl = _el(root, "Buckets")
        for b in self.s3.objects.list_buckets():
            be = _el(bl, "Bucket")
            _el(be, "Name", b.name)
            _el(be, "CreationDate", _iso8601(b.created))
        self._send_xml(root)

    def _put_bucket(self, bucket, _key, body, _headers):
        if "versioning" in self._query:
            return self._put_versioning(bucket, body)
        if self._query:
            raise S3Error("NotImplemented", "PUT on this bucket resource")
        self.s3.objects.make_bucket(bucket)
        self._send(200, {"Location": f"/{bucket}"})

    def _head_bucket(self, bucket, _key, _body, _headers):
        self._check_bucket(bucket)
        self._send(200, {})

    def _delete_bucket(self, bucket, _key, _body, _headers):
        if self._query:
            raise S3Error("NotImplemented", "DELETE on this bucket resource")
        self.s3.objects.delete_bucket(bucket)
        self._send(204, {})

    def _post_bucket(self, bucket, _key, body, _headers):
        if "delete" not in self._query:
            raise S3Error("NotImplemented", "POST on this bucket resource")
        self._delete_objects(bucket, body)

    def _get_bucket(self, bucket, _key, _body, _headers):
        if set(self._query) - _BUCKET_GET_PARAMS:
            raise S3Error("NotImplemented", "GET on this bucket resource")
        if "uploads" in self._query:
            return self._list_uploads(bucket)
        if "versioning" in self._query:
            return self._get_versioning(bucket)
        if "versions" in self._query:
            return self._list_versions(bucket)
        self._list_objects(bucket)

    def _q(self, name: str, default: str = "") -> str:
        return self._query.get(name, [default])[0]

    def _list_objects(self, bucket):
        """ListObjects V1 and V2 (`?list-type=2`, continuation tokens),
        as minio_tpu/s3/server.py `_list_objects` answers them."""
        v2 = self._q("list-type") == "2"
        prefix, delimiter = self._q("prefix"), self._q("delimiter")
        max_keys = int(self._q("max-keys", "1000") or 1000)
        if v2:
            marker = self._q("start-after")
            if self._q("continuation-token"):
                marker = _b64d(self._q("continuation-token"))
        else:
            marker = self._q("marker")
        info = self.s3.objects.list_objects(
            bucket, prefix=prefix, marker=marker, delimiter=delimiter,
            max_keys=max_keys)
        root = ET.Element("ListBucketResult", xmlns=XMLNS)
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        if delimiter:
            _el(root, "Delimiter", delimiter)
        _el(root, "MaxKeys", max_keys)
        _el(root, "IsTruncated", "true" if info.is_truncated else "false")
        if v2:
            _el(root, "KeyCount", len(info.objects) + len(info.prefixes))
            if info.is_truncated:
                _el(root, "NextContinuationToken", _b64e(info.next_marker))
        else:
            _el(root, "Marker", marker)
            if info.is_truncated:
                _el(root, "NextMarker", info.next_marker)
        for o in info.objects:
            c = _el(root, "Contents")
            _el(c, "Key", o.name)
            _el(c, "LastModified", _iso8601(o.mod_time))
            _el(c, "ETag", f'"{o.etag}"')
            _el(c, "Size", o.size)
            _el(c, "StorageClass", o.storage_class)
        for p in info.prefixes:
            _el(_el(root, "CommonPrefixes"), "Prefix", p)
        self._send_xml(root)

    def _list_versions(self, bucket):
        """GET ?versions, ListObjectVersions (minio_tpu/s3/server.py
        `_list_versions`): a version-id-marker resumes within the marker
        key, its older versions first, then the listing goes on past the
        key."""
        objects = self.s3.objects
        prefix, delimiter = self._q("prefix"), self._q("delimiter")
        key_marker = self._q("key-marker")
        vid_marker = self._q("version-id-marker")
        max_keys = int(self._q("max-keys", "1000") or 1000)
        entries = []
        if key_marker and vid_marker:
            try:
                versions = objects.list_versions_all(bucket, key_marker)
            except ot.ObjectNotFound:            # the marker key is gone
                versions = []
            emit = False
            for v in versions:                   # latest first
                if emit:
                    entries.append(object_info(bucket, key_marker, v))
                elif (v.version_id or "null") == vid_marker:
                    emit = True
        info = objects.list_objects(bucket, prefix=prefix, marker=key_marker,
                                    delimiter=delimiter, max_keys=max_keys,
                                    include_versions=True)
        combined = entries + info.objects
        truncated = info.is_truncated
        if len(combined) > max_keys:
            combined = combined[:max_keys]
            truncated = True
        root = ET.Element("ListVersionsResult", xmlns=XMLNS)
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        _el(root, "KeyMarker", key_marker)
        if vid_marker:
            _el(root, "VersionIdMarker", vid_marker)
        _el(root, "MaxKeys", max_keys)
        _el(root, "IsTruncated", "true" if truncated else "false")
        if truncated and combined:
            _el(root, "NextKeyMarker", combined[-1].name)
            _el(root, "NextVersionIdMarker", combined[-1].version_id or "null")
        for o in combined:
            ve = _el(root, "DeleteMarker" if o.delete_marker else "Version")
            _el(ve, "Key", o.name)
            _el(ve, "VersionId", o.version_id or "null")
            _el(ve, "IsLatest", "true" if o.is_latest else "false")
            _el(ve, "LastModified", _iso8601(o.mod_time))
            if not o.delete_marker:
                _el(ve, "ETag", f'"{o.etag}"')
                _el(ve, "Size", o.size)
                _el(ve, "StorageClass", o.storage_class)
        for p in info.prefixes:
            _el(_el(root, "CommonPrefixes"), "Prefix", p)
        self._send_xml(root)

    def _check_bucket(self, bucket):
        if not self.s3.objects.bucket_exists(bucket):
            raise ot.BucketNotFound(bucket)

    def _get_versioning(self, bucket):
        self._check_bucket(bucket)
        root = ET.Element("VersioningConfiguration", xmlns=XMLNS)
        state = self.s3.objects.versioning_state(bucket)
        if state:
            _el(root, "Status", state)
        self._send_xml(root)

    def _put_versioning(self, bucket, body):
        self._check_bucket(bucket)
        try:
            tree = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        status = tree.findtext(f"{{{XMLNS}}}Status") or tree.findtext("Status")
        if status not in ("Enabled", "Suspended"):
            raise S3Error("MalformedXML", "Status must be Enabled or Suspended")
        self.s3.objects.set_bucket_versioning(bucket, status)
        self._send(200, {})

    @staticmethod
    def _delete_options(version_id: str, state: str) -> ot.DeleteOptions:
        return ot.DeleteOptions(version_id=version_id,
                                versioned=state == "Enabled",
                                null_marker=state == "Suspended"
                                and not version_id)

    def _delete_objects(self, bucket, body):
        """POST ?delete, DeleteObjects: up to 1000 keys, each deleted as
        a DELETE of it would be; Quiet answers the errors only."""
        try:
            tree = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML") from None
        ns = f"{{{XMLNS}}}"
        objs = tree.findall(f"{ns}Object") or tree.findall("Object")
        quiet = (tree.findtext(f"{ns}Quiet") or tree.findtext("Quiet")
                 or "") == "true"
        state = self.s3.objects.versioning_state(bucket)
        root = ET.Element("DeleteResult", xmlns=XMLNS)
        for obj in objs[:1000]:
            key = obj.findtext(f"{ns}Key") or obj.findtext("Key") or ""
            vid = obj.findtext(f"{ns}VersionId") or \
                obj.findtext("VersionId") or ""
            try:
                deleted = self.s3.objects.delete_object(
                    bucket, key, self._delete_options(vid, state))
            except Exception as e:  # noqa: BLE001 - a result per key
                code = next((c for t, c in _OBJECT_ERRORS.items()
                             if isinstance(e, t)), "InternalError")
                if code == "InternalError":
                    traceback.print_exc(file=sys.stderr)
                ee = _el(root, "Error")
                _el(ee, "Key", key)
                _el(ee, "Code", code)
                _el(ee, "Message", ERRORS[code][1])
                continue
            if not quiet:
                de = _el(root, "Deleted")
                _el(de, "Key", key)
                if vid:
                    _el(de, "VersionId", vid)
                if deleted.delete_marker:
                    _el(de, "DeleteMarker", "true")
                    _el(de, "DeleteMarkerVersionId",
                        deleted.delete_marker_version_id)
        self._send_xml(root)

    def _list_uploads(self, bucket):
        prefix = self._q("prefix")
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

    # The pool verbs (minio_tpu/s3/server.py `_admin_op`): (method, op)
    # -> the object layer's call.
    _POOL_VERBS = {
        ("POST", "decommission"): "start_decommission",
        ("GET", "decommission-status"): "decommission_status",
        ("POST", "decommission-cancel"): "cancel_decommission",
        ("POST", "rebalance-start"): "start_rebalance",
        ("GET", "rebalance-status"): "rebalance_status",
        ("POST", "rebalance-stop"): "stop_rebalance",
    }

    def _admin(self, method: str, op: str) -> None:
        """The admin API (minio_tpu/s3/server.py `_admin_op`): the heal
        (POST starts a sweep, GET polls it), the pool verbs, `info`
        (S3Server.info), the live `trace`, `speedtest`, and
        `start-profiling` / `download-profiling`."""
        verb = self._POOL_VERBS.get((method, op))
        if verb is not None:
            return self._admin_pools(verb)
        if (method, op) == ("GET", "info"):
            return self._send(200, {"Content-Type": "application/json"},
                              json.dumps(self.s3.info()).encode())
        obs = {("GET", "trace"): self._admin_trace,
               ("POST", "speedtest"): self._admin_speedtest,
               ("POST", "start-profiling"): self._start_profiling,
               ("GET", "download-profiling"): self._download_profiling
               }.get((method, op))
        if obs is not None:
            return obs()
        if op != "heal" or method not in ("POST", "GET"):
            raise S3Error("NotImplemented", f"admin {method} {op}")
        if method == "POST":
            status = self.s3.start_heal(
                self._query.get("deep", [""])[0] in ("true", "1"))
        else:
            status = dict(self.s3.heal_status)
            if self.s3.drive_heal is not None:
                # The replaced drives' bulk heals (the JAX package's
                # `drive_heal` entry).
                status["drive_heal"] = self.s3.drive_heal.status()
        self._send(200, {"Content-Type": "application/json"},
                   json.dumps(status).encode())

    def _admin_pools(self, verb: str) -> None:
        """A decommission or rebalance verb, from any node
        (minio_tpu/s3/server.py): a start answers 200 once its walk runs
        (400 InvalidArgument when refused, the coordinator lease held
        elsewhere included), a status the walk's state as JSON (an empty
        body before any): a live coordinator's, asked of the peers
        (`elastic.status`) when no walk runs here, else the checkpoint;
        a stop 200, once it reached this node and every peer
        (`elastic.stop`), whichever drives the walk."""
        layer = self.s3.objects
        fn = getattr(layer, verb, None)
        if fn is None:
            raise S3Error("NotImplemented", "a layout of one pool")
        kind = "decommission" if "decommission" in verb else "rebalance"
        try:
            result = fn(int(self._q("pool", "-1"))) \
                if verb == "start_decommission" else fn()
        except (DecomError, RebalanceError, ValueError) as e:
            raise S3Error("InvalidArgument", str(e)) from None
        if verb.endswith("_status"):
            walk = getattr(layer, "_decom" if kind == "decommission"
                           else "_rebalance")
            if walk is None or walk.wait(timeout=0):
                result = self._live_peer_state(kind) or result
        elif verb in ("cancel_decommission", "stop_rebalance"):
            for cli in self.s3.elastic_peers:
                try:
                    cli.call("elastic.stop", {"kind": kind}, timeout=5.0)
                except Exception:  # noqa: BLE001 - a peer that is down
                    continue
        body = json.dumps(result).encode() \
            if verb.endswith("_status") and result is not None else b""
        self._send(200, {"Content-Type": "application/json"}, body)

    # -- observability (minio_tpu/s3/server.py's handlers) ---------------

    def _metrics(self) -> None:
        """`GET /minio/v2/metrics/cluster`, unsigned: the Prometheus
        text of s3/metrics.Metrics.render. A fleet worker merges every
        worker's snapshot (the parent's control plane, io/workers.py); a
        distributed node adds every peer node's (`peer.metrics`) with
        node labels, unless `?cluster=false`."""
        srv = self.s3
        peers = None
        if srv.cluster_stats is not None:
            try:
                peers = srv.cluster_stats()
            except Exception:  # noqa: BLE001 - control plane down: own view
                peers = None
        nodes = None
        if srv.profile_peers and self._q("cluster").lower() not in (
                "false", "0", "off", "no"):
            nodes = self._cluster_metrics_states()
        text = srv.metrics.render(object_layer=srv.objects,
                                  scanner=srv.scanner, server=srv,
                                  peer_states=peers, node_states=nodes)
        self._send(200, {"Content-Type": "text/plain; version=0.0.4"},
                   text.encode())

    def _cluster_metrics_states(self) -> list:
        """This node's snapshot (every worker's, flagged local) and one
        `peer.metrics` call a peer node, concurrently; a peer that does
        not answer is an `unreachable` stub (cluster_node_up 0)."""
        srv = self.s3
        local = metrics_mod.peer_metrics_state(srv)
        local["local"] = True
        nodes = [local]
        mu = threading.Lock()

        def fetch(name, client):
            try:
                st = client.call("peer.metrics", {}, timeout=3)
                if not isinstance(st, dict):
                    raise ValueError("bad peer snapshot")
            except Exception:  # noqa: BLE001 - a peer that is down
                st = {"node": name, "states": [], "unreachable": True}
            st.setdefault("node", name)
            with mu:
                nodes.append(st)
        ts = [threading.Thread(target=fetch, args=(n, c), daemon=True)
              for n, c in srv.profile_peers]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=4)
        return nodes

    def _admin_trace(self) -> None:
        """The live trace stream (the `mc admin trace` shape): chunked
        JSON lines until the client goes or `?count=N` entries went.
        `?types=` filters (s3 by default: the request records; `all`:
        every type, the internal spans too). A fleet worker subscribes
        fleet-wide through the parent's trace pump; `?cluster=true` on a
        distributed node adds every peer node's stream (`trace.stream`),
        its entries tagged with their node."""
        import queue as queue_mod
        srv = self.s3
        try:
            limit = int(self._q("count", "0") or 0)
        except ValueError:
            limit = 0
        raw = self._q("types").strip()
        if not raw:
            types = {"s3"}
        elif raw == "all":
            types = set(tracing.TRACE_TYPES)
        else:
            types = {t.strip() for t in raw.split(",") if t.strip()} \
                & set(tracing.TRACE_TYPES) or {"s3"}
        relay_q = relay_stop = None
        if srv.profile_peers and self._q("cluster").lower() in (
                "true", "1", "yes", "on"):
            relay_q = queue_mod.Queue(maxsize=4096)
            relay_stop = threading.Event()
            for name, client in srv.profile_peers:
                threading.Thread(target=_trace_relay,
                                 args=(name, client, sorted(types), relay_q,
                                       relay_stop), daemon=True).start()
        hub = srv.cluster_trace
        sub = sub_id = None
        if hub is not None:
            try:
                sub_id = hub.trace_sub(sorted(types))
            except Exception:  # noqa: BLE001 - control plane down
                hub = None
        if hub is None:
            sub = srv.tracer.subscribe(types)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            sent = 0
            idle_since = time.monotonic()
            while not limit or sent < limit:
                entries = []
                if hub is not None:
                    entries = hub.trace_poll(sub_id)
                else:
                    try:
                        # Then what else is queued, in one write: a
                        # stream that writes an entry at a time falls
                        # behind a loaded server and drops.
                        entries = [sub.get(timeout=0.2)]
                        while len(entries) < 1024:
                            entries.append(sub.get_nowait())
                    except queue_mod.Empty:
                        pass
                if relay_q is not None:
                    try:
                        while len(entries) < 1024:
                            entries.append(relay_q.get_nowait())
                    except queue_mod.Empty:
                        pass
                if not entries:
                    if time.monotonic() - idle_since > 1.0:
                        # A heartbeat chunk: on an idle server the only
                        # way a gone client surfaces (EPIPE).
                        self.wfile.write(b"1\r\n\n\r\n")
                        self.wfile.flush()
                        idle_since = time.monotonic()
                    if hub is not None:
                        time.sleep(0.2)
                    continue
                idle_since = time.monotonic()
                if limit:
                    entries = entries[:limit - sent]
                # The batch's lines as one chunk: one write a batch.
                lines = b"".join(json.dumps(e).encode() + b"\n"
                                 for e in entries)
                self.wfile.write(b"%x\r\n" % len(lines) + lines + b"\r\n")
                sent += len(entries)
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            pass                # the client went away
        finally:
            if relay_stop is not None:
                relay_stop.set()
            if hub is not None:
                try:
                    hub.trace_unsub(sub_id)
                except Exception:  # noqa: BLE001 - best effort
                    pass
            else:
                srv.tracer.unsubscribe(sub)
            self.close_connection = True

    def _admin_speedtest(self) -> None:
        """Self-measured object throughput (`mc admin speedtest`,
        reference cmd/perf-tests.go): timed PUTs, then GETs, of
        synthetic objects through the whole object layer, removed after.
        `size` (1 KiB to 256 MiB, default 4 MiB) and `count` (1 to 64,
        default 8) are clamped as in the JAX package."""
        try:
            size = int(self._q("size", str(4 << 20)))
            count = int(self._q("count", "8"))
        except ValueError:
            raise S3Error("InvalidArgument") from None
        size = max(1 << 10, min(size, 256 << 20))
        count = max(1, min(count, 64))
        layer = self.s3.objects
        bucket = "mtpu-speedtest-tmp"
        try:
            layer.make_bucket(bucket)
        except ot.BucketExists:
            pass        # shared across runs; keys are run-unique
        body = os.urandom(size)
        run = os.urandom(6).hex()
        keys = [f"obj-{run}-{i}" for i in range(count)]
        try:
            t0 = time.perf_counter()
            for k in keys:
                layer.put_object(bucket, k, body, ot.PutOptions())
            put_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for k in keys:
                layer.get_object(bucket, k)
            get_s = time.perf_counter() - t0
        finally:
            for k in keys:
                try:
                    layer.delete_object(bucket, k)
                except Exception:  # noqa: BLE001 - best effort
                    pass
            try:
                layer.delete_bucket(bucket)
            except Exception:  # noqa: BLE001 - another run is active
                pass
        total = size * count
        result = {"object_size": size, "objects": count,
                  "put_seconds": round(put_s, 4),
                  "get_seconds": round(get_s, 4),
                  "put_mibps": round(total / put_s / (1 << 20), 2),
                  "get_mibps": round(total / get_s / (1 << 20), 2)}
        self._send(200, {"Content-Type": "application/json"},
                   json.dumps(result).encode())

    def _start_profiling(self) -> None:
        """Start this node's profile (s3/profiling.py) and each peer
        node's (`peer.profile`)."""
        srv = self.s3
        try:
            srv.profiler.start()
        except prof_mod.ProfileError as e:
            raise S3Error("InvalidRequest", str(e)) from None
        for _name, client in srv.profile_peers:
            try:
                client.call(prof_mod.PROFILE_HANDLER, {"action": "start"},
                            timeout=5)
            except Exception:  # noqa: BLE001 - a peer that is down
                pass
        self._send(200, {"Content-Type": "application/json"},
                   json.dumps({"started": True}).encode())

    def _download_profiling(self) -> None:
        """Stop the profiles and answer the zip bundle: `local/` and a
        folder a peer node that answered."""
        srv = self.s3
        per_node = {}
        try:
            per_node["local"] = srv.profiler.stop()
        except prof_mod.ProfileError as e:
            raise S3Error("InvalidRequest", str(e)) from None
        for name, client in srv.profile_peers:
            try:
                rec = client.call(prof_mod.PROFILE_HANDLER,
                                  {"action": "stop"}, timeout=10)
                if rec.get("ok"):
                    per_node[name] = {
                        "stats": base64.b64decode(rec.get("stats_b64", "")),
                        "text": rec.get("text", "")}
            except Exception:  # noqa: BLE001 - a peer that is down
                pass
        self._send(200, {"Content-Type": "application/zip"},
                   prof_mod.bundle(per_node))

    def _live_peer_state(self, kind: str):
        """The state of a walk of `kind` that a peer drives now, or None
        (the lease lets one node drive, so the first live answer is
        the coordinator's)."""
        for cli in self.s3.elastic_peers:
            try:
                r = cli.call("elastic.status", None, timeout=3.0)
            except Exception:  # noqa: BLE001 - a peer that is down
                continue
            if isinstance(r, dict) and r.get(f"{kind}_live") and r.get(kind):
                return r[kind]
        return None

    # -- multipart --------------------------------------------------------

    def _post_object(self, bucket, key, body, headers):
        if "uploads" in self._query:
            meta = {k[len("x-amz-meta-"):]: v for k, v in headers.items()
                    if k.startswith("x-amz-meta-")}
            uid = self.s3.objects.new_multipart_upload(
                bucket, key, ot.PutOptions(
                    versioned=self.s3.objects.bucket_versioning(bucket),
                    user_metadata=meta,
                    content_type=headers.get("content-type", "")))
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
        self._send_xml(root, {"x-amz-version-id": info.version_id}
                       if info.version_id else None)

    def _put_part(self, bucket, key, payload, headers):
        try:
            part_num = int(self._query["partNumber"][0])
        except (ValueError, KeyError):
            raise S3Error("InvalidArgument") from None
        uid = self._query.get("uploadId", [""])[0]
        if "x-amz-copy-source" not in headers:
            part = self.s3.objects.put_object_part(bucket, key, uid,
                                                   part_num, payload)
            return self._send(200, {"ETag": f'"{part.etag}"',
                                    **payload.checksum_headers})
        # UploadPartCopy: a byte range of the source object, streamed
        # window by window into the part.
        payload.read_all()                   # the (empty) body's checks
        sbucket, skey, svid = _copy_source(headers)
        spec = _range_spec(headers.get("x-amz-copy-source-range", ""))
        sinfo = self.s3.objects.get_object_info(
            sbucket, skey, ot.GetOptions(version_id=svid))
        start, length = (0, sinfo.size) if spec is None else \
            _resolve_range(spec, sinfo.size, sbucket, skey)
        part = self._copy_into(
            sbucket, skey, sinfo.version_id or "null", start, length,
            lambda src: self.s3.objects.put_object_part(bucket, key, uid,
                                                        part_num, src))
        root = ET.Element("CopyPartResult", xmlns=XMLNS)
        _el(root, "ETag", f'"{part.etag}"')
        _el(root, "LastModified", _iso8601(part.mod_time))
        self._send_xml(root)

    def _copy_into(self, sbucket: str, skey: str, svid: str, start: int,
                   length, write):
        """write(Payload) over bytes [start, start + length) of version
        `svid` of the source ("null" for the null version; length None:
        to the end), streamed from
        get_object_stream one window at a time; the source's leases
        return whatever write() does. The stream, and with it the
        source key's read lock, closes once the last byte is copied out,
        before write() commits: a copy onto its own key must not wait on
        its own source. Returns write()'s result."""
        sinfo, chunks = self.s3.objects.get_object_stream(
            sbucket, skey, start, length, ot.GetOptions(version_id=svid))
        size = sinfo.size - start if length is None else length
        reader = ChunkReader(chunks, size)
        try:
            return write(Payload(reader, size))
        finally:
            reader.close()

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
            return self._put_part(bucket, key, payload, headers)
        if "x-amz-copy-source" in headers:
            return self._copy_object(bucket, key, payload, headers)
        meta = {k[len("x-amz-meta-"):]: v for k, v in headers.items()
                if k.startswith("x-amz-meta-")}
        info = self.s3.objects.put_object(bucket, key, payload, ot.PutOptions(
            versioned=self.s3.objects.bucket_versioning(bucket),
            user_metadata=meta, content_type=headers.get("content-type", ""),
            internal_metadata=payload.internal_metadata))
        self._send(200, {"ETag": f'"{info.etag}"',
                         **({"x-amz-version-id": info.version_id}
                            if info.version_id else {}),
                         **payload.checksum_headers})

    def _copy_object(self, bucket, key, payload, headers):
        """CopyObject (minio_tpu/s3/server.py `_copy_object`): the source
        version (x-amz-copy-source, `?versionId=`) streams into a new
        version of the destination; x-amz-metadata-directive COPY keeps
        the source's metadata and content type, REPLACE takes the
        request's."""
        payload.read_all()                   # the (empty) body's checks
        sbucket, skey, svid = _copy_source(headers)
        sinfo = self.s3.objects.get_object_info(
            sbucket, skey, ot.GetOptions(version_id=svid))
        if headers.get("x-amz-metadata-directive", "COPY").upper() \
                == "REPLACE":
            meta = {k[len("x-amz-meta-"):]: v for k, v in headers.items()
                    if k.startswith("x-amz-meta-")}
            ctype = headers.get("content-type", sinfo.content_type)
        else:
            meta, ctype = dict(sinfo.user_metadata), sinfo.content_type
        opts = ot.PutOptions(
            versioned=self.s3.objects.bucket_versioning(bucket),
            user_metadata=meta, content_type=ctype)
        info = self._copy_into(
            sbucket, skey, sinfo.version_id or "null", 0, None,
            lambda src: self.s3.objects.put_object(bucket, key, src, opts))
        root = ET.Element("CopyObjectResult", xmlns=XMLNS)
        _el(root, "ETag", f'"{info.etag}"')
        _el(root, "LastModified", _iso8601(info.mod_time))
        self._send_xml(root, {"x-amz-version-id": info.version_id}
                       if info.version_id else None)

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
        info = self.s3.objects.get_object_info(bucket, key,
                                               self._version_opts())
        spec, start, length = self._resolve(spec, info, bucket, key)
        self._send(*self._answer(info, spec, start, length, headers),
                   length=length)

    def _get_object(self, bucket, key, _body, headers):
        """GET, streamed window by window. The latest version of a key
        may be a hit of the hot-object tier (object/hotcache.py), served
        with no object-layer work and the miss's headers, a range
        resolved on the resident object (minio_tpu/s3/server.py
        `_get_object`); a plain whole-object miss the tinyLFU filter
        admits is buffered as it is sent and inserted at its end, with
        its head as the entry's template unless checksum headers shaped
        it."""
        if "uploadId" in self._query:
            return self._list_parts(bucket, key)
        spec = _range_spec(headers.get("range", ""))
        opts = self._version_opts()
        hot = self.s3.hot_cache
        entry = hot.get(bucket, key) if not opts.version_id else None
        template = hot.enabled and headers.get(
            "x-amz-checksum-mode", "").upper() != "ENABLED"
        token = admit = None
        if entry is not None:
            self._path_kind = "hotcache"
            info = entry.info
            spec, start, length = self._resolve(spec, info, bucket, key)
            chunks = (w for w in (memoryview(entry.body)
                                  [start:start + length],))
        else:
            if hot.enabled and not opts.version_id:
                # Before the read fan-out: a mutation racing this read
                # moves the bucket's generation and put() refuses.
                token = hot.token(bucket)
            start, length = 0, None
            if spec is not None:
                info = self.s3.objects.get_object_info(bucket, key, opts)
                spec, start, length = self._resolve(spec, info, bucket, key)
                # The range was resolved on this version: read the same one.
                opts = ot.GetOptions(version_id=info.version_id or "null")
            info, chunks = self.s3.objects.get_object_stream(
                bucket, key, start, length, opts)
            if length is None:
                length = info.size
            if token is not None and spec is None and length:
                admit = hot.admit(bucket, key, length)
        buf = bytearray() if admit else None
        try:
            first = next(chunks, b"")      # errors before the head is sent
            status, out_headers = self._answer(info, spec, start, length,
                                               headers)
            head = self._head(status, out_headers, length)
            if entry is not None and spec is None and template:
                hot.set_head(bucket, key, info.etag, info.version_id or "",
                             head)
            sent = 0
            try:
                # Each chunk views a pooled lease that returns at the
                # next pull, so it is on the wire (and copied into the
                # hot buffer) before then; the head rides the first
                # chunk's write. The last chunk is the response's final
                # write: under the event loop, what a slow reader's socket
                # does not take at once is copied and left to the loop.
                for chunk in itertools.chain((first,), chunks):
                    if buf is not None:
                        buf += chunk
                    last = sent + len(chunk) >= length
                    self._send_bufs([head, chunk], final=last)
                    head = b""
                    sent += len(chunk)
            except Exception:  # noqa: BLE001 - head already sent
                # A failure mid-body can only cut the connection (the
                # client sees a short body), never send a second response.
                traceback.print_exc(file=sys.stderr)
                self.close_connection = True
            if buf is not None and sent == length:
                hot.put(bucket, key, info, bytes(buf),
                        self._last_head if template else None, token)
        finally:
            chunks.close()        # returns the leases of a cut response

    def _delete_object(self, bucket, key, _body, _headers):
        if "uploadId" in self._query:
            self.s3.objects.abort_multipart_upload(
                bucket, key, self._query["uploadId"][0])
            return self._send(204, {})
        vid = self._version_opts().version_id
        deleted = self.s3.objects.delete_object(
            bucket, key, self._delete_options(
                vid, self.s3.objects.versioning_state(bucket)))
        headers = {}
        if deleted.delete_marker:
            headers = {"x-amz-delete-marker": "true",
                       "x-amz-version-id": deleted.delete_marker_version_id}
        elif vid:
            headers = {"x-amz-version-id": vid}
        self._send(204, headers)

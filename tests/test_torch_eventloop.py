"""The port's event-loop front end (s3/eventloop.py) against the JAX
package's, on the CPU.

Port servers boot through `minio_tpu_torch.server.boot` with `--device
cpu` on 12 temporary drives (EC 8+4), serving from a thread of this
process; where a case compares answers, a JAX package S3Server on 12
drives of its own gets the same requests, and status, body (or the error
code) and the headers both set must be equal, leaving out Date,
x-amz-request-id and Server (each response's own) and Last-Modified (the
two PUTs' own times). The counterparts of tests/test_eventloop.py:

  * front-end selection: the loop by default, MTPU_HTTP_EVENTLOOP=off
    the thread path, as the JAX server chooses; round trips (plain,
    ranged, aws-chunked, a missing key), keep-alive reuse and pipelined
    requests on both front ends;
  * the idle deadline: a slowloris partial head reaped while parked
    (never dispatched), and an idle keep-alive connection closed on the
    same MTPU_HTTP_KEEPALIVE_S on both front ends;
  * a churn storm of instant closes, partial heads and PUTs dying
    mid-body: the connection table empties and the recv and staging
    pools' leases net to zero;
  * the 503 shed at accept past MTPU_MAX_CONNS, byte for byte the JAX
    server's, and a freed slot admitting again;
  * a response's final write offloaded to the loop's EPOLLOUT drain;
  * parked idle connections holding no recv lease.

And the port's own risks:

  * bytes already buffered: a PUT whose body (plain, or aws-chunked
    through the pooled reader) arrives in the head's segment, and two
    pipelined PUTs in one segment;
  * an offloaded GET tail: a slow reader of a multi-window GET gets every
    byte of the version it asked for while an overwrite of the key
    commits and another GET reuses the pooled windows; the pools'
    leases are back at their idle count afterwards;
  * stalled bodies: as many PUTs as the executor has threads stall
    mid-body, are answered 408 and closed on the idle deadline, and a
    health probe on another connection is answered meanwhile;
  * the loop never blocks: a hot hit whose reader reads nothing sits in
    the EPOLLOUT drain while another connection is answered;
  * the hot short circuit: a resident GET is answered on the loop (hot
    hits up, no dispatch) with the bytes and headers of the same GET
    with the hot cache off; Range, If-Match, versioned and chunked
    requests are declined and dispatched;
  * a stopped server closes every parked connection and leaves no
    socket and no lease; a pre-forked fleet's workers each serve through
    a loop of their own, a SIGKILLed worker's parked connections close
    and its respawn serves, and SIGTERM drains the fleet.

The tier sendfile case and the metrics, admin and fleet-merge cases of
tests/test_eventloop.py have no counterpart: the port has no tiering,
metrics or fleet control pipes yet.
"""

import contextlib
import hashlib
import hmac
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.s3 import eventloop as ref_eventloop
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.storage.local import LocalStorage as RefLocal
from minio_tpu_torch import server
from minio_tpu_torch.io.bufpool import global_pool
from minio_tpu_torch.object import erasure_object as eo
from minio_tpu_torch.s3 import eventloop, hotloop, sigv4
from tests.s3client import S3Client

pytestmark = pytest.mark.skipif(not hasattr(select, "epoll"),
                                reason="the epoll front end is Linux's")

RNG = np.random.default_rng(23)
BUCKET = "evloop"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Headers each response sets for itself, or that name its own PUT's time.
_OWN = {"date", "x-amz-request-id", "server", "last-modified"}


@contextlib.contextmanager
def _env(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Port:
    """A port server (`--device cpu`, 12 drives) serving from a thread;
    `env` holds while it is built (its front end reads it there)."""

    def __init__(self, root, env=None):
        with _env(env or {}):
            self.srv = server.boot([
                "--device", "cpu", "--address", "127.0.0.1:0",
                "--scanner-interval", "0",
                *[str(root / f"d{i}") for i in range(12)]])
        self.srv.objects.sets[0]._mrf_closed = True
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.address = self.srv.address

    def stats(self):
        return self.srv.eventloop_stats()

    def stop(self):
        self.srv.shutdown()
        self.thread.join(timeout=30)


def _ref(root, env=None):
    with _env(env or {}):
        srv = RefServer(RefSet([RefLocal(str(root / f"d{i}"))
                                for i in range(12)]), address="127.0.0.1:0")
    srv.start()
    return srv


def _raw(address, timeout=10, rcvbuf=None):
    host, _, port = address.rpartition(":")
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if rcvbuf:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    s.settimeout(timeout)
    s.connect((host, int(port)))
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _wait(cond, timeout=30, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _read_all(sock) -> bytes:
    raw = bytearray()
    while True:
        try:
            got = sock.recv(1 << 20)
        except OSError:
            break
        if not got:
            break
        raw += got
    return bytes(raw)


def _responses(raw: bytes) -> list:
    """[(status, lowercase headers, body)] of Content-Length responses
    laid end to end."""
    out = []
    while raw:
        end = raw.index(b"\r\n\r\n")
        lines = raw[:end].decode("latin-1").split("\r\n")
        h = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            h[k.strip().lower()] = v.strip()
        n = int(h.get("content-length", 0))
        out.append((int(lines[0].split()[1]), h, raw[end + 4:end + 4 + n]))
        raw = raw[end + 4 + n:]
    return out


def _signed_head(address, method, path, body=b"", extra=None,
                 payload_hash=None) -> bytes:
    """A header-signed request head (the port's signer) for raw sockets."""
    uri, headers = sigv4.sign_headers(
        method, address, path, "minioadmin", "minioadmin",
        payload_hash or hashlib.sha256(body).hexdigest(), extra=extra)
    lines = [f"{method} {uri} HTTP/1.1"] + \
        [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _comparable(st, h, body):
    """What both servers must answer alike: status, the body (or an
    error's code), the headers both set bar their own."""
    h = {k.lower(): v for k, v in h.items() if k.lower() not in _OWN}
    if st >= 300:
        # An error's XML is compared by its code (the JAX server's says
        # more), so its length is not compared either.
        start = body.find(b"<Code>")
        body = body[start:body.find(b"</Code>")] if start >= 0 else body
        h.pop("content-length", None)
    return st, h, body


def _same(port_answer, ref_answer):
    pst, ph, pb = _comparable(*port_answer)
    rst, rh, rb = _comparable(*ref_answer)
    common = set(ph) & set(rh)
    assert (pst, pb) == (rst, rb)
    assert {k: ph[k] for k in common} == {k: rh[k] for k in common}


# ---------------------------------------------------------------------------
# both front ends, held against the JAX server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["loop", "threads"])
def pair(request, tmp_path_factory):
    """A port server and a JAX server, both on the front end of the
    parameter (MTPU_HTTP_EVENTLOOP=off for "threads"), each with BUCKET."""
    env = {"MTPU_HTTP_EVENTLOOP": None if request.param == "loop"
           else "off"}
    root = tmp_path_factory.mktemp(f"evl-{request.param}")
    port = Port(root / "p", env)
    ref = _ref(root / "r", env)
    port.front = request.param
    port.ref = ref
    try:
        for addr in (port.address, ref.address):
            assert S3Client(addr).request("PUT", f"/{BUCKET}")[0] == 200
        yield port
    finally:
        ref.stop()
        port.stop()


def test_front_end_selection(pair):
    loop = pair.front == "loop"
    assert (type(pair.srv.httpd).__name__ == "EventLoopServer") == loop
    assert (type(pair.ref.httpd).__name__ == "EventLoopServer") == loop
    if pair.front == "loop":
        assert pair.stats()["enabled"] is True
        assert eventloop.loop_enabled() and ref_eventloop.loop_enabled()
    else:
        assert pair.stats() is None
        with _env({"MTPU_HTTP_EVENTLOOP": "off"}):
            assert not eventloop.loop_enabled()


def test_roundtrip_both_front_ends(pair):
    body = RNG.bytes(300_000)
    steps = [
        ("PUT", f"/{BUCKET}/obj", dict(body=body,
                                       headers={"x-amz-meta-k": "v"})),
        ("GET", f"/{BUCKET}/obj", {}),
        ("GET", f"/{BUCKET}/obj", dict(headers={"Range": "bytes=1000-2999"})),
        ("HEAD", f"/{BUCKET}/obj", {}),
        ("PUT", f"/{BUCKET}/chunked", dict(body=body, chunked=True)),
        ("GET", f"/{BUCKET}/chunked", {}),
        ("GET", f"/{BUCKET}/missing-key", {}),
    ]
    for method, path, kw in steps:
        got = S3Client(pair.address).request(method, path, **kw)
        want = S3Client(pair.ref.address).request(method, path, **kw)
        _same(got, want)
    assert S3Client(pair.address).request("GET", f"/{BUCKET}/obj")[2] == body


def test_keepalive_reuse_both_front_ends(pair):
    """Four requests, one after another, on one connection: each is
    answered and the connection stays open (the loop re-parks it)."""
    before = pair.stats()
    sock = _raw(pair.address)
    try:
        for _ in range(4):
            sock.sendall(b"GET /minio/health/live HTTP/1.1\r\n"
                         b"Host: x\r\n\r\n")
            got = b""
            while b"\r\n\r\n" not in got:
                more = sock.recv(65536)
                assert more, "the server closed a keep-alive connection"
                got += more
            assert got.startswith(b"HTTP/1.1 200")
            assert b"connection: close" not in got.lower()
    finally:
        sock.close()
    if before is not None:
        assert pair.stats()["accepted_total"] == before["accepted_total"] + 1
        assert _wait(lambda: pair.stats()["reparks_total"]
                     >= before["reparks_total"] + 4, timeout=10)


def test_pipelined_requests(pair):
    """Two GETs and a PUT in one segment, answered in order, as the JAX
    server answers them."""
    body = RNG.bytes(5000)
    answers = []
    for addr in (pair.address, pair.ref.address):
        sock = _raw(addr)
        try:
            sock.sendall(
                b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n\r\n"
                + _signed_head(addr, "PUT", f"/{BUCKET}/piped", body,
                               extra={"content-length": str(len(body))})
                + body
                + b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n"
                b"Connection: close\r\n\r\n")
            answers.append([(st, b) for st, _, b in
                            _responses(_read_all(sock))])
        finally:
            sock.close()
    assert answers[0] == answers[1]
    assert [st for st, _ in answers[0]] == [200, 200, 200]


# ---------------------------------------------------------------------------
# the idle deadline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["loop", "threads"])
def reap(request, tmp_path_factory):
    env = {"MTPU_HTTP_KEEPALIVE_S": "1",
           "MTPU_HTTP_EVENTLOOP": None if request.param == "loop"
           else "off"}
    port = Port(tmp_path_factory.mktemp(f"reap-{request.param}"), env)
    port.front = request.param
    yield port
    port.stop()


def _closed_within(sock, seconds) -> bool:
    sock.settimeout(seconds)
    try:
        return sock.recv(4096) == b""
    except socket.timeout:
        return False
    except OSError:
        return True


def test_slowloris_partial_head_reaped(reap):
    """A partial head never reaches the executor and dies on the idle
    deadline (the thread path's timeout on the head's read alike)."""
    stats0 = reap.stats()
    sock = _raw(reap.address)
    try:
        sock.sendall(b"GET /minio/health/live HTTP/1.1\r\nHo")
        assert _closed_within(sock, 8)
    finally:
        sock.close()
    if reap.front == "loop":
        assert _wait(lambda: reap.stats()["reaped_idle_total"]
                     > stats0["reaped_idle_total"], timeout=5)
        assert reap.stats()["dispatch_total"] == stats0["dispatch_total"]


def test_idle_keepalive_timeout_parity(reap):
    sock = _raw(reap.address)
    try:
        sock.sendall(b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n\r\n")
        assert sock.recv(65536).startswith(b"HTTP/1.1 200")
        t0 = time.monotonic()
        assert _closed_within(sock, 8)
        # The deadline is 1 s: far longer means another timer closed it.
        assert time.monotonic() - t0 < 6
    finally:
        sock.close()


def test_stalled_bodies_free_the_executor(tmp_path, monkeypatch):
    """As many PUTs as the executor has threads send their heads and a
    little of their bodies, then stall: each is answered 408
    RequestTimeout and closed on the idle deadline, which gives its
    thread back, and a health probe on another connection is answered
    within a few deadlines."""
    monkeypatch.setattr(eventloop, "EXECUTOR_THREADS", 4)
    port = Port(tmp_path, {"MTPU_HTTP_KEEPALIVE_S": "1",
                           "MTPU_HTTP_EVENTLOOP": None})
    stalled = []
    try:
        assert S3Client(port.address).request("PUT", f"/{BUCKET}")[0] == 200
        dispatched = port.stats()["dispatch_total"]
        for i in range(4):
            s = _raw(port.address, timeout=15)
            s.sendall(_signed_head(port.address, "PUT", f"/{BUCKET}/stall{i}",
                                   payload_hash=sigv4.UNSIGNED_PAYLOAD,
                                   extra={"content-length": str(64 << 10)})
                      + b"\x00" * 1024)
            stalled.append(s)
        assert _wait(lambda: port.stats()["dispatch_total"]
                     >= dispatched + 4, timeout=10)
        t0 = time.monotonic()
        probe = _raw(port.address, timeout=15)
        probe.sendall(b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n"
                      b"Connection: close\r\n\r\n")
        assert _read_all(probe).startswith(b"HTTP/1.1 200")
        probe.close()
        assert time.monotonic() - t0 < 6
        for s in stalled:
            assert [st for st, _, _ in _responses(_read_all(s))] == [408]
        assert port.stats()["executor_threads"] <= 4
        assert S3Client(port.address).request(
            "HEAD", f"/{BUCKET}/stall0")[0] == 404
    finally:
        for s in stalled:
            s.close()
        port.stop()


# ---------------------------------------------------------------------------
# churn, shed, idle memory
# ---------------------------------------------------------------------------

def _socket_fds() -> int:
    """Sockets this process holds open (the servers' and the tests')."""
    n = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            n += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass
    return n


def _leases():
    return (hotloop.recv_pool().stats()["outstanding"],
            global_pool("cpu").stats()["outstanding"])


def _back_to(base) -> bool:
    """No more leases out than at `base` (a connection of another
    server of the module may return one meanwhile)."""
    return all(now <= then for now, then in zip(_leases(), base))


def test_churn_storm_leases_net_zero(pair):
    """Instant closes, partial heads and signed PUTs dying mid-body,
    closed abortively: the connection table empties, the recv and
    staging pools' leases net to zero, and the server still serves."""
    time.sleep(0.5)
    base = _leases()
    fds = _socket_fds()
    put_head = _signed_head(pair.address, "PUT", f"/{BUCKET}/churn-victim",
                            payload_hash=sigv4.UNSIGNED_PAYLOAD,
                            extra={"content-length": str(64 << 10)})
    for _ in range(100):
        socks = []
        try:
            for kind in range(10):
                s = _raw(pair.address, timeout=5)
                if kind % 3 == 1:
                    s.sendall(b"GET /x HTTP/1.1\r\nHo")
                elif kind % 3 == 2:
                    s.sendall(put_head + b"\x00" * 1024)
                socks.append(s)
        finally:
            for s in socks:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             b"\x01\x00\x00\x00\x00\x00\x00\x00")
                s.close()
    if pair.front == "loop":
        assert _wait(lambda: pair.stats()["parked"] + pair.stats()["active"]
                     == 0, timeout=60), pair.stats()
    assert _wait(lambda: _socket_fds() <= fds, timeout=60), \
        (fds, _socket_fds())
    assert _wait(lambda: _back_to(base), timeout=60), (base, _leases())
    assert S3Client(pair.address).request(
        "GET", "/minio/health/live", sign=False)[0] == 200


def test_accept_shed_503(tmp_path):
    """Past MTPU_MAX_CONNS an accept is answered with the JAX server's
    503 + Retry-After and closed before any byte is read; a freed slot
    admits again."""
    env = {"MTPU_MAX_CONNS": "8"}
    port = Port(tmp_path / "p", env)
    ref = _ref(tmp_path / "r", env)
    try:
        shed = []
        for srv, stats in ((port, port.stats), (ref, ref.eventloop_stats)):
            assert stats()["max_conns"] == 8
            parked = [_raw(srv.address) for _ in range(8)]
            try:
                assert _wait(lambda: stats()["parked"] == 8, timeout=10)
                extra = _raw(srv.address)
                shed.append(_read_all(extra))
                extra.close()
                assert stats()["shed_total"] >= 1
                parked.pop().close()
                assert _wait(lambda: stats()["parked"] == 7, timeout=10)
                ok = _raw(srv.address)
                ok.sendall(b"GET /minio/health/live HTTP/1.1\r\n"
                           b"Host: x\r\n\r\n")
                assert ok.recv(4096).startswith(b"HTTP/1.1 200")
                ok.close()
            finally:
                for s in parked:
                    s.close()
        assert shed[0] == shed[1] == eventloop._SHED_RESPONSE
        assert b"Retry-After" in shed[0]
    finally:
        ref.stop()
        port.stop()


def test_parked_idle_connections_hold_no_leases(tmp_path):
    port = Port(tmp_path)
    conns = []
    try:
        time.sleep(0.3)
        base = hotloop.recv_pool().stats()["outstanding"]
        for _ in range(100):
            s = _raw(port.address)
            s.sendall(b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n\r\n")
            conns.append(s)
        for s in conns:
            assert s.recv(65536).startswith(b"HTTP/1.1 200")
        assert _wait(lambda: port.stats()["parked"] == 100, timeout=15)
        assert _wait(lambda: hotloop.recv_pool().stats()["outstanding"]
                     <= base, timeout=10)
        assert port.stats()["recv_leases"] <= base
    finally:
        for s in conns:
            s.close()
        port.stop()


# ---------------------------------------------------------------------------
# bytes already buffered
# ---------------------------------------------------------------------------

def _aws_chunked(address, path, body, chunk=8192) -> bytes:
    """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD PUT, head and body as one
    byte string (the body's framed length is known before signing)."""
    pieces = [body[i:i + chunk] for i in range(0, len(body), chunk)] + [b""]
    framed = sum(len(f"{len(p):x};chunk-signature=") + 64 + len(p) + 4
                 for p in pieces)
    head = _signed_head(address, "PUT", path,
                        payload_hash=sigv4.STREAMING_PAYLOAD,
                        extra={"content-encoding": "aws-chunked",
                               "x-amz-decoded-content-length": str(len(body)),
                               "content-length": str(framed)})
    text = head.decode()
    amz_date = text.split("x-amz-date: ")[1].split("\r\n")[0]
    prev = text.rsplit("Signature=", 1)[1].split("\r\n")[0]
    scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
    key = sigv4.signing_key("minioadmin", amz_date[:8], "us-east-1")
    wire = bytearray()
    for data in pieces:
        sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
                         sigv4.EMPTY_SHA256,
                         hashlib.sha256(data).hexdigest()])
        prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        wire += f"{len(data):x};chunk-signature={prev}\r\n".encode() \
            + data + b"\r\n"
    assert len(wire) == framed
    return head + wire


def test_put_body_in_the_head_segment(pair):
    """A PUT whose whole body rides its head's segment (plain, and
    aws-chunked through the pooled decoder), and two pipelined PUTs in
    one segment: every body is read from the connection's buffer."""
    bodies = [RNG.bytes(3000), RNG.bytes(20_000), RNG.bytes(7000),
              RNG.bytes(40_000)]
    addr = pair.address
    one = _signed_head(addr, "PUT", f"/{BUCKET}/seg0", bodies[0],
                       extra={"content-length": str(len(bodies[0]))}) \
        + bodies[0]
    chunked = _aws_chunked(addr, f"/{BUCKET}/seg1", bodies[1])
    two = b"".join(
        _signed_head(addr, "PUT", f"/{BUCKET}/seg{i}", bodies[i],
                     extra={"content-length": str(len(bodies[i]))})
        + bodies[i] for i in (2, 3))
    for wire, n in ((one, 1), (chunked, 1), (two, 2)):
        sock = _raw(addr)
        try:
            sock.sendall(wire + b"GET /minio/health/live HTTP/1.1\r\n"
                         b"Host: x\r\nConnection: close\r\n\r\n")
            got = _responses(_read_all(sock))
        finally:
            sock.close()
        assert [st for st, _, _ in got] == [200] * (n + 1), got
    for i, body in enumerate(bodies):
        assert S3Client(addr).request("GET", f"/{BUCKET}/seg{i}")[2] == body


# ---------------------------------------------------------------------------
# loop-owned tails
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_srv(tmp_path_factory):
    """A loop server with the hot cache off: GETs stream pooled
    windows."""
    port = Port(tmp_path_factory.mktemp("tails"),
                {"MTPU_HOT_CACHE": "off", "MTPU_HTTP_EVENTLOOP": None})
    assert S3Client(port.address).request("PUT", f"/{BUCKET}")[0] == 200
    yield port
    port.stop()


def _slow_get(srv, path, rcvbuf=8192):
    """A raw GET whose listener-inherited send buffer and own receive
    buffer are small, so the response cannot go out at once."""
    srv.srv.httpd.socket.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                    16384)
    sock = _raw(srv.address, timeout=60, rcvbuf=rcvbuf)
    sock.sendall(_signed_head(srv.address, "GET", path))
    return sock


def test_final_write_offloads_to_loop(loop_srv):
    body = RNG.bytes(512 << 10)
    c = S3Client(loop_srv.address)
    assert c.request("PUT", f"/{BUCKET}/slowread", body=body)[0] == 200
    before = loop_srv.stats()["offloads_total"]
    sock = _slow_get(loop_srv, f"/{BUCKET}/slowread")
    try:
        assert _wait(lambda: loop_srv.stats()["writing"] >= 1, timeout=15)
        assert loop_srv.stats()["offloads_total"] == before + 1
        raw = bytearray()
        while len(raw) < len(body) + 200:
            got = sock.recv(65536)
            if not got:
                break
            raw += got
            time.sleep(0.001)
            if raw.find(b"\r\n\r\n") > 0 and len(raw) - raw.find(
                    b"\r\n\r\n") - 4 >= len(body):
                break
        (st, _, got), = _responses(bytes(raw))
        assert st == 200 and got == body
    finally:
        sock.close()


def test_offloaded_tail_outlives_its_windows(loop_srv, monkeypatch):
    """A slow reader of a multi-window GET (1 MiB windows) gets every
    byte of the version it asked for, while, once its last window was
    offloaded (the GET's stream and read lock closed), an overwrite of
    the key commits and a GET of another object reuses the pooled
    windows; then the pools are back at their idle counts."""
    monkeypatch.setattr(eo, "STREAM_WINDOW_BLOCKS", 1)
    old, other, new = RNG.bytes(2 << 20), RNG.bytes(2 << 20), RNG.bytes(999)
    c = S3Client(loop_srv.address, timeout=120)
    assert c.request("PUT", f"/{BUCKET}/tail", body=old)[0] == 200
    assert c.request("PUT", f"/{BUCKET}/other", body=other)[0] == 200
    time.sleep(0.3)
    base = _leases()
    before = loop_srv.stats()["offloads_total"]
    sock = _slow_get(loop_srv, f"/{BUCKET}/tail")
    offloaded, resume = threading.Event(), threading.Event()
    raw = bytearray()

    def reader():
        # Reads 4 KiB at a time, and stops reading from the moment the
        # last window was left to the loop until resume is set.
        while True:
            got = sock.recv(4096)
            if not got:
                return
            raw.extend(got)
            if not offloaded.is_set() and \
                    loop_srv.stats()["offloads_total"] > before:
                offloaded.set()
                resume.wait(120)
            head = raw.find(b"\r\n\r\n")
            if head > 0 and len(raw) - head - 4 >= len(old):
                return
    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        assert offloaded.wait(60), loop_srv.stats()
        # The executor hands the tail to the loop just after the offload.
        assert _wait(lambda: loop_srv.stats()["writing"] >= 1, timeout=30)
        assert c.request("PUT", f"/{BUCKET}/tail", body=new)[0] == 200
        assert c.request("GET", f"/{BUCKET}/other")[2] == other
        assert t.is_alive()                 # the tail still drains
        resume.set()
        t.join(60)
        (st, _, got), = _responses(bytes(raw))
        assert st == 200 and got == old
    finally:
        resume.set()
        sock.close()
    assert c.request("GET", f"/{BUCKET}/tail")[2] == new
    assert _wait(lambda: _back_to(base), timeout=20), (base, _leases())


# ---------------------------------------------------------------------------
# the hot short circuit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hot_srv(tmp_path_factory):
    port = Port(tmp_path_factory.mktemp("hot"),
                {"MTPU_HOT_CACHE": "on", "MTPU_HTTP_EVENTLOOP": None})
    c = S3Client(port.address)
    assert c.request("PUT", f"/{BUCKET}")[0] == 200
    yield port
    port.stop()


def _resident(srv, path, body):
    """PUT `path` and GET it until the hot cache holds it with its
    head template (admission runs after the miss's final write)."""
    c = S3Client(srv.address)
    assert c.request("PUT", path, body=body)[0] == 200
    bucket, key = path.lstrip("/").split("/", 1)

    def held():
        assert c.request("GET", path)[2] == body
        e = srv.srv.hot_cache.get(bucket, key)
        return e is not None and e.head_prefix is not None
    assert _wait(held, timeout=20)


def test_hot_get_answered_on_the_loop(hot_srv):
    body = RNG.bytes(4096)
    path = f"/{BUCKET}/hot4k"
    _resident(hot_srv, path, body)
    s0 = hot_srv.stats()
    ka = S3Client(hot_srv.address, keepalive=True)
    try:
        hits = [ka.request("GET", path) for _ in range(5)]
    finally:
        ka.close()
    s1 = hot_srv.stats()
    assert s1["hot_hits_total"] == s0["hot_hits_total"] + 5
    assert s1["dispatch_total"] == s0["dispatch_total"]
    hc = hot_srv.srv.hot_cache
    hc.enabled = False
    try:
        cold = S3Client(hot_srv.address).request("GET", path)
    finally:
        hc.enabled = True
    assert hot_srv.stats()["dispatch_total"] == s1["dispatch_total"] + 1

    def plain(answer):
        st, h, b = answer
        return st, b, {k.lower(): v for k, v in h.items()
                       if k.lower() not in ("date", "x-amz-request-id")}
    for hit in hits:
        assert plain(hit) == plain(cold)
        assert hit[2] == body
    assert len({h[1]["x-amz-request-id"] for h in hits}) == 5


@pytest.mark.parametrize("case", ["range", "if-match", "versioned",
                                  "chunked"])
def test_hot_probe_declines(hot_srv, case):
    body = RNG.bytes(4096)
    path = f"/{BUCKET}/decline-{case}"
    _resident(hot_srv, path, body)
    s0 = hot_srv.stats()
    c = S3Client(hot_srv.address)
    if case == "range":
        st, _, got = c.request("GET", path, headers={"Range": "bytes=0-9"})
        assert (st, got) == (206, body[:10])
    elif case == "if-match":
        st, _, got = c.request("GET", path, headers={"If-Match": '"x"'})
        assert st == 200 and got == body
    elif case == "versioned":
        st, _, _ = c.request("GET", path, query={"versionId": "null"})
        assert st == 200
    else:
        sock = _raw(hot_srv.address)
        try:
            sock.sendall(_signed_head(hot_srv.address, "GET", path, extra={
                "transfer-encoding": "chunked", "connection": "close"})
                + b"0\r\n\r\n")
            (st, _, got), = _responses(_read_all(sock))
            assert st == 200 and got == body
        finally:
            sock.close()
    s1 = hot_srv.stats()
    assert s1["hot_hits_total"] == s0["hot_hits_total"]
    assert s1["dispatch_total"] == s0["dispatch_total"] + 1


def test_loop_never_blocks_on_a_slow_hot_reader(hot_srv):
    """A hot hit whose reader takes nothing waits in the EPOLLOUT drain
    (send_nb), and another connection is answered meanwhile."""
    body = RNG.bytes(2 << 20)
    path = f"/{BUCKET}/hot2m"
    _resident(hot_srv, path, body)
    hits = hot_srv.stats()["hot_hits_total"]
    sock = _slow_get(hot_srv, path)
    try:
        assert _wait(lambda: hot_srv.stats()["writing"] >= 1, timeout=10)
        assert hot_srv.stats()["hot_hits_total"] == hits + 1
        probe = _raw(hot_srv.address, timeout=5)
        t0 = time.monotonic()
        probe.sendall(b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n"
                      b"Connection: close\r\n\r\n")
        assert _read_all(probe).startswith(b"HTTP/1.1 200")
        assert time.monotonic() - t0 < 5
        probe.close()
        raw = bytearray()
        while True:
            got = sock.recv(1 << 20)
            raw += got
            head = raw.find(b"\r\n\r\n")
            if not got or (head > 0 and len(raw) - head - 4 >= len(body)):
                break
        (st, _, got), = _responses(bytes(raw))
        assert st == 200 and got == body
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# stop, and the pre-forked fleet
# ---------------------------------------------------------------------------

def _sockets() -> int:
    n = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            n += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass
    return n


def test_stop_closes_parked_connections(tmp_path):
    """A stop closes every parked connection (each client sees EOF) and
    leaves no socket of the server's and no recv lease."""
    base_socks = _sockets()
    base = hotloop.recv_pool().stats()["outstanding"]
    port = Port(tmp_path)
    conns = []
    for _ in range(20):
        s = _raw(port.address)
        s.sendall(b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n\r\n")
        assert s.recv(65536).startswith(b"HTTP/1.1 200")
        conns.append(s)
    partial = _raw(port.address)
    partial.sendall(b"GET /minio/health/live HTTP/1.1\r\nHo")
    conns.append(partial)
    assert _wait(lambda: port.stats()["parked"] == 21, timeout=10)
    port.stop()
    for s in conns:
        assert _closed_within(s, 5)
        s.close()
    assert hotloop.recv_pool().stats()["outstanding"] <= base
    assert _wait(lambda: _sockets() <= base_socks, timeout=10), \
        (base_socks, _sockets())


def _meet_workers(address, n: int, timeout: float = 60) -> dict:
    """pid -> admin info, asked over fresh connections until `n`
    workers answered."""
    seen: dict = {}
    deadline = time.monotonic() + timeout
    while len(seen) < n and time.monotonic() < deadline:
        st, _, body = S3Client(address).request("GET",
                                                "/minio/admin/v3/info")
        if st == 200:
            info = json.loads(body)
            seen[info["pid"]] = info
    return seen


def test_fleet_workers_serve_through_their_loops(tmp_path):
    """MTPU_HTTP_WORKERS=2: each worker answers through a loop of its
    own (admin info from fresh connections meets both); a SIGKILLed
    worker's parked connections close and its respawn serves through a
    loop; SIGTERM to the parent drains the fleet, each worker printing
    its front end's counters."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    addr = f"127.0.0.1:{port_no}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", "cpu",
         "--address", addr, "--scanner-interval", "0",
         *[str(tmp_path / f"d{i}") for i in range(12)]],
        cwd=ROOT, env={**os.environ, "MTPU_HTTP_WORKERS": "2",
                       "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    lines: list = []
    threading.Thread(target=lambda: lines.extend(
        ln.rstrip() for ln in proc.stdout), daemon=True).start()
    try:
        assert _wait(lambda: sum("serving S3 on" in ln for ln in lines) >= 2,
                     timeout=240), lines[-20:]
        seen = _meet_workers(addr, 2)
        assert len(seen) == 2
        for info in seen.values():
            # Admin info's `workers` carries each worker's own loop.
            assert [w["connections"]["enabled"]
                    for w in info["workers"]] == [True, True]
        victim = sorted(seen)[-1]
        parked = [_raw(addr) for _ in range(16)]
        for s in parked:
            s.sendall(b"GET /minio/health/live HTTP/1.1\r\nHost: x\r\n\r\n")
            assert s.recv(65536).startswith(b"HTTP/1.1 200")
        os.kill(victim, signal.SIGKILL)
        closed = sum(_closed_within(s, 0.5) for s in parked)
        assert closed >= 1                  # the victim's parked ones
        for s in parked:
            s.close()
        assert _wait(lambda: sum("serving S3 on" in ln for ln in lines) >= 3,
                     timeout=240), lines[-20:]
        fresh = _meet_workers(addr, 2)
        assert len(fresh) == 2 and victim not in fresh
        assert all(w["connections"]["enabled"] for i in fresh.values()
                   for w in i["workers"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=30)
    time.sleep(0.2)
    fronts = [ln for ln in lines if "front end while serving: " in ln]
    assert len(fronts) == 2, lines[-20:]
    for ln in fronts:
        doc = json.loads(ln.split("front end while serving: ", 1)[1])
        assert doc["dispatched"] >= 1 and doc["recv_leases"] == 0

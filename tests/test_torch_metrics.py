"""The port's metrics registry and admin surfaces
(minio_tpu_torch/s3/metrics.py, the server's /minio/v2/metrics/cluster
and admin info) held against the JAX package's.

* The same record() sequence on both registries renders the same lines
  for every series the port has; the series the port leaves out are
  exactly those of the planes it lacks.
* A fleet's merge: the same per-worker states render the same lines,
  and `merge_loop_stats` merges the same.
* The server: one accounting a request on every response path (pooled
  windows, the hot short circuit on the loop, a tail the loop drains),
  the unsigned scrape, the connection plane's series and admin info's
  sections (the cases of tests/test_eventloop.py and
  tests/test_admin_api.py).

Tolerance: none; lines and counts compare exactly.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
import time

import numpy as np
import pytest

from minio_tpu.s3 import metrics as ref_metrics
from minio_tpu_torch import server
from minio_tpu_torch.s3 import metrics as port_metrics
from tests.s3client import S3Client

RNG = np.random.default_rng(31)
# The JAX series of planes the port does not have yet (ROADMAP A.6-A.8
# and the per-drive engine queues): never rendered by the port.
LEFT_OUT = re.compile(r"minio_tpu_(transform|replication|site_replication|"
                      r"batch_jobs|drive_queue|drive_op_duration|"
                      r"drive_last_minute|get_kernel_windows|"
                      r"cluster_node_replication_lag)")


def _family(line: str) -> str:
    if line.startswith("#"):
        return line.split()[2]
    name = re.split(r"[{ ]", line, maxsplit=1)[0]
    return re.sub(r"_(bucket|sum|count)$", "", name)


def _record_sequence(m) -> None:
    for i in range(60):
        m.record("GET:object", 200 if i % 7 else 503, 0.0013 * i,
                 rx=10, tx=100 * i)
        m.record("PUT:object", 200 if i % 11 else 429, 0.021, rx=1000)
    m.record("GET:admin", 200, 0.3)
    m.record("DELETE:object", 404, 0.0001)
    for _ in range(3):
        m.conn_open()
    m.conn_close()
    m.keepalive_reuse()
    m.keepalive_reuse()
    m.parse_fallback()
    for kind in ("pooled", "pooled", "hotcache", "sendfile"):
        m.response_path(kind)


# Families whose samples come from the registry alone; the others read
# process-wide state (pools, batchers, lanes, grid peers) that other
# cases in the same process leave different in the two packages.
REGISTRY = ("minio_tpu_http_", "minio_tpu_api_")


def _families(text: str) -> dict:
    out: dict = {}
    for ln in text.splitlines():
        out.setdefault(_family(ln), []).append(ln)
    return out


def _compare(ref_text: str, port_text: str) -> None:
    """The same families in the same order with the same HELP and TYPE
    lines, the registry's with the same samples; the JAX families the
    port lacks are LEFT_OUT's."""
    ref, port = _families(ref_text), _families(port_text)
    assert list(port) == [f for f in ref if f in port]
    left = set(ref) - set(port)
    assert all(LEFT_OUT.match(f) for f in left), sorted(left)
    for fam, lines in port.items():
        if fam.startswith(REGISTRY):
            assert lines == ref[fam], fam
        else:
            assert [ln for ln in lines if ln.startswith("#")] == \
                [ln for ln in ref[fam] if ln.startswith("#")], fam


@pytest.fixture
def fixed_clock(monkeypatch):
    # The last-minute windows and the SLO rings read the wall clock.
    monkeypatch.setattr(time, "time", lambda: 1760832000.25)


def test_record_sequence_renders_the_jax_lines(fixed_clock):
    regs = (ref_metrics.Metrics(), port_metrics.Metrics())
    for m in regs:
        _record_sequence(m)
    # slow_ops_total is the process's slow-op count (utils/tracing),
    # which earlier cases in the same process set apart.
    ref_state, port_state = (m.state() for m in regs)
    ref_state.pop("slow_ops_total")
    port_state.pop("slow_ops_total")
    assert port_state == ref_state
    assert regs[1].last_minute() == regs[0].last_minute()
    assert regs[1].http_conn_stats() == regs[0].http_conn_stats()
    _compare(regs[0].render(), regs[1].render())


def test_fleet_states_render_the_jax_lines(fixed_clock):
    """Three workers' states, one of them unreachable, merged by the
    render of a scrape that reached any worker."""
    states = []
    for w in range(2):
        m = port_metrics.Metrics()
        _record_sequence(m)
        m.record("HEAD:object", 200, 0.002 * (w + 1))
        states.append({"worker": w, "pid": 100 + w, "metrics": m.state(),
                       "connections": {
                           "enabled": True, "parked": 3 + w, "active": 1,
                           "writing": 0, "max_conns": 4096,
                           "accepted_total": 20 * (w + 1),
                           "shed_total": w, "reparks_total": 5,
                           "reaped_idle_total": 0, "dispatch_total": 40,
                           "hot_hits_total": 2, "executor_threads": 8,
                           "executor_queue": 0}})
    states.append({"worker": 2, "pid": 102, "unreachable": True})
    ref = ref_metrics.Metrics().render(peer_states=json.loads(
        json.dumps(states)))
    port = port_metrics.Metrics().render(peer_states=json.loads(
        json.dumps(states)))
    _compare(ref, port)
    loops = [s["connections"] for s in states if "connections" in s]
    assert port_metrics.merge_loop_stats(loops) == \
        ref_metrics.merge_loop_stats(loops)


# -- the server ----------------------------------------------------------------

class _Srv:
    """A port server (`--device cpu`, 4 drives, the event loop, the hot
    cache on) serving from a thread."""

    def __init__(self, root):
        saved = os.environ.get("MTPU_HOT_CACHE")
        os.environ["MTPU_HOT_CACHE"] = "on"
        try:
            self.srv = server.boot([
                "--device", "cpu", "--address", "127.0.0.1:0",
                "--scanner-interval", "0",
                *[str(root / f"d{i}") for i in range(4)]])
        finally:
            if saved is None:
                os.environ.pop("MTPU_HOT_CACHE")
            else:
                os.environ["MTPU_HOT_CACHE"] = saved
        self.srv.objects.sets[0]._mrf_closed = True
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.address = self.srv.address

    def stop(self):
        self.srv.shutdown()
        self.thread.join(timeout=30)


@pytest.fixture(scope="module")
def srv(tmp_path_factory):
    s = _Srv(tmp_path_factory.mktemp("metrics"))
    yield s
    s.stop()


def _scrape(address, query="") -> str:
    st, _, body = S3Client(address).request(
        "GET", "/minio/v2/metrics/cluster" + query, sign=False)
    assert st == 200
    return body.decode()


def _requests(text: str) -> dict:
    out: dict = {}
    for ln in text.splitlines():
        m = re.match(r'minio_tpu_http_requests_total\{api="([^"]+)",'
                     r'status="([^"]+)"\} (\d+)$', ln)
        if m:
            out[(m.group(1), m.group(2))] = int(m.group(3))
    return out


def _wait(cond, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_every_response_path_is_accounted_once(srv):
    """PUTs, pooled GETs, hot GETs answered on the loop and a GET whose
    tail the loop drains: the scrape's counts are the requests sent."""
    c = S3Client(srv.address)
    base = _requests(_scrape(srv.address))
    sent: dict = {}

    def note(api, st):
        cls = f"{st // 100}xx"
        sent[(api, cls)] = sent.get((api, cls), 0) + 1
    st = c.request("PUT", "/acct")[0]
    note("PUT:bucket", st)
    small = RNG.bytes(4096)
    note("PUT:object", c.request("PUT", "/acct/hot", body=small)[0])
    hc = srv.srv.hot_cache

    def held():
        note("GET:object", c.request("GET", "/acct/hot")[0])
        e = hc.get("acct", "hot")
        return e is not None and e.head_prefix is not None
    assert _wait(held)
    loop0 = srv.srv.eventloop_stats()["hot_hits_total"]
    ka = S3Client(srv.address, keepalive=True)
    try:
        for _ in range(4):
            note("GET:object", ka.request("GET", "/acct/hot")[0])
    finally:
        ka.close()
    assert srv.srv.eventloop_stats()["hot_hits_total"] == loop0 + 4
    big = RNG.bytes(300_000)
    note("PUT:object", c.request("PUT", "/acct/big", body=big)[0])
    hc.enabled = False
    try:
        st, _, got = c.request("GET", "/acct/big")
        assert got == big
        note("GET:object", st)
        note("HEAD:object", c.request("HEAD", "/acct/big")[0])
        note("GET:object", c.request("GET", "/acct/none")[0])
        # A slow reader: the response's tail goes to the loop's drain.
        srv.srv.httpd.socket.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_SNDBUF, 16384)
        off0 = srv.srv.eventloop_stats()["offloads_total"]
        from tests.test_torch_eventloop import _raw, _signed_head
        sock = _raw(srv.address, timeout=60, rcvbuf=8192)
        try:
            sock.sendall(_signed_head(srv.address, "GET", "/acct/big"))
            assert _wait(lambda: srv.srv.eventloop_stats()[
                "offloads_total"] > off0)
            raw = b""
            while len(raw) < len(big):
                got = sock.recv(65536)
                if not got:
                    break
                raw += got
        finally:
            sock.close()
        note("GET:object", 200)
    finally:
        hc.enabled = True
    assert _wait(lambda: {k: v - base.get(k, 0) for k, v in _requests(
        _scrape(srv.address)).items()
        if v - base.get(k, 0) and k[0] != "GET:metrics"} == sent), \
        (sent, _requests(_scrape(srv.address)), base)
    paths = srv.srv.metrics.http_conn_stats()["response_path"]
    assert paths.get("hotcache", 0) >= 4 and paths.get("pooled", 0) >= 2


def test_connection_plane_metrics_exported(srv):
    text = srv.srv.metrics.render(server=srv.srv)
    for name in ("minio_tpu_http_eventloop_enabled",
                 "minio_tpu_http_parked_connections",
                 "minio_tpu_http_dispatched_connections",
                 "minio_tpu_http_conns_accepted_total",
                 "minio_tpu_http_conns_shed_total",
                 "minio_tpu_http_conn_reparks_total",
                 "minio_tpu_http_idle_reaped_total",
                 "minio_tpu_http_response_path_total"):
        assert name in text, name
    assert "minio_tpu_http_eventloop_enabled 1" in text
    assert "minio_tpu_http_loop_lag_seconds" in text


def test_admin_info_sections(srv):
    """Admin info's connection plane, last-minute latency, slow-op and
    SLO sections; the connection counters come from the registry."""
    c = S3Client(srv.address)
    c.request("PUT", "/infob")
    st, _, body = c.request("GET", "/minio/admin/v3/info")
    assert st == 200
    info = json.loads(body)
    conns = info["connections"]
    for k in ("parked", "active", "max_conns", "accepted_total",
              "shed_total", "reparks_total", "reaped_idle_total"):
        assert k in conns, k
    assert "loop_lag_ms" in conns
    assert set(info["http"]) == {"connections_active", "keepalive_reuses",
                                 "parse_fallbacks", "response_path"}
    assert info["sets"] == 1 and info["drives_online"] == 4
    assert len(info["drives"]) == 4
    assert all(d["state"] == "ok" for d in info["drives"])
    assert "PUT:bucket" in info["last_minute"]
    assert set(info["slow_ops"]) == {"total", "threshold_ms", "recent"}
    assert {o["name"] for o in info["slo"]["objectives"]} == {
        "get-availability", "put-availability"}


def test_metrics_endpoint_reports_the_layer(srv):
    c = S3Client(srv.address)
    c.request("PUT", "/metb")
    c.request("PUT", "/metb/obj", body=b"x" * 1000)
    srv.srv.scanner.scan_cycle()
    text = _scrape(srv.address)
    assert 'minio_tpu_http_requests_total{api="PUT:object"' in text
    assert re.search(r"^minio_tpu_cluster_objects_total [1-9]", text,
                     re.M)
    assert "minio_tpu_drives_online 4" in text
    assert "minio_tpu_capacity_raw_total_bytes" in text
    assert "minio_tpu_batcher_dispatches_total" in text


def test_admin_verbs_require_root(srv):
    anon = S3Client(srv.address, access_key="nobody",
                    secret_key="xxxxxxxx")
    for method, path in (("GET", "info"), ("GET", "trace"),
                         ("POST", "speedtest"),
                         ("POST", "start-profiling")):
        assert anon.request(method, f"/minio/admin/v3/{path}")[0] == 403


def test_admin_speedtest_clamps_and_cleans_up(srv):
    c = S3Client(srv.address)
    st, _, body = c.request("POST", "/minio/admin/v3/speedtest",
                            query={"size": "1", "count": "3"})
    assert st == 200, body
    r = json.loads(body)
    # size clamps to 1 KiB (and at most 256 MiB), count to 1..64.
    assert r["objects"] == 3 and r["object_size"] == 1024
    assert r["put_mibps"] > 0 and r["get_mibps"] > 0
    st, _, body = c.request("GET", "/")
    assert b"speedtest" not in body

"""The port's observability plane across processes: a pre-forked fleet
(io/workers.py's control pipes: cluster stats and the trace pump) and
four nodes over the grid (the `wire` spans with each peer's subtree, the
`?cluster=true` metrics, a call cut by a SIGKILLed node).

The JAX counterparts: tests/test_trace_deep.py
`test_cross_worker_trace_stream` (the fleet, not slow) and
tests/test_fleet_obs.py `test_cluster_armed_get_chaos_fault_annotation`
(nodes over the grid, slow); each case here is marked as its
counterpart is.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac as hmac_mod
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from minio_tpu_torch.s3 import sigv4
from tests.s3client import S3Client
from tests.torch_cluster import TorchCluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stream_trace(address, query: dict, out: list) -> None:
    """One signed GET of /minio/admin/v3/trace, de-chunked, its JSON
    lines appended to `out` (S3Client cannot stream)."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    scope = f"{date}/us-east-1/s3/aws4_request"
    payload_hash = hashlib.sha256(b"").hexdigest()
    hdrs = {"host": address, "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash}
    signed = sorted(hdrs)
    q = {k: [v] for k, v in query.items()}
    canon = sigv4.canonical_request("GET", "/minio/admin/v3/trace", q,
                                    hdrs, signed, payload_hash)
    sts = sigv4.string_to_sign(amz_date, scope, canon)
    skey = sigv4.signing_key("minioadmin", date, "us-east-1")
    sig = hmac_mod.new(skey, sts.encode(), hashlib.sha256).hexdigest()
    qs = "&".join(f"{k}={v}" for k, v in sorted(query.items()))
    conn = http.client.HTTPConnection(address, timeout=90)
    conn.request("GET", f"/minio/admin/v3/trace?{qs}", headers={
        **hdrs,
        "Authorization": f"{sigv4.ALGORITHM} "
        f"Credential=minioadmin/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"})
    body = conn.getresponse().read()
    conn.close()
    for line in body.splitlines():
        if line.strip():
            out.append(json.loads(line))


def _requests(text: str, api: str) -> int:
    return sum(int(m.group(1)) for m in re.finditer(
        r'^minio_tpu_http_requests_total\{api="' + re.escape(api)
        + r'",status="[^"]+"\} (\d+)$', text, re.M))


# -- a fleet of two workers ----------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("obsfleet")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    address = f"127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", "cpu",
         "--address", address, "--scanner-interval", "0",
         *[str(root / f"d{i}") for i in range(4)]],
        cwd=REPO, env={**os.environ, "MTPU_HTTP_WORKERS": "2",
                       "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    lines: list = []
    threading.Thread(target=lambda: lines.extend(
        ln.rstrip() for ln in proc.stdout), daemon=True).start()
    deadline = time.time() + 240
    while time.time() < deadline and \
            sum("serving S3 on" in ln for ln in lines) < 2:
        assert proc.poll() is None, lines[-20:]
        time.sleep(0.2)
    assert sum("serving S3 on" in ln for ln in lines) >= 2, lines[-20:]
    yield address
    proc.send_signal(signal.SIGTERM)
    try:
        assert proc.wait(timeout=60) == 0, lines[-20:]
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def test_fleet_trace_and_metrics_see_every_worker(fleet):
    """One worker's trace subscriber receives entries from every
    worker's pid, internal spans included; one scrape through any worker
    sums every worker's request counts to the requests sent; admin info
    lists both workers."""
    entries: list = []
    t = threading.Thread(target=stream_trace,
                         args=(fleet, {"types": "all", "count": "400"},
                               entries), daemon=True)
    t.start()
    time.sleep(1.5)                 # the subscription arms the fleet
    assert S3Client(fleet).request("PUT", "/fleetobs")[0] == 200
    body = os.urandom(150_000)
    sent = 0
    deadline = time.time() + 60
    while t.is_alive() and time.time() < deadline:
        # A fresh connection each: the kernel spreads them over both.
        assert S3Client(fleet).request(
            "PUT", f"/fleetobs/o{sent % 8}", body=body)[0] == 200
        sent += 1
    t.join(timeout=10)
    roots = [e for e in entries if e.get("trace_type") == "s3"
             and e.get("api") == "PUT:object"]
    assert {e["worker"] for e in roots} == {0, 1}, \
        {e.get("worker") for e in entries}
    tids = {e["trace"] for e in roots}
    assert any(e.get("trace_type") == "storage" and e.get("trace") in tids
               for e in entries)
    for _ in range(4):
        # Scrapes through fresh connections: whichever worker answers,
        # it reports the fleet.
        st, _, text = S3Client(fleet).request(
            "GET", "/minio/v2/metrics/cluster", sign=False)
        assert st == 200
        assert _requests(text.decode(), "PUT:object") == sent
        assert "minio_tpu_workers_total 2" in text.decode()
        assert text.decode().count("minio_tpu_worker_up{") == 2
        assert "minio_tpu_http_eventloop_enabled 1" in text.decode()
    # Admin info through any worker reports the fleet's connection plane
    # (tests/test_eventloop.py test_fleet_connections_admin_and_metrics).
    st, _, raw = S3Client(fleet).request("GET", "/minio/admin/v3/info")
    info = json.loads(raw)
    assert sorted(w["worker"] for w in info["workers"]) == [0, 1]
    conns = info["connections"]
    assert conns["accepted_total"] >= sent and conns["max_conns"] > 0
    assert "loop_lag_ms" in conns


# -- four nodes ----------------------------------------------------------------

def _collect(cluster, i, count, fn) -> list:
    """Subscribe types=all on node i, run `fn`, then pad with probes
    until the count closes the stream."""
    entries: list = []
    t = threading.Thread(target=stream_trace,
                         args=(cluster.address(i),
                               {"types": "all", "count": str(count)},
                               entries), daemon=True)
    t.start()
    time.sleep(0.8)
    fn()
    cli = cluster.client(i)
    for _ in range(200):
        if not t.is_alive():
            break
        cli.request("GET", "/minio/health/live", sign=False)
        time.sleep(0.05)
    t.join(timeout=30)
    return entries


@pytest.mark.slow
def test_four_node_armed_get_cluster_metrics_and_a_cut_call(tmp_path):
    """An armed GET through node 0 of an object whose shards lie mostly
    on other nodes: `wire` spans with each remote subtree stitched under
    them, tagged with its node. `?cluster=true` metrics carry all four
    node labels. After node 3's SIGKILL an armed GET's tree annotates
    the cut call as a fault."""
    with TorchCluster(tmp_path, nodes=4, drives_per_node=2) as cluster:
        cli = cluster.client(0)
        assert cli.request("PUT", "/obs")[0] == 200
        body = os.urandom(200_000)
        assert cli.request("PUT", "/obs/o", body=body)[0] == 200
        got: dict = {}

        def get():
            st, _, data = cli.request("GET", "/obs/o")
            got["ok"] = st == 200 and data == body
        entries = _collect(cluster, 0, 150, get)
        assert got["ok"]
        roots = [e for e in entries if e.get("trace_type") == "s3"
                 and e.get("api") == "GET:object"]
        assert roots
        me = roots[0].get("node")
        tree = [e for e in entries if e.get("trace") == roots[0]["trace"]]
        wires = {e["span"]: e for e in tree if e.get("api") == "wire"}
        remote = [e for e in tree if str(e.get("api")).startswith("disk.")
                  and e.get("node") not in (None, me)]
        assert wires and remote
        assert all(e["parent"] in wires or e["parent"] in
                   {r["span"] for r in remote} for e in remote)
        assert len({e["node"] for e in remote}) == 3

        st, _, text = cli.request("GET", "/minio/v2/metrics/cluster",
                                  query={"cluster": "true"}, sign=False)
        assert st == 200
        nodes = set(re.findall(r'minio_tpu_cluster_node_up\{node="([^"]+)"'
                               r'\} 1', text.decode()))
        assert len(nodes) == 4, text.decode()[-2000:]

        cluster.kill(3)

        def cut():
            deadline = time.time() + 20
            while time.time() < deadline:
                st, _, data = cli.request("GET", "/obs/o")
                if st == 200:
                    got["cut"] = data == body
                    return
                time.sleep(0.5)
        entries = _collect(cluster, 0, 150, cut)
        assert got.get("cut")
        faults = [e for e in entries if e.get("api") == "wire"
                  and "fault" in (e.get("tags") or {})]
        assert faults, [e.get("api") for e in entries][:40]

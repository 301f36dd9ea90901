"""The port's trace records and live trace stream
(minio_tpu_torch/s3/trace.py) held against the JAX package's
(minio_tpu/s3/trace.py): `make_entry`, the broadcaster's typed
subscriptions, its drop-oldest slow subscriber, the broadcast entries
that pass every filter, the remote relay and its TTL, and the audit
webhook. Every broadcaster case runs on both packages and compares what
each delivered. Tolerance: none.
"""

from __future__ import annotations

import http.server
import json
import threading
import time

import pytest

from minio_tpu.s3 import trace as ref_trace
from minio_tpu.utils import tracing as ref_tracing

from minio_tpu_torch.s3 import trace as port_trace
from minio_tpu_torch.utils import tracing as port_tracing

PKG = {"jax": (ref_trace, ref_tracing), "port": (port_trace, port_tracing)}
ARGS = ("PUT:object", "PUT", "/b/k", "b", "k", 200, 0.0123456,
        "127.0.0.1", "minioadmin")


def test_make_entry_equal_to_jax(monkeypatch):
    """Both packages' records of one request, at one clock reading."""
    for mod in (ref_trace, port_trace):
        monkeypatch.setattr(mod.time, "time", lambda: 1760832000.4567)
    ref = ref_trace.make_entry(*ARGS, rx=1024, tx=7)
    port = port_trace.make_entry(*ARGS, rx=1024, tx=7)
    assert port == ref
    assert port["time"] == "2025-10-19T00:00:00.456Z"
    assert list(port) == list(ref)          # the same key order


def _run_both(case) -> dict:
    out = {}
    for pkg, (trace, tracing) in PKG.items():
        out[pkg] = case(trace.TraceBroadcaster(), tracing)
    assert out["port"] == out["jax"], out
    return out["port"]


def _drain(q) -> list:
    got = []
    while not q.empty():
        got.append(q.get_nowait())
    return got


def test_typed_subscriptions_filter():
    def case(b, tracing):
        qs3 = b.subscribe()                     # default: s3 only
        qst = b.subscribe(types={"storage", "kernel"})
        armed = tracing.ACTIVE
        for e in ({"trace_type": "s3", "i": 1},
                  {"trace_type": "storage", "i": 2},
                  {"trace_type": "kernel", "i": 3},
                  {"trace_type": "grid", "i": 4},     # nobody wants it
                  {"i": 5}):                          # untyped is s3
            b.publish(e)
        got = ([e["i"] for e in _drain(qs3)], [e["i"] for e in _drain(qst)])
        b.unsubscribe(qst)
        disarmed = not tracing.ACTIVE or tracing.slow_ms() > 0
        b.unsubscribe(qs3)
        return armed, got, disarmed, b.active
    assert _run_both(case) == (True, ([1, 5], [2, 3]), True, False)


def test_slow_subscriber_drops_oldest():
    def case(b, tracing):
        q = b.subscribe(types={"storage"})
        try:
            for i in range(1500):           # past the queue's 1000
                b.publish({"trace_type": "storage", "i": i})
            got = [e["i"] for e in _drain(q)]
        finally:
            b.unsubscribe(q)
        return len(got), got[0], got[-1]
    assert _run_both(case) == (1000, 500, 1499)


def test_slow_subscriber_drops_are_counted():
    """The port's broadcaster counts what its slow subscribers dropped
    (chip_smoke.py's unpaced 4l window reports it)."""
    b = port_trace.TraceBroadcaster()
    q = b.subscribe(types={"storage"})
    try:
        for i in range(1500):
            b.publish({"trace_type": "storage", "i": i})
        b.publish({"trace_type": "s3", "i": -1})    # not subscribed
    finally:
        b.unsubscribe(q)
    assert b.dropped == 500 and len(_drain(q)) == 1000


def test_untyped_pubsub_and_slow_subscriber():
    """tests/test_trace_robustness.py's case: a default subscriber of
    untyped entries past the queue's depth."""
    def case(b, tracing):
        before = b.active
        q = b.subscribe()
        during = b.active
        for i in range(1500):
            b.publish({"i": i})
        got = [e["i"] for e in _drain(q)]
        b.unsubscribe(q)
        return before, during, len(got), got[-1], b.active
    assert _run_both(case) == (False, True, 1000, 1499, False)


def test_broadcast_entries_pass_every_filter():
    def case(b, tracing):
        q = b.subscribe(types={"storage"})
        try:
            b.publish({"trace_type": "s3", "api": "trace.dropped",
                       "broadcast": True})
            b.publish({"trace_type": "s3", "api": "normal-root"})
            return [e["api"] for e in _drain(q)]
        finally:
            b.unsubscribe(q)
    assert _run_both(case) == ["trace.dropped"]


def test_remote_relay_arms_and_drains():
    def case(b, tracing):
        b.arm_remote(["s3", "storage"])
        armed = b.active and tracing.ACTIVE
        b.publish({"trace_type": "storage", "i": 1})
        b.publish({"trace_type": "kernel", "i": 2})   # not relayed
        b.publish({"trace_type": "s3", "i": 3})
        first = [e["i"] for e in b.drain_remote()]
        second = b.drain_remote()
        b.disarm_remote()
        return armed, first, second, b.active
    assert _run_both(case) == (True, [1, 3], [], False)


def test_remote_relay_ttl_self_disarms():
    """A worker whose parent never sent trace_stop does not stay armed:
    the relay expires when no drain refreshed it within its TTL."""
    def case(b, tracing):
        b.arm_remote(["storage"])
        armed = b.active and tracing.ACTIVE
        b._remote_deadline = time.monotonic() - 1     # stale
        b.publish({"trace_type": "storage", "i": 1})  # the lazy check
        return (armed, b.active, b.drain_remote(),
                not tracing.ACTIVE or tracing.slow_ms() > 0)
    assert _run_both(case) == (True, False, [], True)


class _Hook(http.server.BaseHTTPRequestHandler):
    received: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).received.append((self.headers.get("Content-Type"),
                                    json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("pkg", list(PKG))
def test_audit_logger_delivers_bare_records(pkg):
    """Each record is POSTed bare as JSON, the same on both packages."""
    trace, _ = PKG[pkg]
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    _Hook.received = []
    log = trace.AuditLogger(f"http://127.0.0.1:{srv.server_address[1]}/a")
    try:
        entry = trace.make_entry(*ARGS)
        log.submit(entry)
        deadline = time.time() + 10
        while not _Hook.received and time.time() < deadline:
            time.sleep(0.02)
        assert _Hook.received == [("application/json", entry)]
        deadline = time.time() + 5
        while log.stats()["sent"] < 1 and time.time() < deadline:
            time.sleep(0.02)
        st = log.stats()
        assert st["sent"] == 1 and st["dropped"] == 0
    finally:
        log.stop()
        srv.shutdown()


def test_audit_drops_surface_in_both_renders():
    """An unreachable target: the drop counters, rendered by both
    packages' Metrics the same."""
    import types
    from minio_tpu.s3.metrics import Metrics as RefMetrics
    from minio_tpu_torch.s3.metrics import Metrics as PortMetrics
    texts = []
    for trace, metrics in ((ref_trace, RefMetrics),
                           (port_trace, PortMetrics)):
        log = trace.AuditLogger("http://127.0.0.1:1/audit", timeout=0.2)
        log._MAX_ATTEMPTS = 1
        try:
            log.submit(trace.make_entry(*ARGS))
            deadline = time.time() + 10
            while log.dropped == 0 and time.time() < deadline:
                time.sleep(0.05)
            text = metrics().render(server=types.SimpleNamespace(audit=log))
        finally:
            log.stop()
        texts.append([ln for ln in text.splitlines()
                      if "minio_tpu_audit_" in ln])
    assert texts[0] == texts[1]
    assert any(ln.startswith("minio_tpu_audit_dropped_total 1")
               for ln in texts[1]), texts[1]

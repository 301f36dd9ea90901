"""The port's admission control (minio_tpu_torch/s3/admission.py)
against the JAX package's (minio_tpu/s3/admission.py), exact.

path_class / class_for on a table of paths, parse_duration and
from_env on tables of settings, divided() for fleet widths, and the
gate's decisions (fast admit, queue, queue-full shed, deadline shed,
admit after a leave) in the same order in both, each step's snapshot
equal. Over HTTP on the port's server: a request that finds no slot
answers 503 SlowDown with Retry-After, and the admin/health class keeps
its own gate.
"""

from __future__ import annotations

import threading
import time

import pytest

from minio_tpu.s3 import admission as jax_adm
from minio_tpu_torch import server
from minio_tpu_torch.object.drive_heal import admission_pressure
from minio_tpu_torch.s3 import admission
from tests.s3client import S3Client

PATHS = ["/", "/bucket", "/bucket/key", "/minio/admin", "/minio/admin/",
         "/minio/admin/v3/heal", "/minio/adminx", "/minio/health/live",
         "/minio/health/ready", "/minio/health/cluster",
         "/minio/healthfiles/x", "/minio/v2/metrics/cluster",
         "/minio/v2/metricsx", "/minio/v3/metrics", "/minio", ""]


@pytest.mark.parametrize("path", PATHS)
def test_path_class_matches_jax(path):
    assert admission.path_class(path) == jax_adm.path_class(path)
    pc = admission.path_class(path)
    assert admission.class_for(pc) == jax_adm.class_for(pc)


@pytest.mark.parametrize("text", ["", "10s", "500ms", "1m", "2h", "250us",
                                  "3", "1.5s", "junk", "  7S ", "-1s"])
def test_parse_duration_matches_jax(text):
    assert admission.parse_duration(text, 10.0) == \
        jax_adm.parse_duration(text, 10.0)


ENVS = [{}, {"MTPU_API_REQUESTS_MAX": "4"},
        {"MTPU_API_REQUESTS_MAX": "5", "MTPU_API_REQUESTS_DEADLINE": "100ms",
         "MTPU_API_ADMIN_REQUESTS_MAX": "3",
         "MTPU_API_REQUEST_TIMEOUT": "2s"},
        {"MTPU_API_REQUESTS_MAX": "x", "MTPU_API_REQUESTS_DEADLINE": "??"},
        {"MTPU_API_REQUESTS_MAX": "-2"}]


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("workers", [1, 2, 3, 4, 8])
def test_from_env_and_divided_match_jax(env, workers):
    p = admission.AdmissionController.from_env(env).divided(workers)
    j = jax_adm.AdmissionController.from_env(env).divided(workers)
    assert p.snapshot() == j.snapshot()


def _run_gate(mod, wait: float) -> list:
    """A fixed script of enters and leaves on a gate of 2 slots and a
    queue of 2: each decision and the snapshot after it."""
    ctl = mod.AdmissionController(max_requests=2, wait_deadline=wait)
    out = []

    def step(what, fn):
        try:
            fn()
            out.append((what, "ok"))
        except mod.AdmissionShed as e:
            out.append((what, e.klass, e.reason, e.retry_after))
        out.append(ctl.snapshot())

    step("enter", lambda: ctl.enter("s3"))
    step("enter", lambda: ctl.enter("s3"))
    waiters = []
    results = []
    for _ in range(2):             # two queue, admitted by the leaves
        def wait_in():
            try:
                ctl.enter("s3")
                results.append("admitted")
            except mod.AdmissionShed as e:
                results.append(e.reason)
        t = threading.Thread(target=wait_in)
        t.start()
        waiters.append(t)
    deadline = time.monotonic() + 10
    while ctl.gates["s3"].waiting < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    out.append(("waiting", ctl.gates["s3"].waiting))
    step("queue full", lambda: ctl.enter("s3"))
    step("admin", lambda: ctl.enter("admin"))
    step("leave", lambda: ctl.gates["s3"].leave())
    step("leave", lambda: ctl.gates["s3"].leave())
    for t in waiters:
        t.join(timeout=10)
    out.append(("waiters", sorted(results)))
    out.append(ctl.snapshot())
    # Both slots held by the admitted waiters: a lone request waits out
    # the deadline and is shed.
    step("deadline", lambda: ctl.enter("s3"))
    out.append(("pressure", admission_pressure(ctl)))
    return out


def test_gate_decisions_match_jax():
    assert _run_gate(admission, 0.2) == _run_gate(jax_adm, 0.2)
    out = _run_gate(admission, 0.2)
    assert ("queue full", "s3", "queue_full", 1) in out
    assert ("deadline", "s3", "deadline", 1) in out
    assert ("waiters", ["admitted", "admitted"]) in out


def test_unlimited_never_sheds():
    ctl = admission.AdmissionController()
    for _ in range(100):
        ctl.enter("s3")
    snap = ctl.snapshot()["s3"]
    assert snap["in_flight"] == 100 and snap["limit"] == 0
    assert not admission_pressure(admission.AdmissionController())


def test_shed_over_http(tmp_path, monkeypatch):
    """One slot, a queue of one, 50 ms: a request held in its slot, a
    second waits out the deadline and a third finds the queue full;
    both answer 503 SlowDown with Retry-After 1, while the health probe
    rides its own gate."""
    monkeypatch.setenv("MTPU_API_REQUESTS_MAX", "1")
    monkeypatch.setenv("MTPU_API_REQUESTS_DEADLINE", "50ms")
    srv = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                       "--scanner-interval", "0",
                       *[str(tmp_path / f"d{i}") for i in range(4)]])
    srv.start()
    release = threading.Event()
    held = threading.Event()
    orig = srv.objects.list_buckets

    def slow_list():
        held.set()
        release.wait(30)
        return orig()
    srv.objects.list_buckets = slow_list
    try:
        first = []
        t = threading.Thread(target=lambda: first.append(
            S3Client(srv.address).request("GET", "/")))
        t.start()
        assert held.wait(30)
        answers = []
        ts = [threading.Thread(target=lambda: answers.append(
            S3Client(srv.address).request("PUT", "/shedb", body=b"")))
            for _ in range(2)]
        for x in ts:
            x.start()
        for x in ts:
            x.join(30)
        st, _, _ = S3Client(srv.address).request(
            "GET", "/minio/health/live", sign=False)
        assert st == 200
        release.set()
        t.join(30)
        assert first[0][0] == 200
        assert [a[0] for a in answers] == [503, 503]
        for _, hdrs, body in answers:
            assert b"<Code>SlowDown</Code>" in body
            assert {k.lower(): v for k, v in hdrs.items()}[
                "retry-after"] == "1"
        snap = srv.admission.snapshot()["s3"]
        assert snap["shed_queue_full_total"] + \
            snap["shed_deadline_total"] == 2
        assert S3Client(srv.address).request("PUT", "/shedb")[0] == 200
    finally:
        release.set()
        srv.stop()

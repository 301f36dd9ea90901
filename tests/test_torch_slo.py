"""The port's SLO engine (minio_tpu_torch/utils/slo.py) held against the
JAX package's (minio_tpu/utils/slo.py): the cases of
tests/test_fleet_obs.py, each run on both engines with the same
observations and the same clock, with `evaluate()` and `snapshot()`
compared whole. Tolerance: none (the budget arithmetic is held to the
JAX engine's floats exactly).
"""

from __future__ import annotations

import json

import pytest

from minio_tpu.s3.metrics import Metrics as RefMetrics
from minio_tpu.utils.slo import SLOEngine as RefEngine

from minio_tpu_torch.s3.metrics import Metrics as PortMetrics
from minio_tpu_torch.utils.slo import SLOEngine as PortEngine


class _Pair:
    """The two engines of one spec on one clock; every call goes to both
    and their answers must be equal."""

    def __init__(self, spec, t0: float, metrics=False):
        self.t = [t0]
        self.engines = [cls(objectives=[spec], eval_s=5.0,
                            now=lambda: self.t[0])
                        for cls in (RefEngine, PortEngine)]
        self.metrics = (RefMetrics(), PortMetrics()) if metrics else None

    def observe(self, api, status, n=1):
        for _ in range(n):
            for eng in self.engines:
                eng.observe(api, status)

    def record(self, api, status, seconds, n=1):
        for _ in range(n):
            for m in self.metrics:
                m.record(api, status, seconds)

    def evaluate(self) -> dict:
        ms = self.metrics or (None, None)
        ref, port = (eng.evaluate(metrics=m)
                     for eng, m in zip(self.engines, ms))
        assert port == ref
        ref, port = (eng.snapshot(metrics=m)
                     for eng, m in zip(self.engines, ms))
        assert port == ref
        return port["objectives"][0]


def test_budget_arithmetic():
    p = _Pair({"name": "o", "match": ["GET:object"], "p99_ms": 0,
               "error_budget": 0.02, "window_s": 60}, 1000.0)
    p.observe("GET:object", 200, 98)
    p.observe("GET:object", 500, 2)
    p.observe("PUT:object", 500)            # no match: not counted
    o = p.evaluate()
    assert o["requests"] == 100 and o["errors"] == 2
    # Exactly at budget: burn 1.0, nothing left, warn (not yet burn).
    assert o["burn_rate"] == pytest.approx(1.0)
    assert o["budget_remaining"] == pytest.approx(0.0)
    assert o["verdict"] == "warn"
    p.observe("GET:object", 500)
    o = p.evaluate()
    assert o["burn_rate"] > 1.0 and o["verdict"] == "burn"
    assert o["budget_remaining"] == 0.0


def test_shed_rate_and_warn_thresholds():
    p = _Pair({"name": "o", "match": ["GET:*"], "p99_ms": 0,
               "error_budget": 0.5, "shed_ceiling": 0.10,
               "window_s": 60}, 2000.0)
    p.observe("GET:object", 200, 93)
    p.observe("GET:object", 503, 7)         # a shed is an error too
    o = p.evaluate()
    assert o["sheds"] == 7 and o["errors"] == 7
    assert o["shed_rate"] == pytest.approx(0.07)
    assert o["verdict"] == "warn"           # above half the ceiling
    p.observe("GET:object", 503, 5)
    o = p.evaluate()
    assert o["shed_rate"] > 0.10 and o["verdict"] == "burn"


def test_window_rollover():
    p = _Pair({"name": "o", "match": ["GET:object"], "p99_ms": 0,
               "error_budget": 0.5, "window_s": 10}, 5000.0)
    p.observe("GET:object", 500)
    assert p.evaluate()["requests"] == 1
    p.t[0] += 11.0                          # the window slid past it
    o = p.evaluate()
    assert o["requests"] == 0 and o["burn_rate"] == 0.0
    assert o["verdict"] == "pass"
    p.t[0] = 5010.0                         # the same slot, reused
    p.observe("GET:object", 200)
    o = p.evaluate()
    assert o["requests"] == 1 and o["errors"] == 0


@pytest.mark.parametrize("ceiling_ms, verdict", [(100, "burn"),
                                                 (5000, "pass")])
def test_p99_from_the_registry_windows(ceiling_ms, verdict, monkeypatch):
    import time
    monkeypatch.setattr(time, "time", lambda: 3000.5)
    p = _Pair({"name": "o", "match": ["GET:object"], "p99_ms": ceiling_ms,
               "error_budget": 0.5, "window_s": 60}, 3000.0, metrics=True)
    p.record("GET:object", 200, 0.400, 50)
    p.observe("GET:object", 200)
    o = p.evaluate()
    assert o["p99_s"] >= 0.4 and o["p99_ceiling_s"] == ceiling_ms / 1000
    assert o["verdict"] == verdict


@pytest.mark.parametrize("value, names", [
    ("off", None),
    (json.dumps([{"name": "mine", "match": ["GET:object"],
                  "error_budget": 0.1}]), ["mine"]),
    ("{not json", ["get-availability", "put-availability"]),
    ("", ["get-availability", "put-availability"]),
])
def test_from_env(value, names, monkeypatch):
    monkeypatch.setenv("MTPU_SLO", value)
    ref, port = RefEngine.from_env(), PortEngine.from_env()
    if names is None:
        assert ref is None and port is None
        return
    assert [o.name for o in port.objectives] == \
        [o.name for o in ref.objectives] == names
    ref_snap, port_snap = ref.snapshot(), port.snapshot()
    ref_snap.pop("time", None)
    port_snap.pop("time", None)
    assert port_snap == ref_snap
    assert port_snap["verdict"] == "pass"
    for o in port_snap["objectives"]:
        assert set(o) >= {"burn_rate", "budget_remaining", "verdict",
                          "requests", "p99_s"}


def test_from_env_file(tmp_path, monkeypatch):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps([{"name": "f", "match": ["PUT:*"],
                                 "error_budget": 0.01, "p99_ms": 250}]))
    monkeypatch.setenv("MTPU_SLO", f"@{path}")
    ref, port = RefEngine.from_env(), PortEngine.from_env()
    assert [vars_of(o) for o in port.objectives] == \
        [vars_of(o) for o in ref.objectives]


def vars_of(o) -> dict:
    return {k: getattr(o, k) for k in o.__slots__ if k != "ring"}

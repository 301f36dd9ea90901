"""Continuous SLO engine: declared objectives evaluated against the
live rolling windows.

The port's copy of minio_tpu/utils/slo.py. Operators declare
objectives a class of API: a p99 latency ceiling, an error budget (the
fraction of requests allowed to fail), a shed-rate ceiling; the engine
evaluates them against the per-second structures the metrics layer
keeps (utils/latency.LastMinute for p99, its own per-second counter
rings for error and shed rates). Each objective exports a burn rate
(the observed error rate over the declared budget: 1.0 burns exactly
the budget, sustained), the budget left, and a pass/warn/burn verdict:
the SRE workbook's burn-rate alerting, reduced to the one rolling
window the server keeps.

Declaration (env `MTPU_SLO`): inline JSON, `@/path/to/file.json`, or
`off` to disable. The JSON is a list of objectives:

    [{"name": "get-availability",
      "match": ["GET:object", "HEAD:object"],
      "p99_ms": 1000, "error_budget": 0.01,
      "shed_ceiling": 0.05, "window_s": 3600}]

`match` lists API labels (method:scope, the metrics layer's request
labels); a trailing "*" matches by prefix. Unset fields take the
defaults above. With no declaration the two DEFAULTS below (GET and
PUT availability) apply, so every deployment carries evaluated
objectives out of the box.

Environment:
  MTPU_SLO         objective declarations (JSON / @file / off)
  MTPU_SLO_EVAL_S  background evaluation period seconds (default 5)
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from minio_tpu_torch.utils.latency import LastMinute, summarize

DEFAULTS = [
    {"name": "get-availability",
     "match": ["GET:object", "HEAD:object"],
     "p99_ms": 1000.0, "error_budget": 0.01, "shed_ceiling": 0.05,
     "window_s": 3600},
    {"name": "put-availability",
     "match": ["PUT:object", "POST:object"],
     "p99_ms": 2000.0, "error_budget": 0.01, "shed_ceiling": 0.05,
     "window_s": 3600},
]

# Verdict thresholds: "warn" fires at half the burn ceiling (or 80% of
# the latency ceiling) so the operator sees the trend before the
# budget is gone.
_WARN_BURN = 0.5
_WARN_P99 = 0.8


class _SecondRing:
    """Per-second (total, error, shed) counters over a fixed window.

    O(1) observe: one slot per wall second, lazily reset on reuse —
    the rollover arithmetic the unit tests pin down. Sums walk the
    ring (bounded by window_s, done on the eval tick, never the
    request path)."""

    __slots__ = ("size", "stamp", "total", "err", "shed", "_mu")

    def __init__(self, window_s: int):
        self.size = max(1, int(window_s))
        self.stamp = [0] * self.size
        self.total = [0] * self.size
        self.err = [0] * self.size
        self.shed = [0] * self.size
        self._mu = threading.Lock()

    def observe(self, sec: int, error: bool, shed: bool) -> None:
        i = sec % self.size
        with self._mu:
            if self.stamp[i] != sec:
                self.stamp[i] = sec
                self.total[i] = self.err[i] = self.shed[i] = 0
            self.total[i] += 1
            if error:
                self.err[i] += 1
            if shed:
                self.shed[i] += 1

    def sums(self, now_sec: int) -> tuple:
        """(total, errors, sheds) across slots still inside the
        window ending at `now_sec`."""
        lo = now_sec - self.size
        t = e = s = 0
        with self._mu:
            for i in range(self.size):
                if lo < self.stamp[i] <= now_sec:
                    t += self.total[i]
                    e += self.err[i]
                    s += self.shed[i]
        return t, e, s


class Objective:
    __slots__ = ("name", "match", "p99_ms", "error_budget",
                 "shed_ceiling", "window_s", "ring")

    def __init__(self, spec: dict):
        self.name = str(spec.get("name") or "objective")
        self.match = [str(m) for m in spec.get("match") or []]
        self.p99_ms = float(spec.get("p99_ms", 1000.0))
        self.error_budget = max(1e-9,
                                float(spec.get("error_budget", 0.01)))
        self.shed_ceiling = float(spec.get("shed_ceiling", 0.05))
        self.window_s = int(spec.get("window_s", 3600))
        self.ring = _SecondRing(self.window_s)

    def matches(self, api: str) -> bool:
        for m in self.match:
            if m.endswith("*"):
                if api.startswith(m[:-1]):
                    return True
            elif api == m:
                return True
        return False


class SLOEngine:
    """Holds the declared objectives, ingests request outcomes, and
    evaluates verdicts continuously (background thread) or lazily on
    snapshot(). `now` is injectable for the unit tests."""

    def __init__(self, objectives: Optional[list] = None,
                 eval_s: Optional[float] = None, now=time.time):
        specs = DEFAULTS if objectives is None else objectives
        self.objectives = [Objective(dict(s)) for s in specs]
        self.eval_s = float(eval_s if eval_s is not None
                            else _env_float("MTPU_SLO_EVAL_S", 5.0))
        self._now = now
        self._mu = threading.Lock()
        self._last_eval: list = []
        self._last_eval_t = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- configuration ---------------------------------------------------

    @classmethod
    def from_env(cls) -> Optional["SLOEngine"]:
        raw = (os.environ.get("MTPU_SLO", "") or "").strip()
        if raw.lower() in ("off", "0", "false", "no"):
            return None
        specs = None
        if raw:
            try:
                if raw.startswith("@"):
                    with open(raw[1:], encoding="utf-8") as fh:
                        specs = json.load(fh)
                else:
                    specs = json.loads(raw)
            except (OSError, ValueError):
                specs = None    # malformed declaration: defaults apply
        return cls(objectives=specs)

    # -- ingestion (request path) ----------------------------------------

    def observe(self, api: str, status: int) -> None:
        """One finished request. Errors are 5xx; 503 is the admission
        shed signal (it counts as both)."""
        error = status >= 500
        shed = status == 503
        sec = int(self._now())
        for obj in self.objectives:
            if obj.matches(api):
                obj.ring.observe(sec, error, shed)

    # -- evaluation ------------------------------------------------------

    def _p99_s(self, obj: Objective, metrics) -> float:
        """Observed p99 (seconds) over the metric layer's last-minute
        windows of the objective's matching APIs, merged."""
        if metrics is None:
            return 0.0
        try:
            with metrics._mu:
                wins = [lm.window()
                        for api, lm in metrics._last_minute.items()
                        if obj.matches(api)]
        except AttributeError:
            return 0.0
        if not wins:
            return 0.0
        return float(summarize(LastMinute.merge(wins)).get("p99", 0.0))

    def evaluate(self, metrics=None) -> list:
        """One evaluation pass: per-objective burn rate, remaining
        budget, shed rate, p99, verdict."""
        now_sec = int(self._now())
        out = []
        for obj in self.objectives:
            total, errors, sheds = obj.ring.sums(now_sec)
            error_rate = errors / total if total else 0.0
            shed_rate = sheds / total if total else 0.0
            burn = error_rate / obj.error_budget
            budget_remaining = max(0.0, 1.0 - burn)
            p99_s = self._p99_s(obj, metrics)
            p99_ceiling_s = obj.p99_ms / 1000.0
            verdict = "pass"
            if burn > 1.0 or (p99_s > p99_ceiling_s > 0) \
                    or shed_rate > obj.shed_ceiling:
                verdict = "burn"
            elif burn > _WARN_BURN \
                    or (p99_ceiling_s > 0
                        and p99_s > _WARN_P99 * p99_ceiling_s) \
                    or shed_rate > _WARN_BURN * obj.shed_ceiling:
                verdict = "warn"
            out.append({
                "name": obj.name,
                "match": list(obj.match),
                "window_s": obj.window_s,
                "requests": total,
                "errors": errors,
                "sheds": sheds,
                "error_rate": round(error_rate, 6),
                "shed_rate": round(shed_rate, 6),
                "burn_rate": round(burn, 4),
                "budget_remaining": round(budget_remaining, 4),
                "p99_s": round(p99_s, 6),
                "p99_ceiling_s": p99_ceiling_s,
                "verdict": verdict,
            })
        with self._mu:
            self._last_eval = out
            self._last_eval_t = self._now()
        return out

    def snapshot(self, metrics=None) -> dict:
        """The admin-info / Prometheus view: the last evaluation,
        refreshed in-line when stale (covers deployments where the
        background thread was never started — tests, bench)."""
        with self._mu:
            fresh = self._last_eval \
                and self._now() - self._last_eval_t < 2 * self.eval_s
            objs = list(self._last_eval)
        if not fresh:
            objs = self.evaluate(metrics=metrics)
        worst = "pass"
        for o in objs:
            if o["verdict"] == "burn":
                worst = "burn"
                break
            if o["verdict"] == "warn":
                worst = "warn"
        return {"objectives": objs, "verdict": worst,
                "eval_s": self.eval_s}

    # -- background evaluation -------------------------------------------

    def start(self, metrics=None) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.eval_s):
                try:
                    self.evaluate(metrics=metrics)
                except Exception:  # noqa: BLE001 - eval must survive
                    pass

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="slo-eval")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)


def _env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except ValueError:
        return default

"""API admission control: bounded in-flight requests with load shedding.

The port of minio_tpu/s3/admission.py (reference maxClients,
cmd/generic-handlers.go + cmd/handler-api.go apiConfig: requests_max /
requests_deadline): at most N API requests run concurrently; excess
requests wait in a BOUNDED queue for a slot and are shed with
503 SlowDown + Retry-After when the queue is full or the wait deadline
passes. Request classes get independent gates so admin/health traffic
is never starved behind saturating data traffic. In a pre-forked fleet
(io/workers.py) each worker holds `divided(n)` of the budgets.

Environment (the JAX package's names and defaults):
  MTPU_API_REQUESTS_MAX       max in-flight data-path requests
                              (0 = unlimited, the default)
  MTPU_API_REQUESTS_DEADLINE  max time a request may wait for a slot
                              (duration: "10s", "500ms", "1m"; default 10s)
  MTPU_API_ADMIN_REQUESTS_MAX independent cap for the admin/health class
                              (0 = unlimited, the default)
  MTPU_API_REQUEST_TIMEOUT    per-request deadline budget granted at
                              admission and propagated through the stack
                              (utils/deadline.py); 0 = no budget (default)
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional

# Shed reasons (label values on the shed counter).
QUEUE_FULL = "queue_full"
DEADLINE = "deadline"

# Request classes.
CLASS_S3 = "s3"
CLASS_ADMIN = "admin"

# The operator health endpoints, enumerated ONCE: the router, the
# metrics labeler, and the admission classifier all consult this — a
# new health endpoint added here is automatically exempt from data-
# path gating and labeled correctly.
HEALTH_PATHS = ("/minio/health/live", "/minio/health/ready")


def path_class(raw_path: str) -> str:
    """'admin' | 'health' | 'metrics' | 's3' — the single source of
    truth for operator-endpoint path patterns, matching the router's
    dispatch exactly. A path the router serves as ordinary S3 data
    (e.g. a bucket named "minio" with key "healthfiles/x") must
    classify as 's3'."""
    if raw_path == "/minio/admin" or raw_path.startswith("/minio/admin/"):
        return "admin"
    if raw_path in HEALTH_PATHS:
        return "health"
    if raw_path.startswith("/minio/v2/metrics"):
        return "metrics"
    return CLASS_S3


def class_for(pc: str) -> str:
    """Gate class for an already-computed path_class — the serve hot
    loop classifies each request's path ONCE and shares the result
    between admission, routing, and metrics labeling."""
    return CLASS_ADMIN if pc != CLASS_S3 else CLASS_S3


class AdmissionShed(Exception):
    """Request shed by admission control -> 503 SlowDown + Retry-After."""

    def __init__(self, klass: str, reason: str, retry_after: int):
        self.klass = klass
        self.reason = reason
        self.retry_after = retry_after
        super().__init__(f"{klass} request shed ({reason})")


def parse_duration(text: str, default: float) -> float:
    """Parse "10s" / "500ms" / "1m" / bare seconds; fall back on junk
    (a typo in an env var must not take the server down)."""
    t = (text or "").strip().lower()
    if not t:
        return default
    mult = 1.0
    for suffix, m in (("ms", 1e-3), ("us", 1e-6), ("s", 1.0), ("m", 60.0),
                      ("h", 3600.0)):
        if t.endswith(suffix):
            t, mult = t[:-len(suffix)], m
            break
    try:
        return float(t) * mult
    except ValueError:
        return default


class _Gate:
    """One request class: a semaphore of `limit` slots plus a bounded
    wait queue of `queue_limit` (overflow sheds immediately, a queued
    wait sheds at the deadline). limit=0 disables gating entirely."""

    def __init__(self, name: str, limit: int, wait_deadline: float,
                 queue_limit: Optional[int] = None):
        self.name = name
        self.limit = max(0, limit)
        self.wait_deadline = max(0.0, wait_deadline)
        # Queue bound defaults to the slot count: at saturation at most
        # 2*limit requests occupy threads (running + queued); the rest
        # shed instantly instead of accumulating unbounded waiters.
        self.queue_limit = self.limit if queue_limit is None \
            else max(0, queue_limit)
        self._sem = threading.Semaphore(self.limit) if self.limit else None
        self._mu = threading.Lock()
        self.in_flight = 0
        self.waiting = 0
        self.peak_in_flight = 0
        self.admitted_total = 0
        self.shed_total: dict[str, int] = {QUEUE_FULL: 0, DEADLINE: 0}

    def _shed(self, reason: str) -> None:
        with self._mu:
            self.shed_total[reason] += 1
        raise AdmissionShed(self.name, reason, self.retry_after())

    def retry_after(self) -> int:
        """Advisory Retry-After: the wait deadline rounded up — a
        client retrying sooner would likely just queue again."""
        return max(1, int(math.ceil(self.wait_deadline)))

    def _admitted(self) -> None:
        with self._mu:
            self.in_flight += 1
            self.peak_in_flight = max(self.peak_in_flight, self.in_flight)
            self.admitted_total += 1

    def enter(self) -> None:
        if self._sem is None:
            self._admitted()
            return
        # Fast path: a free slot admits without ever touching the
        # queue (and without racing the in_flight bookkeeping).
        if self._sem.acquire(blocking=False):
            self._admitted()
            return
        with self._mu:
            if self.waiting >= self.queue_limit:
                # Counter bumped inline (we hold the lock already).
                self.shed_total[QUEUE_FULL] += 1
                raise AdmissionShed(self.name, QUEUE_FULL,
                                    self.retry_after())
            self.waiting += 1
        try:
            ok = self._sem.acquire(timeout=self.wait_deadline)
        finally:
            with self._mu:
                self.waiting -= 1
        if not ok:
            self._shed(DEADLINE)
        self._admitted()

    def leave(self) -> None:
        with self._mu:
            self.in_flight -= 1
        if self._sem is not None:
            self._sem.release()

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "limit": self.limit,
                "queue_limit": self.queue_limit,
                "wait_deadline_seconds": self.wait_deadline,
                "in_flight": self.in_flight,
                "waiting": self.waiting,
                "peak_in_flight": self.peak_in_flight,
                "admitted_total": self.admitted_total,
                "shed_queue_full_total": self.shed_total[QUEUE_FULL],
                "shed_deadline_total": self.shed_total[DEADLINE],
            }


class AdmissionController:
    """Per-class gates plus the per-request deadline budget config."""

    def __init__(self, max_requests: int = 0, wait_deadline: float = 10.0,
                 admin_max_requests: int = 0,
                 request_timeout: float = 0.0):
        self.gates = {
            CLASS_S3: _Gate(CLASS_S3, max_requests, wait_deadline),
            CLASS_ADMIN: _Gate(CLASS_ADMIN, admin_max_requests,
                               wait_deadline),
        }
        # Seconds granted to each admitted request as its deadline
        # budget (utils/deadline.py); 0 = requests get no budget.
        self.request_timeout = max(0.0, request_timeout)
        self._mu = threading.Lock()
        self.deadline_exceeded_total = 0

    @classmethod
    def from_env(cls, env=os.environ) -> "AdmissionController":
        def intenv(key):
            try:
                return int(env.get(key, "0") or 0)
            except ValueError:
                return 0
        return cls(
            max_requests=intenv("MTPU_API_REQUESTS_MAX"),
            wait_deadline=parse_duration(
                env.get("MTPU_API_REQUESTS_DEADLINE", ""), 10.0),
            admin_max_requests=intenv("MTPU_API_ADMIN_REQUESTS_MAX"),
            request_timeout=parse_duration(
                env.get("MTPU_API_REQUEST_TIMEOUT", ""), 0.0),
        )

    def divided(self, workers: int) -> "AdmissionController":
        """This controller's budgets split across `workers` pre-forked
        processes (io/workers.py): per-worker limit = ceil(limit / n),
        so the fleet-wide in-flight bound stays what the operator
        configured (within rounding). 0 (unlimited) stays 0; the
        per-request deadline budget is per request, not per fleet, and
        passes through unchanged."""
        if workers <= 1:
            return self
        def split(limit: int) -> int:
            return math.ceil(limit / workers) if limit > 0 else 0
        s3 = self.gates[CLASS_S3]
        admin = self.gates[CLASS_ADMIN]
        return AdmissionController(
            max_requests=split(s3.limit),
            wait_deadline=s3.wait_deadline,
            admin_max_requests=split(admin.limit),
            request_timeout=self.request_timeout)

    def classify(self, raw_path: str) -> str:
        """Admin, health, and metrics endpoints ride the admin gate —
        an operator diagnosing an overloaded server must not queue
        behind the very traffic that overloaded it (path_class is the
        single shared pattern source, so router and gate cannot
        drift)."""
        return class_for(path_class(raw_path))

    def enter(self, klass: str) -> _Gate:
        """Admit or raise AdmissionShed; caller must leave() the
        returned gate when the request finishes."""
        gate = self.gates[klass]
        gate.enter()
        return gate

    def record_deadline_exceeded(self) -> None:
        with self._mu:
            self.deadline_exceeded_total += 1

    def snapshot(self) -> dict:
        out = {name: g.snapshot() for name, g in self.gates.items()}
        out["request_timeout_seconds"] = self.request_timeout
        with self._mu:
            out["deadline_exceeded_total"] = self.deadline_exceeded_total
        return out

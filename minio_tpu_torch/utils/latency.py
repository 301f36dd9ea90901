"""Bucketed latency histograms.

The histogram of minio_tpu/utils/latency.py: every observation lands in
a fixed-boundary histogram (Prometheus `_bucket{le=}` shape), a few ints
under one short lock per observe. Snapshots are plain JSON-safe dicts
that merge across instances; `summarize` reads p50/p99 off one.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

# Prometheus-style cumulative upper bounds, seconds. The +Inf bucket is
# implicit (== count).
BUCKETS: tuple = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                  0.5, 1.0, 2.5, 5.0, 10.0)


def _bucket_index(seconds: float) -> int:
    for i, ub in enumerate(BUCKETS):
        if seconds <= ub:
            return i
    return len(BUCKETS)


class Histogram:
    """Fixed-boundary latency histogram."""

    __slots__ = ("_mu", "counts", "sum", "count")

    def __init__(self):
        self._mu = threading.Lock()
        self.counts = [0] * (len(BUCKETS) + 1)   # last = overflow (+Inf)
        self.sum = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        i = _bucket_index(seconds)
        with self._mu:
            self.counts[i] += 1
            self.sum += seconds
            self.count += 1

    def state(self) -> dict:
        with self._mu:
            return {"counts": list(self.counts),
                    "sum": round(self.sum, 6), "count": self.count}

    @staticmethod
    def merge(states: Sequence[dict]) -> dict:
        counts = [0] * (len(BUCKETS) + 1)
        total_sum, total_count = 0.0, 0
        for st in states:
            for i, c in enumerate(st.get("counts", [])[:len(counts)]):
                counts[i] += c
            total_sum += st.get("sum", 0.0)
            total_count += st.get("count", 0)
        return {"counts": counts, "sum": round(total_sum, 6),
                "count": total_count}


def percentile(counts: Sequence[int], total: int, q: float,
               overflow: Optional[float] = None) -> float:
    """Upper-bound estimate of the q-quantile (0..1) from bucket counts:
    the bucket's upper edge (histogram_quantile's shape). Quantiles in
    the +Inf bucket report `overflow`. 0.0 on an empty window."""
    if total <= 0:
        return 0.0
    if overflow is None:
        overflow = BUCKETS[-1] * 2
    rank = max(1, int(total * q + 0.999999))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            return BUCKETS[i] if i < len(BUCKETS) else overflow
    return overflow


def summarize(window: dict) -> dict:
    """{count, p50, p99, max} of a histogram state (seconds; a state
    without "max" reports a quantile past the last edge as 2x that
    edge)."""
    counts = window.get("counts", [])
    total = window.get("count", 0)
    mx = window.get("max", 0.0)
    ov = mx if mx > BUCKETS[-1] else None
    return {
        "count": total,
        "p50": round(percentile(counts, total, 0.50, overflow=ov), 6),
        "p99": round(percentile(counts, total, 0.99, overflow=ov), 6),
        "max": round(mx, 6),
    }

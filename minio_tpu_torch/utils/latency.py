"""Bucketed latency histograms and rolling last-minute windows.

The port's copy of minio_tpu/utils/latency.py (the reference's
metrics-v3 histograms and its per-drive last-minute tracking,
cmd/last-minute.gen.go): every observation lands in a fixed-boundary
histogram (Prometheus `_bucket{le=}` shape) and, where a series wants
it, in a 60-slot one-second ring whose merged view answers "p50/p99/max
over the LAST minute", which a sum/count pair cannot (a counter never
forgets the past; the ring does, by design).

Both are a few ints under one short lock per observe. Snapshots are
plain JSON-safe dicts, so pre-forked workers ship them over the control
pipe and any worker merges the fleet's view; `summarize` reads
p50/p99 off one.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

# Prometheus-style cumulative upper bounds, seconds. The +Inf bucket is
# implicit (== count).
BUCKETS: tuple = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                  0.5, 1.0, 2.5, 5.0, 10.0)

_SLOTS = 60


class Histogram:
    """Fixed-boundary latency histogram (cumulative on render)."""

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

    @staticmethod
    def cumulative(state: dict) -> list[tuple[str, int]]:
        """[(le_label, cumulative_count)] including +Inf — the
        Prometheus exposition shape."""
        out = []
        acc = 0
        counts = state.get("counts", [])
        for i, ub in enumerate(BUCKETS):
            acc += counts[i] if i < len(counts) else 0
            out.append((_le(ub), acc))
        acc += counts[len(BUCKETS)] if len(counts) > len(BUCKETS) else 0
        out.append(("+Inf", acc))
        return out


def _bucket_index(seconds: float) -> int:
    for i, ub in enumerate(BUCKETS):
        if seconds <= ub:
            return i
    return len(BUCKETS)


def _le(ub: float) -> str:
    return f"{ub:g}"


class LastMinute:
    """60 one-second slots of (count, max, per-bucket counts); merged
    on read into the trailing-minute window. Stale slots (older than
    60 s) are zeroed lazily on the write path, so an idle series decays
    to empty without a sweeper thread."""

    __slots__ = ("_mu", "_slots")

    def __init__(self):
        self._mu = threading.Lock()
        # slot: [epoch_second, count, max_seconds, bucket_counts]
        self._slots = [[0, 0, 0.0, None] for _ in range(_SLOTS)]

    def observe(self, seconds: float, now: Optional[float] = None) -> None:
        sec = int(now if now is not None else time.time())
        slot = self._slots[sec % _SLOTS]
        i = _bucket_index(seconds)
        with self._mu:
            if slot[0] != sec:
                slot[0] = sec
                slot[1] = 0
                slot[2] = 0.0
                slot[3] = [0] * (len(BUCKETS) + 1)
            slot[1] += 1
            if seconds > slot[2]:
                slot[2] = seconds
            slot[3][i] += 1

    def window(self, now: Optional[float] = None) -> dict:
        """The merged trailing-minute view: {count, max, counts}."""
        cutoff = int(now if now is not None else time.time()) - _SLOTS
        counts = [0] * (len(BUCKETS) + 1)
        total, mx = 0, 0.0
        with self._mu:
            for slot in self._slots:
                if slot[0] <= cutoff or slot[3] is None:
                    continue
                total += slot[1]
                if slot[2] > mx:
                    mx = slot[2]
                for i, c in enumerate(slot[3]):
                    counts[i] += c
        return {"count": total, "max": round(mx, 6), "counts": counts}

    def stats(self, now: Optional[float] = None) -> dict:
        """{count, p50, p99, max} over the last minute (seconds)."""
        return summarize(self.window(now))

    @staticmethod
    def merge(windows: Sequence[dict]) -> dict:
        counts = [0] * (len(BUCKETS) + 1)
        total, mx = 0, 0.0
        for w in windows:
            total += w.get("count", 0)
            mx = max(mx, w.get("max", 0.0))
            for i, c in enumerate(w.get("counts", [])[:len(counts)]):
                counts[i] += c
        return {"count": total, "max": round(mx, 6), "counts": counts}


def percentile(counts: Sequence[int], total: int, q: float,
               overflow: Optional[float] = None) -> float:
    """Upper-bound estimate of the q-quantile (0..1) from bucket
    counts — the bucket's upper edge, the standard histogram_quantile
    shape. Quantiles landing in the +Inf bucket report `overflow`
    (callers pass the window's tracked max so a 60 s stall reads as
    60 s, not a silent cap). Returns 0.0 on an empty window."""
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
    counts = window.get("counts", [])
    total = window.get("count", 0)
    mx = window.get("max", 0.0)
    # Overflow-bucket quantiles report the observed max: anything past
    # the last bucket edge IS at least that slow, and the true worst
    # case is already tracked.
    ov = mx if mx > BUCKETS[-1] else None
    return {
        "count": total,
        "p50": round(percentile(counts, total, 0.50, overflow=ov), 6),
        "p99": round(percentile(counts, total, 0.99, overflow=ov), 6),
        "max": round(mx, 6),
    }

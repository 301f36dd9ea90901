"""Hot-object read tier: frequency-admitted whole-object RAM cache.

The port of minio_tpu/object/hotcache.py. A small hot set hit by many
clients should be served from memory, not by fanning every GET across
the erasure shards and a journal read. This module pins hot plaintext
objects as contiguous buffers, served from the handler GET path
(s3/server.py `_get_object`) without touching the object layer.

Admission is tinyLFU-style (Einziger & Friedman, "TinyLFU: A Highly
Efficient Cache Admission Policy"): a count-min frequency sketch with
4-bit-capped counters and periodic halving estimates each key's recent
popularity; a doorkeeper bloom filter absorbs the first access so
one-hit-wonder scans never increment the sketch. A candidate is
admitted only when the cache has free room or its estimated frequency
beats the eviction victim's. Residency is a segmented LRU
(probation/protected): new admits land in probation, a second hit
promotes to protected, eviction drains probation first.

Coherence rides the funnel object/fi_cache.py uses:

- every namespace mutation goes through ``metacache.bump``; the set's
  bucket listener (``attach_layer``) drops the bucket synchronously,
  before the mutation acks;
- the token protocol (``token()`` before the read fan-out, checked in
  ``put()``) makes inserts race-free against concurrent mutations;
- pre-forked workers observe the shared ``list.gen`` bump file (their
  own SharedGen instance: ``changed()`` is stateful per observer) and
  flush wholesale when a sibling worker mutated anything;
- a layer with a set whose fileinfo-cache ``remote_gate`` is shut (a
  set with a drive on another node) turns the cache off at
  ``attach_layer``: no invalidation from another node reaches it, and
  without the cross-node coherence protocol that gate never reopens.

Each entry also keeps the response head its admitting GET sent, split
around its Date value (``split_head``), so that a hit can be replayed
with only the Date re-stamped (``date_bytes``); the handler path builds
its head from the cached ObjectInfo, as the JAX package's does, and the
replay waits for the event loop's short circuit.

Kill switch: ``MTPU_HOT_CACHE=off`` (or 0/false). Knobs, with the JAX
package's defaults: ``MTPU_HOT_CACHE_MAX`` (entries, 1024),
``MTPU_HOT_CACHE_BYTES`` (resident bytes, 256 MiB),
``MTPU_HOT_CACHE_OBJ_MAX`` (one object, 8 MiB).
"""
from __future__ import annotations

import email.utils
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from minio_tpu_torch.object.fi_cache import cache_enabled, gate_open
from minio_tpu_torch.object.pools import layer_sets


def _env_int(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# Date splice: a captured head replays with only the Date value
# re-stamped. http.server's send_response writes Date via
# email.utils.formatdate (usegmt), so ours uses the same function.

_DATE_RE = re.compile(rb"\r\nDate: [^\r\n]*\r\n")
_date_cached: tuple[int, bytes] = (0, b"")


def date_bytes() -> bytes:
    """Current RFC 1123 date, encoded, cached per wall-clock second."""
    global _date_cached
    now = time.time()
    sec = int(now)
    cached = _date_cached
    if cached[0] == sec:
        return cached[1]
    d = email.utils.formatdate(now, usegmt=True).encode("ascii")
    _date_cached = (sec, d)
    return d


def split_head(head: bytes) -> Optional[tuple[bytes, bytes]]:
    """(prefix ending with b"Date: ", suffix from the date line's
    \\r\\n) of captured response-head bytes, or None without a Date."""
    m = _DATE_RE.search(head)
    if m is None:
        return None
    return head[:m.start()] + b"\r\nDate: ", head[m.end() - 2:]


# ---------------------------------------------------------------------------
# TinyLFU admission filter.

class FrequencySketch:
    """Count-min sketch with 4-bit-capped counters, a doorkeeper bloom
    filter in front, and periodic halving (aging) so the estimate
    tracks *recent* frequency. Keys hash with Python's hash(), which
    PYTHONHASHSEED salts per process."""

    ROWS = 4
    CAP = 15  # 4-bit counters, stored one per byte for simplicity

    def __init__(self, max_entries: int):
        width = 64
        while width < 4 * max(16, max_entries):
            width <<= 1
        self._width = width
        self._mask = width - 1
        self._rows = [bytearray(width) for _ in range(self.ROWS)]
        self._door = bytearray(width // 8)
        # Aging: after a sample window of increments, halve everything
        # and reset the doorkeeper so stale popularity decays.
        self._sample = 10 * max(16, max_entries)
        self._increments = 0
        self._seed = id(self) & 0xFFFF

    def _index(self, row: int, key: str) -> int:
        return hash((self._seed, row, key)) & self._mask

    def _door_probe(self, key: str) -> tuple[int, int, int, int]:
        h = hash((self._seed, -1, key))
        a = h & self._mask
        b = (h >> 17) & self._mask
        return a >> 3, 1 << (a & 7), b >> 3, 1 << (b & 7)

    def _door_has(self, key: str) -> bool:
        i1, m1, i2, m2 = self._door_probe(key)
        return bool(self._door[i1] & m1) and bool(self._door[i2] & m2)

    def record(self, key: str) -> None:
        """Count one occurrence of key (access or candidacy)."""
        if not self._door_has(key):
            i1, m1, i2, m2 = self._door_probe(key)
            self._door[i1] |= m1
            self._door[i2] |= m2
            return
        for row in range(self.ROWS):
            r = self._rows[row]
            i = self._index(row, key)
            if r[i] < self.CAP:
                r[i] += 1
        self._increments += 1
        if self._increments >= self._sample:
            self._age()

    def estimate(self, key: str) -> int:
        est = min(self._rows[row][self._index(row, key)]
                  for row in range(self.ROWS))
        if self._door_has(key):
            est += 1
        return est

    def _age(self) -> None:
        for r in self._rows:
            for i in range(self._width):
                r[i] >>= 1
        self._door = bytearray(self._width // 8)
        self._increments //= 2


class _Entry:
    __slots__ = ("info", "body", "head_prefix", "head_suffix", "nbytes")

    def __init__(self, info: Any, body: bytes):
        self.info = info
        self.body = body
        # Captured response-head template (split around Date), None
        # until a plain whole-object GET's head is captured.
        self.head_prefix: Optional[bytes] = None
        self.head_suffix: Optional[bytes] = None
        self.nbytes = len(body)


class HotObjectCache:
    """Per-process whole-object read cache with tinyLFU admission.

    Thread-safe; every public method takes the internal lock. An entry
    holds the served plaintext body (immutable bytes), the ObjectInfo
    it was served with and, once captured, its response-head
    template."""

    def __init__(self) -> None:
        self.enabled = cache_enabled("MTPU_HOT_CACHE")
        self.max_entries = max(1, _env_int("MTPU_HOT_CACHE_MAX", 1024))
        self.max_bytes = max(1, _env_int("MTPU_HOT_CACHE_BYTES",
                                         256 * 1024 * 1024))
        self.obj_max = max(1, _env_int("MTPU_HOT_CACHE_OBJ_MAX",
                                       8 * 1024 * 1024))
        self._mu = threading.Lock()
        # Segmented LRU: MRU at the OrderedDict tail. Keys: (bucket, key).
        self._probation: "OrderedDict[tuple[str, str], _Entry]" = \
            OrderedDict()
        self._protected: "OrderedDict[tuple[str, str], _Entry]" = \
            OrderedDict()
        self._protected_cap = max(1, (self.max_entries * 4) // 5)
        self._bytes = 0
        self._sketch = FrequencySketch(self.max_entries)
        # Token protocol (fi_cache's): per-bucket generation, bumped by
        # invalidation; put() refuses when it moved since token().
        self._gens: dict[str, int] = {}
        # Pre-forked workers: an observer of the fleet's list.gen bump
        # file (io/workers.WorkerContext.attach wires one of our own).
        self.shared_gen: Optional[Any] = None
        self.hits = 0
        self.misses = 0
        self.admits = 0
        self.rejects = 0
        self.evictions = 0
        self.invalidations = 0

    def attach_layer(self, layer: Any) -> None:
        """Front the given object layer: subscribe to the metacache bump
        funnel of every set of every pool, so every mutation of a bucket
        (a pool migration's included) drops its entries. A set whose
        remote gate is shut turns the cache off: it could serve no entry
        (minio_tpu/object/hotcache.py reads the same gate at each
        lookup), so no GET copies a body into it."""
        sets = layer_sets(layer)
        for s in sets:
            s.metacache.listeners.append(self.invalidate_bucket)
        if not all(gate_open(s.fi_cache.remote_gate) for s in sets):
            self.enabled = False

    def maybe_flush(self) -> None:
        """Flush wholesale when a sibling worker process bumped the
        shared generation (any mutation anywhere in the fleet)."""
        sg = self.shared_gen
        if sg is not None:
            try:
                if sg.changed():
                    self.invalidate_all()
            except OSError:          # an unreadable observer flushes
                self.invalidate_all()

    def token(self, bucket: str) -> int:
        """Current generation for bucket; take BEFORE the read fan-out
        and hand to put()."""
        self.maybe_flush()
        with self._mu:
            return self._gens.setdefault(bucket, 0)

    # -- lookups --------------------------------------------------------

    def get(self, bucket: str, object_: str) -> Optional[_Entry]:
        """Resident entry for (bucket, object) or None. Counts the
        access in the admission sketch either way; a probation hit
        promotes to protected."""
        if not self.enabled:
            return None
        self.maybe_flush()
        key = (bucket, object_)
        with self._mu:
            self._sketch.record(bucket + "/" + object_)
            entry = self._protected.get(key)
            if entry is not None:
                self._protected.move_to_end(key)
                self.hits += 1
                return entry
            entry = self._probation.get(key)
            if entry is None:
                self.misses += 1
                return None
            # Second hit: promote, demoting the protected LRU back to
            # probation when the protected segment is full.
            del self._probation[key]
            self._protected[key] = entry
            if len(self._protected) > self._protected_cap:
                old_key, old = self._protected.popitem(last=False)
                self._probation[old_key] = old
                self._probation.move_to_end(old_key)
            self.hits += 1
            return entry

    # -- admission / insert ---------------------------------------------

    def admit(self, bucket: str, object_: str, size: int) -> bool:
        """Should the GET path buffer this object for insertion? Free
        room admits outright; otherwise the candidate must beat the
        eviction victim's estimated frequency."""
        if not self.enabled or size <= 0 or size > self.obj_max:
            return False
        with self._mu:
            key = (bucket, object_)
            if key in self._probation or key in self._protected:
                return False
            if (len(self._probation) + len(self._protected)
                    < self.max_entries
                    and self._bytes + size <= self.max_bytes):
                return True
            victim_key = next(iter(self._probation), None) \
                or next(iter(self._protected), None)
            if victim_key is None:
                self.rejects += 1
                return False
            skey = bucket + "/" + object_
            vkey = victim_key[0] + "/" + victim_key[1]
            if self._sketch.estimate(skey) > self._sketch.estimate(vkey):
                return True
            self.rejects += 1
            return False

    def put(self, bucket: str, object_: str, info: Any, body: bytes,
            head: Optional[bytes], token: int) -> bool:
        """Insert a served object. Refused when the bucket generation
        moved since token(), a sibling's bump included."""
        if not self.enabled or len(body) > self.obj_max:
            return False
        self.maybe_flush()
        with self._mu:
            if self._gens.get(bucket, 0) != token:
                return False
            key = (bucket, object_)
            old = self._probation.pop(key, None) \
                or self._protected.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            entry = _Entry(info, body)
            if head is not None:
                tpl = split_head(head)
                if tpl is not None:
                    entry.head_prefix, entry.head_suffix = tpl
            self._probation[key] = entry
            self._bytes += entry.nbytes
            self.admits += 1
            self._evict_locked()
            return True

    def set_head(self, bucket: str, object_: str, etag: str,
                 version_id: str, head: bytes) -> None:
        """Back-fill the response-head template of an entry admitted
        without one; identity-checked so a template of another version
        is never spliced onto these bytes."""
        with self._mu:
            key = (bucket, object_)
            entry = self._protected.get(key) or self._probation.get(key)
            if entry is None or entry.head_prefix is not None:
                return
            if (getattr(entry.info, "etag", None) != etag
                    or (getattr(entry.info, "version_id", None) or "")
                    != (version_id or "")):
                return
            tpl = split_head(head)
            if tpl is not None:
                entry.head_prefix, entry.head_suffix = tpl

    def _evict_locked(self) -> None:
        while (len(self._probation) + len(self._protected)
               > self.max_entries or self._bytes > self.max_bytes):
            if self._probation:
                _, victim = self._probation.popitem(last=False)
            elif self._protected:
                _, victim = self._protected.popitem(last=False)
            else:
                break
            self._bytes -= victim.nbytes
            self.evictions += 1

    # -- invalidation ----------------------------------------------------

    def invalidate_bucket(self, bucket: str) -> None:
        """Metacache bump listener: every namespace mutation in the
        bucket lands here synchronously, before the mutation acks."""
        with self._mu:
            self._gens[bucket] = self._gens.get(bucket, 0) + 1
            for seg in (self._probation, self._protected):
                for key in [k for k in seg if k[0] == bucket]:
                    self._bytes -= seg.pop(key).nbytes
            self.invalidations += 1

    def invalidate_all(self) -> None:
        with self._mu:
            for bucket in self._gens:
                self._gens[bucket] += 1
            self._probation.clear()
            self._protected.clear()
            self._bytes = 0
            self.invalidations += 1

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "entries": len(self._probation) + len(self._protected),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "obj_max": self.obj_max,
                "hits": self.hits,
                "misses": self.misses,
                "admits": self.admits,
                "rejects": self.rejects,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }

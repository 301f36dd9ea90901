"""Coherent quorum-fileinfo cache: (bucket, object, version) -> (fi, fis).

The port of minio_tpu/object/fi_cache.py. Every GET/HEAD pays a drive
`read_version` fan-out to quorum-pick the version before a single data
byte moves. Repeat reads of the same key serve the quorum-agreed
FileInfo (and the per-drive fis the shard-holder map is built from)
straight from memory, zero drive calls, while writes invalidate, so a
cached entry can never outlive the version it describes.

Coherence model (correctness first, three layers):

  * in-process: every namespace mutation funnels through
    `MetaCache.bump(bucket)` (puts, deletes, multipart completes, heals,
    group-commit batches); the erasure set registers this cache as a
    bump listener, so one hook covers every mutation path.
    Invalidation is bucket-wide: a spurious re-read costs one fan-out.
  * insert races: an entry is only stored if the bucket's invalidation
    generation still matches a token taken BEFORE the drive fan-out
    that produced it (`token()`/`put(..., token)`). Without this, an
    unlocked metadata read could read pre-overwrite state, lose the
    race to the overwrite's bump, and insert a stale entry nothing
    would ever invalidate.
  * cross-process: pre-forked workers (io/workers.py) attach a
    SharedGen observer on the shared `list.gen` file that every
    worker's bump appends to; `maybe_flush()` runs at each lookup and
    at each token grab, clearing the whole cache when ANY worker
    mutated ANY namespace since we last looked.
  * cross-node: a set with a drive on another node shuts `remote_gate`
    (no invalidation from other nodes reaches this process), and its
    lookups answer misses.

Bounds: entry count AND resident bytes (inline objects carry their
framed shard payloads in fis), both LRU-evicted. Cached entries keep
only the k DATA shards' inline blobs: the GET fast path reads those
alone, and a read that needs a parity shard re-reads that holder's
journal (the empty not-loaded sentinel b"" means "fetch my journal").

HEAD traffic gets its own STAT class: a HEAD needs only the quorum fi,
so stat entries live in a separate, much larger LRU; a HEAD storm
never evicts a data-class entry. Lookups check the stat map first,
then the data map; inserts from the HEAD path touch the stat map only.

Environment (the JAX package's names and defaults):
  MTPU_FILEINFO_CACHE        "0"/"off"/"false" disables the cache
  MTPU_FILEINFO_CACHE_MAX    max cached keys (default 4096)
  MTPU_FILEINFO_CACHE_BYTES  max resident inline bytes (default 256 MiB)
  MTPU_FILEINFO_STAT_MAX     max stat-class keys (default 65536)
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import Optional

from minio_tpu_torch.utils.env import env_int


def cache_enabled(key: str) -> bool:
    """A cache's kill switch: on unless `key` is 0, off or false."""
    return os.environ.get(key, "").lower() not in ("0", "off", "false")


def gate_open(gate) -> bool:
    """Whether a cache's remote gate lets it serve: no gate, or one that
    answers true (a gate that raises counts as shut)."""
    if gate is None:
        return True
    try:
        return bool(gate())
    except Exception:  # noqa: BLE001 - a broken gate fails closed
        return False


class FileInfoCache:
    """Thread-safe LRU of (bucket, object, version_id) -> (fi, fis)."""

    def __init__(self, max_entries: int | None = None,
                 max_bytes: int | None = None,
                 enabled: bool | None = None,
                 max_stat: int | None = None):
        self.enabled = cache_enabled("MTPU_FILEINFO_CACHE") \
            if enabled is None else enabled
        self.max_entries = max_entries if max_entries is not None \
            else env_int("MTPU_FILEINFO_CACHE_MAX", 4096)
        self.max_bytes = max_bytes if max_bytes is not None \
            else env_int("MTPU_FILEINFO_CACHE_BYTES", 256 << 20)
        self.max_stat = max_stat if max_stat is not None \
            else env_int("MTPU_FILEINFO_STAT_MAX", 65536)
        self._mu = threading.Lock()
        self._map: OrderedDict = OrderedDict()   # key -> entry dict
        self._stat: OrderedDict = OrderedDict()  # key -> quorum fi only
        self._gens: dict[str, int] = {}          # bucket -> invalidation gen
        self._bytes = 0
        # Cross-process invalidation observer (io/workers.SharedGen or
        # anything with a changed() -> bool); None in one process.
        self.shared_gen = None
        # Cross-NODE gate (minio_tpu/object/fi_cache.py): a set with a
        # remote drive gets a deny-all gate at construction, so its
        # lookups answer misses, never hits that no invalidation from
        # another node covers. None on local sets.
        self.remote_gate = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.stat_hits = 0
        self.stat_misses = 0
        self.stat_evictions = 0

    # -- coherence -------------------------------------------------------

    def maybe_flush(self) -> None:
        """Pull-check the cross-process generation; a change made by
        ANY worker flushes everything."""
        sg = self.shared_gen
        if sg is not None and sg.changed():
            self.invalidate_all()

    def token(self, bucket: str) -> int:
        """Generation token to take BEFORE the drive fan-out whose
        result will be put(); put() refuses when it no longer matches.
        setdefault, not get: the bucket must be in the generation map
        from now on, or an invalidate_all() racing the fan-out would
        have no entry to bump for it."""
        self.maybe_flush()
        with self._mu:
            return self._gens.setdefault(bucket, 0)

    def invalidate_bucket(self, bucket: str) -> None:
        with self._mu:
            self._gens[bucket] = self._gens.get(bucket, 0) + 1
            stale = [k for k in self._map if k[0] == bucket]
            for k in stale:
                self._drop(k)
            sstale = [k for k in self._stat if k[0] == bucket]
            for k in sstale:
                self._stat.pop(k, None)
            if stale or sstale:
                self.invalidations += 1

    def invalidate_all(self) -> None:
        with self._mu:
            for b in set(self._gens) | {k[0] for k in self._map} \
                    | {k[0] for k in self._stat}:
                self._gens[b] = self._gens.get(b, 0) + 1
            if self._map or self._stat:
                self.invalidations += 1
            self._map.clear()
            self._stat.clear()
            self._bytes = 0

    def _serving(self) -> bool:
        """May cached entries be served, and taken, now? Not while the
        remote gate is shut. The JAX package takes inserts behind a shut
        gate, which its coherence protocol may reopen; the port's shut
        gate never reopens, so an insert would copy what no lookup
        serves."""
        return gate_open(self.remote_gate)

    # -- lookup / insert -------------------------------------------------

    def get(self, bucket: str, object_: str, version_id: str,
            need_data: bool) -> Optional[tuple]:
        """(fi, fis) or None. `need_data=True` only matches entries
        whose fis were read with read_data (inline payloads loaded)."""
        if not self.enabled or not self._serving():
            return None
        self.maybe_flush()
        key = (bucket, object_, version_id)
        with self._mu:
            e = self._map.get(key)
            if e is None or (need_data and not e["read_data"]):
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return e["fi"], e["fis"]

    def put(self, bucket: str, object_: str, version_id: str,
            fi, fis, read_data: bool, token: int) -> None:
        if not self.enabled or not self._serving():
            return
        self.maybe_flush()
        key = (bucket, object_, version_id)
        # Parity holders' inline blobs become the empty not-loaded
        # sentinel (a COPY: the caller's read may still use its fis).
        k = fi.erasure.data_blocks if fi is not None else 0
        if k:
            fis = [dataclasses.replace(f, inline_data=b"")
                   if f is not None and f.inline_data
                   and f.erasure.index > k else f
                   for f in fis]
        size = sum(len(f.inline_data) for f in fis
                   if f is not None and f.inline_data)
        with self._mu:
            if self._gens.get(bucket, 0) != token:
                return        # a mutation landed during the fan-out
            old = self._map.get(key)
            if old is not None:
                if old["read_data"] and not read_data:
                    return    # never downgrade a data-bearing entry
                self._drop(key)
            self._map[key] = {"fi": fi, "fis": fis,
                              "read_data": read_data, "bytes": size}
            self._bytes += size
            while len(self._map) > self.max_entries \
                    or self._bytes > self.max_bytes:
                self._drop(next(iter(self._map)))
                self.evictions += 1

    def _drop(self, key) -> None:
        e = self._map.pop(key, None)
        if e is not None:
            self._bytes -= e["bytes"]

    # -- stat class (HEAD traffic) ---------------------------------------

    def get_stat(self, bucket: str, object_: str, version_id: str):
        """Quorum fi for a HEAD, or None: the stat map first, then the
        data map; only the stat counters move."""
        if not self.enabled or not self._serving():
            return None
        self.maybe_flush()
        key = (bucket, object_, version_id)
        with self._mu:
            fi = self._stat.get(key)
            if fi is not None:
                self._stat.move_to_end(key)
                self.stat_hits += 1
                return fi
            e = self._map.get(key)
            if e is not None:
                self.stat_hits += 1
                return e["fi"]
            self.stat_misses += 1
            return None

    def put_stat(self, bucket: str, object_: str, version_id: str,
                 fi, token: int) -> None:
        """Insert a HEAD result into the STAT class only; same token
        protocol as put()."""
        if not self.enabled or fi is None or not self._serving():
            return
        self.maybe_flush()
        if fi.inline_data:
            fi = dataclasses.replace(fi, inline_data=b"")
        key = (bucket, object_, version_id)
        with self._mu:
            if self._gens.get(bucket, 0) != token:
                return        # a mutation landed during the fan-out
            self._stat[key] = fi
            self._stat.move_to_end(key)
            while len(self._stat) > self.max_stat:
                self._stat.popitem(last=False)
                self.stat_evictions += 1

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            total = self.hits + self.misses
            return {
                "enabled": self.enabled,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "entries": len(self._map),
                "bytes": self._bytes,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "stat_hits": self.stat_hits,
                "stat_misses": self.stat_misses,
                "stat_entries": len(self._stat),
                "stat_evictions": self.stat_evictions,
            }

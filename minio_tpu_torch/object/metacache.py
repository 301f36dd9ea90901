"""Metacache: shared listing walk streams with write invalidation.

The port of minio_tpu/object/metacache.py (reference cmd/metacache.go,
cmd/metacache-set.go:700, cmd/metacache-walk.go:73). A listing starts
ONE background walk of the erasure set (ErasureSet._walk_resolved: the
drives' sorted journal walks merged, each key resolved) whose sorted
entry stream collects in memory and persists on the set's first drive
with a root of its own (slot 0 unless that slot is offline).
Every page of that listing, every concurrent listing of the prefix and
every follow-up listing within _IDLE_TTL reads the SAME stream: a large
bucket is walked once, not once a page.

Stream entries are trimmed (storage/meta_scan):

    ("s", vlist)   per-version summary tuples
    ("m", maps)    full version maps (no summary, metadata past the
                   summary, or a quorum read where copies disagreed)
    PREFIX_MARK    shallow ("/" delimiter) walks: a key prefix

Persistence (format v2, JSON where the JAX package packs msgpack): a
completed walk writes fixed-size sorted segments under
`.mtpu.sys/listcache/<bucket>/<prefix>/` (names hashed) plus a head
holding each segment's first key, last key and count, so a continuation
page in a fresh process SEEKS to its marker's segment; the continuation
walk of a truncated run COMPACTS onto it. A fresh process warm-starts
from a run younger than _PERSIST_TTL (2 s). A bump of a bucket
removes its runs (its first bump in a process removes whatever earlier
processes left), so a restart never loads a run that predates an
acknowledged write; the JAX package bounds that staleness by the TTL
alone.

Invalidation is by generation: every namespace mutation of a bucket
calls `bump`, which orphans the bucket's walks (a cached stream never
serves names from before a change) and calls every `listeners` entry.
A set with a drive on another node shuts `remote_gate` (its bumps
reach no other node): every lookup then walks afresh, outside the
registry. The JAX package's `on_bump` broadcast to peer nodes waits for
the port's cross-node coherence protocol.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Callable, Optional

from minio_tpu_torch.object.fi_cache import gate_open
from minio_tpu_torch.storage.meta_scan import PREFIX_MARK


# Entries a persisted segment (the head indexes one (first, last, count)
# triple a segment: a seek is O(log segments) plus one segment read).
_SEG = 4096
# A completed walk serves this long after its last touch; an active walk
# always serves (the generation still decides validity).
_IDLE_TTL = 30.0
# How young a persisted run must be for a fresh process to load it.
_PERSIST_TTL = 2.0
# In-memory entries a walk at most; past it the walk marks itself
# truncated and later pages continue through start-floored walks.
_MAX_ENTRIES = 500_000

META_DIR = "listcache"         # under SYS_VOL on the first drive
SYS_VOL_ = ".mtpu.sys"
_FMT = 2


def _safe(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()[:24]


def _canon_entry(e):
    """An entry read back from JSON -> its in-memory form: summaries as
    tuples of tuples, the prefix marker as THE module sentinel."""
    if isinstance(e, list):
        if len(e) == 1 and e[0] == PREFIX_MARK[0]:
            return PREFIX_MARK
        if len(e) == 2 and e[0] == "s" and isinstance(e[1], list):
            return ("s", tuple(tuple(v) for v in e[1]))
        if len(e) == 2 and e[0] == "m" and isinstance(e[1], list):
            return ("m", list(e[1]))
    return None


def _seg_blob(keys: list, entries: list) -> bytes:
    return json.dumps(list(zip(keys, entries)),
                      separators=(",", ":")).encode()


class WalkStream:
    """One background merged and resolved walk of (bucket, prefix)."""

    def __init__(self, bucket: str, prefix: str, gen: int,
                 start: str = "", shallow: bool = False):
        self.bucket = bucket
        self.prefix = prefix
        # A walk starts at the prefix; a continuation past a truncated
        # stream's cap starts at that listing's marker.
        self.start_after = start
        self.shallow = shallow
        self.gen = gen
        self.keys: list[str] = []          # sorted walked keys
        self.entries: list = []            # their stream entries
        self.done = False
        self.error: Optional[Exception] = None
        self.truncated = False             # hit _MAX_ENTRIES, or cancelled
        self.persisted_from = 0            # segments a seek skipped
        # A walk that bypassed the registry (a shut remote gate) serves
        # one call and is never persisted.
        self.ephemeral = False
        self.last_touch = time.monotonic()
        self.cond = threading.Condition()
        self._cancel = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- production (the walk thread) ---------------------------------

    def start(self, es, mc: "MetaCache") -> None:
        self._thread = threading.Thread(
            target=self._run, args=(es, mc), daemon=True,
            name=f"metacache-walk-{self.bucket}")
        self._thread.start()

    def _run(self, es, mc) -> None:
        try:
            for path, entry in es._walk_resolved(
                    self.bucket, self.prefix, self.start_after,
                    shallow=self.shallow):
                if self._cancel.is_set():
                    # Orphaned by a bump or an eviction: stop spending
                    # drive I/O on a stream nobody can read.
                    self.truncated = True
                    break
                with self.cond:
                    self.keys.append(path)
                    self.entries.append(entry)
                    self.cond.notify_all()
                    if len(self.keys) >= _MAX_ENTRIES:
                        self.truncated = True
                        break
            if not self.shallow and not self.start_after:
                # A base run persists BEFORE done: a caller that saw the
                # walk complete may warm-start a fresh process from it.
                self._persist(es, mc)
        except Exception as e:  # noqa: BLE001 - reported to the waiters
            self.error = e
        finally:
            with self.cond:
                self.done = True
                self.cond.notify_all()
        # A continuation compacts AFTER done: it may wait (bounded) for
        # an earlier continuation to close a gap, and no page must wait
        # on that.
        if self.error is None and not self.shallow and self.start_after:
            self._persist(es, mc)

    # -- persistence (format v2: segments + an indexed head) ----------

    @staticmethod
    def _dir(bucket: str, prefix: str) -> str:
        return f"{META_DIR}/{_safe(bucket)}/{_safe(prefix)}"

    def _persist(self, es, mc) -> None:
        """Write the completed stream to the first drive as sorted
        segments plus an indexed head (best effort); a continuation walk
        compacts onto its base run instead. Under the cache's
        persist_mu with the cancel re-checked there: a bump that
        orphaned the walk first means no write, and a bump after it
        removes what was written."""
        d = mc.persist_drive
        if d is None or not self.keys or self.ephemeral:
            return
        base = self._dir(self.bucket, self.prefix)
        try:
            with mc.persist_mu:
                if self._cancel.is_set():
                    return
                if self.start_after:
                    self._compact_onto(d, base, mc)
                    return
                seg_index = []
                for s, i in enumerate(range(0, len(self.keys), _SEG)):
                    keys = self.keys[i:i + _SEG]
                    d.write_all(SYS_VOL_, f"{base}/seg-{s:06d}",
                                _seg_blob(keys, self.entries[i:i + _SEG]))
                    seg_index.append([keys[0], keys[-1], len(keys)])
                d.write_all(SYS_VOL_, f"{base}/head", json.dumps({
                    "v": _FMT, "created_ns": time.time_ns(),
                    "count": len(self.keys), "start": "",
                    "truncated": self.truncated,
                    "seg": seg_index}).encode())
                mc.note_persisted(self.bucket)
        except Exception:  # noqa: BLE001 - persistence is optional
            pass

    # How long a continuation floored past the base run's end waits for
    # the earlier continuation whose append closes the gap.
    _COMPACT_WAIT = 5.0

    def _compact_onto(self, d, base: str, mc) -> None:
        """Append this continuation's entries to the persisted base run
        (segments and index updated in place; the head rewrite is the
        commit point). Continuations finish in completion order, not key
        order: one floored at or below the base's end appends only its
        tail past the end; one floored above it would leave a hole, so
        it waits (bounded, persist_mu released) for the gap to close.
        Called with persist_mu held; returns with it held."""
        deadline = time.monotonic() + self._COMPACT_WAIT
        while not self._cancel.is_set():
            try:
                head = json.loads(d.read_all(SYS_VOL_, f"{base}/head"))
            except Exception:  # noqa: BLE001 - no base run to extend
                return
            if head.get("v") != _FMT or not head.get("truncated") or \
                    not head.get("seg"):
                return
            last = head["seg"][-1][1]
            if self.start_after <= last:
                lo = bisect.bisect_right(self.keys, last)
                if lo >= len(self.keys):
                    return
                seg_index = list(head["seg"])
                s = len(seg_index)
                for i in range(lo, len(self.keys), _SEG):
                    kseg = self.keys[i:i + _SEG]
                    d.write_all(SYS_VOL_, f"{base}/seg-{s:06d}",
                                _seg_blob(kseg, self.entries[i:i + _SEG]))
                    seg_index.append([kseg[0], kseg[-1], len(kseg)])
                    s += 1
                head.update({"count": head["count"] + len(self.keys) - lo,
                             "truncated": self.truncated, "seg": seg_index})
                d.write_all(SYS_VOL_, f"{base}/head",
                            json.dumps(head).encode())
                mc.compactions += 1
                mc.note_persisted(self.bucket)
                return
            if time.monotonic() > deadline:
                return          # the gap never closed: stays truncated
            mc.persist_mu.release()
            try:
                time.sleep(0.05)
            finally:
                mc.persist_mu.acquire()

    @classmethod
    def load_persisted(cls, es, bucket: str, prefix: str, gen: int,
                       marker: str = "") -> Optional["WalkStream"]:
        """A persisted run, if young enough. With a marker only the
        segments holding keys past it are read (the seek the index
        exists for); the stream then starts at the marker as a
        start-floored walk would."""
        d = es.metacache.persist_drive
        if d is None:
            return None
        base = cls._dir(bucket, prefix)
        try:
            head = json.loads(d.read_all(SYS_VOL_, f"{base}/head"))
            if head.get("v") != _FMT:
                return None
            if time.time_ns() - head["created_ns"] > _PERSIST_TTL * 1e9:
                return None
            seg_index = head.get("seg") or []
            first = 0
            if marker:
                while first < len(seg_index) and \
                        seg_index[first][1] <= marker:
                    first += 1
                if first >= len(seg_index):
                    return None     # the run ends at or before the marker
            w = cls(bucket, prefix, gen, start=marker)
            w.persisted_from = first
            want = 0
            for s in range(first, len(seg_index)):
                want += seg_index[s][2]
                for path, entry in json.loads(
                        d.read_all(SYS_VOL_, f"{base}/seg-{s:06d}")):
                    entry = _canon_entry(entry)
                    if entry is None:
                        return None
                    w.keys.append(path)
                    w.entries.append(entry)
            if len(w.keys) != want or want == 0:
                return None
            w.truncated = bool(head.get("truncated"))
            w.done = True
            return w
        except Exception:  # noqa: BLE001 - absent, stale or corrupt
            return None

    def cancel(self) -> None:
        self._cancel.set()
        with self.cond:
            self.cond.notify_all()

    # -- consumption (listing threads) --------------------------------

    def wait_past(self, key: str, need: int, timeout: float = 60.0):
        """Block until the walk has `need` entries after `key` or is
        done; returns (count, done). keys and entries only grow, so the
        indices below count are stable and readers copy nothing."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                idx = bisect.bisect_right(self.keys, key)
                if self.done or len(self.keys) - idx >= need:
                    self.last_touch = time.monotonic()
                    return len(self.keys), self.done
                left = deadline - time.monotonic()
                if left <= 0:
                    return len(self.keys), self.done
                self.cond.wait(timeout=min(left, 5))


class MetaCache:
    """One erasure set's walk-stream registry and bucket generations."""

    MAX_WALKS = 8

    def __init__(self, persist_drive=None):
        self._mu = threading.Lock()
        self._gen: dict[str, int] = {}             # bucket -> generation
        self._walks: dict[tuple, WalkStream] = {}
        # Serializes persisted-run writes and their removal by bump.
        self.persist_mu = threading.Lock()
        # The drive runs persist on, and the buckets whose runs this
        # process removed there with none persisted since: any other
        # bucket may have a run, from this process or an earlier one.
        self.persist_drive = persist_drive
        self._clean: set[str] = set()
        self.hits = 0
        self.misses = 0
        self.persisted_loads = 0
        self.compactions = 0
        self.walks_started = 0
        # Called on EVERY bump and drop with the bucket: bump is the one
        # funnel every namespace mutation goes through, so caches that
        # must see writes subscribe here (the JAX package's fi_cache).
        self.listeners: list[Callable[[str], None]] = []
        # Cross-NODE gate (minio_tpu/object/metacache.py): while it is
        # shut (the deny-all gate of a set with a remote drive), every
        # lookup walks afresh, unregistered, and the drives answer.
        self.remote_gate: Optional[Callable[[], bool]] = None

    def stats(self) -> dict:
        with self._mu:
            active = sum(1 for w in self._walks.values() if not w.done)
            walks = len(self._walks)
        return {"hits": self.hits, "misses": self.misses,
                "walks_active": active, "walks_cached": walks,
                "walks_started": self.walks_started,
                "persisted_loads": self.persisted_loads,
                "compactions": self.compactions}

    def note_persisted(self, bucket: str) -> None:
        """A run of `bucket` was written (called under persist_mu)."""
        with self._mu:
            self._clean.discard(bucket)

    def _notify(self, bucket: str) -> None:
        for listener in self.listeners:
            try:
                listener(bucket)
            except Exception:  # noqa: BLE001 - listeners are best-effort
                pass

    def _orphan(self, bucket: str) -> None:
        """Cancel the bucket's walks (under _mu)."""
        for k in [k for k in self._walks if k[0] == bucket]:
            self._walks.pop(k).cancel()

    def _unpersist(self, bucket: str) -> None:
        """Remove the bucket's persisted runs from the first drive unless
        none can exist. Under persist_mu: a walk persisting now finishes
        first (it saw its cancel, or wrote what is removed here)."""
        root = getattr(self.persist_drive, "root", None)
        if root is None:
            return
        with self.persist_mu:
            with self._mu:
                if bucket in self._clean:
                    return
                self._clean.add(bucket)
            shutil.rmtree(os.path.join(root, SYS_VOL_, META_DIR,
                                       _safe(bucket)), ignore_errors=True)

    def bump(self, bucket: str) -> None:
        """A namespace mutation in the bucket: its walks are orphaned and
        its persisted runs removed, before the caller acks the
        mutation."""
        self._notify(bucket)
        with self._mu:
            self._gen[bucket] = self._gen.get(bucket, 0) + 1
            self._orphan(bucket)
        self._unpersist(bucket)

    def drop_bucket(self, bucket: str) -> None:
        """The bucket is gone: its generation, walks and persisted runs
        go with it."""
        self._notify(bucket)
        with self._mu:
            self._gen.pop(bucket, None)
            self._orphan(bucket)
        self._unpersist(bucket)

    def close(self) -> None:
        """Cancel every walk (the set is going away)."""
        with self._mu:
            for w in self._walks.values():
                w.cancel()
            self._walks.clear()

    def walk_for(self, es, bucket: str, prefix: str, start: str = "",
                 shallow: bool = False, seek: str = "") -> WalkStream:
        """Find or start the shared walk of (bucket, prefix) at the
        current generation (reference: cmd/metacache-set.go looks a
        listing up before starting one). An active walk, or a done one
        touched less than _IDLE_TTL ago, serves. `seek` is the page's
        scan floor: on a miss it lets a done stream floored at or below
        it that still covers it serve the page (the coverage scan), and
        lets a fresh process's continuation page load only the persisted
        segments past it."""
        if not gate_open(self.remote_gate):
            # No cached or persisted stream is provable: a fresh walk
            # outside the registry serves this call alone. Not a bump,
            # which would cancel concurrent listings' walks.
            with self._mu:
                self.misses += 1
                self.walks_started += 1
                gen = self._gen.get(bucket, 0)
            w = WalkStream(bucket, prefix, gen, start=start,
                           shallow=shallow)
            w.ephemeral = True
            w.start(es, self)
            return w
        with self._mu:
            gen = self._gen.get(bucket, 0)
            key = (bucket, prefix, start, shallow)
            w = self._walks.get(key)
            now = time.monotonic()
            if w is not None and w.gen == gen and w.error is None and \
                    not w._cancel.is_set() and \
                    (not w.done or now - w.last_touch < _IDLE_TTL):
                # A truncated but complete walk still serves the pages
                # below its cap; pages past it ask for a continuation.
                self.hits += 1
                return w
            if seek and not start:
                best = None
                for (b2, p2, _, sh2), cand in self._walks.items():
                    if b2 != bucket or p2 != prefix or sh2 != shallow:
                        continue
                    if cand.gen != gen or cand.error is not None or \
                            cand._cancel.is_set() or not cand.done or \
                            now - cand.last_touch >= _IDLE_TTL:
                        continue
                    if cand.start_after <= seek and \
                            (not cand.truncated
                             or (cand.keys and cand.keys[-1] > seek)) \
                            and (best is None
                                 or cand.start_after > best.start_after):
                        best = cand
                if best is not None:
                    self.hits += 1
                    best.last_touch = now
                    return best
            self.misses += 1
            w = None
            if gen == 0 and not shallow:
                # A quiet bucket in a fresh process: a recent persisted
                # run warm-starts the listing, seeking for deep pages.
                w = WalkStream.load_persisted(es, bucket, prefix, gen,
                                              marker=start or seek)
                if w is not None:
                    self.persisted_loads += 1
                    key = (bucket, prefix, w.start_after, shallow)
            if w is None:
                w = WalkStream(bucket, prefix, gen, start=start,
                               shallow=shallow)
                self.walks_started += 1
                w.start(es, self)
            self._walks[key] = w
            while len(self._walks) > self.MAX_WALKS:
                oldest = min(self._walks,
                             key=lambda k: self._walks[k].last_touch)
                self._walks.pop(oldest).cancel()
            return w

"""The background data scanner and the heal sweeps over one erasure set.

The port of minio_tpu/object/scanner.py (reference cmd/data-scanner.go,
cmd/background-newdisks-heal-ops.go, cmd/global-heal.go):

  * `Scanner` cycles over its sets at low priority: it restores the
    format of drives that lost it (`check_drive_formats`, a drive
    replaced while serving), recreates bucket volumes a drive misses,
    heals every object some live drive lacks, samples 1 object in
    DEEP_EVERY for a deep (bitrot-verifying) heal, and keeps the usage
    accounts (objects, versions, delete markers, bytes; per bucket),
    persisted at `.mtpu.sys/scanner/usage.json` on every drive. Each
    scanned object goes to the `on_object` hooks (none subscribe yet;
    lifecycle rules will).
  * `heal_set` heals every bucket and object of one set (the admin heal).
  * `_walk_all_drives` merges the drives' sorted walks (each drive's
    `walk_scan`) by key, so which drives hold a key falls out of the
    merge with no extra stat; it resumes at `forward_from`, as the
    checkpointed bulk heal of a replaced drive needs (drive_heal.py).

Each walked key carries its per-version summary, or its journal where
the summary does not suffice (storage/meta_scan.py): usage and version
ids read the summary, and the journal is parsed in full only where the
JAX scanner falls back to its parser too.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import threading
import time
from itertools import groupby
from typing import Callable, Optional, Sequence

SYS_VOL = ".mtpu.sys"
USAGE_PATH = "scanner/usage.json"
DEEP_EVERY = 1024     # reference healObjectSelectProb (data-scanner.go:59)


@dataclasses.dataclass
class BucketUsage:
    objects: int = 0
    versions: int = 0
    delete_markers: int = 0
    size: int = 0

    def to_json(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DataUsage:
    """Aggregate usage snapshot (reference DataUsageInfo); the JAX
    package's JSON."""
    buckets: dict = dataclasses.field(default_factory=dict)
    objects: int = 0
    versions: int = 0
    delete_markers: int = 0
    total_size: int = 0
    last_update: float = 0.0
    cycles: int = 0
    healed: int = 0
    heal_failures: int = 0

    def to_json(self):
        return {
            "buckets": {b: u.to_json() for b, u in self.buckets.items()},
            "objects": self.objects, "versions": self.versions,
            "delete_markers": self.delete_markers,
            "total_size": self.total_size,
            "last_update": self.last_update, "cycles": self.cycles,
            "healed": self.healed, "heal_failures": self.heal_failures,
        }

    @classmethod
    def from_json(cls, m: dict) -> "DataUsage":
        u = cls()
        for b, bu in (m.get("buckets") or {}).items():
            u.buckets[b] = BucketUsage(**bu)
        for f in ("objects", "versions", "delete_markers", "total_size",
                  "last_update", "cycles", "healed", "heal_failures"):
            setattr(u, f, m.get(f, 0))
        return u


def _walk_all_drives(es, bucket: str, forward_from: str = ""):
    """Merged sorted walk over all of the set's drives: (object path,
    [(drive index, summary or None, journal or None), ...]) per key, in
    drive order (LocalStorage.walk_scan's yield forms). From
    `forward_from` on (inclusive). A drive that cannot be walked
    contributes nothing."""
    def tagged(i, d):
        try:
            for path, vlist, blob in d.walk_scan(bucket,
                                                 forward_from=forward_from):
                yield path, i, vlist, blob
        except Exception:  # noqa: BLE001 - offline drive, missing volume
            return

    merged = heapq.merge(*[tagged(i, d) for i, d in enumerate(es.disks)],
                         key=lambda t: t[0])
    for path, grp in groupby(merged, key=lambda t: t[0]):
        yield path, [(i, vlist, blob) for _, i, vlist, blob in grp]


def key_versions(es, bucket: str, path: str, copies: list):
    """The walked key's FileInfos, latest first, from the first copy that
    has them: its summary when that suffices, else its journal parsed in
    full. None when no copy has either."""
    from minio_tpu_torch.storage.meta import MetaError, XLMeta
    from minio_tpu_torch.storage.meta_scan import summary_sufficient
    for _, vlist, blob in copies:
        if vlist is not None and (blob is None or summary_sufficient(vlist)):
            return es._entry_fileinfos(bucket, path, ("s", vlist))
        if blob is not None:
            try:
                return XLMeta.load(blob).list_versions(bucket, path)
            except MetaError:
                continue
    return None


def key_version_ids(copies: list) -> list:
    """Every version id of a walked key as its journal stores it ("null"
    for the null version), from the first copy with a summary or a
    parseable journal; [""] (the latest only) when none has."""
    from minio_tpu_torch.storage.meta import MetaError, XLMeta
    for _, vlist, blob in copies:
        if vlist is not None:
            vids = [v[3] for v in vlist]
        elif blob is not None:
            try:
                vids = [v.get("vid", "") for v in XLMeta.load(blob).versions]
            except MetaError:
                continue
        else:
            continue
        if vids:
            return vids
    return [""]


def scan_set_bucket(es, bucket: str, usage: BucketUsage, state: dict,
                    heal: bool = True, throttle: float = 0.0,
                    on_object: Optional[Callable] = None) -> None:
    """One pass over one bucket of one set: usage accounting, heals of
    keys some live drive lacks, and the deep-heal sample (every
    state["deep_every"]-th key, counted in state["counter"]); heal counts
    go to state["healed"] and state["failures"]. The pass ends early once
    state["stop"] (an Event) is set."""
    from minio_tpu_torch.object.healing import heal_bucket, heal_object

    if heal:
        try:
            # Drives that miss the bucket (replaced ones) get its volume,
            # so the object heals can write there.
            heal_bucket(es, bucket)
        except Exception:  # noqa: BLE001 - bucket gone everywhere
            return

    alive = set()
    for i, d in enumerate(es.disks):
        try:
            d.stat_vol(bucket)
            alive.add(i)
        except Exception:  # noqa: BLE001 - offline or missing bucket
            continue

    stop = state.get("stop")
    for path, copies in _walk_all_drives(es, bucket):
        if stop is not None and stop.is_set():
            return
        versions = key_versions(es, bucket, path, copies)
        if versions is None:
            continue
        # An empty version list still counts and heals (a crash inside
        # a delete can leave zero-version journals on some drives).
        usage.objects += 1
        usage.versions += len(versions)
        for v in versions:
            if v.deleted:
                usage.delete_markers += 1
            else:
                usage.size += v.size
        if on_object is not None and versions:
            try:
                on_object(bucket, path, versions)
            except Exception:  # noqa: BLE001 - hooks never stop the scan
                pass
        if not heal:
            continue
        state["counter"] = state.get("counter", 0) + 1
        missing = alive - {i for i, _, _ in copies}
        deep = state["counter"] % state.get("deep_every", DEEP_EVERY) == 0
        if missing or deep:
            try:
                heal_object(es, bucket, path, deep=deep)
                state["healed"] = state.get("healed", 0) + 1
            except Exception:  # noqa: BLE001 - the next cycle retries
                state["failures"] = state.get("failures", 0) + 1
        if throttle:
            time.sleep(throttle)


def check_drive_formats(sets: Sequence) -> int:
    """New-drive detection while serving (reference
    cmd/background-newdisks-heal-ops.go:563): a drive whose format.json
    is gone (a replaced drive) gets its slot's identity back from a
    healthy peer's layout and a healing marker, so the drive lifecycle
    manager bulk-heals it. Returns the formats restored. The set's row
    in the layout is the one holding the donor drive's own UUID, and the
    donor's column must be its position in the set."""
    from minio_tpu_torch.object.drive_heal import mark_healing
    from minio_tpu_torch.topology.format import FormatInfo

    restored = 0
    for es in sets:
        layout = None
        donor_pos = None          # (row, column) of the donor in its layout
        fresh: list[int] = []
        donor_q = None
        for q, d in enumerate(es.disks):
            try:
                layout_m = d.read_format()   # None: fresh (no format.json)
            except Exception:  # noqa: BLE001 - offline: not fresh, no donor
                continue
            if layout_m is None:
                fresh.append(q)
                continue
            if layout is not None:
                continue
            try:
                cand = FormatInfo.from_json(layout_m)
            except Exception:  # noqa: BLE001 - corrupt format: skip
                continue
            for r, row in enumerate(cand.sets):
                if cand.this in row:
                    layout, donor_pos, donor_q = \
                        cand, (r, row.index(cand.this)), q
                    break
        if not fresh or layout is None or donor_pos is None:
            continue
        row = layout.sets[donor_pos[0]]
        if donor_pos[1] != donor_q or len(row) != len(es.disks):
            continue
        for q in fresh:
            d = es.disks[q]
            try:
                fi = FormatInfo(deployment_id=layout.deployment_id,
                                sets=layout.sets, this=row[q])
                d.write_format(fi.to_json())
                restored += 1
            except Exception:  # noqa: BLE001 - still dead: next cycle
                continue
            try:
                mark_healing(d, donor_pos[0], q, getattr(d, "endpoint", ""))
            except Exception:  # noqa: BLE001 - the scanner's heals converge
                pass
    return restored


def heal_set(es, deep: bool = False) -> dict:
    """Heal every bucket and every object of one set (reference
    cmd/global-heal.go:49 healErasureSet); counts of buckets, objects
    seen, objects healed and failures."""
    from minio_tpu_torch.object.healing import heal_bucket, heal_object
    stats = {"buckets": 0, "objects": 0, "healed": 0, "failures": 0}
    for b in es.list_buckets():
        try:
            heal_bucket(es, b.name)
            stats["buckets"] += 1
        except Exception:  # noqa: BLE001 - counted
            stats["failures"] += 1
        for path, _ in _walk_all_drives(es, b.name):
            stats["objects"] += 1
            try:
                if heal_object(es, b.name, path, deep=deep).healed:
                    stats["healed"] += 1
            except Exception:  # noqa: BLE001 - counted
                stats["failures"] += 1
    return stats


class Scanner:
    """The background walker over all sets of a server.

    interval: seconds between cycles; throttle: sleep per scanned object
    (the reference's scannerSleeper); deep_every: 1 in deep_every
    scanned objects gets a deep heal. on_object hooks receive (set,
    bucket, path, versions) for every scanned object."""

    def __init__(self, sets: Sequence, interval: float = 60.0,
                 throttle: float = 0.001, deep_every: int = DEEP_EVERY):
        self.sets = list(sets)
        self.interval = interval
        self.throttle = throttle
        self.deep_every = deep_every
        self.usage = DataUsage()
        self.on_object: list[Callable] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._load_usage()

    # -- persistence ----------------------------------------------------

    def _load_usage(self) -> None:
        for es in self.sets:
            for d in es.disks:
                try:
                    blob = d.read_all(SYS_VOL, USAGE_PATH)
                    self.usage = DataUsage.from_json(json.loads(blob))
                    return
                except Exception:  # noqa: BLE001 - try the next drive
                    continue

    def _save_usage(self) -> None:
        blob = json.dumps(self.usage.to_json()).encode()
        for es in self.sets:
            es._fanout([lambda d=d: d.write_all(SYS_VOL, USAGE_PATH, blob)
                        for d in es.disks])

    # -- one cycle ------------------------------------------------------

    def scan_cycle(self) -> DataUsage:
        """One full pass over every set: format checks, walk, heals,
        usage roll-up, persisted."""
        check_drive_formats(self.sets)
        usage = DataUsage()
        state = {"deep_every": self.deep_every, "stop": self._stop,
                 "counter": self.usage.cycles * 31}   # decorrelate samples
        buckets: dict[str, BucketUsage] = {}
        for es in self.sets:
            for b in es.list_buckets():
                buckets.setdefault(b.name, BucketUsage())
        for bucket, bu in buckets.items():
            for es in self.sets:
                def hook(bkt, path, versions, es=es):
                    for cb in self.on_object:
                        cb(es, bkt, path, versions)
                scan_set_bucket(es, bucket, bu, state,
                                throttle=self.throttle, on_object=hook)
        usage.buckets = buckets
        for bu in buckets.values():
            usage.objects += bu.objects
            usage.versions += bu.versions
            usage.delete_markers += bu.delete_markers
            usage.total_size += bu.size
        usage.cycles = self.usage.cycles + 1
        usage.healed = self.usage.healed + state.get("healed", 0)
        usage.heal_failures = self.usage.heal_failures \
            + state.get("failures", 0)
        usage.last_update = time.time()
        self.usage = usage
        try:
            self._save_usage()
        except Exception:  # noqa: BLE001 - losing the stats is not fatal
            pass
        return usage

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="scanner")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scan_cycle()
            except Exception:  # noqa: BLE001 - the scanner must survive
                continue

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

"""Drive lifecycle: a replaced drive refilled by a checkpointed bulk heal.

The port of minio_tpu/object/drive_heal.py (reference
cmd/background-newdisks-heal-ops.go): a drive swapped for a fresh one is
adopted into its slot at boot (topology/format.load_and_order) or while
serving (scanner.check_drive_formats), marked healing
(storage/local.HEALING_FILE), and refilled by a bulk heal that walks
every bucket and every version of every key of its set through
healing.heal_object, so the rebuilt shards go through the card's
gf_apply and highwayhash256 kernels as any heal's do.

While a drive heals, writes land on it at once (the backlog only
shrinks), reads rebuild around what it misses, and readiness
(/minio/health/ready) names its set. The bulk heal saves its position
(bucket, last key) in the marker every CHECKPOINT_EVERY keys, so a
restart resumes there; it yields while the front end's admission
controller (s3/admission.py) queues clients: the server sets a
manager's `pressure` to `admission_pressure` of its controller.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

from minio_tpu_torch.storage.local import (clear_healing, read_healing,
                                           write_healing)

# Keys healed between two checkpoints of the tracker.
CHECKPOINT_EVERY = 64


def new_tracker(set_index: int, disk_index: int,
                endpoint: str = "") -> dict:
    """A fresh healing tracker for a just-adopted replacement drive."""
    return {
        "started": time.time(),
        "set_index": set_index,
        "disk_index": disk_index,
        "endpoint": endpoint,
        "objects_scanned": 0,
        "objects_healed": 0,
        "objects_failed": 0,
        "bytes_healed": 0,
        "checkpoint_bucket": "",
        "checkpoint_object": "",
        "finished": False,
    }


def mark_healing(disk, set_index: int, disk_index: int,
                 endpoint: str = "") -> bool:
    """Write a fresh healing marker unless the drive carries one already
    (its checkpoint must survive). True when written."""
    if read_healing(disk) is not None:
        return False
    write_healing(disk, new_tracker(set_index, disk_index, endpoint))
    return True


def admission_pressure(admission) -> bool:
    """Whether an admission controller's snapshot shows clients queueing
    or a class at its limit: the bulk heal's signal to yield. None or a
    controller that cannot answer means no pressure."""
    if admission is None:
        return False
    try:
        snap = admission.snapshot()
    except Exception:  # noqa: BLE001 - controller mid-teardown
        return False
    for v in snap.values():
        if not isinstance(v, dict):
            continue
        if v.get("waiting", 0) > 0:
            return True
        limit = v.get("limit", 0)
        if limit and v.get("in_flight", 0) >= limit:
            return True
    return False


def bulk_heal_drive(es, disk_idx: int, tracker: dict,
                    stop: Optional[threading.Event] = None,
                    throttle: float = 0.0,
                    pressure: Optional[Callable[[], bool]] = None,
                    checkpoint_every: int = CHECKPOINT_EVERY) -> dict:
    """Refill drive `disk_idx` of set `es`: every bucket volume, then
    every version of every key, in key order from the tracker's
    checkpoint, through heal_object (reference cmd/global-heal.go
    healErasureSet). Updates and persists `tracker` as it goes; returns
    it finished, or checkpointed when `stop` fired."""
    from minio_tpu_torch.object.healing import heal_bucket, heal_object
    from minio_tpu_torch.object.scanner import (_walk_all_drives,
                                                key_version_ids)

    disk = es.disks[disk_idx]
    since_ckpt = 0

    def save(bucket: str = "", obj: str = "") -> None:
        if bucket:
            tracker["checkpoint_bucket"] = bucket
            tracker["checkpoint_object"] = obj
        try:
            write_healing(disk, tracker)
        except Exception:  # noqa: BLE001 - drive hiccup: next checkpoint
            pass

    ckpt_bucket = tracker.get("checkpoint_bucket", "")
    ckpt_object = tracker.get("checkpoint_object", "")
    try:
        buckets = sorted(b.name for b in es.list_buckets())
    except Exception:  # noqa: BLE001 - set unreadable: retry next poll
        return tracker
    for bucket in buckets:
        if bucket < ckpt_bucket:
            continue
        try:
            heal_bucket(es, bucket)
        except Exception:  # noqa: BLE001 - bucket gone mid-sweep
            continue
        forward = ckpt_object if bucket == ckpt_bucket else ""
        for path, copies in _walk_all_drives(es, bucket,
                                             forward_from=forward):
            if stop is not None and stop.is_set():
                save(bucket, path)
                return tracker
            while pressure is not None and pressure():
                # Clients are queueing: yield until the front end drains.
                if stop is not None and stop.is_set():
                    save(bucket, path)
                    return tracker
                time.sleep(0.05)
            tracker["objects_scanned"] += 1
            key_healed = False
            # Every version: a replaced drive gets old versions and delete
            # markers back too, not only the latest.
            for vid in key_version_ids(copies):
                try:
                    r = heal_object(es, bucket, path, vid)
                    if r.healed and disk_idx < len(r.after) \
                            and r.before[disk_idx] != r.after[disk_idx]:
                        key_healed = True
                        tracker["bytes_healed"] += r.size
                except Exception:  # noqa: BLE001 - scanner/MRF retry it
                    tracker["objects_failed"] += 1
                    break
            if key_healed:
                tracker["objects_healed"] += 1
            since_ckpt += 1
            if since_ckpt >= checkpoint_every:
                since_ckpt = 0
                save(bucket, path)
            if throttle:
                time.sleep(throttle)
        ckpt_object = ""
    tracker["finished"] = True
    tracker["finished_at"] = time.time()
    clear_healing(disk)
    return tracker


class DriveHealManager:
    """The process's drive lifecycle manager.

    poll_once() restores the format of fresh drives in formatted slots
    and starts (or, after a restart, resumes from its checkpoint) a bulk
    heal thread for every drive with an unfinished healing marker;
    start() polls on an interval."""

    def __init__(self, sets: Sequence, throttle: float = 0.001,
                 checkpoint_every: int = CHECKPOINT_EVERY,
                 pressure: Optional[Callable[[], bool]] = None,
                 total_hint: Optional[Callable[[], int]] = None):
        self.sets = list(sets)
        self.throttle = throttle
        self.checkpoint_every = checkpoint_every
        self.pressure = pressure
        self.total_hint = total_hint      # e.g. the scanner's object count
        self.formats_restored = 0
        self._mu = threading.Lock()
        # (set, drive) -> {"tracker": dict, "thread": Thread}
        self._active: dict[tuple, dict] = {}
        # Finished trackers, kept for the status.
        self._done: dict[tuple, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- detection -------------------------------------------------------

    def poll_once(self) -> int:
        """One pass: formats restored, bulk heals started or resumed.
        Returns the heals started."""
        from minio_tpu_torch.object.scanner import check_drive_formats
        try:
            self.formats_restored += check_drive_formats(self.sets)
        except Exception:  # noqa: BLE001 - the next poll retries
            pass
        started = 0
        for si, es in enumerate(self.sets):
            for di, d in enumerate(es.disks):
                tracker = read_healing(d)
                if tracker is None or tracker.get("finished"):
                    continue
                if self._ensure_heal(si, di, es, tracker):
                    started += 1
        return started

    def _ensure_heal(self, si: int, di: int, es, tracker: dict) -> bool:
        with self._mu:
            slot = self._active.get((si, di))
            if slot is not None and slot["thread"].is_alive():
                return False
            # The persisted indices are advisory: the manager's own
            # topology names the drive.
            tracker["set_index"] = si
            tracker["disk_index"] = di
            tracker["endpoint"] = getattr(es.disks[di], "endpoint", "") \
                or tracker.get("endpoint", "")
            t = threading.Thread(
                target=self._run_heal, args=(si, di, es, tracker),
                daemon=True, name=f"drive-heal-{si}-{di}")
            self._active[(si, di)] = {"tracker": tracker, "thread": t}
        t.start()
        return True

    def _run_heal(self, si: int, di: int, es, tracker: dict) -> None:
        try:
            bulk_heal_drive(es, di, tracker, stop=self._stop,
                            throttle=self.throttle, pressure=self.pressure,
                            checkpoint_every=self.checkpoint_every)
        except Exception:  # noqa: BLE001 - the next poll resumes it
            pass
        if tracker.get("finished"):
            with self._mu:
                self._active.pop((si, di), None)
                self._done[(si, di)] = tracker

    # -- introspection ---------------------------------------------------

    def status(self) -> dict:
        """One entry per healing or finished drive with its progress, and
        an ETA when an object-count hint is given."""
        total = 0
        if self.total_hint is not None:
            try:
                total = int(self.total_hint()) // max(len(self.sets), 1)
            except Exception:  # noqa: BLE001 - the hint is optional
                total = 0
        drives = []
        with self._mu:
            live = [(k, dict(v["tracker"]), v["thread"].is_alive())
                    for k, v in self._active.items()]
            done = [(k, dict(t)) for k, t in self._done.items()]
        for (si, di), tracker, alive in live:
            entry = dict(tracker, set=si, drive=di,
                         state="healing" if alive else "paused")
            scanned = tracker.get("objects_scanned", 0)
            elapsed = max(time.time() - tracker.get("started", 0), 1e-6)
            rate = scanned / elapsed
            if total and rate > 0:
                entry["eta_seconds"] = round(
                    max(total - scanned, 0) / rate, 1)
            drives.append(entry)
        for (si, di), tracker in done:
            drives.append(dict(tracker, set=si, drive=di, state="done"))
        return {"formats_restored": self.formats_restored,
                "drives": drives}

    def wait(self, timeout: float = 30.0) -> bool:
        """Block until every active bulk heal has ended."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._mu:
                threads = [v["thread"] for v in self._active.values()]
            if not any(t.is_alive() for t in threads):
                return True
            time.sleep(0.02)
        return False

    # -- lifecycle -------------------------------------------------------

    def start(self, interval: float = 10.0) -> None:
        if self._thread is not None:
            return

        def run():
            while not self._stop.wait(interval):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 - the manager survives
                    continue

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="drive-heal-manager")
        self._thread.start()

    def stop(self) -> None:
        """Stop polling and every bulk heal (each saves its checkpoint)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._mu:
            threads = [v["thread"] for v in self._active.values()]
        for t in threads:
            t.join(timeout=30)

"""Healing: rebuild missing, outdated or corrupt shards onto the drives
that lack them, and the MRF ("most recently failed") queue.

The port of minio_tpu/object/healing.py (reference
cmd/erasure-healing.go:296 healObject, cmd/mrf.go). heal_object
classifies each drive for the quorum version (the five DRIVE_STATE_*s),
rebuilds every lost shard, data and parity alike, from k verified
survivors, and commits the rebuilt shard files through the staged
rename_data a PUT uses, each drive with its own `erasure.index`. A
partial PUT, a multipart complete on fewer than n drives, a GET that
found a drive without the version and a degraded decode queue the
object on the set's MRFQueue, whose worker heals it in the background.

The JAX package loads whole parts on the host; here a heal runs on the
card window by window, as GET does, so memory grows with the window and
not with the object. For each window of STREAM_WINDOW_BLOCKS erasure
blocks of each part, every surviving shard's frames are scatter-read into
one pinned region and verified through the get batcher; the rows of the
bad shards (decode rows times coding rows, one gf_apply launch for every
bad shard) rebuild them through the reconstruct batcher; the rebuilt
blocks are hashed with highwayhash256 and appended, framed
`digest || block`, to each bad drive's staged shard file. A survivor
that fails its digest in some window is marked corrupt and the pass
starts again with it among the bad drives, so the verdicts and the
bytes equal the JAX package's.

A heal that changed drive journals bumps the bucket in the set's
metacache (both sites of the JAX package: a rebuild or a metadata copy
that healed drives, and the purge of a dangling version), so no cached
listing outlives it. Not ported yet: the tiered-version branch (it
waits for tiering).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import queue
import threading
import time

import numpy as np

from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.io.bufpool import global_pool
from minio_tpu_torch.object.erasure_object import (DIGEST, STAGING_PREFIX,
                                                   STREAM_WINDOW_BLOCKS,
                                                   hold_past, rebuild_rows)
from minio_tpu_torch.object.types import ObjectNotFound, ReadQuorumError
from minio_tpu_torch.ops import hh_device
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.storage.meta import (FileInfo, FileNotFoundErr,
                                          ObjectPartInfo, VersionNotFoundErr,
                                          new_uuid)
from minio_tpu_torch.utils.highwayhash import MAGIC_KEY

DRIVE_STATE_OK = "ok"
DRIVE_STATE_OFFLINE = "offline"
DRIVE_STATE_MISSING = "missing"
DRIVE_STATE_OUTDATED = "outdated"
DRIVE_STATE_CORRUPT = "corrupt"

_GONE = (FileNotFoundErr, VersionNotFoundErr)


@dataclasses.dataclass
class HealResult:
    bucket: str
    object: str
    version_id: str = ""
    before: list = dataclasses.field(default_factory=list)
    after: list = dataclasses.field(default_factory=list)
    healed: int = 0
    data_blocks: int = 0
    parity_blocks: int = 0
    size: int = 0                 # logical object bytes


def heal_object(es, bucket: str, object_: str, version_id: str = "",
                deep: bool = False) -> HealResult:
    """Heal one version of one object across the set's drives, under the
    key's lock (reference healObject's NSLock,
    cmd/erasure-healing.go:323), so a heal never races a commit.

    Normal mode (deep=False) classifies shard files by stat, existence
    and exact framed size, and reads only when a rebuild is needed; deep
    mode reads and verifies every block of every surviving shard."""
    with es.ns.write(bucket, object_):
        return _heal_object_locked(es, bucket, object_, version_id, deep)


class HealStopped(Exception):
    """A heal given up between windows because its MRF queue stops; its
    staged shards are cleared and its key stays pending."""


def _heal_object_locked(es, bucket: str, object_: str, version_id: str,
                        deep: bool, stop=None) -> HealResult:
    fis, errors = es._read_version_all(bucket, object_, version_id,
                                       read_data=True)
    n = len(es.disks)
    not_found = sum(isinstance(e, _GONE) for e in errors)
    if not_found > n // 2:
        return _heal_dangling(es, bucket, object_, version_id, fis,
                              not_found)
    result = _heal_present(es, bucket, object_, fis, errors, deep, stop)
    if result.healed:
        # Drive journals changed under the key: orphan the bucket's
        # listing walks.
        es.metacache.bump(bucket)
    return result


def _heal_present(es, bucket: str, object_: str, fis: list, errors: list,
                  deep: bool, stop) -> HealResult:
    """Heal the quorum version a majority of drives holds."""
    n = len(es.disks)
    if all(f is None for f in fis):
        raise ObjectNotFound(bucket, object_)
    fi = es._pick_quorum(fis, es._read_quorum(fis, n))
    if fi is None:
        raise ReadQuorumError(bucket, object_)
    if fi.deleted:
        # Delete markers heal by replicating the journal entry.
        return _heal_metadata_only(es, bucket, object_, fi, fis, errors)

    k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
    e = Erasure(k, m, fi.erasure.block_size, backend=es.backend)
    ss = e.shard_size()
    inline = fi.inline_data is not None
    dist = fi.erasure.distribution
    parts = fi.parts or [ObjectPartInfo(number=1, size=fi.size,
                                        actual_size=fi.size)]

    def stat_all_parts(i: int) -> bool:
        """Every shard file exists with its exact framed size."""
        try:
            for p in parts:
                want = bitrot.shard_file_size(e.shard_file_size(p.size), ss)
                if inline:
                    if len(fis[i].inline_data or b"") != want:
                        return False
                elif es.disks[i].stat_info_file(
                        bucket, f"{object_}/{fi.data_dir}/part.{p.number}"
                        ).st_size != want:
                    return False
            return True
        except Exception:  # noqa: BLE001 - unstattable == corrupt
            return False

    states = [DRIVE_STATE_OFFLINE] * n
    to_stat = []
    for i in range(n):
        dfi = fis[i]
        if isinstance(errors[i], _GONE):
            states[i] = DRIVE_STATE_MISSING
        elif dfi is None:
            states[i] = DRIVE_STATE_OFFLINE
        elif (dfi.mod_time, dfi.data_dir) != (fi.mod_time, fi.data_dir) \
                or dfi.deleted != fi.deleted:
            states[i] = DRIVE_STATE_OUTDATED
        else:
            states[i] = DRIVE_STATE_OK
            if fi.size:
                to_stat.append(i)
    stats, _ = es._fanout([functools.partial(stat_all_parts, i)
                           if i in to_stat else None for i in range(n)])
    for i in to_stat:
        if not stats[i]:
            states[i] = DRIVE_STATE_CORRUPT

    result = HealResult(bucket=bucket, object=object_,
                        version_id=fi.version_id, before=list(states),
                        data_blocks=k, parity_blocks=m, size=fi.size)
    bad = [i for i in range(n) if states[i] in
           (DRIVE_STATE_MISSING, DRIVE_STATE_OUTDATED, DRIVE_STATE_CORRUPT)]
    if not bad and not (deep and fi.size):
        result.after = list(states)
        return result

    staging = f"{STAGING_PREFIX}/h{os.getpid()}-{new_uuid()}"
    frames: dict[int, bytearray] = {}
    try:
        if fi.size:
            while True:
                # A survivor that fails a digest anywhere is corrupt:
                # start again with it among the drives to rebuild.
                frames = {i: bytearray() for i in bad} if inline else {}
                newly = _rebuild_pass(es, bucket, object_, fi, fis, states,
                                      bad, parts, e, staging, frames, stop)
                if not newly:
                    break
                for i in newly:
                    states[i] = result.before[i] = DRIVE_STATE_CORRUPT
                bad = sorted(bad + newly)
                if not inline:
                    _clear_staging(es, staging, bad)
        if not bad:                      # deep mode found nothing wrong
            result.after = list(states)
            return result

        def heal_one(i: int) -> None:
            d = es.disks[i]
            hfi = dataclasses.replace(
                fi, metadata=dict(fi.metadata), parts=list(fi.parts),
                erasure=dataclasses.replace(fi.erasure, index=dist[i]),
                inline_data=None)
            if fi.size == 0:
                hfi.inline_data = b"" if inline else None
                d.write_metadata(bucket, object_, hfi)
            elif inline:
                hfi.inline_data = bytes(frames[i])
                d.write_metadata(bucket, object_, hfi)
            else:
                d.rename_data(SYS_VOL, staging, hfi, bucket, object_)

        _, herrs = es._fanout([functools.partial(heal_one, i)
                               if i in bad else None for i in range(n)])
    finally:
        if fi.size and not inline:
            _clear_staging(es, staging, bad)
    after = list(states)
    for i in bad:
        if herrs[i] is None:
            after[i] = DRIVE_STATE_OK
            result.healed += 1
    result.after = after
    return result


def _clear_staging(es, staging: str, drives) -> None:
    def clear(d):
        try:
            d.delete(SYS_VOL, staging, recursive=True)
        except Exception:  # noqa: BLE001 - absent or already committed
            pass
    es._fanout([functools.partial(clear, d) if i in drives else None
                for i, d in enumerate(es.disks)])


def _rebuild_pass(es, bucket: str, object_: str, fi: FileInfo, fis: list,
                  states: list, bad: list, parts: list, e: Erasure,
                  staging: str, frames: dict, stop) -> list[int]:
    """One windowed pass over every part: read and verify every
    surviving shard, rebuild the bad drives' shards on the card and
    append them, framed, to their staged shard files (`frames` for an
    inline object). Returns the survivors found corrupt on the way,
    at the first window that shows any (nothing rebuilt is kept then).
    Raises HealStopped before a window once `stop` (an Event) is set."""
    k, m = e.data_blocks, e.parity_blocks
    n = k + m
    ss = e.shard_size()
    frame = DIGEST + ss
    dist = fi.erasure.distribution
    surv = sorted((i for i in range(n) if states[i] == DRIVE_STATE_OK),
                  key=lambda i: dist[i])
    if bad and len(surv) < k:
        raise ReadQuorumError(bucket, object_, "not enough shards to heal")
    use = tuple(dist[i] - 1 for i in surv[:k])          # shard indices
    targets = tuple(sorted(dist[i] - 1 for i in bad))
    bad_of = {dist[i] - 1: i for i in bad}               # shard -> drive
    inline = fi.inline_data is not None
    pool = global_pool(es.device)

    for p in parts:
        plen = e.shard_file_size(p.size)
        nblocks = -(-plen // ss)
        path = f"{staging}/{fi.data_dir}/part.{p.number}"
        if not nblocks and bad and not inline:
            es._fanout([functools.partial(d.create_file, SYS_VOL, path, [])
                        if i in bad else None
                        for i, d in enumerate(es.disks)])
        for b0 in range(0, nblocks, STREAM_WINDOW_BLOCKS):
            if stop is not None and stop.is_set():
                raise HealStopped(bucket, object_)
            nb = min(nblocks, b0 + STREAM_WINDOW_BLOCKS) - b0
            win_len = min(plen, (b0 + nb) * ss) - b0 * ss
            tail = win_len - (nb - 1) * ss
            full, tail = (nb, 0) if tail == ss else (nb - 1, tail)
            tframe = DIGEST + tail if tail else 0
            lease, fa, ta, got = es._read_shards(
                bucket, object_, fi, fis, p.number, surv, b0 * frame, full,
                tframe)
            leases = [lease]
            try:
                ok = es._verify_framed(fa, ta, k, m, batched=True)
                newly = [i for j, i in enumerate(surv)
                         if not (got[j] and ok[j])]
                if newly:
                    return newly
                if not targets:
                    continue
                pos = {dist[i] - 1: j for j, i in enumerate(surv)}
                rows, tails = _rebuild_window(es, fa, ta, pos, use, targets,
                                              k, m, full, tail, ss, pool,
                                              leases)
                pieces = {s: [] for s in targets}
                for r, s in enumerate(targets):
                    for b in range(full):
                        pieces[s] += [rows[0][b, r], rows[1][b, r]]
                    if tail:
                        pieces[s] += [tails[0][r], tails[1][r]]
                if inline:
                    for s in targets:
                        frames[bad_of[s]] += b"".join(
                            bytes(memoryview(x)) for x in pieces[s])
                    continue
                _, werrs = es._fanout([
                    functools.partial(d.create_file, SYS_VOL, path,
                                      pieces[dist[i] - 1], append=b0 > 0)
                    if i in bad else None for i, d in enumerate(es.disks)])
                for x in werrs:
                    if x is not None:
                        hold_past(x, leases)
                failed = next((x for x in werrs if x is not None), None)
                if failed is not None:
                    raise failed
            finally:
                for h in leases:
                    h.release()
    return []


def _rebuild_window(es, fa: np.ndarray, ta: np.ndarray, pos: dict,
                    use: tuple, targets: tuple, k: int, m: int, full: int,
                    tail: int, ss: int, pool, leases: list) -> tuple:
    """Rebuild the `targets` shards of one window from the survivors
    `use` (shard indices; pos maps a shard to its column of the verified
    region): ((digests [full, r, 32], blocks [full, r, ss]), (digests
    [r, 32], ragged blocks [r, tail])). The full blocks go through the
    reconstruct batcher of (use, targets) from a pinned stack, the
    ragged tail through gf_apply directly; every rebuilt block is hashed
    on the card."""
    r = len(targets)
    blocks = digs = tblocks = tdigs = None
    if full:
        lease = pool.lease(full * k * ss)
        leases.append(lease)
        stacked = lease.ndarray((full, k, ss))
        for j, s in enumerate(use):
            stacked[:, j] = fa[:, pos[s], DIGEST:]
        sb = es._batcher("reconstruct", k, m, use, targets)
        blocks = sb.frame(stacked)                           # [full, r, ss]
        es._count("reconstruct", sb.last_route())
        digs = hh_device.hash_blocks_device(
            MAGIC_KEY, blocks.reshape(full * r, ss),
            device=es.device).reshape(full, r, DIGEST)
    if tail:
        tblocks = es.backend.apply_matrix(
            rebuild_rows(k, m, use, targets),
            np.stack([ta[pos[s], DIGEST:] for s in use]))
        tdigs = hh_device.hash_blocks_device(MAGIC_KEY, tblocks,
                                             device=es.device)
    return (digs, blocks), (tdigs, tblocks)


def _heal_dangling(es, bucket: str, object_: str, version_id: str,
                   fis: list, not_found: int) -> HealResult:
    """A majority of drives lacks the version. Purge the stale copies only
    when they can never satisfy read quorum again: not-found must exceed
    the version's parity count, not only a majority (reference
    deleteIfDangling, cmd/erasure-object.go:484), so a quorum-thin but
    valid write heals instead of vanishing."""
    n = len(es.disks)
    stale = [i for i in range(n) if fis[i] is not None]
    purge = False
    if stale:
        # The parity bound comes from the most redundant data version a
        # stale drive holds; with only delete markers a majority decides.
        ks = [fis[i].erasure.data_blocks for i in stale
              if not fis[i].deleted and fis[i].erasure.data_blocks]
        purge = not_found > max(n // 2, n - min(ks)) if ks else True
    if stale and purge:
        def drop(i):
            try:
                es.disks[i].delete_version(bucket, object_,
                                           fis[i].version_id)
            except Exception:  # noqa: BLE001 - best-effort purge
                pass
        es._fanout([functools.partial(drop, i) if i in stale else None
                    for i in range(n)])
        es.metacache.bump(bucket)
    result = HealResult(bucket=bucket, object=object_,
                        version_id=version_id)
    result.before = [DRIVE_STATE_OUTDATED if i in stale
                     else DRIVE_STATE_MISSING for i in range(n)]
    if purge:
        result.after = [DRIVE_STATE_MISSING] * n
        result.healed = len(stale)
    else:
        result.after = list(result.before)
    return result


def _heal_metadata_only(es, bucket: str, object_: str, fi: FileInfo,
                        fis: list, errors: list) -> HealResult:
    """Replicate a version that holds no data (a delete marker) to the
    drives that miss it or hold an older one."""
    n = len(es.disks)
    states = []
    for i in range(n):
        if fis[i] is not None and fis[i].mod_time == fi.mod_time \
                and fis[i].deleted == fi.deleted:
            states.append(DRIVE_STATE_OK)
        elif isinstance(errors[i], _GONE):
            states.append(DRIVE_STATE_MISSING)
        else:
            states.append(DRIVE_STATE_OUTDATED if fis[i] is not None
                          else DRIVE_STATE_OFFLINE)
    result = HealResult(bucket=bucket, object=object_,
                        version_id=fi.version_id, before=list(states))
    bad = [i for i in range(n) if states[i] in (DRIVE_STATE_MISSING,
                                                DRIVE_STATE_OUTDATED)]
    _, herrs = es._fanout([
        functools.partial(es.disks[i].write_metadata, bucket, object_, fi)
        if i in bad else None for i in range(n)])
    after = list(states)
    for i in bad:
        if herrs[i] is None:
            after[i] = DRIVE_STATE_OK
            result.healed += 1
    result.after = after
    return result


def heal_bucket(es, bucket: str) -> dict:
    """Recreate the bucket's volume on the drives that miss it."""
    results, _ = es._fanout([functools.partial(d.stat_vol, bucket)
                             for d in es.disks])
    missing = [i for i, r in enumerate(results) if r is None]
    if len(missing) == len(es.disks):
        raise ObjectNotFound(bucket, "")
    _, herrs = es._fanout([
        functools.partial(es.disks[i].make_vol_if_missing, bucket)
        if i in missing else None for i in range(len(es.disks))])
    return {"bucket": bucket, "missing": len(missing),
            "healed": sum(1 for i in missing if herrs[i] is None)}


MRF_PATH = "mrf/pending.json"
MRF_MAX_ITEMS = 100_000           # the bounded queue; the rest spills
MRF_RETRIES = 3                   # heal attempts before an entry is dropped


class MRFQueue:
    """The most-recently-failed heal queue (reference cmd/mrf.go): objects
    that a partial write or a degraded read left short of n good shards
    are healed in the background, deeply, by one worker thread.

    The queue is bounded; an entry that does not fit spills into the
    pending set and is fed in as the queue drains. A key already waiting
    in the queue, or being healed, is not queued again: one degraded GET
    of many windows makes one heal. A heal that fails is retried with a
    backoff, then dropped. stop() gives up a heal in flight before its
    next window and keeps its key pending. Pending entries persist to
    `mrf/pending.json` on the system volume of every drive (the JAX
    package's file, as it stands) whenever the queue has been dirty for a
    moment and at stop(), and are reloaded at boot from the union of the
    drives' copies."""

    _PERSIST_EVERY = 2.0

    def __init__(self, es):
        self.es = es
        self.q: "queue.Queue[tuple]" = queue.Queue(maxsize=MRF_MAX_ITEMS)
        self.healed = 0
        # `spilled`: overflow parked in the pending set (nothing lost);
        # `dropped`: retries exhausted, the heal is gone.
        self.spilled = 0
        self.dropped = 0
        # (bucket, object, version id) -> in the bounded queue or being
        # healed? (False: spilled, fed in as the queue drains)
        self._pending: dict[tuple, bool] = {}
        self._dirty = False
        self._last_save = 0.0
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._load()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mrf-heal")
        self._worker.start()

    def enqueue(self, bucket: str, object_: str, version_id: str = "") -> None:
        key = (bucket, object_, version_id)
        with self._mu:
            if self._pending.get(key):
                return
            self._pending[key] = True
            self._dirty = True
        try:
            self.q.put_nowait((bucket, object_, version_id, 0))
        except queue.Full:
            self.spilled += 1
            with self._mu:
                self._pending[key] = False

    # -- persistence ----------------------------------------------------

    def _load(self) -> None:
        # The union across drives: a heal recorded by any drive replays
        # (heals are idempotent; losing one is worse than running twice).
        entries: dict[tuple, int] = {}
        for d in self.es.disks:
            try:
                items = json.loads(d.read_all(SYS_VOL, MRF_PATH))
            except Exception:  # noqa: BLE001 - absent or unreadable
                continue
            for it in items:
                try:
                    entries[(it["b"], it["o"], it.get("v", ""))] = 1
                except (TypeError, KeyError):
                    continue
        for key in entries:
            self._pending[key] = True
            try:
                self.q.put_nowait((*key, 0))
            except queue.Full:
                self.spilled += 1
                self._pending[key] = False

    def _save(self) -> None:
        with self._mu:
            items = [{"b": b, "o": o, "v": v} for (b, o, v) in self._pending]
            self._dirty = False
        blob = json.dumps(items).encode()

        def write(d):
            try:
                d.write_all(SYS_VOL, MRF_PATH, blob)
            except Exception:  # noqa: BLE001 - best effort
                pass
        self.es._fanout([functools.partial(write, d) for d in self.es.disks])

    def _maybe_persist(self) -> None:
        now = time.time()
        if self._dirty and now - self._last_save >= self._PERSIST_EVERY:
            self._last_save = now
            self._save()

    def save_now(self) -> None:
        """Write the pending entries to the drives now."""
        self._save()

    # -- worker ---------------------------------------------------------

    def _refill_one(self) -> None:
        """Move one spilled pending entry into the queue, now that it has
        room."""
        with self._mu:
            key = next((key for key, queued in self._pending.items()
                        if not queued), None)
            if key is None:
                return
            self._pending[key] = True
        try:
            self.q.put_nowait((*key, 0))
        except queue.Full:
            with self._mu:
                if key in self._pending:
                    self._pending[key] = False

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._maybe_persist()
            except Exception:  # noqa: BLE001 - e.g. pools torn down at exit
                pass
            try:
                bucket, object_, vid, attempt = self.q.get(timeout=0.2)
            except queue.Empty:
                self._refill_one()
                continue
            key = (bucket, object_, vid)
            try:
                # MRF entries come from observed failures: verify deeply.
                # The key leaves the pending set under its lock, so a
                # commit that lands after the heal queues it again.
                with self.es.ns.write(bucket, object_):
                    _heal_object_locked(self.es, bucket, object_, vid,
                                        True, self._stop)
                    with self._mu:
                        self._pending.pop(key, None)
                        self._dirty = True
                self.healed += 1
            except Exception:  # noqa: BLE001 - retry with backoff, then drop
                if self._stop.is_set():
                    pass                 # stays pending: saved at stop()
                elif attempt + 1 < MRF_RETRIES:
                    time.sleep(min(2 ** attempt * 0.05, 1.0))
                    try:
                        self.q.put_nowait((*key, attempt + 1))
                    except queue.Full:
                        self.spilled += 1
                        with self._mu:
                            if key in self._pending:
                                self._pending[key] = False
                else:
                    self.dropped += 1
                    with self._mu:
                        self._pending.pop(key, None)
                        self._dirty = True
            finally:
                self.q.task_done()

    def stats(self) -> dict:
        with self._mu:
            return {"healed": self.healed, "spilled": self.spilled,
                    "dropped": self.dropped, "pending": len(self._pending)}

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until the queued and in-flight heals are done; whether
        they were within `timeout` seconds."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.q.unfinished_tasks == 0:
                return True
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        """Stop the worker (a heal in flight gives up before its next
        window) and save what is pending."""
        self._stop.set()
        self._worker.join()
        try:
            self._save()
        except Exception:  # noqa: BLE001 - shutdown best effort
            pass

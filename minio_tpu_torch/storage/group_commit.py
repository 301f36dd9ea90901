"""Group-committed small writes: per-drive commit lanes with a WAL.

The port of minio_tpu/storage/group_commit.py. Every small (inline) PUT
and every delete marker commits one version into the journal of its key
on every drive: a journal read-modify-write plus a tmp write, an
fdatasync and a rename. N concurrent small objects are N durable commits
a drive. The lanes coalesce them: concurrent write_metadata /
rename_data ops bound for one drive gather into one batch (an adaptive
window, closed early once every request in its commit section has a
member pending, at the earliest member deadline, or at
MTPU_GROUP_COMMIT_MAX members) and commit as ONE journal pass on the
drive (storage/local.LocalStorage.commit_group): one journal rewrite a
distinct object, ONE write-ahead frame of every merged journal made
durable by ONE fdatasync, then the journals renamed into place without a
sync of their own.

Each lane has one commit thread of its own. It gathers a window, runs
the batch on its drive, and only then gathers the next one, so members
that arrive during a commit join the next batch instead of queueing
behind it as batches of one. The JAX package runs its batches on the
set's drive queues instead, where the adaptive window has two steady
states under one load: on an H100 host (8 cores, one queue worker a
drive) 16 writers ran at 1.05 and at 14.7-15.7 members a batch from one
run to the next (PERF.md, `where_time_goes`).

A member is acked only once its batch's frame is durable, so an
acknowledged write is in its journal or in a WAL that the next boot
replays (`replay_wals`, run first by storage/local.recovery_sweep). A
journal torn by a power cut is repaired from the frame; replay never
rolls a newer journal back and never brings a deleted object back.

Each batch keeps the journals it replaces (PREV_FILE,
storage/local.commit_group `keep_prev`) until write quorum is known:
the request posts its verdict to each of its members, and once every
member of a batch has one, the lane's thread settles the batch with ONE
drive call (LocalStorage.settle_prevs); the request returns only then,
still under its key's lock. A request whose deadline passes takes its
members that no batch has taken off their lanes and still waits for the
batches that hold the rest (the drive's own timeout bounds them): no
commit or settle of its key lands after it lets the key's lock go. A
cut between the drives of a batch thus never leaves an overwritten
object without its old version at read quorum: the recovery sweep
reports each kept journal, and the heal settles it.

While tracing is armed ONE `commit.group` storage span a batch is
fanned into every member's trace tree (utils/tracing.record_into, as
the batcher's kernel span is).
Every MTPU_GROUP_COMMIT_CKPT_S seconds ONE process-wide coordinator
thread runs os.sync and truncates the WALs whose frames it covered.

A batch that fails on its drive demotes each of its members, alone, to
the solo path (write_metadata / rename_data), counted in
`solo_demotions`, except after a power cut (storage/local.PowerFault):
the node is gone, so no member is acked and each gets the fault. A
member whose deadline passed before its batch ran fails alone with
DeadlineExceeded (`deadline_culls`), as does one its request took off
its lane when the deadline passed. `bump` (the
set's MetaCache.bump) fires once per batch per bucket BEFORE any member
is acked.

WAL frame layout (a binary record list where the JAX package packs
msgpack; one file a drive a process, `.mtpu.sys/gcommit/wal-p<pid>.log`):

    GC_MAGIC | crc32(body) u32 | body = t_ns u64 | len u32 | payload
    payload = count u32, then per record:
              len u16 + volume | len u32 + path | len u32 + journal

t_ns is the frame's creation time: every journal of the batch is renamed
in after it, which replay's newer-wins comparison relies on. The crc
makes a torn tail frame evident; it is discarded, and it protected no
acked member.

Environment:
  MTPU_GROUP_COMMIT          on|off (default on)
  MTPU_GROUP_COMMIT_WAIT_MS  the longest accumulation window (30)
  MTPU_GROUP_COMMIT_MAX      members a drive batch at most (128)
  MTPU_GROUP_COMMIT_CKPT_S   seconds between WAL checkpoints (2)
"""

from __future__ import annotations

import os
import struct
import threading
import time
import uuid as uuid_mod
import weakref
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

from minio_tpu_torch.storage.local import PowerFault
from minio_tpu_torch.utils import deadline as deadline_mod
from minio_tpu_torch.utils import tracing
from minio_tpu_torch.utils.deadline import DeadlineExceeded
from minio_tpu_torch.utils.env import env_float, env_int
from minio_tpu_torch.utils.latency import Histogram

GC_DIR = "gcommit"
GC_MAGIC = b"GCW1"

# A member must dispatch at least this long before its deadline: the
# commit (merges, WAL fsync, renames) must fit in what remains.
_DEADLINE_SLACK_S = 0.005
_MIN_WAIT_S = 0.00025
# An idle lane's commit thread exits after this long with no request
# tracked; the next member starts another.
_IDLE_S = 0.2


def enabled() -> bool:
    return os.environ.get("MTPU_GROUP_COMMIT", "on").lower() \
        not in ("0", "off", "false")


def base_wait_s() -> float:
    """The longest accumulation window. The early-close rule dispatches
    long before it whenever submitters keep up; it binds only at
    saturation."""
    return env_float("MTPU_GROUP_COMMIT_WAIT_MS", 30.0) / 1000.0


def max_members() -> int:
    return env_int("MTPU_GROUP_COMMIT_MAX", 128)


def ckpt_interval_s() -> float:
    return env_float("MTPU_GROUP_COMMIT_CKPT_S", 2.0)


# -- WAL retirement: the checkpoint coordinator --------------------------------
# A batch's WAL frame may go only once its renamed journals are durable.
# One process-wide thread makes everything durable with one os.sync per
# interval (the sync is global: one call covers every drive), then
# truncates the WALs it covered. A WAL that outlives its process
# (SIGKILL before the interval) is replayed at the next boot.

_co_mu = threading.Lock()
_co_disks: "weakref.WeakSet" = weakref.WeakSet()
_co_thread: Optional[threading.Thread] = None
checkpoints_total = 0
wals_retired_total = 0


def schedule_checkpoint(disk) -> None:
    """Register `disk` (a LocalStorage with WAL frames pending) with the
    coordinator, starting it when it is not running."""
    global _co_thread
    with _co_mu:
        _co_disks.add(disk)
        if _co_thread is None or not _co_thread.is_alive():
            _co_thread = threading.Thread(target=_co_loop, daemon=True,
                                          name="gc-checkpoint")
            _co_thread.start()


def _co_loop() -> None:
    global _co_thread, checkpoints_total, wals_retired_total
    idle = 0
    while True:
        time.sleep(ckpt_interval_s())
        with _co_mu:
            disks = list(_co_disks)
        dirty = [d for d in disks if d.gc_pending()]
        if not dirty:
            idle += 1
            if idle >= 3:
                with _co_mu:
                    # Exit only when nothing arrived since the scan: an
                    # append re-pokes through schedule_checkpoint, which
                    # sees the dead thread and starts another.
                    if not any(d.gc_pending() for d in _co_disks):
                        _co_thread = None
                        return
                idle = 0
            continue
        idle = 0
        # Each drive's frame count BEFORE the sync, taken only when
        # every frame's journals have been written (gc_covered; else 0,
        # and the drive waits for the next checkpoint): frames appended
        # after it were not covered, and the guarded truncate skips a
        # drive whose count moved.
        pre = {id(d): d.gc_covered() for d in dirty}
        try:
            os.sync()
        except OSError:
            pass
        frames = 0
        for d in dirty:
            try:
                frames += d.gc_truncate_wal(expect=pre[id(d)])
            except Exception:  # noqa: BLE001 - drive gone mid-checkpoint
                pass
        with _co_mu:
            checkpoints_total += 1
            wals_retired_total += frames


@dataclass
class GroupOp:
    """One member of a drive's commit batch."""
    kind: str                  # "wm" (write_metadata) | "rd" (rename_data)
    volume: str
    path: str
    fi: object                 # storage.meta.FileInfo
    src_volume: str = ""       # rename_data's staging source
    src_path: str = ""

    @classmethod
    def write_meta(cls, volume, path, fi) -> "GroupOp":
        return cls("wm", volume, path, fi)

    @classmethod
    def rename(cls, src_volume, src_path, fi, volume, path) -> "GroupOp":
        return cls("rd", volume, path, fi, src_volume=src_volume,
                   src_path=src_path)


# -- WAL encode / decode / replay ------------------------------------------------

_FRAME_HEAD = struct.Struct("<I")        # crc32 over the body
_FRAME_BODY_HEAD = struct.Struct("<QI")  # t_ns, payload length
_HEAD_LEN = 4 + _FRAME_HEAD.size + _FRAME_BODY_HEAD.size


def wal_file_path(root: str) -> str:
    from minio_tpu_torch.storage.local import SYS_VOL
    return os.path.join(root, SYS_VOL, GC_DIR, f"wal-p{os.getpid()}.log")


def _pack_records(recs) -> bytes:
    parts = [struct.pack("<I", len(recs))]
    for vol, path, blob in recs:
        v, p = vol.encode(), path.encode()
        parts += [struct.pack("<H", len(v)), v, struct.pack("<I", len(p)), p,
                  struct.pack("<I", len(blob)), bytes(blob)]
    return b"".join(parts)


def _unpack_records(payload: bytes) -> list:
    """The records of a payload; ValueError when it does not decode."""
    try:
        (count,), off = struct.unpack_from("<I", payload), 4
        out = []
        for _ in range(count):
            (lv,) = struct.unpack_from("<H", payload, off)
            vol = payload[off + 2:off + 2 + lv].decode()
            off += 2 + lv
            (lp,) = struct.unpack_from("<I", payload, off)
            path = payload[off + 4:off + 4 + lp].decode()
            off += 4 + lp
            (lb,) = struct.unpack_from("<I", payload, off)
            blob = payload[off + 4:off + 4 + lb]
            if len(blob) != lb:
                raise ValueError("short record")
            off += 4 + lb
            out.append((vol, path, blob))
    except (struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"undecodable WAL payload: {e}") from None
    if off != len(payload):
        raise ValueError("trailing bytes in WAL payload")
    return out


def encode_frame(recs: list[tuple[str, str, bytes]],
                 t_ns: Optional[int] = None) -> bytes:
    payload = _pack_records(recs)
    body = _FRAME_BODY_HEAD.pack(
        time.time_ns() if t_ns is None else t_ns, len(payload)) + payload
    return GC_MAGIC + _FRAME_HEAD.pack(zlib.crc32(body)) + body


def iter_frames(blob: bytes):
    """Yield (t_ns, records) of every intact frame; stop at the first
    torn or alien bytes (appends are ordered: nothing after a torn frame
    is reachable). The generator's return value, carried on
    StopIteration, is the number of discarded tails (0 or 1)."""
    off, n = 0, len(blob)
    while off + _HEAD_LEN <= n:
        if blob[off:off + 4] != GC_MAGIC:
            return 1
        (crc,) = _FRAME_HEAD.unpack_from(blob, off + 4)
        _t, plen = _FRAME_BODY_HEAD.unpack_from(blob, off + 8)
        end = off + _HEAD_LEN + plen
        if end > n:
            return 1
        body = blob[off + 8:end]
        if zlib.crc32(body) != crc:
            return 1
        try:
            recs = _unpack_records(body[_FRAME_BODY_HEAD.size:])
        except ValueError:
            return 1
        yield _t, recs
        off = end
    return 1 if off < n else 0


def _wal_improves(dest_blob: bytes, jblob: bytes) -> bool:
    """Whether the WAL's journal holds a version the destination lacks or
    holds at an older mod time, i.e. installing it adds committed state
    instead of rolling newer state back. Unparsable input answers True
    (the torn-destination repair)."""
    from minio_tpu_torch.storage.meta import XLMeta
    try:
        dest = XLMeta.load(dest_blob)
        wal = XLMeta.load(jblob)
    except Exception:  # noqa: BLE001 - torn either side: repair
        return True
    have = {v.get("vid"): v.get("mt", 0) for v in dest.versions}
    return any(have.get(v.get("vid"), -1) < v.get("mt", 0)
               for v in wal.versions)


def replay_wals(disk) -> dict:
    """Boot-time WAL replay of one drive: complete or repair the group
    commits a crash interrupted. Every intact frame of the drive's WAL
    files is read, the records sorted by frame time, and each journal is
    installed, with a real fdatasync, when its destination is missing,
    unparsable (torn), or older than the frame and improved by it
    (`_wal_improves`). A destination newer than the frame is a later
    committed write and stays; a record whose whole object dir is gone
    is a later delete and is not brought back. Torn tail frames are
    discarded. The WAL files are removed afterwards; replaying a batch
    that had already landed changes nothing. Returns {"replayed"
    (frames read), "repaired" (journals installed), "discarded" (torn
    tails)}."""
    from minio_tpu_torch.storage.local import META_FILE, SYS_VOL
    from minio_tpu_torch.storage.meta import XLMeta
    out = {"replayed": 0, "repaired": 0, "discarded": 0}
    gdir = os.path.join(disk.root, SYS_VOL, GC_DIR)
    try:
        names = sorted(os.listdir(gdir))
    except (FileNotFoundError, NotADirectoryError):
        return out
    entries: list[tuple[int, str, str, bytes]] = []
    for name in names:
        full = os.path.join(gdir, name)
        if not name.startswith("wal-"):
            # A stray temp file of an interrupted replay.
            try:
                os.remove(full)
            except OSError:
                pass
            continue
        try:
            with open(full, "rb") as f:
                blob = f.read()
        except OSError:
            continue
        it = iter_frames(blob)
        while True:
            try:
                t_ns, recs = next(it)
            except StopIteration as stop:
                out["discarded"] += stop.value or 0
                break
            out["replayed"] += 1
            entries += [(t_ns, vol, path, jblob) for vol, path, jblob in recs]
    # Frame-time order across files: for one object the newest frame wins.
    entries.sort(key=lambda e: e[0])
    for t_ns, vol, path, jblob in entries:
        obj_dir = os.path.join(disk.root, vol, path)
        dest = os.path.join(obj_dir, META_FILE)
        if not os.path.isdir(obj_dir):
            continue            # deleted after the batch: never resurrect
        try:
            st = os.stat(dest)
            with open(dest, "rb") as f:
                dest_blob = f.read()
            if st.st_mtime_ns < t_ns:
                # Looks older than the batch (its rename lost), but an
                # mtime can lie (coarse clocks, a clock step): install
                # only when the frame adds what the destination lacks.
                install = _wal_improves(dest_blob, jblob)
            else:
                XLMeta.load(dest_blob)
                install = False
        except FileNotFoundError:
            install = True              # the rename never landed
        except Exception:  # noqa: BLE001 - unreadable == torn: repair
            install = True
        if install:
            tmp = os.path.join(gdir, f"replay-{uuid_mod.uuid4().hex}")
            try:
                with open(tmp, "wb") as f:
                    f.write(jblob)
                    f.flush()
                    os.fdatasync(f.fileno())
                os.replace(tmp, dest)
                out["repaired"] += 1
            except OSError:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    for name in names:
        if name.startswith("wal-"):
            try:
                os.remove(os.path.join(gdir, name))
            except OSError:
                pass
    return out


# -- the process's lanes, summed (the metrics render and admin info) ---------

_REGISTRY: "weakref.WeakSet[GroupCommit]" = weakref.WeakSet()
_SUMMED = ("batches", "members", "solo_bypass", "objects", "merged_members",
           "noop_skips", "fsyncs_saved", "deadline_culls", "solo_demotions",
           "settle_calls")


def _zero_stats() -> dict:
    out = {k: 0 for k in _SUMMED}
    out.update(size_buckets={}, wait_hist=None, fill_mean=0.0)
    return out


def aggregate_stats() -> dict:
    """Every live GroupCommit of the process summed
    (minio_tpu/storage/group_commit.py `aggregate_stats`), with the
    process's checkpoint counters."""
    out = _zero_stats()
    hists = []
    for gc in list(_REGISTRY):
        st = gc.stats()
        for key in _SUMMED:
            out[key] += st[key]
        for b, v in st["size_buckets"].items():
            out["size_buckets"][b] = out["size_buckets"].get(b, 0) + v
        hists.append(st["wait_hist"])
    out["wait_hist"] = Histogram.merge(hists)
    out["fill_mean"] = (out["members"] / out["batches"]) \
        if out["batches"] else 0.0
    out["checkpoints"] = checkpoints_total
    out["wals_retired"] = wals_retired_total
    return out


def merge_stats(states: list) -> dict:
    """The fleet's view: per-worker aggregate_stats() snapshots summed
    (each pre-forked worker runs its own lanes over the shared drives)."""
    out = _zero_stats()
    out["checkpoints"] = out["wals_retired"] = 0
    hists = []
    for st in states:
        if not isinstance(st, dict):
            continue
        for key in (*_SUMMED, "checkpoints", "wals_retired"):
            out[key] += st.get(key, 0)
        for b, v in (st.get("size_buckets") or {}).items():
            b = int(b)
            out["size_buckets"][b] = out["size_buckets"].get(b, 0) + v
        if st.get("wait_hist"):
            hists.append(st["wait_hist"])
    out["wait_hist"] = Histogram.merge(hists)
    out["fill_mean"] = (out["members"] / out["batches"]) \
        if out["batches"] else 0.0
    return out


# -- the coalescer -------------------------------------------------------------

class _Latch:
    """One countdown shared by a request's members: one wait and one
    wake a request instead of one a drive."""

    __slots__ = ("event", "mu", "n")

    def __init__(self, n: int):
        self.n = n
        self.mu = threading.Lock()
        self.event = threading.Event()
        if n <= 0:
            # Nothing to wait for (every slot None): an unset event
            # would park the caller inside its key lock forever.
            self.event.set()

    def dec(self) -> None:
        with self.mu:
            self.n -= 1
            if self.n <= 0:
                self.event.set()


class _Member:
    __slots__ = ("op", "latch", "exc", "expires_at", "tctx",
                 "tparent", "t_enq", "keep", "settle", "gone")

    def __init__(self, op: GroupOp, dl, latch: _Latch):
        self.op = op
        self.latch = latch
        self.exc: Optional[BaseException] = None
        self.expires_at = dl.expires_at if dl is not None else None
        self.tctx, self.tparent = tracing.capture() if tracing.ACTIVE \
            else (None, 0)
        self.t_enq = time.perf_counter()
        self.keep: Optional[bool] = None      # the request's verdict
        self.settle: Optional["_Settle"] = None
        # What the settle reclaims once kept, where its batch knows it.
        self.gone: Optional[list] = None


class _Settle:
    """The second half of one drive batch: settled by the lane's thread
    once each member's request has posted its verdict (`left` reaches
    0); `done` wakes the requests."""

    __slots__ = ("members", "left", "done")

    def __init__(self, members: list):
        self.members = members
        self.left = len(members)
        self.done = threading.Event()


@dataclass
class _Lane:
    idx: int
    cond: threading.Condition      # on the GroupCommit's lock
    pending: list = field(default_factory=list)
    deadline: float = 0.0          # the current window's dispatch-by time
    cur_wait: float = 0.0
    min_expiry: Optional[float] = None   # earliest member deadline
    thread: Optional[threading.Thread] = None   # the lane's commit thread
    settles: list = field(default_factory=list)  # batches to settle

    def bound(self) -> float:
        """When this window must close: the adaptive deadline, pulled in
        to the earliest member deadline less the commit's slack."""
        if self.min_expiry is None:
            return self.deadline
        return min(self.deadline, self.min_expiry - _DEADLINE_SLACK_S)


def _size_bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class GroupCommit:
    """The per-drive commit lanes of one erasure set.

    `disks` is the set's drive list, read as it stands when a batch
    runs (a drive put into a slot is the one its lane commits to). Each
    lane's commit thread starts with its first member and exits once
    the lane has been idle for _IDLE_S with no request tracked. `bump`
    (the set's MetaCache.bump) fires once a batch a bucket, before any
    member is acked."""

    def __init__(self, disks, name: str = ""):
        self._disks = disks
        self.name = name
        self.bump: Optional[Callable[[str], None]] = None
        self._max_wait = base_wait_s()
        self._max_members = max_members()
        self._mu = threading.Lock()
        self._lanes = [_Lane(i, threading.Condition(self._mu),
                             cur_wait=self._max_wait / 4)
                       for i in range(len(self._disks))]
        self._inflight = 0
        self._closed = False
        self._stat_mu = threading.Lock()
        self._st = {"batches": 0, "members": 0, "solo_bypass": 0,
                    "objects": 0, "merged_members": 0, "noop_skips": 0,
                    "fsyncs_saved": 0, "deadline_culls": 0,
                    "solo_demotions": 0, "settle_calls": 0}
        self._size_buckets: dict[int, int] = {}
        self._wait_hist = Histogram()
        _REGISTRY.add(self)

    # -- submission -------------------------------------------------------

    def tracking(self):
        """Context manager marking one group-eligible request in its
        commit section: the concurrency that worth_batching and the
        early-close rule read."""
        gc = self

        class _Track:
            def __enter__(self):
                with gc._mu:
                    gc._inflight += 1
                return gc

            def __exit__(self, *exc):
                with gc._mu:
                    gc._inflight -= 1
                return False

        return _Track()

    def worth_batching(self) -> bool:
        """Whether coalescing has company now: another tracked request
        is in its commit section, or members are pending. A lone request
        (the caller counts as 1) takes the solo fan-out and never waits
        out a window."""
        if self._inflight > 1:
            return True
        return any(lane.pending for lane in self._lanes)

    def note_solo(self, n: int = 1) -> None:
        with self._stat_mu:
            self._st["solo_bypass"] += n

    def commit_fanout(self, ops: list, quorum: int) -> list:
        """Submit one op a drive (None skips the drive), wait for every
        ack, then settle the kept journals: kept where at least `quorum`
        drives committed, else put back. Returns a per-drive error list
        aligned with the set's drives (None = committed), the contract
        of ErasureSet._fanout."""
        n = len(ops)
        dl = deadline_mod.current()
        if dl is not None and dl.expired():
            return [DeadlineExceeded("request deadline exceeded")] * n
        members: list[Optional[_Member]] = [None] * n
        latch = _Latch(sum(1 for op in ops if op is not None))
        with self._mu:
            if self._closed:
                from minio_tpu_torch.storage.local import StorageError
                return [StorageError("group commit closed")] * n
            now = time.monotonic()
            for i, op in enumerate(ops):
                if op is None:
                    continue
                m = _Member(op, dl, latch)
                lane = self._lanes[i]
                wake = False
                if not lane.pending:
                    lane.deadline = now + lane.cur_wait
                    lane.min_expiry = m.expires_at
                    wake = True         # a fresh window: re-arm the sleep
                elif m.expires_at is not None and (
                        lane.min_expiry is None
                        or m.expires_at < lane.min_expiry):
                    lane.min_expiry = m.expires_at
                    wake = True         # the bound moved earlier
                lane.pending.append(m)
                if len(lane.pending) >= self._max_members \
                        or len(lane.pending) >= self._inflight:
                    wake = True         # the early-close rule holds
                members[i] = m
                if not self._ensure_thread(lane) and wake:
                    # Only window openings, earlier bounds and early
                    # closes need the thread; its timed sleep covers the
                    # rest (and a thread mid-commit looks on its return).
                    lane.cond.notify()
        if dl is not None and not latch.event.wait(timeout=max(
                0.0, dl.expires_at + 0.25 - time.monotonic())):
            self._withdraw(members)
        # A batch that took a member may still commit it: wait for it
        # (the drive's timeout bounds it), so that nothing of this
        # request lands after it lets its key's lock go.
        latch.event.wait()
        errors = [None if m is None else m.exc for m in members]
        ok = sum(1 for m in members if m is not None and m.exc is None)
        self._post_verdicts(members, ok >= quorum)
        return errors

    def _withdraw(self, members: list) -> None:
        """Take a request's members that no batch has taken off their
        lanes (its deadline passed); each fails with DeadlineExceeded."""
        culled = 0
        with self._mu:
            for i, m in enumerate(members):
                if m is None:
                    continue
                pending = self._lanes[i].pending
                for k, p in enumerate(pending):
                    if p is m:
                        del pending[k]
                        m.exc = DeadlineExceeded(
                            "request deadline exceeded in group commit")
                        culled += 1
                        m.latch.dec()
                        break
        if culled:
            with self._stat_mu:
                self._st["deadline_culls"] += culled

    def _ensure_thread(self, lane: _Lane) -> bool:
        """Start the lane's thread when it has none (under _mu); True
        when one was started."""
        if lane.thread is not None and lane.thread.is_alive():
            return False
        lane.thread = threading.Thread(
            target=self._lane_loop, args=(lane,), daemon=True,
            name=f"group-commit-{lane.idx}")
        lane.thread.start()
        return True

    def _post_verdicts(self, members: list, keep: bool) -> None:
        """A request's verdict on each of its members, once every one is
        done; a batch whose last verdict this is goes to its lane's
        thread. The request then waits until each of its batches that
        ran is settled: it holds its key's lock, and no other commit of
        the key may meet a kept journal. (A member that was culled,
        withdrawn or cut has no batch to settle.)"""
        mine = []
        with self._mu:
            for i, m in enumerate(members):
                if m is None:
                    continue
                m.keep = keep
                g = m.settle
                if g is None:
                    continue    # culled, withdrawn or cut
                mine.append(g)
                g.left -= 1
                if g.left == 0:
                    self._queue_settle(self._lanes[i], g)
        for g in mine:
            g.done.wait()

    def _queue_settle(self, lane: _Lane, g: _Settle) -> None:
        lane.settles.append(g)
        if not self._ensure_thread(lane):
            lane.cond.notify()

    def _run_settles(self, lane: _Lane, groups: list) -> None:
        """One settle_prevs call on the lane's drive for every batch
        whose verdicts are in; a fault leaves the kept journals to the
        heal (ErasureSet._settle_prevs)."""
        items = [(m.op.volume, m.op.path, bool(m.keep), m.gone)
                 for g in groups for m in g.members]
        try:
            with deadline_mod.shield():
                self._disks[lane.idx].settle_prevs(items)
        except BaseException:  # noqa: BLE001 - the heal settles it
            pass
        with self._stat_mu:
            self._st["settle_calls"] += 1
        for g in groups:
            g.done.set()

    # -- dispatch ---------------------------------------------------------

    def _lane_loop(self, lane: _Lane) -> None:
        """One lane's commit thread: gather a window, run it, repeat.
        Members that arrive while a batch runs wait for the next one."""
        while True:
            settles = None
            with self._mu:
                while True:
                    if lane.settles:
                        # A settle runs first: its requests hold their
                        # keys' locks.
                        settles, lane.settles = lane.settles, []
                        break
                    if lane.pending:
                        now = time.monotonic()
                        bound = lane.bound()
                        # Early close: once every tracked request has a
                        # member here, nothing more can join before one
                        # leaves; waiting would buy only latency.
                        if self._closed or now >= bound \
                                or len(lane.pending) >= self._max_members \
                                or len(lane.pending) >= self._inflight:
                            batch, lane.pending = lane.pending, []
                            lane.min_expiry = None
                            break
                        lane.cond.wait(bound - now)
                        continue
                    if not self._closed:
                        lane.cond.wait(_IDLE_S)
                    if not lane.pending and not lane.settles and (
                            self._closed or self._inflight == 0):
                        # Clear the handle under the lock before leaving,
                        # so a racing submit starts another thread.
                        lane.thread = None
                        return
            if settles is not None:
                self._run_settles(lane, settles)
                continue
            self._run_batch(lane, batch)

    def _adapt_window(self, lane: _Lane, size: int) -> None:
        """Batches that merge stretch the window back toward its cap;
        lone members (arrivals slower than the window) shrink it."""
        if size >= 4:
            lane.cur_wait = min(self._max_wait, lane.cur_wait * 1.5)
        elif size <= 1:
            lane.cur_wait = max(_MIN_WAIT_S, lane.cur_wait * 0.7)

    def _solo(self, disk, op: GroupOp) -> None:
        if op.kind == "wm":
            disk.write_metadata(op.volume, op.path, op.fi, keep_prev=True)
        else:
            disk.rename_data(op.src_volume, op.src_path, op.fi,
                             op.volume, op.path, keep_prev=True)

    def _run_batch(self, lane: _Lane, batch: list) -> None:
        # Members whose budget is spent fail alone, counted.
        now = time.monotonic()
        live, dead = [], []
        for m in batch:
            if m.expires_at is not None and now >= m.expires_at - 1e-9:
                dead.append(m)
            else:
                live.append(m)
        if dead:
            with self._stat_mu:
                self._st["deadline_culls"] += len(dead)
            for m in dead:
                m.exc = DeadlineExceeded(
                    "request deadline exceeded before group commit")
                m.latch.dec()
        if not live:
            return
        disk = self._disks[lane.idx]
        info: dict = {}
        t_wall = time.time()
        t0 = time.perf_counter()
        results = None
        batch_exc: Optional[BaseException] = None
        try:
            # The batch serves many requests with many budgets; their
            # deadlines were enforced at the cull.
            with deadline_mod.shield():
                results = disk.commit_group([m.op for m in live], _info=info,
                                            keep_prev=True)
        except BaseException as e:  # noqa: BLE001 - delivered per member
            batch_exc = e
        demotions = 0
        # A power cut takes the node: nothing may commit after it, so no
        # member is demoted and none is acked.
        cut = isinstance(batch_exc, PowerFault)
        kept = info.get("kept", {})
        for k, m in enumerate(live):
            err = batch_exc if results is None else results[k]
            if err is None:
                m.gone = kept.get((m.op.volume, m.op.path))
            elif not cut:
                # Demote this member, and only it, to the solo path; its
                # own verdict is final.
                demotions += 1
                try:
                    with deadline_mod.shield():
                        self._solo(disk, m.op)
                    err = None
                except BaseException as e2:  # noqa: BLE001 - per member
                    err = e2
            m.exc = err
        size = len(live)
        with self._stat_mu:
            st = self._st
            st["batches"] += 1
            st["members"] += size
            st["objects"] += info.get("objects", 0)
            st["merged_members"] += info.get("merged", 0)
            st["noop_skips"] += info.get("noops", 0)
            st["fsyncs_saved"] += info.get("fsyncs_saved", 0)
            st["solo_demotions"] += demotions
            b = _size_bucket(size)
            self._size_buckets[b] = self._size_buckets.get(b, 0) + 1
        # One invalidation a bucket, BEFORE any member acks: a reader
        # that saw the PUT return must not meet a stale listing.
        if self.bump is not None:
            for bucket in sorted({m.op.volume for m in live
                                  if m.exc is None}):
                try:
                    self.bump(bucket)
                except Exception:  # noqa: BLE001 - listeners best-effort
                    pass
        if not cut:
            # The batch's second half, once every verdict is in: each
            # member's request posts its own once all of its members are
            # done, so none has posted yet.
            g = _Settle(live)
            for m in live:
                m.settle = g
        dur_ms = (time.perf_counter() - t0) * 1000.0
        for m in live:
            wait_s = max(0.0, t0 - m.t_enq)
            self._wait_hist.observe(wait_s)
            if m.tctx is not None:
                # ONE commit span fanned into each member's tree.
                tracing.record_into(
                    m.tctx, m.tparent, "storage", "commit.group",
                    t_wall, dur_ms,
                    tags={"drive": str(getattr(disk, "endpoint", "")
                                       or getattr(disk, "root", "")
                                       or lane.idx),
                          "members": size,
                          "objects": info.get("objects", 0),
                          "wait_ms": round(wait_s * 1000.0, 3)})
            m.latch.dec()
        self._adapt_window(lane, size)

    # -- lifecycle and stats ----------------------------------------------

    def close(self) -> None:
        """Refuse new members, let the lanes commit what is pending,
        then checkpoint and close every drive's WAL: a graceful stop
        leaves no frame for the next boot."""
        with self._mu:
            self._closed = True
            threads = [ln.thread for ln in self._lanes if ln.thread]
            for lane in self._lanes:
                lane.cond.notify()
        # The threads commit what is pending, then exit.
        for t in threads:
            t.join()
        with self._mu:
            threads = [ln.thread for ln in self._lanes if ln.thread]
        for t in threads:
            # Settles queued by verdicts that came in after the join.
            t.join()
        for d in self._disks:
            for name in ("gc_checkpoint", "gc_close"):
                fn = getattr(d, name, None)
                if fn is not None:
                    try:
                        fn()
                    except Exception:  # noqa: BLE001 - best effort
                        pass

    def stats(self) -> dict:
        """Batches, members, solo bypasses, objects, merged members,
        no-op skips, fsyncs saved, deadline culls, solo demotions, batch
        sizes (power-of-two buckets), the members' wait before their
        batch ran, members a batch, and the process's checkpoints."""
        with self._stat_mu:
            out = {"name": self.name, **self._st,
                   "size_buckets": dict(self._size_buckets),
                   "wait_hist": self._wait_hist.state()}
        out["fill_mean"] = out["members"] / out["batches"] \
            if out["batches"] else 0.0
        out["checkpoints"] = checkpoints_total
        out["wals_retired"] = wals_retired_total
        return out

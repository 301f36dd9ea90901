"""CrashDisk: the power-cut double of a drive (sibling of NaughtyDisk).

The port of minio_tpu/storage/crashdisk.py, built on the port's own
LocalStorage. NaughtyDisk models a drive that fails; CrashDisk models
the node losing power in the middle of a write: every drive of the node
stops at the same instant (one shared CrashClock), the write in flight
is dropped or torn according to what its system calls had made durable,
and every call after the cut raises PowerCut (the process is gone).

The clock ticks once a durable sub-step, so a cut can land between the
halves of a composite commit: rename_data moves the data dir and then
writes the journal (reference RenameData, cmd/xl-storage.go:2557);
delete_version rewrites the journal and then reclaims the version's
data dir; commit_group (storage/group_commit lanes) moves each member's
data dir, appends one WAL frame and writes each journal, and a
checkpoint syncs. A solo commit that keeps the journal it replaces
(keep_prev: the PUT's, the DELETE's) links PREV_FILE, writes the journal
and syncs the object's directory, and its settle_prev drops PREV_FILE
or puts it back (synced) and then reclaims data dirs: each of those is
a sub-step too, seen from inside LocalStorage (_KeptHook). Sweeping `crash_at` over 1..N walks every such
interleaving of a commit's fan-out, which the crash-point matrix does.

The port's shard writes stream: create_file takes an iterable of chunks
(a per-drive queue of pooled rows, object/erasure_object.py), and
`append` and `sync` flags (heal appends window by window). Its sub-step
comes once the stream is under way, after its first chunk (at its end
for a stream of none): a cut there leaves the stream begun and not
finished, and a cut that fires elsewhere while a stream runs stops it
at its next chunk. Either way the chunks taken so far are torn or
dropped, and the caller's generator is left where it stood, so its own
hooks return the rows it holds. A write with
sync=False (or an unsynced append) is not durable: a later cut tears it
as it tears an unsynced journal rename.

Tear modes (what the platter holds of the interrupted write):
  * "drop": the page cache died with the power; the write in flight has
    no effect;
  * "tear": a prefix of the write landed: a torn shard file in staging,
    a torn journal write as a tmp file (the protocol stages both, so a
    torn file never sits at a commit destination), and an interrupted
    rename_data leaves its data dir moved in with no journal naming it;
  * "lose_entry": a filesystem without a journal or directory fsync: as
    drop, and the LAST completed rename (or link, or unlink) on every
    drive whose directory entry was not synced is rolled back too. MTPU_FS_OSYNC exists
    because this mode can show the OLD version of a write a quorum
    acknowledged: the matrix asserts old-or-new here, not durability.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid as uuid_mod
from typing import Optional

from minio_tpu_torch.storage.local import SYS_VOL, TMP_DIR, PowerFault

TEAR_MODES = ("drop", "tear", "lose_entry")


class PowerCut(PowerFault):
    """The node lost power: this call and every later one cannot happen.
    A PowerFault, so commit_group lets it out whole and the group-commit
    lanes ack no member of its batch."""


class CrashClock:
    """The mutation counter shared by every CrashDisk of one node.

    crash_at: the 1-based sub-step at which the power dies (0 = never).
    `fired_op` names the sub-step the cut landed in. The cut lands
    between sub-steps: one that another thread began before it (its tick
    passed) runs to its end, and every later tick raises PowerCut. The
    cut's effects on what was written but not synced (torn journals and
    shard files, lose_entry's rollback) land at power_off(), which the
    caller runs once the op's threads have ended (the set is closed)."""

    def __init__(self, crash_at: int = 0):
        self.crash_at = crash_at
        self.count = 0
        self.fired = False
        self.fired_op = ""
        self._off = False
        self._mu = threading.Lock()
        self._disks: list = []

    def register(self, disk: "CrashDisk") -> None:
        with self._mu:
            self._disks.append(disk)

    def dead(self) -> bool:
        with self._mu:
            return self.fired

    def tick(self, op: str) -> bool:
        """Advance one sub-step of `op`. True: the power dies ON this
        sub-step (the caller leaves its partial effect, then raises).
        Raises PowerCut when the node is already dead: an op in flight
        when the power died cannot do its remaining sub-steps."""
        with self._mu:
            if self.fired:
                raise PowerCut("node lost power")
            self.count += 1
            if not (self.crash_at and self.count == self.crash_at):
                return False
            self.fired = True
            self.fired_op = op
        return True

    def power_off(self) -> None:
        """Apply the cut's effects on every drive, once; nothing when the
        clock never fired."""
        with self._mu:
            if not self.fired or self._off:
                return
            self._off = True
            disks = list(self._disks)
        for d in disks:
            d._on_power_cut()


# One-step mutators of the port's LocalStorage that need no partial state
# of their own; the composite ones (create_file, write_metadata,
# write_all, write_format, rename_data, delete_version, commit_group,
# gc_checkpoint) have methods below. Every other call passes through
# while the node lives.
_MUTATORS = ("rename_file", "make_vol", "make_vol_if_missing",
             "delete_vol", "delete", "gc_truncate_wal")


class CrashDisk:
    """A LocalStorage of the port under the power-cut model above. The
    double knows the drive's layout: it must, to leave the partial
    states a real cut leaves."""

    def __init__(self, disk, clock: CrashClock, mode: str = "drop"):
        if mode not in TEAR_MODES:
            raise ValueError(f"unknown tear mode {mode!r}")
        self._disk = disk
        self._clock = clock
        self.mode = mode
        self._mu = threading.Lock()
        # [(path, prior bytes or None)] of the latest journal rename (or
        # PREV_FILE link, unlink or restore): the unsynced directory
        # change lose_entry rolls back.
        self._last_commit: Optional[list] = None
        # Group-commit journals written without a sync of their own (the
        # WAL is their durability point): (dest, blob, prior). A cut
        # tears them (drop, tear) or voids their rename (lose_entry);
        # they retire at a checkpoint's sync.
        self._unsynced: list = []
        # WAL files whose directory entry was never synced: lost under
        # lose_entry (MTPU_FS_OSYNC syncs the directory and clears it).
        self._unsynced_wals: list = []
        # Shard files written with sync=False: dest -> their durable
        # state before the first such write (see _durable_state).
        self._unsynced_files: dict = {}
        # Only a hook-ticked gc_checkpoint() retires this drive's WAL:
        # the double owns durability's timing.
        if hasattr(disk, "_gc_auto"):
            disk._gc_auto = False
        clock.register(self)

    @property
    def wrapped(self):
        return self._disk

    @property
    def endpoint(self):
        return getattr(self._disk, "endpoint", "crash")

    @property
    def root(self):
        return getattr(self._disk, "root", None)

    # -- power-cut effects -------------------------------------------------

    def _check_alive(self) -> None:
        if self._clock.dead():
            raise PowerCut(f"drive {self.endpoint}: node lost power")

    def _on_power_cut(self) -> None:
        """The cut's effects on this drive (CrashClock.power_off)."""
        with self._mu:
            unsynced, self._unsynced = self._unsynced, []
            uwals, self._unsynced_wals = self._unsynced_wals, []
            ufiles, self._unsynced_files = self._unsynced_files, {}
            last, self._last_commit = self._last_commit, None
        for dest, state in ufiles.items():
            self._settle_file(dest, state)
        # Journals renamed in without a sync: torn (their rename is in
        # the filesystem's journal, their pages are not) or, under
        # lose_entry, never renamed. replay_wals repairs the former.
        for dest, blob, prior in unsynced:
            try:
                if self.mode == "lose_entry":
                    _restore(dest, prior)
                else:
                    with open(dest, "wb") as f:
                        f.write(blob[:len(blob) // 2])
            except OSError:
                pass
        if self.mode != "lose_entry":
            return
        for wal in uwals:
            try:
                os.remove(wal)
            except OSError:
                pass
        for dest, prior in reversed(last or ()):
            try:
                _restore(dest, prior)
            except OSError:
                pass

    def _note_commit_file(self, dest: str, prior: Optional[bytes]) -> None:
        """A journal rename that completed (lose_entry may void it)."""
        if self.mode == "lose_entry":
            with self._mu:
                self._last_commit = [(dest, prior)]

    def _tear_tmp(self, payload: bytes) -> None:
        """mode=tear: the half-written temp file of an interrupted
        atomic write."""
        if self.mode != "tear" or self.root is None:
            return
        tmp = os.path.join(self.root, SYS_VOL, TMP_DIR,
                           f"torn-{uuid_mod.uuid4()}")
        try:
            os.makedirs(os.path.dirname(tmp), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(payload[:max(0, len(payload) - 1) // 2])
        except OSError:
            pass

    def _meta_prior(self, volume: str, path: str) -> Optional[bytes]:
        """The journal's bytes now (None = absent), for lose_entry."""
        return self._file_prior(self._disk._meta_path(volume, path))

    def _file_prior(self, path: str) -> Optional[bytes]:
        """`path`'s bytes now (None = absent), for lose_entry."""
        if self.mode != "lose_entry" or self.root is None:
            return None
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None

    # -- shard files (streamed) --------------------------------------------

    def _durable_state(self, dest: str, append: bool):
        """What of `dest` a cut leaves when the write about to start
        never becomes durable: an earlier unsynced write's durable
        state, else the length an append extends, else the bytes a
        rewrite replaces (None: no file)."""
        with self._mu:
            if dest in self._unsynced_files:
                return self._unsynced_files[dest]
        if append:
            try:
                return ("len", os.path.getsize(dest))
            except OSError:
                return ("len", 0)
        try:
            with open(dest, "rb") as f:
                return ("bytes", f.read())
        except OSError:
            return ("bytes", None)

    def _settle_file(self, dest: str, state) -> None:
        """A cut meets a shard file whose newest bytes are not durable:
        drop and lose_entry leave its durable state, tear leaves that
        and a prefix of the bytes written since."""
        kind, base = state
        try:
            size = os.path.getsize(dest)
        except OSError:
            return
        keep = base if kind == "len" else 0
        if self.mode == "tear":
            with open(dest, "r+b") as f:
                f.truncate(keep + max(0, size - keep - 1) // 2)
        elif kind == "len":
            with open(dest, "r+b") as f:
                f.truncate(base)
        elif base is None:
            os.remove(dest)
        else:
            with open(dest, "wb") as f:
                f.write(base)

    def create_file(self, volume, path, chunks, append=False, sync=True):
        self._check_alive()
        d = self._disk
        dest = d._obj_dir(volume, path)
        state = self._durable_state(dest, append)

        def feed():
            it = iter(chunks)
            for c in it:
                yield c
                break
            # The stream is under way: this write's sub-step.
            if self._clock.tick("create_file"):
                raise PowerCut(f"{self.endpoint}: power cut in create_file")
            for c in it:
                # A cut elsewhere stops the stream at its next chunk.
                self._check_alive()
                yield c
        try:
            d.create_file(volume, path, feed(), append=append, sync=sync)
        except PowerCut:
            try:
                self._settle_file(dest, state)
            except OSError:
                pass
            raise
        with self._mu:
            if sync:
                # fdatasync made every earlier byte of the file durable.
                self._unsynced_files.pop(dest, None)
            else:
                self._unsynced_files.setdefault(dest, state)

    # -- atomic writes and journals ------------------------------------------

    def _atomic(self, op: str, payload: bytes, call, journal=None):
        """An atomic write (tmp + fdatasync + rename) as one sub-step;
        `journal` = (volume, path) of the xl.meta it commits."""
        self._check_alive()
        if self._clock.tick(op):
            self._tear_tmp(payload)
            raise PowerCut(f"{self.endpoint}: power cut in {op}")
        prior = self._meta_prior(*journal) if journal else None
        result = call()
        if journal:
            self._note_commit_file(self._disk._meta_path(*journal), prior)
        return result

    def write_all(self, volume, path, data):
        return self._atomic("write_all", bytes(data),
                            lambda: self._disk.write_all(volume, path, data))

    def write_format(self, fmt):
        return self._atomic("write_format", b"x" * 256,
                            lambda: self._disk.write_format(fmt))

    def write_metadata(self, volume, path, fi, keep_prev=False):
        if keep_prev:
            self._check_alive()
            return self._disk.write_metadata(volume, path, fi,
                                             keep_prev=True,
                                             _hook=_KeptHook(self))
        return self._atomic("write_metadata", b"x" * 256,
                            lambda: self._disk.write_metadata(
                                volume, path, fi),
                            journal=(volume, path))

    def _move_data_dir(self, src_volume, src_path, data_dir, dst_volume,
                       dst_path) -> None:
        """The staged data dir's move into the object dir, done on its
        own: the state a cut after that rename leaves."""
        d = self._disk
        try:
            dst_dir = d._obj_dir(dst_volume, dst_path)
            os.makedirs(dst_dir, exist_ok=True)
            os.replace(os.path.join(d._obj_dir(src_volume, src_path),
                                    data_dir),
                       os.path.join(dst_dir, data_dir))
        except OSError:
            pass

    def rename_data(self, src_volume, src_path, fi, dst_volume, dst_path,
                    keep_prev=False):
        self._check_alive()
        # Sub-step 1, the data dir's move. Under tear the rename's entry
        # is taken as durable, so the data dir stands in the object dir
        # with no journal naming it: what recovery_sweep must undo.
        if self._clock.tick("rename_data.move"):
            if self.mode == "tear" and fi.data_dir:
                self._move_data_dir(src_volume, src_path, fi.data_dir,
                                    dst_volume, dst_path)
            raise PowerCut(f"{self.endpoint}: power cut moving data dir")
        if keep_prev:
            # The move, PREV_FILE's link, the journal and the directory's
            # sync, each a sub-step inside (_KeptHook).
            return self._disk.rename_data(src_volume, src_path, fi,
                                          dst_volume, dst_path,
                                          keep_prev=True,
                                          _hook=_KeptHook(self))
        # Sub-step 2, the journal's write: the commit point.
        if self._clock.tick("rename_data.journal"):
            if fi.data_dir:
                self._move_data_dir(src_volume, src_path, fi.data_dir,
                                    dst_volume, dst_path)
            self._tear_tmp(b"x" * 256)
            raise PowerCut(f"{self.endpoint}: power cut writing journal")
        prior = self._meta_prior(dst_volume, dst_path)
        result = self._disk.rename_data(src_volume, src_path, fi,
                                        dst_volume, dst_path)
        self._note_commit_file(self._disk._meta_path(dst_volume, dst_path),
                               prior)
        return result

    def delete_version(self, volume, path, version_id="", keep_prev=False):
        self._check_alive()
        if keep_prev:
            # PREV_FILE's link, the journal and the directory's sync;
            # nothing is reclaimed before settle_prev (_KeptHook).
            return self._disk.delete_version(volume, path, version_id,
                                             keep_prev=True,
                                             _hook=_KeptHook(self))
        # Sub-step 1, the journal's rewrite (or its removal when no
        # version is left): the delete's commit point.
        if self._clock.tick("delete_version.journal"):
            self._tear_tmp(b"x" * 256)
            raise PowerCut(f"{self.endpoint}: power cut rewriting journal")
        # Sub-step 2, the version's data dir reclaimed. A cut here: the
        # delete is committed, its data dir is left as debris that the
        # recovery sweep removes.
        if self._clock.tick("delete_version.reclaim"):
            self._journal_only_delete(volume, path, version_id)
            raise PowerCut(f"{self.endpoint}: power cut reclaiming data dir")
        return self._disk.delete_version(volume, path, version_id)

    def settle_prev(self, volume, path, keep):
        self._check_alive()
        return self._disk.settle_prev(volume, path, keep,
                                      _hook=_KeptHook(self))

    def _journal_only_delete(self, volume, path, version_id) -> None:
        """delete_version's journal half alone."""
        from minio_tpu_torch.storage.meta import FileNotFoundErr, MetaError
        d = self._disk
        try:
            with d._path_lock(volume, path):
                xl = d._read_meta(volume, path)
                xl.delete_version(version_id)
                meta_path = d._meta_path(volume, path)
                if xl.versions:
                    d._atomic_write(meta_path, xl.dump())
                else:
                    os.remove(meta_path)
        except (OSError, MetaError, FileNotFoundErr):
            pass

    # -- group commit (storage/group_commit lanes) ---------------------------

    def commit_group(self, ops, _info=None, keep_prev=False):
        """The batched commit, with a cut point at each durable sub-step:
        each member's data-dir move, each kept journal's link, the WAL
        frame, each journal write (_GCHook)."""
        self._check_alive()
        return self._disk.commit_group(ops, _info=_info,
                                       _hook=_GCHook(self),
                                       keep_prev=keep_prev)

    def settle_prevs(self, items):
        self._check_alive()
        return self._disk.settle_prevs(items, _hook=_KeptHook(self))

    def gc_checkpoint(self):
        self._check_alive()
        return self._disk.gc_checkpoint(_hook=_GCHook(self))

    def gc_close(self):
        # Closing a descriptor changes nothing on the platter, and a
        # dead process's descriptors close with it.
        return self._disk.gc_close()

    def __getattr__(self, name: str):
        attr = getattr(self._disk, name)
        if not callable(attr):
            return attr

        if name in _MUTATORS:
            def mutate(*args, **kwargs):
                self._check_alive()
                if self._clock.tick(name):
                    raise PowerCut(f"{self.endpoint}: power cut in {name}")
                return attr(*args, **kwargs)
            return mutate

        def passthrough(*args, **kwargs):
            self._check_alive()
            return attr(*args, **kwargs)
        return passthrough


def _restore(dest: str, prior: Optional[bytes]) -> None:
    """Put `dest` back as it was: `prior`'s bytes, or gone (None)."""
    if prior is None:
        if os.path.isdir(dest):
            shutil.rmtree(dest, ignore_errors=True)
        else:
            os.remove(dest)
    else:
        with open(dest, "wb") as f:
            f.write(prior)


class _KeptHook:
    """The seam of a solo commit that keeps the journal it replaces
    (LocalStorage._land_kept) and of its settle_prev, bound to one
    CrashDisk. step ticks the shared clock before each durable sub-step
    (a journal's cut under tear leaves its torn tmp file) and notes the
    bytes of the paths it is about to change; once the change landed it
    is the drive's last directory change not yet synced, which lose_entry
    rolls back, until synced() reports the directory's fsync."""

    __slots__ = ("cd", "_priors")

    def __init__(self, cd: CrashDisk):
        self.cd = cd
        self._priors: list = []

    def step(self, op: str, *paths: str) -> None:
        cd = self.cd
        if cd._clock.tick(op):
            if op.endswith(".journal"):
                cd._tear_tmp(b"x" * 256)
            raise PowerCut(f"{cd.endpoint}: power cut in {op}")
        self._priors = [(p, cd._file_prior(p)) for p in paths]

    def landed(self) -> None:
        cd = self.cd
        if cd.mode == "lose_entry" and self._priors:
            with cd._mu:
                cd._last_commit = self._priors
        self._priors = []

    def synced(self, obj_dir: str) -> None:
        cd = self.cd
        with cd._mu:
            last = cd._last_commit
            if last and all(os.path.dirname(p) == obj_dir for p, _ in last):
                cd._last_commit = None


class _GCHook(_KeptHook):
    """commit_group's power-cut seam, bound to one CrashDisk.

    LocalStorage.commit_group calls these at each durable sub-step; a
    tick can fire the shared clock, leave the partial state a real cut
    leaves at that instant, and raise PowerCut. note_* record effects
    that completed but are not durable yet, so that a LATER cut (any
    op, any drive) tears them in _on_power_cut: the page cache dies
    with the node, not with the op that filled it. A kept journal's link
    (the lanes' batches) ticks through _KeptHook's step."""

    __slots__ = ()

    def step_move(self, op) -> None:
        cd = self.cd
        if cd._clock.tick("commit_group.move"):
            if cd.mode == "tear" and op.fi.data_dir:
                cd._move_data_dir(op.src_volume, op.src_path,
                                  op.fi.data_dir, op.volume, op.path)
            raise PowerCut(f"{cd.endpoint}: power cut moving data dir "
                           "(group commit)")

    def step_wal(self, path: str, frame: bytes) -> None:
        cd = self.cd
        if cd._clock.tick("commit_group.wal"):
            if cd.mode == "tear":
                # A prefix of the frame landed: its crc shows it torn at
                # replay, and it protected no acked member.
                try:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "ab") as f:
                        f.write(frame[:max(0, len(frame) - 1) // 2])
                except OSError:
                    pass
            raise PowerCut(f"{cd.endpoint}: power cut writing group WAL")

    def note_wal(self, path: str, synced_dir: bool) -> None:
        cd = self.cd
        if cd.mode == "lose_entry" and not synced_dir:
            with cd._mu:
                cd._unsynced_wals.append(path)

    def meta_prior(self, volume: str, path: str):
        return self.cd._meta_prior(volume, path)

    def step_rename(self, dest: str, blob: bytes) -> None:
        cd = self.cd
        if cd._clock.tick("commit_group.journal"):
            # The power dies before this journal's write: it keeps its
            # old journal; the batch's earlier ones tear in _on_power_cut.
            raise PowerCut(f"{cd.endpoint}: power cut in batched journal "
                           "writes")

    def note_rename(self, dest: str, blob: bytes, prior) -> None:
        cd = self.cd
        with cd._mu:
            cd._unsynced.append((dest, bytes(blob),
                                 None if prior is None else bytes(prior)))

    def step_sync(self) -> None:
        cd = self.cd
        if cd._clock.tick("gc_checkpoint.sync"):
            # The sync never ran: unsynced journals tear, live WALs stay
            # for replay.
            raise PowerCut(f"{cd.endpoint}: power cut in WAL checkpoint")
        with cd._mu:
            cd._unsynced.clear()
            cd._unsynced_wals.clear()
            cd._unsynced_files.clear()

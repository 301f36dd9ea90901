"""Local drive backend: the per-drive POSIX storage the slice uses.

The subset of minio_tpu/storage/local.py that PutObject, GetObject,
DeleteObject, multipart uploads, healing and the drive plane need, with
the same on-disk layout:

    <root>/<volume>/<object>/xl.meta            version journal (meta.py)
    <root>/<volume>/<object>/<dataDir>/part.N   bitrot-framed shard file
    <root>/.mtpu.sys/format.json                drive identity, set layout
    <root>/.mtpu.sys/healing.json               bulk-heal tracker of a
                                                replaced drive
    <root>/.mtpu.sys/staging/...                staging for commits
    <root>/.mtpu.sys/multipart/...              uploads in progress
    <root>/.mtpu.sys/mrf/pending.json           the MRF heal queue
    <root>/.mtpu.sys/tmp/<uuid>                 atomic-write temporaries

Shard files are written into staging and committed with rename_data:
the data dir moves into the object dir first, then the merged journal is
written atomically (tmp + fdatasync + rename) as the commit point
(reference: CreateFile cmd/xl-storage.go:2092, RenameData :2557).

Concurrent journal-only commits may instead ride the group-commit lanes
(storage/group_commit.py): `commit_group` merges a batch per object,
makes every merged journal durable with ONE write-ahead frame under
`.mtpu.sys/gcommit/` and one fdatasync, then renames the journals into
place without a sync of their own; `recovery_sweep` replays those
frames at boot before anything serves. The listing walk reads journals
through `walk_scan`, which yields per-version summaries
(storage/meta_scan.py) and, in shallow mode, one marker per key prefix.
"""

from __future__ import annotations

import errno
import itertools
import json
import os
import shutil
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Iterator, Optional

from minio_tpu_torch.storage.meta import (FileInfo, FileNotFoundErr,
                                          MetaError, XLMeta)

SYS_VOL = ".mtpu.sys"
META_FILE = "xl.meta"
TMP_DIR = "tmp"
# The drive's identity and its set's layout (topology/format.py).
FORMAT_FILE = "format.json"
# Present on a drive adopted into a formatted slot (a replaced drive)
# until its bulk heal finishes; holds the checkpointed tracker JSON of
# object/drive_heal.py (the reference's .healing.bin).
HEALING_FILE = "healing.json"

# Directory-entry fsync after rename commits, as the JAX package and the
# reference do it: file contents are always synced, parent directories
# only when MTPU_FS_OSYNC is set (reference MINIO_FS_OSYNC,
# cmd/xl-storage.go:1557 globalSync).
FS_OSYNC = os.environ.get("MTPU_FS_OSYNC", "").lower() in ("1", "on", "true")


class StorageError(Exception):
    pass


class VolumeNotFound(StorageError):
    pass


class VolumeExists(StorageError):
    pass


class VolumeNotEmpty(StorageError):
    pass


class DiskAccessDenied(StorageError):
    pass


class FaultyDisk(StorageError):
    """The drive failed an operation for reasons of its own (a deadline
    it missed, its open breaker: storage/health.py)."""


@dataclass
class DiskInfo:
    total: int = 0
    free: int = 0
    used: int = 0
    healing: bool = False
    endpoint: str = ""
    disk_id: str = ""


@dataclass
class VolInfo:
    name: str
    created: int = 0


def _is_uuid(name: str) -> bool:
    try:
        uuid_mod.UUID(name)
        return True
    except ValueError:
        return False


def _read_raw(path: str) -> bytes:
    """Whole-file read through os.open: the io.open stack costs several
    times the system call for the small files the commit and walk loops
    read (version journals)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        buf = os.read(fd, size)
        while len(buf) < size:
            chunk = os.read(fd, size - len(buf))
            if not chunk:
                break
            buf += chunk
        return buf
    finally:
        os.close(fd)


def _write_raw(path: str, blob: bytes) -> None:
    """Whole-file write through os.open, no sync: callers that need
    durability sync explicitly."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        off = 0
        view = memoryview(blob)
        while off < len(blob):
            off += os.write(fd, view[off:])
    finally:
        os.close(fd)


def _is_valid_volname(vol: str) -> bool:
    return bool(vol) and vol not in (".", "..") and "/" not in vol \
        and "\\" not in vol


class OfflineDisk:
    """The drive of a format slot that is missing or refused: every
    operation raises StorageError, which the erasure layer tolerates up
    to parity (the reference's nil StorageAPI slot). It has no root, so
    nothing that writes beside the storage API picks it."""

    root = None

    def __init__(self, endpoint: str = "offline"):
        self.endpoint = endpoint

    def __getattr__(self, name: str):
        def fail(*a, **kw):
            raise StorageError(f"drive offline: {self.endpoint}")
        return fail


class LocalStorage:
    """One local drive. All paths are (volume, object-path) pairs."""

    def __init__(self, root: str, endpoint: str = ""):
        self.root = os.path.abspath(root)
        self.endpoint = endpoint or self.root
        self._disk_id: Optional[str] = None
        self._lock = threading.Lock()
        self._path_locks: dict[str, threading.Lock] = {}
        # The group-commit WAL (commit_group): one append-mode file per
        # process, held open across batches; its frames accumulate until
        # a checkpoint's sync lets them go (storage/group_commit).
        self._gc_mu = threading.Lock()
        self._gc_wal_fd: Optional[int] = None
        self._gc_wal_path = ""
        self._gc_dirty = 0                 # frames since the last checkpoint
        # Batches whose frame is in the WAL but whose journals are still
        # being written: while any is, a sync covers not every frame.
        self._gc_landing = 0
        self._gc_seq = itertools.count()   # temp names of journal renames
        os.makedirs(os.path.join(self.root, SYS_VOL, TMP_DIR), exist_ok=True)

    def _path_lock(self, volume: str, path: str) -> threading.Lock:
        """Per-object lock serializing xl.meta read-modify-write cycles."""
        key = f"{volume}/{path}"
        with self._lock:
            lk = self._path_locks.get(key)
            if lk is None:
                if len(self._path_locks) > 4096:
                    for k in [k for k, v in self._path_locks.items()
                              if not v.locked()][:2048]:
                        del self._path_locks[k]
                lk = self._path_locks[key] = threading.Lock()
            return lk

    # -- identity (format.json; reference cmd/format-erasure.go) -------------

    def read_format(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, SYS_VOL, FORMAT_FILE),
                      "rb") as f:
                return json.loads(f.read())
        except FileNotFoundError:
            return None

    def write_format(self, fmt: dict) -> None:
        """Write the drive's format.json (the JAX package's bytes:
        json.dumps with indent 2). A drive wiped while serving gets its
        format back through here (scanner.check_drive_formats), so the
        group-commit WAL reopens too: its cached descriptor names a file
        the wipe unlinked, and frames appended there would reach no
        linked file."""
        blob = json.dumps(fmt, indent=2).encode()
        self._atomic_write(os.path.join(self.root, SYS_VOL, FORMAT_FILE),
                           blob)
        self._disk_id = fmt.get("xl", {}).get("this")
        self._gc_reopen_if_unlinked()

    def disk_id(self) -> str:
        if self._disk_id is None:
            fmt = self.read_format()
            self._disk_id = fmt.get("xl", {}).get("this", "") if fmt else ""
        return self._disk_id or ""

    def disk_info(self) -> DiskInfo:
        st = os.statvfs(self.root)
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        healing = os.path.exists(os.path.join(self.root, SYS_VOL,
                                              HEALING_FILE))
        return DiskInfo(total=total, free=free, used=total - free,
                        healing=healing, endpoint=self.endpoint,
                        disk_id=self.disk_id())

    # -- paths --------------------------------------------------------------

    def _vol_dir(self, volume: str) -> str:
        if not _is_valid_volname(volume):
            raise StorageError(f"invalid volume name {volume!r}")
        return os.path.join(self.root, volume)

    def _obj_dir(self, volume: str, path: str) -> str:
        base = self._vol_dir(volume)
        full = os.path.normpath(os.path.join(base, path))
        if not full.startswith(base + os.sep) and full != base:
            raise DiskAccessDenied(path)
        return full

    def _tmp_path(self) -> str:
        return os.path.join(self.root, SYS_VOL, TMP_DIR, str(uuid_mod.uuid4()))

    @staticmethod
    def _fsync_dir(path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _atomic_write(self, dest: str, data: bytes) -> None:
        """tmp + fdatasync + rename: the crash-consistency primitive
        (minio_tpu/storage/local.py `_atomic_write`). Directories are
        made only when a FileNotFoundError says one is missing, for the
        temp file and for the destination alike: the temp dir exists
        from the drive's start, and an object's dir from its first
        commit, so the common write makes none."""
        tmp = self._tmp_path()
        try:
            f = open(tmp, "wb")
        except FileNotFoundError:
            os.makedirs(os.path.dirname(tmp), exist_ok=True)
            f = open(tmp, "wb")
        with f:
            f.write(data)
            f.flush()
            os.fdatasync(f.fileno())
        try:
            os.replace(tmp, dest)
        except FileNotFoundError:
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            os.replace(tmp, dest)
        if FS_OSYNC:
            self._fsync_dir(os.path.dirname(dest))

    # -- volumes ------------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        d = self._vol_dir(volume)
        if os.path.isdir(d):
            raise VolumeExists(volume)
        os.makedirs(d)

    def make_vol_if_missing(self, volume: str) -> None:
        os.makedirs(self._vol_dir(volume), exist_ok=True)

    def list_vols(self) -> list[VolInfo]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name == SYS_VOL or not _is_valid_volname(name):
                continue
            full = os.path.join(self.root, name)
            if os.path.isdir(full):
                out.append(VolInfo(name=name,
                                   created=int(os.stat(full).st_ctime_ns)))
        return out

    def stat_vol(self, volume: str) -> VolInfo:
        d = self._vol_dir(volume)
        if not os.path.isdir(d):
            raise VolumeNotFound(volume)
        return VolInfo(name=volume, created=int(os.stat(d).st_ctime_ns))

    def delete_vol(self, volume: str, force: bool = False) -> None:
        """Remove an empty volume (VolumeNotEmpty otherwise); with
        `force`, remove it and everything in it."""
        d = self._vol_dir(volume)
        if not os.path.isdir(d):
            raise VolumeNotFound(volume)
        if force:
            shutil.rmtree(d)
            return
        try:
            os.rmdir(d)
        except OSError as e:
            if e.errno in (errno.ENOTEMPTY, errno.EEXIST):
                raise VolumeNotEmpty(volume) from e
            raise

    # -- files --------------------------------------------------------------

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._atomic_write(self._obj_dir(volume, path), data)

    def read_all(self, volume: str, path: str) -> bytes:
        try:
            with open(self._obj_dir(volume, path), "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            raise FileNotFoundErr(f"{volume}/{path}") from None

    def stat_info_file(self, volume: str, path: str) -> os.stat_result:
        try:
            return os.stat(self._obj_dir(volume, path))
        except FileNotFoundError:
            raise FileNotFoundErr(f"{volume}/{path}") from None

    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None:
        """Atomic same-drive move (multipart assembly)."""
        src = self._obj_dir(src_volume, src_path)
        dst = self._obj_dir(dst_volume, dst_path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            raise FileNotFoundErr(f"{src_volume}/{src_path}") from None

    def list_dir(self, volume: str, dir_path: str) -> list[str]:
        """Entries of one directory level, sorted: files as they are,
        directories with a trailing '/'."""
        base = self._obj_dir(volume, dir_path) if dir_path \
            else self._vol_dir(volume)
        try:
            names = sorted(os.listdir(base))
        except (FileNotFoundError, NotADirectoryError):
            raise FileNotFoundErr(f"{volume}/{dir_path}") from None
        return [n + "/" if os.path.isdir(os.path.join(base, n)) else n
                for n in names]

    def walk_scan(self, volume: str, base_dir: str = "",
                  forward_from: str = "", shallow: bool = False):
        """The per-drive sorted walk of the objects under `base_dir`
        (minio_tpu/storage/local.py `walk_scan`; reference WalkDir,
        cmd/metacache-walk.go:73), streaming, each journal read once and
        summarized (storage/meta_scan). A directory that holds xl.meta is
        an object; a directory `d` sorts as the key "d" (before siblings
        such as "d-x") and as the prefix "d/" (after them). Subtrees
        wholly before `forward_from` are not entered, so a walk that
        resumes at a marker costs about the keys after it. Yields, in
        key order:

            (path, vlist, None)   summarized object
            (path, vlist, blob)   summarized, but a version's metadata
                                  goes past the summary: the journal
                                  rides along for the full parse
            (path, None, blob)    no summary; the caller parses the blob
            (path + "/", PREFIX_MARK, None)   shallow mode only: a key
                                  prefix with evidence of keys below

        shallow=True walks ONE directory level under base_dir and emits
        prefix markers instead of descending, the shape of a "/"
        delimiter page: a page costs O(page), not O(subtree). The
        evidence for a marker is one probe scandir a child subtree (a
        grandchild holding a journal or a directory), so a chain of
        directories holding no key may show as a prefix until deletes
        prune it, as the reference's non-recursive WalkDir allows.

        The walk parses no journal to classify data dirs: it descends
        everywhere, and a version's data dir (part files only) yields
        nothing."""
        from minio_tpu_torch.storage.meta_scan import scan_entry
        vol = self._vol_dir(volume)
        if not os.path.isdir(vol):
            raise VolumeNotFound(volume)
        if shallow:
            yield from self._walk_shallow(vol, base_dir, forward_from)
            return

        def rec(rel: str):
            full = os.path.join(vol, rel) if rel else vol
            try:
                with os.scandir(full) as it:
                    dirs = [e.name for e in it
                            if e.is_dir(follow_symlinks=False)]
            except (FileNotFoundError, NotADirectoryError):
                return
            events = sorted([(n, n, True) for n in dirs]
                            + [(n + "/", n, False) for n in dirs])
            for _, n, obj_slot in events:
                child = f"{rel}/{n}" if rel else n
                if obj_slot:
                    if not (child >= forward_from
                            or forward_from.startswith(child)):
                        continue
                    try:
                        blob = _read_raw(os.path.join(full, n, META_FILE))
                    except OSError:
                        continue        # not an object (or gone)
                    yield (child, *scan_entry(blob))
                else:
                    subtree = child + "/"
                    if subtree < forward_from and \
                            not forward_from.startswith(subtree):
                        continue
                    yield from rec(child)

        yield from rec(base_dir)

    def _walk_shallow(self, vol: str, base_dir: str, forward_from: str):
        """One level under base_dir: the objects there and the prefix
        markers of their sibling subtrees (see walk_scan)."""
        from minio_tpu_torch.storage.meta_scan import PREFIX_MARK, scan_entry
        full = os.path.join(vol, base_dir) if base_dir else vol
        try:
            with os.scandir(full) as it:
                dirs = [e.name for e in it if e.is_dir(follow_symlinks=False)]
        except (FileNotFoundError, NotADirectoryError):
            return
        events = sorted([(n, n, True) for n in dirs]
                        + [(n + "/", n, False) for n in dirs])
        probes: dict[str, list] = {}    # child -> its subdir names

        def probe(n: str) -> list:
            if n in probes:
                return probes.pop(n)
            try:
                with os.scandir(os.path.join(full, n)) as it:
                    return [e.name for e in it
                            if e.is_dir(follow_symlinks=False)]
            except OSError:
                return []

        def has_keys_below(n: str, subdirs: list) -> bool:
            # A grandchild holding a journal (a key) or any directory (a
            # deeper tree); the first evidence ends the probe.
            for sub in subdirs:
                try:
                    with os.scandir(os.path.join(full, n, sub)) as it:
                        for e in it:
                            if e.name == META_FILE or \
                                    e.is_dir(follow_symlinks=False):
                                return True
                except OSError:
                    continue
            return False

        for _, n, obj_slot in events:
            child = f"{base_dir}/{n}" if base_dir else n
            if obj_slot:
                if not (child >= forward_from
                        or forward_from.startswith(child)):
                    continue
                sub = probe(n)
                if len(probes) < 128:
                    probes[n] = sub
                try:
                    blob = _read_raw(os.path.join(full, n, META_FILE))
                except OSError:
                    continue
                yield (child, *scan_entry(blob))
            else:
                subtree = child + "/"
                if subtree < forward_from and \
                        not forward_from.startswith(subtree):
                    continue
                if has_keys_below(n, probe(n)):
                    yield subtree, PREFIX_MARK, None

    def create_file(self, volume: str, path: str, chunks, append: bool = False,
                    sync: bool = True) -> None:
        """Write (or with append=True, extend) a shard file from an
        iterable of bytes-like chunks; fdatasync when `sync`."""
        dest = self._obj_dir(volume, path)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "ab" if append else "wb") as f:
            for c in chunks:
                f.write(c)
            f.flush()
            if sync:
                os.fdatasync(f.fileno())

    def read_file(self, volume: str, path: str, offset: int = 0,
                  length: int = -1) -> bytes:
        try:
            with open(self._obj_dir(volume, path), "rb") as f:
                f.seek(offset)
                return f.read() if length < 0 else f.read(length)
        except FileNotFoundError:
            raise FileNotFoundErr(f"{volume}/{path}") from None

    def read_file_into(self, volume: str, path: str, offset: int,
                       bufs: list) -> int:
        """Scatter-read a shard file from `offset` into `bufs` (writable
        buffers, filled in order; one preadv); returns the bytes read,
        short at the end of the file."""
        try:
            fd = os.open(self._obj_dir(volume, path), os.O_RDONLY)
        except FileNotFoundError:
            raise FileNotFoundErr(f"{volume}/{path}") from None
        try:
            return os.preadv(fd, bufs, offset)
        finally:
            os.close(fd)

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        full = self._obj_dir(volume, path)
        try:
            if recursive:
                shutil.rmtree(full)
            elif os.path.isdir(full):
                os.rmdir(full)
            else:
                os.remove(full)
        except FileNotFoundError:
            raise FileNotFoundErr(f"{volume}/{path}") from None
        self._rm_empty_parents(os.path.dirname(full), self._vol_dir(volume))

    def _rm_empty_parents(self, d: str, stop: str) -> None:
        while d.startswith(stop + os.sep):
            try:
                os.rmdir(d)
            except OSError as e:
                if e.errno in (errno.ENOTEMPTY, errno.EEXIST, errno.ENOENT):
                    return
                raise
            d = os.path.dirname(d)

    # -- version journal ----------------------------------------------------

    def _meta_path(self, volume: str, path: str) -> str:
        return os.path.join(self._obj_dir(volume, path), META_FILE)

    def _read_meta(self, volume: str, path: str) -> XLMeta:
        try:
            with open(self._meta_path(volume, path), "rb") as f:
                return XLMeta.load(f.read())
        except (FileNotFoundError, NotADirectoryError):
            raise FileNotFoundErr(f"{volume}/{path}") from None

    def _reclaim_data_dir(self, volume: str, path: str, data_dir: str) -> None:
        if data_dir:
            shutil.rmtree(os.path.join(self._obj_dir(volume, path), data_dir),
                          ignore_errors=True)

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        """Append/replace one version in the journal (inline objects)."""
        with self._path_lock(volume, path):
            try:
                xl = self._read_meta(volume, path)
            except FileNotFoundErr:
                xl = XLMeta()
            if xl.version_unchanged(fi):
                return
            old_ddir = xl.add_version(fi)
            self._atomic_write(self._meta_path(volume, path), xl.dump())
            self._reclaim_data_dir(volume, path, old_ddir)

    def read_version(self, volume: str, path: str, version_id: str = "",
                     read_data: bool = False) -> FileInfo:
        xl = self._read_meta(volume, path)
        return xl.to_fileinfo(volume, path, version_id, read_data=read_data)

    def list_versions(self, volume: str, path: str) -> list[FileInfo]:
        return self._read_meta(volume, path).list_versions(volume, path)

    def delete_version(self, volume: str, path: str,
                       version_id: str = "") -> None:
        """Remove one version, and its data dir unless another version
        still points at it; remove the object dir when the journal
        empties."""
        with self._path_lock(volume, path):
            xl = self._read_meta(volume, path)
            data_dir = xl.delete_version(version_id)
            self._reclaim_data_dir(volume, path, data_dir)
            if not xl.versions:
                self.delete(volume, path, recursive=True)
                return
            self._atomic_write(self._meta_path(volume, path), xl.dump())

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Atomically commit staged shard data + a new version: move
        <src>/<src_path>/<data_dir> into the object dir, then write the
        merged journal (the commit point)."""
        dst_dir = self._obj_dir(dst_volume, dst_path)
        with self._path_lock(dst_volume, dst_path):
            try:
                xl = self._read_meta(dst_volume, dst_path)
            except FileNotFoundErr:
                xl = XLMeta()
            if fi.data_dir:
                src_data = os.path.join(self._obj_dir(src_volume, src_path),
                                        fi.data_dir)
                dst_data = os.path.join(dst_dir, fi.data_dir)
                os.makedirs(dst_dir, exist_ok=True)
                if os.path.isdir(dst_data):
                    shutil.rmtree(dst_data)
                os.replace(src_data, dst_data)
            old_ddir = xl.add_version(fi)
            self._atomic_write(os.path.join(dst_dir, META_FILE), xl.dump())
            self._reclaim_data_dir(dst_volume, dst_path, old_ddir)
        shutil.rmtree(self._obj_dir(src_volume, src_path), ignore_errors=True)

    # -- the group commit protocol (storage/group_commit.py lanes) ----------

    def commit_group(self, ops: list, _info: Optional[dict] = None) -> list:
        """Commit a batch of write_metadata / rename_data ops
        (storage/group_commit.GroupOp) as one journal pass
        (minio_tpu/storage/local.py `commit_group`). Returns one result a
        member: None when committed, else the member's exception; a
        member's fault never fails its batch-mates (isolation is per
        member for merge faults, per object for journal-write faults).

          1. each rename_data member's staged data dir moves in;
          2. one journal read-modify-write per distinct object, its
             members merged in arrival order (a hot-key overwrite storm
             is one rewrite; byte-identical re-adds skip);
          3. ONE frame holding every merged journal is appended to the
             drive's WAL and fdatasynced: the batch's durability point;
          4. each journal lands without a sync of its own, directly for
             a fresh object, through tmp + rename over an old one (a
             journal torn by a power cut is repaired from the WAL at
             boot, group_commit.replay_wals);
          5. one directory fsync a distinct parent under MTPU_FS_OSYNC;
          6. replaced data dirs are reclaimed, staging is cleared.

        `_info` receives the batch's accounting: objects, merged
        (same-object members past the first), noops, fsyncs_saved."""
        results: list = [None] * len(ops)
        info = _info if _info is not None else {}
        for key in ("objects", "merged", "noops", "fsyncs_saved"):
            info.setdefault(key, 0)
        groups: dict[tuple, list[int]] = {}
        for i, op in enumerate(ops):
            groups.setdefault((op.volume, op.path), []).append(i)
        # Every path lock of the batch, in sorted order: a fixed global
        # order cannot deadlock with another batch, and solo ops take one.
        lks = [self._path_lock(v, p) for (v, p) in sorted(groups)]
        for lk in lks:
            lk.acquire()
        staging_cleanup: list[tuple[str, str]] = []
        try:
            staged: list = []     # (meta path, blob, members, reclaims, fresh)
            reclaims: list = []   # applied once the new journal landed
            for (vol, path), idxs in groups.items():
                try:
                    dst_dir = self._obj_dir(vol, path)
                except StorageError as e:
                    for i in idxs:
                        results[i] = e
                    continue
                meta_path = os.path.join(dst_dir, META_FILE)
                fresh = False
                try:
                    xl = XLMeta.load(_read_raw(meta_path))
                except (FileNotFoundError, NotADirectoryError):
                    xl, fresh = XLMeta(), True
                except (OSError, MetaError, ValueError) as e:
                    for i in idxs:
                        results[i] = e
                    continue
                if fresh:
                    # The data-dir moves and the journal need the object
                    # dir: one mkdir now.
                    try:
                        os.mkdir(dst_dir)
                    except FileExistsError:
                        pass
                    except FileNotFoundError:
                        os.makedirs(dst_dir, exist_ok=True)
                changed = False
                ok_idxs: list[int] = []
                obj_reclaims: list[str] = []
                for i in idxs:
                    op = ops[i]
                    # A member's fault must not poison the journal its
                    # same-object mates commit.
                    snap = (list(xl.versions), dict(xl.inline))
                    try:
                        if op.kind == "rd":
                            old = xl.add_version(op.fi)
                            if op.fi.data_dir:
                                src = os.path.join(
                                    self._obj_dir(op.src_volume, op.src_path),
                                    op.fi.data_dir)
                                dd = os.path.join(dst_dir, op.fi.data_dir)
                                if os.path.isdir(dd):
                                    shutil.rmtree(dd)
                                os.replace(src, dd)
                            if old:
                                obj_reclaims.append(old)
                            staging_cleanup.append((op.src_volume,
                                                    op.src_path))
                            changed = True
                        elif xl.version_unchanged(op.fi):
                            info["noops"] += 1
                        else:
                            old = xl.add_version(op.fi)
                            if old:
                                obj_reclaims.append(old)
                            changed = True
                        ok_idxs.append(i)
                    except Exception as e:  # noqa: BLE001 - per member
                        xl.versions, xl.inline = snap
                        results[i] = e
                if ok_idxs:
                    info["objects"] += 1
                    info["merged"] += len(ok_idxs) - 1
                    if changed:
                        staged.append((vol, path, meta_path, xl.dump(),
                                       ok_idxs, obj_reclaims, fresh))
            if staged:
                try:
                    self._gc_append_wal([(v, p, b) for v, p, _, b, _, _, _
                                         in staged])
                except Exception as e:  # noqa: BLE001 - batch durability
                    for *_, idxs2, _, _ in staged:
                        for i in idxs2:
                            if results[i] is None:
                                results[i] = e
                    staged = []
                try:
                    self._land_journals(staged, reclaims, results, info)
                finally:
                    if staged:
                        # Only now may a checkpoint retire the frame.
                        with self._gc_mu:
                            self._gc_landing -= 1
            for vol, path, ddir in reclaims:
                self._reclaim_data_dir(vol, path, ddir)
        finally:
            for lk in lks:
                lk.release()
        for sv, sp in staging_cleanup:
            shutil.rmtree(self._obj_dir(sv, sp), ignore_errors=True)
        return results

    def _land_journals(self, staged: list, reclaims: list, results: list,
                       info: dict) -> None:
        """Steps 4 and 5 of commit_group: write each staged journal into
        place after its WAL frame is durable."""
        # One WAL fdatasync stands for one a changed journal.
        info["fsyncs_saved"] += max(0, len(staged) - 1)
        tmp_dir = os.path.join(self.root, SYS_VOL, TMP_DIR)
        dirs: set[str] = set()
        for vol, path, meta_path, blob, idxs2, obj_reclaims, \
                was_fresh in staged:
            try:
                if was_fresh:
                    # No old journal a torn write could destroy, and no
                    # member acked yet: write in place.
                    _write_raw(meta_path, blob)
                else:
                    # Over an old journal: tmp + rename, so the old one
                    # stands until the atomic replace.
                    tmp = os.path.join(
                        tmp_dir, f"gc{os.getpid()}-{next(self._gc_seq)}")
                    _write_raw(tmp, blob)
                    os.replace(tmp, meta_path)
                dirs.add(os.path.dirname(meta_path))
                # Old data dirs go only once the new journal landed: the
                # old one still names them.
                reclaims.extend((vol, path, dd) for dd in obj_reclaims)
            except Exception as e:  # noqa: BLE001 - per object
                for i in idxs2:
                    if results[i] is None:
                        results[i] = e
        if FS_OSYNC:
            for d in sorted(dirs):
                self._fsync_dir(d)

    # False on a drive whose WAL only an explicit gc_checkpoint() may
    # retire (tests); the process-wide checkpoint coordinator skips it.
    _gc_auto = True

    def _gc_append_wal(self, recs: list) -> None:
        """Append one batch frame to this drive's WAL and fdatasync it:
        the batch's durability point. The file is made once and held
        open; checkpoints truncate it in place (storage/group_commit)."""
        from minio_tpu_torch.storage import group_commit as gc_mod
        frame = gc_mod.encode_frame(recs)
        with self._gc_mu:
            created = False
            if self._gc_wal_fd is None:
                path = gc_mod.wal_file_path(self.root)
                flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
                try:
                    fd = os.open(path, flags, 0o644)
                except FileNotFoundError:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    fd = os.open(path, flags, 0o644)
                self._gc_wal_fd, self._gc_wal_path = fd, path
                created = True
            fd = self._gc_wal_fd
            off = 0
            view = memoryview(frame)
            while off < len(frame):
                off += os.write(fd, view[off:])
            os.fdatasync(fd)
            if created and FS_OSYNC:
                self._fsync_dir(os.path.dirname(self._gc_wal_path))
            self._gc_dirty += 1
            self._gc_landing += 1       # commit_group lowers it
        if self._gc_auto:
            gc_mod.schedule_checkpoint(self)

    def gc_pending(self) -> int:
        """Frames appended since the last checkpoint."""
        with self._gc_mu:
            return self._gc_dirty

    def gc_covered(self) -> int:
        """The frames a sync started now would make retirable: every
        pending frame once each batch's journals have been written, and
        0 while a batch is between its WAL append and the end of its
        journal writes (the sync could miss those writes)."""
        with self._gc_mu:
            return 0 if self._gc_landing else self._gc_dirty

    def gc_truncate_wal(self, expect: Optional[int] = None) -> int:
        """Drop the WAL's frames once the caller has made the renamed
        journals durable (os.sync); returns the frames dropped. With
        `expect`, a count that moved since the caller's sync skips the
        truncate: a frame appended after the sync was not covered by it
        and retires at the next checkpoint."""
        with self._gc_mu:
            n = self._gc_dirty
            if n == 0 or (expect is not None and n != expect):
                return 0
            if self._gc_wal_fd is not None:
                try:
                    os.ftruncate(self._gc_wal_fd, 0)
                except OSError:
                    pass
            self._gc_dirty = 0
        return n

    def gc_checkpoint(self) -> int:
        """Make every renamed journal durable (one os.sync) and drop the
        WAL frames that protected them; returns the frames dropped. The
        set's close runs it, so a graceful stop leaves nothing to
        replay."""
        pre = self.gc_covered()
        if not pre:
            return 0
        os.sync()
        return self.gc_truncate_wal(expect=pre)

    def _gc_reopen_if_unlinked(self) -> None:
        """Drop the cached WAL descriptor when its file is no longer
        linked (the drive was wiped under it), so the next batch opens
        the WAL at its path again."""
        with self._gc_mu:
            fd = self._gc_wal_fd
            if fd is None:
                return
            try:
                linked = os.fstat(fd).st_nlink > 0
            except OSError:
                linked = False
            if linked:
                return
            self._gc_wal_fd = None
        try:
            os.close(fd)
        except OSError:
            pass

    def gc_close(self) -> None:
        """Close the WAL's descriptor (after a final checkpoint; an empty
        WAL file may remain, and replays to nothing)."""
        with self._gc_mu:
            fd, self._gc_wal_fd = self._gc_wal_fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass


# -- the healing marker (drive replacement) -----------------------------------
# Through the storage API (read_all/write_all/delete), so the helpers work
# on a LocalStorage and on a health-wrapped drive alike; the tracker JSON
# is object/drive_heal.py's.


def read_healing(disk) -> Optional[dict]:
    """The drive's healing tracker, or None (absent or unreachable)."""
    try:
        return json.loads(disk.read_all(SYS_VOL, HEALING_FILE))
    except Exception:  # noqa: BLE001 - no marker == not healing
        return None


def write_healing(disk, tracker: dict) -> None:
    disk.write_all(SYS_VOL, HEALING_FILE,
                   json.dumps(tracker, indent=1).encode())


def clear_healing(disk) -> None:
    try:
        disk.delete(SYS_VOL, HEALING_FILE)
    except Exception:  # noqa: BLE001 - already gone, or offline
        pass


# -- boot-time crash recovery -------------------------------------------------

# Present only when the previous process stopped through its shutdown
# path: its absence at boot means a crash, which is what the deep
# recovery sweep is for (minio_tpu/storage/local.py CLEAN_SHUTDOWN_FILE).
CLEAN_SHUTDOWN_FILE = "clean.shutdown"


def mark_clean_shutdown(disk) -> None:
    try:
        with open(os.path.join(disk.root, SYS_VOL, CLEAN_SHUTDOWN_FILE),
                  "wb") as f:
            f.write(b"1")
    except OSError:
        pass


def consume_clean_shutdown(disk) -> bool:
    """Whether the previous stop was graceful; consumes the stamp so the
    next boot decides afresh."""
    try:
        os.remove(os.path.join(disk.root, SYS_VOL, CLEAN_SHUTDOWN_FILE))
        return True
    except OSError:
        return False


def _staging_owner_pid(name: str) -> Optional[int]:
    """The pid in a pid-tagged staging entry name (`p<pid>-<uuid>`)."""
    if not name.startswith("p"):
        return None
    head = name[1:].split("-", 1)[0]
    return int(head) if head.isdigit() else None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True        # EPERM: it exists, owned by someone else


def sweep_stale_tmp(disk, min_age: float = 0.0) -> int:
    """Remove crash leftovers under the system volume's tmp/ and
    staging/ (minio_tpu/storage/local.py `sweep_stale_tmp`); returns the
    entries removed. A pid-tagged staging entry of another live process
    stays; an untagged entry younger than `min_age` seconds stays."""
    now = time.time()
    me = os.getpid()
    removed = 0
    for sub in (TMP_DIR, "staging"):
        base = os.path.join(disk.root, SYS_VOL, sub)
        try:
            entries = os.listdir(base)
        except (FileNotFoundError, NotADirectoryError):
            continue
        for name in entries:
            full = os.path.join(base, name)
            pid = _staging_owner_pid(name)
            if pid is not None:
                if pid != me and _pid_alive(pid):
                    continue
            elif min_age > 0:
                try:
                    if now - os.lstat(full).st_mtime < min_age:
                        continue
                except OSError:
                    continue
            try:
                if os.path.isdir(full):
                    shutil.rmtree(full)
                else:
                    os.unlink(full)
                removed += 1
            except OSError:
                continue
    return removed


def _only_part_files(d: str) -> bool:
    """Whether `d` holds nothing but shard part files: the shape of a
    version data dir, never of a key prefix."""
    try:
        names = os.listdir(d)
    except OSError:
        return False
    return bool(names) and all(
        n.startswith("part.") and os.path.isfile(os.path.join(d, n))
        for n in names)


def recovery_sweep(disk, min_age: float = 0.0) -> dict:
    """Boot-time crash recovery of one drive, before it serves
    (minio_tpu/storage/local.py `recovery_sweep`):

      0. the group-commit WALs replay first (group_commit.replay_wals),
         so journals a batch acknowledged are in place before the scan
         below decides what is dangling;
      1. stale tmp/ and staging/ entries go (sweep_stale_tmp);
      2. a UUID-named, part-files-only child that no journal version
         names is the uncommitted half of a rename_data: removed;
      3. a journal that does not parse is removed and its object
         reported for heal (the other drives hold the quorum copy);
      4. a version whose data dir is missing is reported for heal.

    Returns {"removed", "dangling", "heal": [(bucket, path)],
    "wal_replayed", "wal_repaired", "wal_discarded"}; the caller queues
    the heal list on the set's MRF."""
    from minio_tpu_torch.storage.group_commit import replay_wals
    gc = replay_wals(disk)
    out = {"removed": sweep_stale_tmp(disk, min_age), "dangling": 0,
           "heal": [], "wal_replayed": gc["replayed"],
           "wal_repaired": gc["repaired"],
           "wal_discarded": gc["discarded"]}
    root = disk.root

    def scan(vol: str, rel: str) -> None:
        base = os.path.join(root, vol, rel) if rel else os.path.join(root,
                                                                     vol)
        meta_path = os.path.join(base, META_FILE)
        refs: Optional[frozenset] = None
        if os.path.isfile(meta_path):
            try:
                xl = XLMeta.load(_read_raw(meta_path))
                refs = frozenset(v.get("ddir", "") for v in xl.versions
                                 if v.get("ddir"))
                if any(v.get("ddir") and not v.get("inline")
                       and not os.path.isdir(os.path.join(base, v["ddir"]))
                       for v in xl.versions):
                    out["heal"].append((vol, rel))
            except (OSError, MetaError):
                try:
                    os.remove(meta_path)
                except OSError:
                    pass
                out["heal"].append((vol, rel))
                refs = frozenset()
        try:
            names = os.listdir(base)
        except OSError:
            return
        for n in names:
            if n == META_FILE:
                continue
            full = os.path.join(base, n)
            if not os.path.isdir(full):
                continue
            if _is_uuid(n) and _only_part_files(full) \
                    and (refs is None or n not in refs):
                shutil.rmtree(full, ignore_errors=True)
                out["dangling"] += 1
                continue
            scan(vol, f"{rel}/{n}" if rel else n)
        try:
            if rel and not os.listdir(base):
                os.rmdir(base)
        except OSError:
            pass

    try:
        vols = sorted(os.listdir(root))
    except OSError:
        return out
    for vol in vols:
        if vol != SYS_VOL and _is_valid_volname(vol) and \
                os.path.isdir(os.path.join(root, vol)):
            scan(vol, "")
    return out

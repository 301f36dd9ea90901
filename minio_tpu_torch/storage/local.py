"""Local drive backend: the per-drive POSIX storage the slice uses.

The subset of minio_tpu/storage/local.py that PutObject, GetObject,
DeleteObject, multipart uploads and healing need, with the same on-disk
layout:

    <root>/<volume>/<object>/xl.meta            version journal (meta.py)
    <root>/<volume>/<object>/<dataDir>/part.N   bitrot-framed shard file
    <root>/.mtpu.sys/staging/...                staging for commits
    <root>/.mtpu.sys/multipart/...              uploads in progress
    <root>/.mtpu.sys/mrf/pending.json           the MRF heal queue
    <root>/.mtpu.sys/tmp/<uuid>                 atomic-write temporaries

Shard files are written into staging and committed with rename_data:
the data dir moves into the object dir first, then the merged journal is
written atomically (tmp + fdatasync + rename) as the commit point
(reference: CreateFile cmd/xl-storage.go:2092, RenameData :2557).
"""

from __future__ import annotations

import errno
import os
import shutil
import threading
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Iterator, Optional

from minio_tpu_torch.storage.meta import (FileInfo, FileNotFoundErr,
                                          MetaError, XLMeta)

SYS_VOL = ".mtpu.sys"
META_FILE = "xl.meta"
TMP_DIR = "tmp"


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


def _is_valid_volname(vol: str) -> bool:
    return bool(vol) and vol not in (".", "..") and "/" not in vol \
        and "\\" not in vol


class LocalStorage:
    """One local drive. All paths are (volume, object-path) pairs."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._lock = threading.Lock()
        self._path_locks: dict[str, threading.Lock] = {}
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

    def _atomic_write(self, dest: str, data: bytes) -> None:
        """tmp + fdatasync + rename: the crash-consistency primitive."""
        tmp = os.path.join(self.root, SYS_VOL, TMP_DIR, str(uuid_mod.uuid4()))
        os.makedirs(os.path.dirname(tmp), exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fdatasync(f.fileno())
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        os.replace(tmp, dest)

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

    def walk_dir(self, volume: str, base_dir: str = "",
                 recursive: bool = True,
                 forward_from: str = "") -> Iterator[tuple[str, bytes]]:
        """Yield (object path, raw xl.meta) for the objects under
        `base_dir` in S3 key order, streaming (minio_tpu/storage/local.py
        `walk_dir`; reference WalkDir, cmd/metacache-walk.go:73). A
        directory that holds xl.meta is an object; the children its
        journal names as data dirs are its shard storage, any other
        child is a key of its own. A directory `d` sorts as the key "d"
        (before siblings such as "d-x") and as the prefix "d/" (after
        them). Subtrees wholly before `forward_from` are not entered, so
        a walk that resumes at a marker costs about the keys after it.
        recursive=False yields each subtree once as ("d/", b"")."""
        vol = self._vol_dir(volume)
        if not os.path.isdir(vol):
            raise VolumeNotFound(volume)

        # The journal last read, for the descend event of the same dir:
        # one slot (an object's subtree is walked right after it).
        last = ["", b""]

        def journal(rel: str) -> Optional[bytes]:
            if last[0] == rel:
                return last[1]
            try:
                with open(os.path.join(vol, rel, META_FILE), "rb") as f:
                    blob = f.read()
            except (FileNotFoundError, NotADirectoryError):
                return None
            last[0], last[1] = rel, blob
            return blob

        def data_dirs(rel: str) -> frozenset:
            """The data dirs rel's journal names: only those children
            are shard storage; any other one is a key."""
            try:
                return frozenset(v.get("ddir") for v in
                                 XLMeta.load(journal(rel) or b"").versions
                                 if v.get("ddir"))
            except MetaError:
                return frozenset()

        def walk(rel: str, rel_is_obj: bool) -> Iterator[tuple[str, bytes]]:
            full = os.path.join(vol, rel) if rel else vol
            try:
                names = os.listdir(full)
            except (FileNotFoundError, NotADirectoryError):
                return
            ddirs: Optional[frozenset] = None     # parsed when needed
            events = []
            for n in names:
                if n == META_FILE:
                    continue
                if rel_is_obj and _is_uuid(n):
                    if ddirs is None:
                        ddirs = data_dirs(rel)
                    if n in ddirs:
                        continue
                if os.path.isdir(os.path.join(full, n)):
                    events += [(n, n, False), (n + "/", n, True)]
            for _, n, descend in sorted(events):
                child = f"{rel}/{n}" if rel else n
                if not descend:
                    if child >= forward_from or \
                            forward_from.startswith(child):
                        blob = journal(child)
                        if blob is not None:
                            yield child, blob
                    continue
                subtree = child + "/"
                if subtree < forward_from and \
                        not forward_from.startswith(subtree):
                    continue
                if not recursive:
                    yield subtree, b""
                    continue
                yield from walk(child, os.path.exists(
                    os.path.join(vol, child, META_FILE)))

        yield from walk(base_dir, bool(base_dir) and os.path.exists(
            os.path.join(vol, base_dir, META_FILE)))

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

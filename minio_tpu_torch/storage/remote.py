"""Remote drives: the storage API of drives that live in other nodes.

The port of minio_tpu/storage/remote.py (reference
cmd/storage-rest-client.go / cmd/storage-rest-server.go):
`RemoteStorage` answers the calls the erasure layer, the metacache, the
scanner, heal, drive heal and the pools make on a drive, by forwarding
each over the grid (grid/client.py) to the node that owns the drive;
`StorageRPCService` is that node's side, serving its local drives. A
handler's exception comes back as the same exception type through the
grid's error codes, so quorum logic and the health wrapper cannot tell
a remote drive from a local one: a missing file is FileNotFoundErr on
both, and a grid transport fault is a StorageError, a drive fault.

Bulk bytes ride raw frames: a shard file is read as one stream of raw
frames the owner ships with os.sendfile (`read_file_into` scatters
them into the caller's pooled buffers), and written as one client-push
stream the owner writes through LocalStorage.create_file (append and
sync included, as heal's windowed rewrite needs). The chunks of a
streamed PUT are gathered into raw frames of up to 1 MiB.

Group commit (`commit_group`, `gc_*`) stays local: a set with a remote
drive commits each journal on its own (object/erasure_object.py).
A RemoteStorage has no `root`: nothing that writes beside the storage
API (clean-shutdown stamps, recovery sweeps, persisted listings) picks
it.

For an armed caller each served drive op is one `disk.<op>` storage
span on the owner, which the grid ships back into the caller's tree.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace
from typing import Optional

from minio_tpu_torch.grid import chaos, wire
from minio_tpu_torch.grid.client import client_for
from minio_tpu_torch.grid.server import GridServer, register_error
from minio_tpu_torch.grid.wire import GridError, RemoteCallError
from minio_tpu_torch.storage.local import (DiskAccessDenied, DiskInfo,
                                           FaultyDisk, LocalStorage,
                                           StorageError, VolInfo,
                                           VolumeExists, VolumeNotEmpty,
                                           VolumeNotFound)
from minio_tpu_torch.storage.meta import (ErasureInfo, FileInfo,
                                          FileNotFoundErr, MetaError,
                                          ObjectPartInfo, VersionNotFoundErr)
from minio_tpu_torch.storage.meta_scan import PREFIX_MARK
from minio_tpu_torch.utils import tracing

# One raw frame of a bulk transfer, and the batch size of a walk
# stream: small enough to interleave with lock frames on the shared
# connection.
CHUNK = 1 << 20

# walk_scan wire entry kinds: [path, kind, payload...] an entry (the
# JAX package's).
_WS_SUMMARY = 0        # [path, 0, vlist]            trimmed summary
_WS_SUMMARY_BLOB = 1   # [path, 1, vlist, blob]      summary + journal
_WS_BLOB = 2           # [path, 2, blob]             no summary
_WS_MARK = 3           # [path, 3]                   shallow prefix mark

# Wire code -> exception class. The builtin OSErrors are here because a
# local drive raises them too and its callers tell them apart (a GET
# takes an OSError for a missing shard; the health wrapper takes
# IsADirectoryError and NotADirectoryError for the drive answering).
_CODE_TO_EXC = {
    "FileNotFound": FileNotFoundErr,
    "VersionNotFound": VersionNotFoundErr,
    "VolumeNotFound": VolumeNotFound,
    "VolumeExists": VolumeExists,
    "VolumeNotEmpty": VolumeNotEmpty,
    "DiskAccessDenied": DiskAccessDenied,
    "FaultyDisk": FaultyDisk,
    "MetaError": MetaError,
    "StorageError": StorageError,
    "FileNotFoundError": FileNotFoundError,
    "IsADirectoryError": IsADirectoryError,
    "NotADirectoryError": NotADirectoryError,
    "OSError": OSError,
    "ValueError": ValueError,
    "KeyError": KeyError,
}
for _code, _exc in _CODE_TO_EXC.items():
    register_error(_exc, _code)


def _raise_mapped(e: RemoteCallError):
    exc = _CODE_TO_EXC.get(e.code)
    if exc is not None:
        raise exc(str(e)) from None
    raise StorageError(str(e)) from None


def fi_to_wire(fi: FileInfo) -> dict:
    return {"v": fi.volume, "n": fi.name, "vid": fi.version_id,
            "lt": fi.is_latest, "del": fi.deleted, "dd": fi.data_dir,
            "mt": fi.mod_time, "sz": fi.size, "meta": fi.metadata,
            "parts": [p.to_map() for p in fi.parts],
            "ec": fi.erasure.to_map(), "inl": fi.inline_data}


def fi_from_wire(d: dict) -> FileInfo:
    return FileInfo(volume=d["v"], name=d["n"], version_id=d["vid"],
                    is_latest=d["lt"], deleted=d["del"], data_dir=d["dd"],
                    mod_time=d["mt"], size=d["sz"], metadata=d["meta"],
                    parts=[ObjectPartInfo.from_map(p) for p in d["parts"]],
                    erasure=ErasureInfo.from_map(d["ec"]),
                    inline_data=d["inl"])


def _scatter(view, bufs: list, pos: int) -> int:
    """Copy `view` into the concatenation of `bufs` from byte `pos`;
    returns the bytes copied (short when the buffers end first)."""
    done = 0
    base = 0
    for b in bufs:
        mv = memoryview(b).cast("B")
        end = base + len(mv)
        if pos < end and done < len(view):
            lo = pos - base
            n = min(len(mv) - lo, len(view) - done)
            mv[lo:lo + n] = view[done:done + n]
            done += n
            pos += n
        base = end
    return done


class RemoteStorage:
    """A drive on another node: LocalStorage's calls, over the grid."""

    def __init__(self, host: str, port: int, path: str,
                 endpoint: str = ""):
        """`port` is the peer's grid port; `endpoint`, the drive's
        endpoint as the command line names it (the peer's S3 port), is
        what every node calls the drive: a pool's signature
        (object/decom.pool_signature) must read the same on each."""
        self.host = host
        self.port = port
        self.path = path
        self.endpoint = endpoint or f"http://{host}:{port}{path}"

    def _client(self):
        return client_for(self.host, self.port)

    def _call(self, method: str, *args, timeout: Optional[float] = None):
        try:
            return self._client().call(
                "st." + method, {"d": self.path, "a": list(args)},
                timeout=timeout)
        except RemoteCallError as e:
            _raise_mapped(e)
        except GridError as e:
            raise StorageError(f"remote drive {self.endpoint}: {e}") from None

    # -- identity --------------------------------------------------------

    def read_format(self) -> Optional[dict]:
        return self._call("read_format")

    def write_format(self, fmt: dict) -> None:
        self._call("write_format", fmt)

    def disk_id(self) -> str:
        return self._call("disk_id")

    def disk_info(self) -> DiskInfo:
        return DiskInfo(**self._call("disk_info"))

    # -- volumes ---------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        self._call("make_vol", volume)

    def make_vol_if_missing(self, volume: str) -> None:
        self._call("make_vol_if_missing", volume)

    def list_vols(self) -> list[VolInfo]:
        return [VolInfo(name=v["name"], created=v["created"])
                for v in self._call("list_vols")]

    def stat_vol(self, volume: str) -> VolInfo:
        v = self._call("stat_vol", volume)
        return VolInfo(name=v["name"], created=v["created"])

    def delete_vol(self, volume: str, force: bool = False) -> None:
        self._call("delete_vol", volume, force)

    # -- files -----------------------------------------------------------

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self._call("write_all", volume, path, bytes(data))

    def read_all(self, volume: str, path: str) -> bytes:
        return self._call("read_all", volume, path)

    def stat_info_file(self, volume: str, path: str):
        st = self._call("stat_info_file", volume, path)
        return SimpleNamespace(st_size=st["size"], st_mtime=st["mtime"])

    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None:
        self._call("rename_file", src_volume, src_path, dst_volume, dst_path)

    def list_dir(self, volume: str, dir_path: str) -> list[str]:
        return self._call("list_dir", volume, dir_path)

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        self._call("delete", volume, path, recursive)

    def create_file(self, volume: str, path: str, chunks, append: bool = False,
                    sync: bool = True) -> None:
        """LocalStorage.create_file on the owner: one flow-controlled
        push stream; chunks are gathered into raw frames of up to
        CHUNK bytes (a streamed PUT's digests and blocks are a few
        dozen bytes and ~87 KB each)."""
        def frames():
            buf = bytearray()
            for c in chunks:
                mv = memoryview(c)
                buf += mv if mv.ndim == 1 and mv.format == "B" \
                    else mv.cast("B")
                if len(buf) >= CHUNK:
                    yield buf
                    buf = bytearray()
            if buf:
                yield buf
        try:
            self._client().push_raw(
                "st.create_file_raw",
                {"d": self.path, "a": [volume, path, append, sync]},
                frames())
        except RemoteCallError as e:
            _raise_mapped(e)
        except GridError as e:
            raise StorageError(f"remote drive {self.endpoint}: {e}") from None

    def _read_raw(self, volume: str, path: str, offset: int, length: int):
        """Yield the size header's byte count, then (view, lease) pairs
        of the file region [offset, offset+length)."""
        try:
            for item in self._client().stream(
                    "st.read_file_raw",
                    {"d": self.path, "a": [volume, path, offset, length]},
                    raw=True):
                yield item
        except RemoteCallError as e:
            _raise_mapped(e)
        except GridError as e:
            raise StorageError(f"remote drive {self.endpoint}: {e}") from None

    def read_file(self, volume: str, path: str, offset: int = 0,
                  length: int = -1) -> bytes:
        out = bytearray()
        for item in self._read_raw(volume, path, offset, length):
            if isinstance(item, tuple):
                view, lease = item
                try:
                    out += view
                finally:
                    if lease is not None:
                        lease.release()
        return bytes(out)

    def read_file_into(self, volume: str, path: str, offset: int,
                       bufs: list) -> int:
        """Scatter-read the shard file from `offset` into `bufs`, as
        LocalStorage.read_file_into does: the owner ships exactly the
        buffers' length (less at the end of the file)."""
        want = sum(memoryview(b).nbytes for b in bufs)
        got = 0
        for item in self._read_raw(volume, path, offset, want):
            if isinstance(item, tuple):
                view, lease = item
                try:
                    got += _scatter(view, bufs, got)
                finally:
                    if lease is not None:
                        lease.release()
        return got

    # -- version journal -------------------------------------------------

    def write_metadata(self, volume: str, path: str, fi: FileInfo,
                       keep_prev: bool = False) -> None:
        self._call("write_metadata", volume, path, fi_to_wire(fi), keep_prev)

    def read_version(self, volume: str, path: str, version_id: str = "",
                     read_data: bool = False) -> FileInfo:
        return fi_from_wire(self._call("read_version", volume, path,
                                       version_id, read_data))

    def list_versions(self, volume: str, path: str) -> list[FileInfo]:
        return [fi_from_wire(d)
                for d in self._call("list_versions", volume, path)]

    def delete_version(self, volume: str, path: str, version_id: str = "",
                       keep_prev: bool = False) -> None:
        self._call("delete_version", volume, path, version_id, keep_prev)

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str,
                    keep_prev: bool = False) -> None:
        self._call("rename_data", src_volume, src_path, fi_to_wire(fi),
                   dst_volume, dst_path, keep_prev)

    def settle_prev(self, volume: str, path: str, keep: bool) -> None:
        self._call("settle_prev", volume, path, keep)

    # -- listing ---------------------------------------------------------

    def walk_scan(self, volume: str, base_dir: str = "",
                  forward_from: str = "", shallow: bool = False):
        """LocalStorage.walk_scan on the owner, streamed in batches:
        the same (path, vlist, blob) triples, summaries as tuples of
        tuples and the PREFIX_MARK of shallow pages."""
        try:
            for batch in self._client().stream(
                    "st.walk_scan",
                    {"d": self.path, "a": [volume, base_dir, forward_from,
                                           bool(shallow)]}):
                for ent in batch:
                    path, kind = ent[0], ent[1]
                    if kind == _WS_MARK:
                        yield path, PREFIX_MARK, None
                    elif kind == _WS_BLOB:
                        yield path, None, ent[2]
                    else:
                        vlist = tuple(tuple(v) for v in ent[2])
                        blob = ent[3] if kind == _WS_SUMMARY_BLOB else None
                        yield path, vlist, blob
        except RemoteCallError as e:
            _raise_mapped(e)
        except GridError as e:
            raise StorageError(f"remote drive {self.endpoint}: {e}") from None


def _span_unary(name: str, fn):
    """The owner's span of an armed caller's drive op: the grid server
    runs the handler bound to the shipped trace context, so `disk.<op>`
    lands in the subtree that goes back with the reply. Disarmed, one
    attribute check."""
    def handler(payload):
        if not tracing.ACTIVE:
            return fn(payload)
        tags = {"drive": payload.get("d", "")} \
            if isinstance(payload, dict) else None
        with tracing.span("storage", f"disk.{name}", tags):
            return fn(payload)
    return handler


def _span_stream(name: str, fn):
    """_span_unary for a stream: the span covers the generator from its
    first pull to its end, and is recorded before the EOF frame ships
    the subtree."""
    def handler(payload):
        if not tracing.ACTIVE:
            yield from fn(payload)
            return
        tags = {"drive": payload.get("d", "")} \
            if isinstance(payload, dict) else None
        with tracing.span("storage", f"disk.{name}", tags):
            yield from fn(payload)
    return handler


class StorageRPCService:
    """The owner's side: serves this node's local drives on the grid."""

    _UNARY = ("read_format write_format disk_id make_vol make_vol_if_missing "
              "delete_vol write_all read_all delete rename_file list_dir "
              "delete_version settle_prev").split()

    def __init__(self, disks: dict[str, LocalStorage]):
        self.disks = dict(disks)     # drive path -> LocalStorage

    def _disk(self, payload: dict) -> LocalStorage:
        # A hung remote drive for the cluster tests: every storage RPC
        # passes here (grid/chaos.py).
        delay = chaos.drive_delay()
        if delay > 0:
            time.sleep(delay)
        d = self.disks.get(payload.get("d", ""))
        if d is None:
            raise StorageError(f"no such drive: {payload.get('d')!r}")
        return d

    def register_into(self, srv: GridServer) -> None:
        for name in self._UNARY:
            srv.register(f"st.{name}",
                         _span_unary(name, self._make_unary(name)))
        for name in ("stat_vol", "list_vols", "stat_info_file",
                     "write_metadata", "read_version", "list_versions",
                     "rename_data", "disk_info"):
            srv.register(f"st.{name}",
                         _span_unary(name, getattr(self, f"_{name}")))
        srv.register_stream("st.read_file_raw", _span_stream(
            "read_file_raw", self._read_file_raw))
        srv.register_stream("st.walk_scan",
                            _span_stream("walk_scan", self._walk_scan))
        srv.register_sink("st.create_file_raw", self._create_file_raw)

    def _make_unary(self, name: str):
        def handler(payload):
            return getattr(self._disk(payload), name)(*payload.get("a", ()))
        return handler

    def _stat_vol(self, payload):
        v = self._disk(payload).stat_vol(*payload["a"])
        return {"name": v.name, "created": v.created}

    def _list_vols(self, payload):
        return [{"name": v.name, "created": v.created}
                for v in self._disk(payload).list_vols()]

    def _stat_info_file(self, payload):
        st = self._disk(payload).stat_info_file(*payload["a"])
        return {"size": st.st_size, "mtime": st.st_mtime}

    def _write_metadata(self, payload):
        vol, path, fid, keep_prev = payload["a"]
        self._disk(payload).write_metadata(vol, path, fi_from_wire(fid),
                                           keep_prev=keep_prev)

    def _read_version(self, payload):
        return fi_to_wire(self._disk(payload).read_version(*payload["a"]))

    def _list_versions(self, payload):
        return [fi_to_wire(fi)
                for fi in self._disk(payload).list_versions(*payload["a"])]

    def _rename_data(self, payload):
        src_vol, src_path, fid, dst_vol, dst_path, keep_prev = payload["a"]
        self._disk(payload).rename_data(src_vol, src_path, fi_from_wire(fid),
                                        dst_vol, dst_path,
                                        keep_prev=keep_prev)

    def _disk_info(self, payload):
        di = self._disk(payload).disk_info()
        return {"total": di.total, "free": di.free, "used": di.used,
                "healing": di.healing, "endpoint": di.endpoint,
                "disk_id": di.disk_id}

    def _read_file_raw(self, payload):
        """A size header, then the file region as raw frames the grid
        server ships with os.sendfile."""
        d = self._disk(payload)
        vol, path, offset, length = payload["a"]
        full = d._obj_dir(vol, path)
        try:
            size = os.path.getsize(full)
        except FileNotFoundError:
            raise FileNotFoundErr(f"{vol}/{path}") from None
        offset = max(0, int(offset or 0))
        avail = max(0, size - offset)
        length = avail if length is None or length < 0 \
            else min(int(length), avail)
        yield {"size": length}
        yield wire.RawFile(full, offset, length)

    def _create_file_raw(self, payload, frames):
        vol, path, append, sync = payload["a"]
        self._disk(payload).create_file(vol, path, frames, append=append,
                                        sync=sync)
        return True

    def _walk_scan(self, payload):
        """The owner's walk_scan, batched: summaries are tens of bytes
        a version, so one frame carries hundreds of keys."""
        d = self._disk(payload)
        vol, base_dir, forward_from, shallow = payload["a"]
        batch: list = []
        size = 0
        for path, vlist, blob in d.walk_scan(vol, base_dir=base_dir,
                                             forward_from=forward_from,
                                             shallow=bool(shallow)):
            if vlist is PREFIX_MARK:
                ent = [path, _WS_MARK]
                size += len(path) + 8
            elif vlist is None:
                ent = [path, _WS_BLOB, blob]
                size += len(path) + len(blob or b"")
            elif blob is not None:
                ent = [path, _WS_SUMMARY_BLOB, [list(v) for v in vlist], blob]
                size += len(path) + len(blob) + 64 * len(vlist)
            else:
                ent = [path, _WS_SUMMARY, [list(v) for v in vlist]]
                size += len(path) + 64 * len(vlist)
            batch.append(ent)
            if len(batch) >= 512 or size >= CHUNK:
                yield batch
                batch, size = [], 0
        if batch:
            yield batch

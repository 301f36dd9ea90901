"""Erasure object store: one erasure set of n drives, device-backed.

The port of minio_tpu/object/erasure_object.py's main path (reference
erasureObjects, cmd/erasure-object.go) for one set of local drives:

  * PutObject takes bytes or a utils.streams.Payload and never holds a
    body of more than one window: it reads the body window by window
    (STREAM_WINDOW_BLOCKS 1 MiB erasure blocks) straight into a pooled,
    pinned lease (Payload.readinto), so host and device memory stay
    O(window) for any object size. Every window's full blocks go
    through the fused device framer (ops/hh_device.make_mesh_framer:
    RS parity + the HighwayHash-256 of every shard block), whose parity
    and digests come back into a pinned lease; the ragged last block
    goes through ops/rs_device.gf_apply and
    ops/hh_device.hash_blocks_device. One writer thread per drive, fed
    by a bounded queue, streams its shard file (`digest || block` per
    erasure block) into staging while the next window is read and
    framed, and the MD5 ETag runs on a thread of its own
    (`_stream_framed_writes`; a one-window body writes through the
    set's fan-out pool instead). The payload's finish hook (content
    hash, signatures, declared checksums) runs on the last byte, before
    the commit: quorum-counted renames under the key's lock (write
    quorum k, +1 when k == m). Objects whose shard files fit
    SMALL_FILE_THRESHOLD go inline into xl.meta.
  * GetObject holds the key's read lock (object/nslock.py) until its
    stream is drained or closed, so an overwrite, delete or heal of the
    key waits for it; it picks the version agreed by read quorum and
    streams the range window by window with one window read ahead on
    the set's readahead pool. Each window's k data shards are
    scatter-read into a pinned region [block, shard, frame], every block
    digest verified on the device as the region lies
    (ops/hh_device.make_mesh_deframer), and the payload de-framed into a
    pooled output lease with one strided copy; each chunk handed out
    views that lease.
  * With drives missing, or blocks failing their digest, GetObject
    verifies the surviving shards on the device and rebuilds the data
    shards through the decode matrix on the device from a pinned stack
    of survivors (ops/rs_device.make_mesh_matrix; the ragged tail
    through GpuBackend), and queues the object on the MRF heal queue.
  * A multipart object is one independent erasure encode per part
    (`part.N` shard files, object/multipart.py): GET walks the parts,
    and its windows snap to erasure blocks inside a part, never across
    one. Healing (object/healing.py) rebuilds lost or corrupt shards of
    every part on the card, window by window.
  * The bucket namespace: each bucket's metadata record (its versioning
    state, the JAX package's `bucket-meta.json`); versioned PUTs (a
    fresh version id, or the null version when versioning is off or
    suspended), reads of a named version, delete markers and null
    markers, version removal at a majority write quorum with the MRF
    queued for the drives that missed it; listing pages served from
    the shared walk streams of object/metacache.py (a majority of the
    drives' sorted journal summaries, merged, with a quorum read
    wherever their copies of a key disagree; "/" pages from a one-level
    shallow walk), which every namespace mutation invalidates through
    `metacache.bump`.
  * The metadata plane's writes: a PUT of at most one erasure block and
    a delete marker, when other such requests are in their commit
    section, commit through the per-drive group lanes of
    storage/group_commit.py (one WAL frame and one fdatasync a drive a
    batch, replayed at boot by storage/local.recovery_sweep).

Full blocks of every window go through the cross-request stripe batcher
(ops/batcher.StripeBatcher), one per route and config: the PUT framer,
the GET verify and the degraded-read reconstruct. Windows of concurrent
requests coalesce into one device dispatch from pinned staging; a lone
window dispatches straight through (MIN_DEVICE_BLOCKS is 1 here), from
its own pinned lease when it fills its bucket. The ragged tail of a
window keeps its direct kernel calls.

There is no host cutover: on the card every window runs the kernels, and
with device="cpu" their plain PyTorch versions. The batchers' host rivals
(`_host_rows`, `_host_deframe`, `_host_apply_rows`) run only when a
caller pins a route to the host (MTPU_BATCH_FORCE=host, or force(False)),
and such windows are counted as host windows. A device exception fails
the request; nothing retries it on the host. The on-disk bytes are
identical to the TPU package's for the same objects.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import hashlib
import heapq
import json
import os
import queue
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor, as_completed
from contextlib import nullcontext
from itertools import groupby
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.erasure.codec import _HOST, Erasure
from minio_tpu_torch.io.bufpool import global_pool, leases_of
from minio_tpu_torch.io.engine import kernel_lane, shutdown_kernel_lane
from minio_tpu_torch.object.fi_cache import FileInfoCache
from minio_tpu_torch.object.metacache import MetaCache
from minio_tpu_torch.object.nslock import NSLockMap
from minio_tpu_torch.object.types import (BucketExists, BucketInfo,
                                          BucketNotEmpty, BucketNotFound,
                                          DeletedObject, DeleteOptions,
                                          GetOptions, InvalidRange,
                                          ListObjectsInfo, MethodNotAllowed,
                                          ObjectError, ObjectInfo,
                                          ObjectNotFound,
                                          PutOptions, ReadQuorumError,
                                          VersionNotFound, WriteQuorumError)
from minio_tpu_torch.ops import gf256, hh_device, rs_device
from minio_tpu_torch.ops.batcher import StripeBatcher, merge_route_stats
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.storage import group_commit as gc_mod
from minio_tpu_torch.storage.group_commit import GroupOp
from minio_tpu_torch.storage.health import DiskHealthWrapper
from minio_tpu_torch.storage.local import (SYS_VOL, FaultyDisk, StorageError,
                                           VolumeExists, VolumeNotEmpty,
                                           VolumeNotFound)
from minio_tpu_torch.storage.meta import (KIND_DELETE_MARKER,
                                          NULL_VERSION_ID, ErasureInfo,
                                          FileInfo, FileNotFoundErr,
                                          MetaError, ObjectPartInfo,
                                          VersionNotFoundErr, XLMeta,
                                          new_uuid, now_ns)
from minio_tpu_torch.storage.remote import RemoteStorage
from minio_tpu_torch.storage.meta_scan import (FLAG_DELETED, FLAG_INLINE,
                                               PREFIX_MARK,
                                               summary_sufficient)
from minio_tpu_torch.utils.highwayhash import MAGIC_KEY, highwayhash256_many
from minio_tpu_torch.utils.streams import Payload

BLOCK_SIZE = 1 << 20              # reference blockSizeV2 (cmd/object-api-common.go:37)
SMALL_FILE_THRESHOLD = 128 << 10  # inline threshold (storage-class.go:278)
STAGING_PREFIX = "staging"
# Erasure blocks per device window, PUT and GET alike: a 32 MiB window is
# one framer or deframer dispatch and bounds device memory per request.
STREAM_WINDOW_BLOCKS = 32
DIGEST = bitrot.digest_size(bitrot.DEFAULT_ALGORITHM)
# Framed windows queued ahead of each drive writer of a streamed PUT.
WRITE_QUEUE_DEPTH = 2
# Full blocks a window needs before it may take the device route on its
# own. The JAX package's 8 was tuned on a TPU; until an H100 measurement
# sets it, every window of full blocks goes to the card.
MIN_DEVICE_BLOCKS = 1


_SENTINEL = object()


def _hold(leases: list):
    """One more reference on each lease; returns the callback that drops
    them, for one consumer to call once."""
    for h in leases:
        h.retain()
    return lambda: [h.release() for h in leases]


def hold_past(exc: BaseException, leases: list) -> None:
    """A drive call that outlived its deadline may still read or fill the
    memory of `leases`: one more reference on each, dropped when that
    call ends (storage/health.py attaches it to the error as
    `pending`)."""
    late = getattr(exc, "pending", None)
    if late is not None:
        drop = _hold(leases)
        late.add_done_callback(lambda _f: drop())


def _resolve_range(spec: tuple, size: int, bucket: str, object_: str):
    """(start|None, end|None) -> (offset, length), HTTP Range semantics
    (minio_tpu/object/erasure_object.py `_resolve_range`)."""
    lo, hi = spec
    if lo is None:                       # suffix: last `hi` bytes
        if hi is None or hi <= 0:
            raise InvalidRange(bucket, object_)
        start = max(0, size - hi)
        return start, size - start
    if lo >= size:
        raise InvalidRange(bucket, object_)
    if hi is None:
        return lo, size - lo
    if lo > hi:
        raise InvalidRange(bucket, object_)
    return lo, min(hi, size - 1) - lo + 1


# -- the stripe batchers' device functions and host rivals --------------------

def _host_rows(k: int, m: int, stacked: np.ndarray) -> list[list]:
    """Host-codec twin of the framer's rows: per-drive lists over erasure
    blocks of (digest, block) pieces. The put batcher's host rival."""
    b, _, shard = stacked.shape
    n = k + m
    if m:
        flat = np.ascontiguousarray(stacked.transpose(1, 0, 2)) \
            .reshape(k, b * shard)
        parity = np.asarray(_HOST.apply_matrix(gf256.parity_matrix(k, m),
                                               flat)) \
            .reshape(m, b, shard).transpose(1, 0, 2)
    else:
        parity = np.zeros((b, 0, shard), dtype=np.uint8)
    blocks = np.concatenate([stacked, parity], axis=1)   # [B, n, S]
    digs = highwayhash256_many(MAGIC_KEY, blocks.reshape(b * n, shard)) \
        .reshape(b, n, DIGEST)
    return [[(digs[bi, i], blocks[bi, i]) for bi in range(b)]
            for i in range(n)]


@functools.lru_cache(maxsize=64)
def _mesh_framer_for(k: int, m: int, device: str):
    """The put batcher's device function for one EC config and device
    (ops/hh_device.make_mesh_framer)."""
    return hh_device.make_mesh_framer(gf256.parity_matrix(k, m),
                                      device=device)


def _batcher_for(k: int, m: int, device: str) -> StripeBatcher:
    """Cross-request PUT batcher for one EC config: concurrent PUT windows
    coalesce into one framer dispatch staged in pooled (pinned) memory."""
    return StripeBatcher(_mesh_framer_for(k, m, device),
                         functools.partial(_host_rows, k, m),
                         min_device_blocks=MIN_DEVICE_BLOCKS,
                         pool=global_pool(device), name=f"{k}+{m}")


def _host_deframe(stacked: np.ndarray):
    """Host twin of the device de-framer (the get batcher's host rival):
    HighwayHash of every framed block of `stacked` [B, k, 32+S], verdicts
    [B, k] plus the payload as views, field-identical to
    make_mesh_deframer's run() + _get_split."""
    b, k, f = stacked.shape
    s = f - DIGEST
    digs = highwayhash256_many(
        MAGIC_KEY, np.ascontiguousarray(stacked[:, :, DIGEST:])
        .reshape(b * k, s))
    want = stacked[:, :, :DIGEST].reshape(b * k, DIGEST)
    ok = (digs == want).all(axis=1).reshape(b, k)
    return ok, stacked[:, :, DIGEST:]


def _get_split(ok, off, c, member):
    """Demux one coalesced GET verify dispatch: the member's verdict rows
    plus its payload as views of its OWN framed window (blocks never
    come back from the card)."""
    return ok[off:off + c], member[:, :, DIGEST:]


def _get_concat(a, b):
    return (np.concatenate([a[0], b[0]]),
            np.concatenate([a[1], b[1]]))


def _get_batcher_for(k: int, m: int, device: str) -> StripeBatcher:
    """Cross-request GET verify batcher for one EC config: stacked framed
    windows [B, k, 32+shard] of concurrent GETs coalesce into one
    de-framer dispatch (ops/hh_device.make_mesh_deframer)."""
    return StripeBatcher(hh_device.make_mesh_deframer(k, device=device),
                         _host_deframe,
                         min_device_blocks=MIN_DEVICE_BLOCKS,
                         pool=global_pool(device), name=f"get:{k}+{m}",
                         route="get", split_fn=_get_split,
                         concat_fn=_get_concat)


def _host_apply_rows(rows: np.ndarray, stacked: np.ndarray) -> np.ndarray:
    """Host GF application of `rows` [r, k] to a stripe batch [B, k, S]
    -> [B, r, S] (the reconstruct batcher's host rival): the transform
    is per byte column, so the batch flattens into one host-codec call."""
    b, k, s = stacked.shape
    flat = np.ascontiguousarray(stacked.transpose(1, 0, 2)) \
        .reshape(k, b * s)
    out = np.asarray(_HOST.apply_matrix(rows, flat))
    return np.ascontiguousarray(
        out.reshape(rows.shape[0], b, s).transpose(1, 0, 2))


def rebuild_rows(k: int, m: int, use: tuple, targets) -> np.ndarray:
    """The GF(2^8) rows [len(targets), k] that map the k surviving shards
    `use` to the shards `targets`, data and parity alike: each target's
    coding-matrix row times the decode matrix of `use` (a data shard's
    row is its decode-matrix row). One launch rebuilds every target; the
    bytes equal the JAX package's two steps (data shards from the
    survivors, then parity from the data)."""
    return np.ascontiguousarray(gf256.gf_matmul(
        gf256.coding_matrix(k, m)[list(targets)],
        gf256.decode_matrix(k, m, use)))


def _reconstruct_batcher_for(k: int, m: int, use: tuple, missing: tuple,
                             device: str) -> StripeBatcher:
    """Batched reconstruct for one (EC config, surviving-shard set,
    rebuilt-shard set): degraded-read and heal windows stack their
    survivors [B, k, S] and the rows of the shards to rebuild apply in
    one dispatch (ops/rs_device.make_mesh_matrix). Concurrent degraded
    GETs coalesce when their objects share a survivor set."""
    rows = rebuild_rows(k, m, use, missing)
    return StripeBatcher(
        rs_device.make_mesh_matrix(rows, device=device),
        functools.partial(_host_apply_rows, rows),
        min_device_blocks=MIN_DEVICE_BLOCKS, pool=global_pool(device),
        name=f"rec:{k}+{m}:" + ",".join(map(str, use)) + "->"
        + ",".join(map(str, missing)),
        route="reconstruct",
        split_fn=lambda out, off, c, _member: out[off:off + c],
        concat_fn=lambda a, b: np.concatenate([a, b]))


def _first(errors: list):
    """The first drive error of a fan-out, for a quorum error's text."""
    return next((e for e in errors if e is not None), None)


def _quiet(fn) -> None:
    try:
        fn()
    except Exception:  # noqa: BLE001 - best-effort cleanup
        pass


def default_parity(set_size: int) -> int:
    """Default EC parity by set size (reference storage-class defaults:
    internal/config/storageclass/storage-class.go:355-367):
    1 drive -> 0, 2-3 -> 1, 4-5 -> 2, 6-7 -> 3, 8+ -> 4."""
    if set_size == 1:
        return 0
    if set_size <= 3:
        return 1
    if set_size <= 5:
        return 2
    if set_size <= 7:
        return 3
    return 4


def hash_order(key: str, cardinality: int) -> list[int]:
    """Deterministic shard distribution for a key: a rotation of
    [1..cardinality] starting at crc32(key) % cardinality (behavioural
    equivalent of the reference's hashOrder spread,
    cmd/erasure-metadata-utils.go:178)."""
    if cardinality <= 0:
        return []
    start = zlib.crc32(key.encode()) % cardinality
    return [1 + (start + i) % cardinality for i in range(cardinality)]


def object_info(bucket: str, object_: str, fi: FileInfo) -> ObjectInfo:
    """A version's FileInfo as the object layer answers it."""
    meta = dict(fi.metadata)
    etag = meta.pop("etag", "")
    ctype = meta.pop("content-type", "")
    internal = {k: meta.pop(k) for k in list(meta)
                if k.startswith("x-internal-")}
    return ObjectInfo(bucket=bucket, name=object_, mod_time=fi.mod_time,
                      size=fi.size, etag=etag, content_type=ctype,
                      version_id=fi.version_id, is_latest=fi.is_latest,
                      delete_marker=fi.deleted, user_metadata=meta,
                      internal_metadata=internal, parts=list(fi.parts))


def _innermost(d):
    """The drive behind a health wrapper."""
    while isinstance(d, DiskHealthWrapper):
        d = d._disk
    return d


def _deny() -> bool:
    """The remote gate of a set without the cross-node protocol."""
    return False


def versioning_state_of(meta: dict) -> str:
    """A bucket metadata record's versioning state: "" (never enabled),
    "Enabled" or "Suspended" (minio_tpu/s3/server.py `_versioning_state`)."""
    if meta.get("versioning"):
        return "Enabled"
    if meta.get("versioning-suspended"):
        return "Suspended"
    return ""


class ErasureSet:
    """One erasure set over n local drives; device work on `device`."""

    def __init__(self, disks: Sequence, parity: Optional[int] = None,
                 device=None):
        self.disks = list(disks)
        n = len(self.disks)
        if parity is not None and not 0 <= parity <= n // 2:
            raise ValueError(f"parity {parity} out of range for {n} drives "
                             f"(need 0 <= parity <= {n // 2})")
        self.default_parity = default_parity(n) if parity is None else parity
        self.device = device_mod.resolve(device)
        self.backend = rs_device.GpuBackend(self.device)
        self.pool = ThreadPoolExecutor(max_workers=max(8, 2 * n))
        # GET readahead runs apart from the drive fan-out pool it uses.
        self._readahead = ThreadPoolExecutor(
            max_workers=max(8, 2 * n), thread_name_prefix="get-readahead")
        # Per-key reader/writer locks (object/nslock.py): commits,
        # deletes and heals write, GETs read until their stream ends.
        self.ns = NSLockMap()
        # Windows of full blocks by route, as the batcher routed them:
        # through the device kernels, or through a host rival (only when
        # a caller pinned the route to the host).
        self.device_windows = {"put": 0, "get": 0, "reconstruct": 0}
        self.host_windows = {"put": 0, "get": 0, "reconstruct": 0}
        self._stat_mu = threading.Lock()
        # Stripe batchers, keyed (route, k, m, use, missing, device).
        self._batchers: dict[tuple, StripeBatcher] = {}
        self._batchers_mu = threading.Lock()
        # The MRF heal queue starts on first use (the `mrf` property);
        # with _mrf_closed set first, enqueues go to a stopped queue.
        self._mrf = None
        self._mrf_lock = threading.Lock()
        self._mrf_closed = False
        # Bucket metadata records: bucket -> (monotonic time read, record);
        # buckets seen to exist: bucket -> monotonic time the sight expires.
        self._bmeta_cache: dict[str, tuple] = {}
        self._bexists_until: dict[str, float] = {}
        self._bmeta_mu = threading.Lock()
        # Serializes the read-modify-write of a bucket's metadata record
        # (a flock'd mutex across pre-forked workers, io/workers.py).
        self.bucket_meta_lock = threading.Lock()
        # Which drives the next listing walk starts at (_walk_resolved).
        self._walk_rotor = 0
        # A set with a drive on another node (storage/remote.py, found
        # behind the health wrapper) runs without the cross-node cache
        # protocol, as minio_tpu/object/erasure_object.py does then: its
        # caches answer misses behind a deny-all gate, it has no
        # group-commit lanes, and bucket metadata is cached 2 s.
        self._remote_set = any(isinstance(_innermost(d), RemoteStorage)
                               for d in self.disks)
        # The listing's shared walk streams, and the bump funnel every
        # namespace mutation of the set goes through (object/metacache).
        # Persisted runs go to the first drive with a root of its own
        # (an OfflineDisk in slot 0 has none); a remote set persists
        # none.
        self.metacache = MetaCache(persist_drive=None if self._remote_set
                                   else next(
            (d for d in self.disks
             if isinstance(getattr(d, "root", None), str)), None))
        # Group-commit lanes (storage/group_commit): concurrent small
        # journal-only commits coalesce a drive into one WAL-backed
        # batch. Each batch bumps its buckets before any member acks.
        self.group_commit = None
        if gc_mod.enabled() and self.disks and not self._remote_set and \
                all(hasattr(d, "commit_group") for d in self.disks):
            self.group_commit = gc_mod.GroupCommit(
                self.disks, name=f"set:{id(self) & 0xffff:x}")
            self.group_commit.bump = self.metacache.bump
        # Quorum-fileinfo cache (object/fi_cache.py): repeat GET, HEAD
        # and listing lookups of a key serve the quorum-agreed (fi, fis)
        # from memory; every namespace mutation's bump invalidates it.
        self.fi_cache = FileInfoCache()
        self.metacache.listeners.append(self.fi_cache.invalidate_bucket)
        if self._remote_set:
            self.fi_cache.remote_gate = _deny
            self.metacache.remote_gate = _deny

    def close(self) -> None:
        """Stop the MRF worker, the listing walks, the group-commit lanes
        (checkpointing their WALs), the fan-out pool and the batchers,
        then join the kernel lane, whose worker calls into CUDA and must
        not outlive the process's useful life. Under _mrf_lock with the
        closed sentinel: a racing lazy `mrf` access must not start a
        fresh worker after close() looked."""
        with self._mrf_lock:
            self._mrf_closed = True
            if self._mrf is not None:
                self._mrf.stop()
        self.metacache.close()
        if self.group_commit is not None:
            # A final WAL checkpoint: a graceful stop leaves no frame
            # for the next boot to replay.
            self.group_commit.close()
        self._readahead.shutdown(wait=True)
        self.pool.shutdown(wait=True)
        with self._batchers_mu:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for sb in batchers:
            sb.close()
        shutdown_kernel_lane()

    @property
    def mrf(self):
        """The lazy MRF heal queue (object/healing.MRFQueue; its worker
        starts on first use). After close(), or with _mrf_closed set
        before the first use, enqueues go to a stopped queue: accepted,
        persisted, but not worked."""
        if self._mrf is None:
            with self._mrf_lock:
                if self._mrf is None:
                    from minio_tpu_torch.object.healing import MRFQueue
                    q = MRFQueue(self)
                    if self._mrf_closed:
                        q.stop()
                    self._mrf = q
        return self._mrf

    # -- healing and multipart (object/healing.py, object/multipart.py) --

    def heal_object(self, bucket: str, object_: str, version_id: str = "",
                    deep: bool = False):
        from minio_tpu_torch.object import healing
        return healing.heal_object(self, bucket, object_, version_id,
                                   deep=deep)

    def heal_bucket(self, bucket: str) -> dict:
        from minio_tpu_torch.object import healing
        return healing.heal_bucket(self, bucket)

    def new_multipart_upload(self, bucket: str, object_: str,
                             opts: Optional[PutOptions] = None) -> str:
        from minio_tpu_torch.object import multipart
        return multipart.new_multipart_upload(self, bucket, object_, opts)

    def put_object_part(self, bucket: str, object_: str, upload_id: str,
                        part_number: int, data):
        from minio_tpu_torch.object import multipart
        return multipart.put_object_part(self, bucket, object_, upload_id,
                                         part_number, data)

    def complete_multipart_upload(self, bucket: str, object_: str,
                                  upload_id: str,
                                  parts: list) -> ObjectInfo:
        from minio_tpu_torch.object import multipart
        return multipart.complete_multipart_upload(self, bucket, object_,
                                                   upload_id, parts)

    def abort_multipart_upload(self, bucket: str, object_: str,
                               upload_id: str) -> None:
        from minio_tpu_torch.object import multipart
        multipart.abort_multipart_upload(self, bucket, object_, upload_id)

    def list_parts(self, bucket: str, object_: str, upload_id: str,
                   part_marker: int = 0, max_parts: int = 1000) -> list:
        from minio_tpu_torch.object import multipart
        return multipart.list_parts(self, bucket, object_, upload_id,
                                    part_marker, max_parts)

    def list_multipart_uploads(self, bucket: str, prefix: str = "") -> list:
        from minio_tpu_torch.object import multipart
        return multipart.list_multipart_uploads(self, bucket, prefix)

    def _count(self, route: str, path: str) -> None:
        with self._stat_mu:
            if path == "device":
                self.device_windows[route] += 1
            else:
                self.host_windows[route] += 1

    def _batcher(self, route: str, k: int, m: int, use: tuple = (),
                 missing: tuple = ()) -> StripeBatcher:
        dev = str(self.device)
        key = (route, k, m, use, missing, dev)
        with self._batchers_mu:
            sb = self._batchers.get(key)
            if sb is None:
                if route == "put":
                    sb = _batcher_for(k, m, dev)
                elif route == "get":
                    sb = _get_batcher_for(k, m, dev)
                else:
                    sb = _reconstruct_batcher_for(k, m, use, missing, dev)
                self._batchers[key] = sb
            return sb

    def batcher_stats(self) -> dict:
        """Per route: dispatches (device/host), members (requests by path),
        buckets used, fill ratio, the most members one dispatch carried,
        dispatches with 2+ members, deadline culls, and the coalescing-
        wait and kernel-lane service histograms; beside them the kernel
        lane's own stats and the set's window counts."""
        with self._batchers_mu:
            sbs = list(self._batchers.values())
        with self._stat_mu:
            windows = {"device": dict(self.device_windows),
                       "host": dict(self.host_windows)}
        return {"routes": merge_route_stats([sb.stats() for sb in sbs]),
                "lane": kernel_lane().stats(), "windows": windows}

    def _fanout(self, fns) -> tuple[list, list]:
        """Run one callable per drive in parallel (None = skip). Returns
        aligned (results, errors)."""
        futs = [self.pool.submit(fn) if fn is not None else None
                for fn in fns]
        results: list = [None] * len(fns)
        errors: list = [None] * len(fns)
        for i, f in enumerate(futs):
            if f is None:
                continue
            try:
                results[i] = f.result()
            except Exception as e:  # noqa: BLE001 - collected for quorum
                errors[i] = e
        return results, errors

    # ------------------------------------------------------------------
    # buckets
    # ------------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        _, errors = self._fanout([lambda d=d: d.make_vol(bucket)
                                  for d in self.disks])
        if sum(e is None for e in errors) < len(self.disks) // 2 + 1:
            if any(isinstance(e, VolumeExists) for e in errors):
                raise BucketExists(bucket)
            raise WriteQuorumError(bucket)

    def list_buckets(self) -> list[BucketInfo]:
        """Every bucket on any drive, each with its earliest creation
        time, sorted by name."""
        results, _ = self._fanout([lambda d=d: d.list_vols()
                                   for d in self.disks])
        seen: dict[str, int] = {}
        for vols in results:
            for v in vols or ():
                if v.name not in seen or v.created < seen[v.name]:
                    seen[v.name] = v.created
        return [BucketInfo(name=b, created=c) for b, c in sorted(seen.items())]

    def delete_bucket(self, bucket: str) -> None:
        """Remove the bucket's volume from every drive (BucketNotEmpty
        while any drive holds an object of it) and its metadata record,
        so a bucket made again under the name starts unversioned."""
        _, errors = self._fanout([lambda d=d: d.delete_vol(bucket)
                                  for d in self.disks])
        if any(isinstance(e, VolumeNotEmpty) for e in errors):
            raise BucketNotEmpty(bucket)
        if all(isinstance(e, VolumeNotFound) for e in errors):
            raise BucketNotFound(bucket)
        ok = sum(e is None or isinstance(e, VolumeNotFound) for e in errors)
        if ok < len(self.disks) // 2 + 1:
            raise WriteQuorumError(bucket)
        self.invalidate_bucket_meta(bucket)
        self.metacache.drop_bucket(bucket)
        self._fanout([lambda d=d: _quiet(lambda: d.delete(
            SYS_VOL, f"buckets/{bucket}", recursive=True))
            for d in self.disks])

    # -- bucket metadata: the versioning state, one JSON record a bucket
    #    on SYS_VOL, the JAX package's file and keys --------------------

    # Seconds a bucket's record stays cached. A local set is this
    # process's own (pre-forked siblings bump the meta generation), and
    # every write here invalidates it; a remote set's record may change
    # on another node, which tells nobody, so its TTL is the bound.
    _BUCKET_META_TTL = 60.0
    _REMOTE_BUCKET_META_TTL = 2.0
    # Seconds a bucket seen to exist is taken to exist (the JAX
    # package's TTL).
    _BUCKET_EXISTS_TTL = 2.0

    @staticmethod
    def _bucket_meta_path(bucket: str) -> str:
        return f"buckets/{bucket}/bucket-meta.json"

    def get_bucket_meta(self, bucket: str) -> dict:
        """The bucket's metadata record as most drives hold it, cached
        for _BUCKET_META_TTL seconds, a remote set's for
        _REMOTE_BUCKET_META_TTL ({} when there is none)."""
        now = time.monotonic()
        ttl = self._REMOTE_BUCKET_META_TTL if self._remote_set \
            else self._BUCKET_META_TTL
        with self._bmeta_mu:
            hit = self._bmeta_cache.get(bucket)
        if hit is not None and now - hit[0] < ttl:
            return dict(hit[1])
        meta = self._get_bucket_meta_uncached(bucket)
        with self._bmeta_mu:
            self._bmeta_cache[bucket] = (now, meta)
        return dict(meta)

    def _get_bucket_meta_uncached(self, bucket: str) -> dict:
        path = self._bucket_meta_path(bucket)
        results, _ = self._fanout([lambda d=d: d.read_all(SYS_VOL, path)
                                   for d in self.disks])
        votes: dict[bytes, int] = {}
        for r in results:
            if r is not None:
                votes[r] = votes.get(r, 0) + 1
        if not votes:
            return {}
        try:
            return json.loads(max(votes, key=lambda b: votes[b]))
        except ValueError:
            return {}

    def set_bucket_meta(self, bucket: str, meta: dict) -> None:
        blob = json.dumps(meta, sort_keys=True).encode()
        path = self._bucket_meta_path(bucket)
        _, errors = self._fanout([lambda d=d: d.write_all(SYS_VOL, path, blob)
                                  for d in self.disks])
        self.invalidate_bucket_meta(bucket)
        if sum(e is None for e in errors) < len(self.disks) // 2 + 1:
            raise WriteQuorumError(bucket)

    def invalidate_bucket_meta(self, bucket: str = "") -> None:
        """Drop the cached record and existence of one bucket ("" =
        every bucket: a sibling worker rewrote some record)."""
        with self._bmeta_mu:
            if not bucket:
                self._bmeta_cache.clear()
                self._bexists_until.clear()
                return
            self._bmeta_cache.pop(bucket, None)
            self._bexists_until.pop(bucket, None)

    def bucket_versioning(self, bucket: str) -> bool:
        return bool(self.get_bucket_meta(bucket).get("versioning"))

    def versioning_state(self, bucket: str) -> str:
        return versioning_state_of(self.get_bucket_meta(bucket))

    def set_bucket_versioning(self, bucket: str, status) -> None:
        """status: True or "Enabled", "Suspended", or False (off). A
        suspended bucket writes the null version, replacing the null
        version before it; the versions of the Enabled era stay."""
        try:
            with self.bucket_meta_lock:
                meta = self.get_bucket_meta(bucket)
                meta["versioning"] = status is True or status == "Enabled"
                meta["versioning-suspended"] = status == "Suspended"
                self.set_bucket_meta(bucket, meta)
        finally:
            # What a PUT or DELETE of the bucket writes changes with it.
            self.metacache.bump(bucket)

    def bucket_exists(self, bucket: str) -> bool:
        """Whether any drive holds the bucket: the first drive that
        answers yes decides, so a drive that hangs holds the check up
        only when no other drive has the bucket."""
        futs = [self.pool.submit(d.stat_vol, bucket) for d in self.disks]
        return any(f.exception() is None for f in as_completed(futs))

    def _check_bucket(self, bucket: str) -> None:
        """Bucket existence, positive-cached for _BUCKET_EXISTS_TTL
        seconds (minio_tpu/object/erasure_object.py `_check_bucket`): a
        stat of every drive on each request costs more than a small
        object's encode. delete_bucket drops the entry."""
        now = time.monotonic()
        with self._bmeta_mu:
            until = self._bexists_until.get(bucket)
        if until is not None and now < until:
            return
        if not self.bucket_exists(bucket):
            raise BucketNotFound(bucket)
        with self._bmeta_mu:
            self._bexists_until[bucket] = now + self._BUCKET_EXISTS_TTL

    # ------------------------------------------------------------------
    # PutObject
    # ------------------------------------------------------------------

    def _frame_window(self, e: Erasure, buf: np.ndarray) -> tuple[list, list]:
        """Encode + digest one window of object bytes on the device:
        (per shard index the [(digest, block), ...] pieces of its frames,
        the pool leases those pieces view, one reference each for the
        caller to release)."""
        k, m = e.data_blocks, e.parity_blocks
        n, ss = k + m, e.shard_size()
        pool = global_pool(self.device)
        rows: list[list] = [[] for _ in range(n)]
        leases: list = []
        try:
            full = buf.size // BLOCK_SIZE
            if full:
                if k * ss == BLOCK_SIZE:
                    stacked = buf[:full * BLOCK_SIZE].reshape(full, k, ss)
                else:
                    # Split pads each block to k*ceil(block/k) with zeros
                    # (reference Split semantics).
                    leases.append(pool.lease(full * k * ss))
                    padded = leases[-1].ndarray((full, k * ss))
                    padded[:, :BLOCK_SIZE] = buf[:full * BLOCK_SIZE] \
                        .reshape(full, BLOCK_SIZE)
                    padded[:, BLOCK_SIZE:] = 0
                    stacked = padded.reshape(full, k, ss)
                sb = self._batcher("put", k, m)
                framed = sb.frame(stacked)
                leases += leases_of(framed)
                for i, pieces in enumerate(framed):
                    rows[i].extend(pieces)
                self._count("put", sb.last_route())
            if buf.size > full * BLOCK_SIZE:
                data = e.split(buf[full * BLOCK_SIZE:])           # [k, per]
                shards = rs_device.host_tensor(data).to(self.device)
                if m:
                    parity = rs_device.gf_apply(gf256.parity_matrix(k, m),
                                                shards[None])[0]
                    shards = torch.cat([shards, parity])
                digs = hh_device.hash_blocks_device(MAGIC_KEY, shards)
                held, (parity, digs) = rs_device.to_host_lease(
                    pool, shards[k:], digs)
                leases += held
                blocks = list(data) + list(parity)
                for i in range(n):
                    rows[i].append((digs[i], blocks[i]))
        except BaseException:
            for h in leases:
                h.release()
            raise
        return rows, leases

    def put_object(self, bucket: str, object_: str, data,
                   opts: Optional[PutOptions] = None) -> ObjectInfo:
        """data: bytes-like or a utils.streams.Payload, read window by
        window and never held whole. The version written is
        opts.version_id, else a fresh one when opts.versioned, else the
        null version. opts.internal_metadata is read after the payload's
        finish hook ran, so the hook may fill it; a hook that raises
        fails the PUT before anything is committed."""
        opts = opts or PutOptions()
        payload = Payload.wrap(data)
        gc = self.group_commit
        if gc is not None and payload.size <= BLOCK_SIZE:
            # A body of at most one erasure block may commit through the
            # group lanes. The whole request counts as in flight, encode
            # included: the lanes' early close compares pending members
            # with requests in flight, and this one's members are coming
            # (minio_tpu/object/erasure_object.py `_put_object_buffered`).
            with gc.tracking():
                return self._put_object(bucket, object_, payload, opts,
                                        group=True)
        return self._put_object(bucket, object_, payload, opts, group=False)

    def _put_object(self, bucket: str, object_: str, payload: Payload,
                    opts: PutOptions, group: bool) -> ObjectInfo:
        self._check_bucket(bucket)
        n = len(self.disks)
        m = self.default_parity
        k = n - m
        write_quorum = k + (1 if k == m else 0)
        distribution = hash_order(f"{bucket}/{object_}", n)
        e = Erasure(k, m, BLOCK_SIZE, backend=self.backend)
        size = payload.size
        version_id = opts.version_id or (new_uuid() if opts.versioned else "")
        errors: list = [None] * n

        def make_fi(shard_idx: int, data_dir: str, etag: str,
                    inline_data=None) -> FileInfo:
            return FileInfo(
                volume=bucket, name=object_, version_id=version_id,
                data_dir=data_dir, mod_time=mod_time, size=size,
                metadata={"etag": etag, **({"content-type": opts.content_type}
                                           if opts.content_type else {}),
                          **opts.user_metadata, **opts.internal_metadata},
                parts=[ObjectPartInfo(number=1, size=size,
                                      actual_size=size, etag=etag)],
                erasure=ErasureInfo(
                    data_blocks=k, parity_blocks=m, block_size=BLOCK_SIZE,
                    index=shard_idx + 1, distribution=tuple(distribution)),
                inline_data=inline_data)

        # The JAX package's inline rule: a versioned object goes inline
        # only up to an eighth of the threshold.
        shard_file = e.shard_file_size(size)
        if shard_file <= SMALL_FILE_THRESHOLD and not opts.versioned \
                or shard_file <= SMALL_FILE_THRESHOLD // 8:
            # Inline: the whole (small) body frames at once and goes into
            # xl.meta; read_all runs the finish hook first.
            body = np.frombuffer(payload.read_all(), dtype=np.uint8)
            rows, leases = self._frame_window(e, body) if body.size \
                else ([[] for _ in range(n)], [])
            try:
                frames = [bitrot.join_frames(r) for r in rows]
            finally:
                for h in leases:
                    h.release()
            etag = hashlib.md5(body).hexdigest()
            mod_time = now_ns()

            def inline_fi(i: int) -> FileInfo:
                return make_fi(distribution[i] - 1, "", etag,
                               frames[distribution[i] - 1])
            self._commit(bucket, object_, version_id, errors, write_quorum,
                         lambda i: self.disks[i].write_metadata(
                             bucket, object_, inline_fi(i)),
                         (lambda i: GroupOp.write_meta(
                             bucket, object_, inline_fi(i)))
                         if group else None)
        else:
            data_dir = new_uuid()
            staging = f"{STAGING_PREFIX}/p{os.getpid()}-{new_uuid()}"
            try:
                etag = self._stream_framed_writes(
                    payload, e, distribution, f"{staging}/{data_dir}/part.1",
                    write_quorum, errors)
                mod_time = now_ns()

                def staged_fi(i: int) -> FileInfo:
                    return make_fi(distribution[i] - 1, data_dir, etag)
                self._commit(bucket, object_, version_id, errors,
                             write_quorum,
                             lambda i: self.disks[i].rename_data(
                                 SYS_VOL, staging, staged_fi(i), bucket,
                                 object_),
                             (lambda i: GroupOp.rename(
                                 SYS_VOL, staging, staged_fi(i), bucket,
                                 object_)) if group else None)
            finally:
                # Committed drives already moved their data dir out;
                # whatever staging is left is debris (errors ignored).
                # A drive that missed its deadline (storage/health.py)
                # is cleaned in the background: a hung drive must not
                # hold the PUT for a second deadline.
                cleanup = [functools.partial(d.delete, SYS_VOL, staging,
                                             recursive=True)
                           for d in self.disks]
                hung = [isinstance(err, FaultyDisk) for err in errors]
                self._fanout([None if h else fn
                              for fn, h in zip(cleanup, hung)])
                for fn, h in zip(cleanup, hung):
                    if h:
                        self.pool.submit(fn)
        if any(errors):
            # Committed on fewer than n drives: heal the rest in the
            # background (reference MRF hook,
            # cmd/erasure-object.go:1556-1594).
            self.mrf.enqueue(bucket, object_, version_id)
        return ObjectInfo(bucket=bucket, name=object_, mod_time=mod_time,
                          size=size, etag=etag,
                          content_type=opts.content_type,
                          version_id=version_id,
                          user_metadata=dict(opts.user_metadata),
                          internal_metadata=dict(opts.internal_metadata),
                          parts=[ObjectPartInfo(number=1, size=size,
                                                actual_size=size,
                                                etag=etag)])

    def _commit(self, bucket: str, object_: str, version_id: str,
                errors: list, write_quorum: int, commit_one,
                group_op=None) -> None:
        """Run commit_one(i) on every drive still without an error, under
        the key's namespace lock; below write quorum, take the committed
        version back and raise WriteQuorumError. With `group_op(i)` (the
        GroupOp of drive i) and other requests in their commit section,
        the drives' commits ride the group lanes instead, which bump the
        bucket before they ack; otherwise the bucket is bumped here."""
        n = len(self.disks)
        gc = self.group_commit if group_op is not None else None
        used_group = False
        with self.ns.write(bucket, object_):
            if gc is not None and gc.worth_batching():
                used_group = True
                cerrs = gc.commit_fanout([
                    group_op(i) if errors[i] is None else None
                    for i in range(n)])
            else:
                if gc is not None:
                    gc.note_solo()
                _, cerrs = self._fanout([
                    (lambda i=i: commit_one(i)) if errors[i] is None
                    else None for i in range(n)])
        for i, err in enumerate(cerrs):
            errors[i] = errors[i] or err
        ok = sum(err is None for err in errors)
        if ok < write_quorum:
            self._fanout([lambda d=d: d.delete_version(bucket, object_,
                                                       version_id)
                          if err is None else None
                          for d, err in zip(self.disks, errors)])
            self.metacache.bump(bucket)
            raise WriteQuorumError(bucket, object_,
                                   f"wrote {ok}/{n}, need {write_quorum}")
        if not used_group:
            self.metacache.bump(bucket)

    def _stream_framed_writes(self, payload: Payload, e: Erasure,
                              distribution: Sequence[int], part: str,
                              write_quorum: int, errors: list) -> str:
        """Windowed encode + frame with one streamed writer per drive
        (minio_tpu/object/erasure_object.py `_stream_framed_writes`;
        reference parallelWriter, cmd/erasure-encode.go:69).

        Each window is read with Payload.readinto straight into a pooled
        (pinned) lease and framed while the writers still write the
        windows before it: every drive has a writer thread fed by a
        bounded queue (WRITE_QUEUE_DEPTH windows) and writing its whole
        shard file with one create_file, and the MD5 of the ETag runs on
        a thread of its own. A window's leases are retained once per
        consumer and return to the pool when the last one is done. A
        writer that fails records its error in `errors` and drains its
        queue, so the producer never blocks on it; when fewer than
        `write_quorum` writers live the stream stops with
        WriteQuorumError. Returns the MD5 hex ETag.

        A body of one window or less has nothing to overlap: it goes
        through `_write_one_window`, with no threads of its own, as the
        JAX package sends such bodies to its buffered path."""
        window_bytes = STREAM_WINDOW_BLOCKS * BLOCK_SIZE
        if payload.size <= window_bytes:
            return self._write_one_window(payload, e, distribution, part,
                                          write_quorum, errors)
        n = len(self.disks)
        pool = global_pool(self.device)
        qs = [queue.Queue(maxsize=WRITE_QUEUE_DEPTH) for _ in range(n)]
        md5_q: queue.Queue = queue.Queue(maxsize=WRITE_QUEUE_DEPTH)
        dead = [False] * n
        sentinel_seen = [False] * n
        md5 = hashlib.md5()

        def got_sentinel(i: int, c) -> bool:
            # Sticky: put back on receipt, so every later get() of this
            # queue (the drain loop after a failed create_file) sees it.
            # The producer has stopped feeding the queue, so the put
            # cannot block.
            if c is _SENTINEL:
                sentinel_seen[i] = True
                qs[i].put(c)
                return True
            return False

        def writer(i: int):
            inflight: list = []       # release hook of the row being written

            def finish_inflight():
                while inflight:
                    inflight.pop()()

            def pieces():
                while True:
                    c = qs[i].get()
                    finish_inflight()
                    if got_sentinel(i, c):
                        return
                    row, done = c
                    inflight.append(done)
                    for dig, blk in row:
                        yield dig
                        yield blk
            try:
                self.disks[i].create_file(SYS_VOL, part, pieces())
            except Exception as exc:  # noqa: BLE001 - collected for quorum
                errors[i] = exc
                dead[i] = True
                late = getattr(exc, "pending", None)
                if late is not None:
                    # The abandoned call may still be writing the row it
                    # holds; it is handed no other.
                    hooks = inflight[:]
                    inflight.clear()
                    late.add_done_callback(
                        lambda _f: [h() for h in hooks])
                while not sentinel_seen[i]:
                    c = qs[i].get()
                    if not got_sentinel(i, c):
                        c[1]()
            finally:
                finish_inflight()

        def hasher():
            while (c := md5_q.get()) is not _SENTINEL:
                view, done = c
                try:
                    md5.update(view)      # releases the GIL on big buffers
                finally:
                    done()

        threads = [threading.Thread(target=writer, args=(i,), daemon=True,
                                    name=f"put-writer-{i}")
                   for i in range(n)]
        threads.append(threading.Thread(target=hasher, daemon=True,
                                        name="put-md5"))
        for t in threads:
            t.start()
        stream_error: Optional[BaseException] = None
        try:
            while payload.remaining > 0:
                want = min(window_bytes, payload.remaining)
                held = [pool.lease(want)]
                try:
                    buf = held[0].ndarray((want,))
                    payload.readinto(buf)    # the last read runs finish()
                    rows, more = self._frame_window(e, buf)
                    held += more
                    if n - sum(dead) < write_quorum:
                        raise WriteQuorumError(
                            "", "", f"{sum(dead)}/{n} shard writers failed "
                            "mid-stream")
                    md5_q.put((buf, _hold(held[:1])))
                    for i in range(n):
                        if not dead[i]:
                            qs[i].put((rows[distribution[i] - 1],
                                       _hold(held)))
                finally:
                    # The producer's own references; each consumer
                    # returns its own.
                    for h in held:
                        h.release()
        except BaseException as exc:  # noqa: BLE001 - writers unwind first
            stream_error = exc
        finally:
            for q in (*qs, md5_q):
                q.put(_SENTINEL)
            for t in threads:
                t.join()
        if stream_error is not None:
            raise stream_error
        if n - sum(dead) < write_quorum:
            raise WriteQuorumError("", "", f"{sum(dead)}/{n} shard writers "
                                   f"failed, first {_first(errors)!r}")
        return md5.hexdigest()

    def _write_one_window(self, payload: Payload, e: Erasure,
                          distribution: Sequence[int], part: str,
                          write_quorum: int, errors: list) -> str:
        """`_stream_framed_writes` for a body of one window: read into one
        pooled lease, framed, written to every drive through the set's
        fan-out pool while the MD5 runs on this thread."""
        n = len(self.disks)
        held = [global_pool(self.device).lease(payload.size)]
        try:
            buf = held[0].ndarray((payload.size,))
            payload.readinto(buf)        # the last read runs finish()
            rows, more = self._frame_window(e, buf)
            held += more
            futs = [self.pool.submit(
                self.disks[i].create_file, SYS_VOL, part,
                [p for pair in rows[distribution[i] - 1] for p in pair])
                for i in range(n)]
            etag = hashlib.md5(buf).hexdigest()
            for i, f in enumerate(futs):
                try:
                    f.result()
                except Exception as exc:  # noqa: BLE001 - for quorum
                    errors[i] = exc
                    hold_past(exc, held)
        finally:
            for h in held:
                h.release()
        failed = sum(err is not None for err in errors)
        if n - failed < write_quorum:
            raise WriteQuorumError("", "", f"{failed}/{n} shard writers "
                                   f"failed, first {_first(errors)!r}")
        return etag

    # ------------------------------------------------------------------
    # metadata quorum
    # ------------------------------------------------------------------

    def _read_version_all(self, bucket: str, object_: str,
                          version_id: str = "",
                          read_data: bool = False) -> tuple[list, list]:
        """(per-drive FileInfo or None, per-drive error or None)."""
        return self._fanout([
            lambda d=d: d.read_version(bucket, object_, version_id,
                                       read_data=read_data)
            for d in self.disks])

    @staticmethod
    def _pick_quorum(fis: list, quorum: int) -> Optional[FileInfo]:
        """The latest version agreed by >= quorum drives, or None
        (reference findFileInfoInQuorum, keyed on mod time and data
        layout)."""
        groups: dict[tuple, list[int]] = {}
        for i, fi in enumerate(fis):
            if fi is not None:
                groups.setdefault((fi.mod_time, fi.storage_version_id(),
                                   fi.data_dir, fi.deleted, fi.size),
                                  []).append(i)
        best = max((key for key, idx in groups.items()
                    if len(idx) >= quorum), default=None)
        return None if best is None else fis[groups[best][0]]

    @staticmethod
    def _read_quorum(fis: list, n: int) -> int:
        """Read quorum of the version the drives report: k, at least half
        the set; a majority for a version with no erasure layout."""
        any_fi = next((f for f in fis if f is not None), None)
        k = any_fi.erasure.data_blocks if any_fi is not None else 0
        return max(k, n // 2) if k else n // 2 + 1

    def _quorum_fileinfo(self, bucket: str, object_: str, read_data: bool,
                         version_id: str = "", stat_only: bool = False
                         ) -> tuple[FileInfo, list, list]:
        """(the version agreed by read quorum, per-drive FileInfos,
        per-drive errors): the latest version, or `version_id`. A delete
        marker comes back as it is; `_read_fileinfo` maps it to the
        errors of a read.

        A repeat lookup of an unchanged key is a hit of the fileinfo
        cache, no drive call (minio_tpu/object/erasure_object.py
        `_get_object_fileinfo`); the token taken before the fan-out keeps
        a read that raced a mutation out of it, and only fully healthy
        reads fill it (a degraded read keeps re-reading, so its MRF heal
        keeps being queued). `stat_only` is a HEAD's: the cache's stat
        class, and no per-drive FileInfos (None)."""
        n = len(self.disks)
        if stat_only:
            fi = self.fi_cache.get_stat(bucket, object_, version_id)
            if fi is not None:
                return fi, None, [None] * n
        else:
            hit = self.fi_cache.get(bucket, object_, version_id,
                                    need_data=read_data)
            if hit is not None:
                return hit[0], hit[1], [None] * n
        token = self.fi_cache.token(bucket)
        fis, errors = self._read_version_all(bucket, object_, version_id,
                                             read_data=read_data)
        if sum(isinstance(e, FileNotFoundErr) for e in errors) > n // 2:
            self._check_bucket(bucket)
            raise ObjectNotFound(bucket, object_)
        if sum(isinstance(e, VersionNotFoundErr) for e in errors) > n // 2:
            raise VersionNotFound(bucket, object_)
        if all(f is None for f in fis):
            raise ReadQuorumError(bucket, object_, "no readable metadata")
        quorum = self._read_quorum(fis, n)
        fi = self._pick_quorum(fis, quorum)
        if fi is None:
            raise ReadQuorumError(bucket, object_,
                                  f"no version agreed by {quorum} drives")
        if all(e is None for e in errors):
            if stat_only:
                self.fi_cache.put_stat(bucket, object_, version_id, fi, token)
            else:
                self.fi_cache.put(bucket, object_, version_id, fi, fis,
                                  read_data, token)
        return fi, fis, errors

    def _read_fileinfo(self, bucket: str, object_: str, read_data: bool,
                       version_id: str, stat_only: bool = False
                       ) -> tuple[FileInfo, list, list]:
        """`_quorum_fileinfo` for a GET or HEAD, with the JAX package's
        errors (minio_tpu/object/erasure_object.py `get_object_info`): a
        latest version that is a delete marker is ObjectNotFound, a
        marker named by its version id MethodNotAllowed, an unknown
        version id VersionNotFound."""
        fi, fis, errors = self._quorum_fileinfo(bucket, object_, read_data,
                                                version_id, stat_only)
        if fi.deleted:
            if version_id:
                raise MethodNotAllowed(bucket, object_,
                                       version_id=fi.version_id or "null")
            raise ObjectNotFound(bucket, object_, delete_marker=True,
                                 version_id=fi.version_id or "null")
        return fi, fis, errors

    def get_object_info(self, bucket: str, object_: str,
                        opts: Optional[GetOptions] = None) -> ObjectInfo:
        opts = opts or GetOptions()
        fi, _, _ = self._read_fileinfo(bucket, object_, False,
                                       opts.version_id, stat_only=True)
        return object_info(bucket, object_, fi)

    # ------------------------------------------------------------------
    # GetObject
    # ------------------------------------------------------------------

    def get_object(self, bucket: str, object_: str,
                   opts: Optional[GetOptions] = None
                   ) -> tuple[ObjectInfo, bytes]:
        info, chunks = self.get_object_stream(bucket, object_, opts=opts)
        # Each chunk is copied as it is pulled: its lease goes back to
        # the pool at the next pull. The drained stream drops the lock.
        return info, b"".join([bytes(c) for c in chunks])

    def get_object_stream(self, bucket: str, object_: str, offset: int = 0,
                          length: Optional[int] = None,
                          opts: Optional[GetOptions] = None
                          ) -> tuple[ObjectInfo, Iterator[memoryview]]:
        """(info, iterator over bytes [offset, offset + length) of the
        object's latest version or of opts.version_id, one window each;
        length None reads to the end). Only the
        erasure blocks that cover the range are read. Offsets map onto
        (part, offset in the part) as in the JAX package's
        `_window_descs`: each part is its own erasure encode, so windows
        of STREAM_WINDOW_BLOCKS start at the range's first block inside
        each part and never cross a part; the first and last windows are
        sliced. A range past the object's end is InvalidRange. A drive
        that lacks the version queues the object on the MRF.

        Readahead (minio_tpu/object/erasure_object.py `_iter_payload`):
        while window i is with the consumer, window i+1 is read, verified
        and decoded on the set's readahead pool, one window in flight. A
        response of one window reads on the calling thread. Each chunk
        is a view of a pooled lease, valid until the consumer pulls the
        next chunk or closes the iterator; closing early collects the
        prefetch in flight and returns its lease.

        The key's namespace read lock is taken before the version is
        resolved and held until the iterator is drained or closed
        (minio_tpu/object/erasure_object.py `get_object_stream`; the
        reference's GetObjectNInfo unlocks on the reader's close), so an
        overwrite waits for the stream instead of removing its data dir.
        A consumer that writes the same key must close the stream first."""
        opts = opts or GetOptions()
        cm = self.ns.read(bucket, object_)
        cm.__enter__()
        try:
            fi, fis, errors = self._read_fileinfo(bucket, object_, True,
                                                  opts.version_id)
            if any(errors):
                # A drive misses this version's metadata: heal it in the
                # background even though the read succeeds from the rest.
                self.mrf.enqueue(bucket, object_, fi.version_id)
            if length is None:
                length = fi.size - offset
            if offset < 0 or length < 0 or offset + length > fi.size:
                raise InvalidRange(bucket, object_)
        except BaseException:
            cm.__exit__(None, None, None)
            raise
        end = offset + length
        descs = self._window_descs(fi, offset, end)

        def read(desc):
            return self._read_window(bucket, object_, fi, fis, *desc[:4])

        def chunk(desc, win):
            lo = desc[4] + desc[2] * BLOCK_SIZE
            return memoryview(win)[max(offset, lo) - lo:
                                   min(end, lo + win.size) - lo]

        def windows():
            if not descs:
                return
            if len(descs) == 1:
                win, lease = read(descs[0])
                try:
                    yield chunk(descs[0], win)
                finally:
                    lease.release()
                return
            fut = self._readahead.submit(read, descs[0])
            lease = None
            try:
                for i, desc in enumerate(descs):
                    win, lease = fut.result()
                    # Prefetch the next window before handing this one
                    # out: its reads and kernels overlap the consumer.
                    fut = self._readahead.submit(read, descs[i + 1]) \
                        if i + 1 < len(descs) else None
                    yield chunk(desc, win)
                    lease.release()
                    lease = None
            finally:
                if lease is not None:
                    lease.release()
                if fut is not None:
                    # A prefetch still in flight (closed early, or a
                    # window failed): collect it so its lease returns.
                    try:
                        fut.result()[1].release()
                    except BaseException:  # noqa: BLE001 - unwinding
                        pass

        def gen():
            try:
                # Primer: advanced below before the iterator is handed
                # out, so the generator has started and a close() before
                # its first chunk still runs this finally and unlocks.
                yield b""
                yield from windows()
            finally:
                cm.__exit__(None, None, None)
        g = gen()
        next(g)
        return object_info(bucket, object_, fi), g

    @staticmethod
    def _window_descs(fi: FileInfo, offset: int, end: int) -> list[tuple]:
        """(part number, part size, first block, last block, object
        offset of the part) of each window covering [offset, end): block
        windows of STREAM_WINDOW_BLOCKS inside each part, none crossing a
        part (minio_tpu/object/erasure_object.py `_window_descs`)."""
        parts = fi.parts or [ObjectPartInfo(number=1, size=fi.size,
                                            actual_size=fi.size)]
        descs: list[tuple] = []
        cum = 0
        for p in parts:
            lo, hi = max(offset, cum), min(end, cum + p.size)
            if lo < hi:
                last = (hi - 1 - cum) // BLOCK_SIZE
                descs += [(p.number, p.size, b0,
                           min(last, b0 + STREAM_WINDOW_BLOCKS - 1), cum)
                          for b0 in range((lo - cum) // BLOCK_SIZE, last + 1,
                                          STREAM_WINDOW_BLOCKS)]
            cum += p.size
            if cum >= end:
                break
        return descs

    def _read_window(self, bucket: str, object_: str, fi: FileInfo,
                     fis: list, part_number: int, part_size: int,
                     start_b: int, end_b: int) -> tuple:
        """(bytes of erasure blocks [start_b, end_b] of part
        `part_number` (`part_size` bytes), the pooled lease they live in;
        the caller releases it).

        Every shard's framed bytes are scatter-read straight into a
        pooled (pinned) region laid out [block, shard, frame], which the
        get batcher verifies on the device as it stands; the payload then
        de-frames and interleaves into the output lease in one strided
        copy. With shards missing or failing their digest, the parity
        shards are read and verified too and the missing data shards
        are rebuilt on the device from a pinned stack of survivors, and
        the object goes on the MRF queue."""
        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        n = k + m
        e = Erasure(k, m, fi.erasure.block_size, backend=self.backend)
        ss = e.shard_size()
        frame = DIGEST + ss
        win_len = min(e.shard_file_size(part_size), (end_b + 1) * ss) \
            - start_b * ss
        nb = end_b - start_b + 1
        slast = win_len - (nb - 1) * ss
        full = nb if slast == ss else nb - 1
        tail = 0 if slast == ss else slast    # payload of a ragged frame
        tframe = DIGEST + tail if tail else 0
        framed_lo = start_b * frame

        holders: dict[int, int] = {}
        for di, dfi in enumerate(fis):
            if dfi is not None and not dfi.deleted and \
                    (dfi.mod_time, dfi.data_dir) == (fi.mod_time, fi.data_dir):
                holders[dfi.erasure.index - 1] = di

        leases: list = []
        out_lease = None
        try:
            dl, dfa, dta, got = self._read_shards(
                bucket, object_, fi, fis, part_number,
                [holders.get(s) for s in range(k)], framed_lo, full, tframe)
            leases.append(dl)
            good = [g and v for g, v in zip(got, self._verify_framed(
                dfa, dta, k, m, batched=all(got)))]
            fulls = [dfa[:, i, DIGEST:] for i in range(k)]
            tails = [dta[i, DIGEST:] for i in range(k)]
            if all(good):
                out_lease, out = self._deframe(fi, part_size, start_b, nb,
                                               k, ss, fulls, tails,
                                               framed=dfa)
                return out, out_lease
            pl, pfa, pta, pgot = self._read_shards(
                bucket, object_, fi, fis, part_number,
                [holders.get(s) for s in range(k, n)], framed_lo, full, tframe)
            leases.append(pl)
            good += [g and v for g, v in zip(
                pgot, self._verify_framed(pfa, pta, k, m))]
            fulls += [pfa[:, j, DIGEST:] for j in range(m)]
            tails += [pta[j, DIGEST:] for j in range(m)]
            available = sum(good)
            if available < k:
                raise ReadQuorumError(bucket, object_,
                                      f"{available}/{n} shards readable")
            leases += self._decode_missing(fulls, tails, good, k, m, full,
                                           tail, ss)
            out_lease, out = self._deframe(fi, part_size, start_b, nb, k,
                                           ss, fulls, tails)
            # Bytes served from reconstruction: heal in the background
            # (reference cmd/erasure-object.go:399-417).
            self.mrf.enqueue(bucket, object_, fi.version_id)
            return out, out_lease
        except BaseException:
            if out_lease is not None:
                out_lease.release()
            raise
        finally:
            for h in leases:
                h.release()

    def _read_shards(self, bucket: str, object_: str, fi: FileInfo,
                     fis: list, part_number: int, drives: list,
                     framed_lo: int, full: int, tframe: int) -> tuple:
        """Scatter-read framed blocks of shard files into one pooled
        (pinned) region, one preadv a shard: drives[j] is the drive
        holding the region's shard j (None: no holder), read from framed
        offset framed_lo of its `part.{part_number}` (or of its inline
        data). Returns (lease, full frames [full, c, frame], ragged
        frames [c, tframe], whether each shard read whole); an unreadable
        or short shard counts as missing. The caller releases the
        lease."""
        c = len(drives)
        frame = DIGEST + -(-fi.erasure.block_size // fi.erasure.data_blocks)
        span = full * frame + tframe          # framed bytes per shard
        lease = global_pool(self.device).lease(c * span)
        flat = lease.ndarray((c * span,))
        fa = flat[:full * c * frame].reshape(full, c, frame)
        ta = flat[full * c * frame:].reshape(c, tframe)

        def fetch(j: int, di: int) -> bool:
            blob = fis[di].inline_data
            if blob is not None:
                if not blob:
                    # The not-loaded sentinel (a parity holder of a
                    # cached entry): this holder's journal has it.
                    try:
                        blob = self.disks[di].read_version(
                            bucket, object_, fi.version_id,
                            read_data=True).inline_data or b""
                    except (OSError, StorageError, MetaError):
                        return False
                src = np.frombuffer(blob, dtype=np.uint8)[
                    framed_lo:framed_lo + span]
                if src.size != span:
                    return False
                fa[:, j] = src[:full * frame].reshape(full, frame)
                ta[j] = src[full * frame:]
                return True
            bufs = [fa[b, j] for b in range(full)] + ([ta[j]] if tframe
                                                      else [])
            try:
                return self.disks[di].read_file_into(
                    bucket, f"{object_}/{fi.data_dir}/part.{part_number}",
                    framed_lo, bufs) == span
            except (OSError, FileNotFoundErr):
                return False                 # unreadable shard == missing
            except Exception as exc:
                hold_past(exc, [lease])
                raise

        fns: list = [None] * len(self.disks)
        for j, di in enumerate(drives):
            if di is not None:
                fns[di] = functools.partial(fetch, j, di)
        try:
            results, _ = self._fanout(fns)
        except BaseException:
            lease.release()
            raise
        return lease, fa, ta, [di is not None and bool(results[di])
                               for di in drives]

    def _verify_framed(self, fa: np.ndarray, ta: np.ndarray, k: int, m: int,
                       batched: bool = False) -> list[bool]:
        """Per shard of a framed region (full frames [full, c, frame],
        ragged frames [c, tframe]), whether every block matches its
        digest. With `batched` (the k data shards of a GET, all read; a
        heal's survivors) the full frames go through the get batcher of
        c shards; other regions hash on the device directly."""
        full, count, frame = fa.shape
        ok = np.ones(count, dtype=bool)
        if full:
            if batched:
                sb = self._batcher("get", count, k + m - count)
                verdict, _ = sb.frame(fa)
                self._count("get", sb.last_route())
            else:
                digs = hh_device.framed_digests_device(
                    [fa.reshape(full * count, frame)], device=self.device)
                verdict = (digs.reshape(full, count, DIGEST)
                           == fa[:, :, :DIGEST]).all(axis=2)
            ok &= verdict.all(axis=0)
        if ta.shape[1]:
            digs = hh_device.hash_blocks_device(MAGIC_KEY, ta[:, DIGEST:],
                                                device=self.device)
            ok &= (digs == ta[:, :DIGEST]).all(axis=1)
        return ok.tolist()

    def _deframe(self, fi: FileInfo, part_size: int, start_b: int, nb: int,
                 k: int, ss: int, fulls: list, tails: list,
                 framed=None) -> tuple:
        """(lease, the window's object bytes in it): data shard i's block
        payloads fulls[i] [full, ss] and ragged payload tails[i]
        interleave block-major, each block trimmed to its size (k*ss may
        exceed the block size). Whole blocks of a set with k*ss equal to
        the block size take one strided copy, straight from the framed
        region [full, k, frame] when it holds every data shard."""
        bs = fi.erasure.block_size
        total = min(part_size, (start_b + nb) * bs) - start_b * bs
        full = fulls[0].shape[0]
        lease = global_pool(self.device).lease(total)
        out = lease.ndarray((total,))
        whole = min(full, total // bs) if k * ss == bs else 0
        if whole:
            dst = out[:whole * bs].reshape(whole, k, ss)
            if framed is not None:
                dst[:] = framed[:whole, :, DIGEST:]
            else:
                for i in range(k):
                    dst[:, i] = fulls[i][:whole]
        pos = whole * bs
        for b in range(whole, nb):
            take = min(bs, total - pos)
            w = ss if b < full else tails[0].size
            for i in range(min(k, -(-take // w))):
                src = fulls[i][b] if b < full else tails[i]
                hi = min(take, (i + 1) * w)
                out[pos + i * w:pos + hi] = src[:hi - i * w]
            pos += take
        return lease, out

    def _decode_missing(self, fulls: list, tails: list, good: list, k: int,
                        m: int, full: int, tail: int, ss: int) -> list:
        """Rebuild the data shards that are not good from the first k good
        shards through the decode matrix, in place in fulls/tails: the
        full blocks through the reconstruct batcher of this survivor set
        from a pooled (pinned) stack of the survivors, the ragged tail
        directly. Returns the leases the rebuilt views hold."""
        missing = [i for i in range(k) if not good[i]]
        if not missing:
            return []
        use = tuple(i for i, g in enumerate(good) if g)[:k]
        rows = rebuild_rows(k, m, use, missing)
        leases = []
        if full:
            lease = global_pool(self.device).lease(full * k * ss)
            leases.append(lease)
            stacked = lease.ndarray((full, k, ss))
            for j, i in enumerate(use):
                stacked[:, j] = fulls[i]
            sb = self._batcher("reconstruct", k, m, use, tuple(missing))
            out = sb.frame(stacked)                          # [full, r, ss]
            self._count("reconstruct", sb.last_route())
            for r, i in enumerate(missing):
                fulls[i] = out[:, r]
        if tail:
            tout = self.backend.apply_matrix(
                rows, np.stack([tails[i] for i in use]))
            for r, i in enumerate(missing):
                tails[i] = tout[r]
        return leases

    # ------------------------------------------------------------------
    # DeleteObject
    # ------------------------------------------------------------------

    def delete_object(self, bucket: str, object_: str,
                      opts: Optional[DeleteOptions] = None) -> DeletedObject:
        """minio_tpu/object/erasure_object.py `delete_object` (reference
        DeleteObject, cmd/erasure-object.go): `_delete_object_locked`
        under the key's write lock."""
        opts = opts or DeleteOptions()
        self._check_bucket(bucket)
        with self.ns.write(bucket, object_):
            return self._delete_object_locked(bucket, object_, opts)

    def _delete_object_locked(self, bucket: str, object_: str,
                              opts: DeleteOptions) -> DeletedObject:
        """The delete, for a caller holding the key's write lock (a pool
        migration's clean-up, object/decom.migrate_key): with no version
        named, a versioned bucket gets a delete marker and a suspended
        one a null marker that replaces the null version; otherwise the
        named (or null) version is removed. Write quorum is a majority
        of the set, and a drive that no longer holds the version counts
        as done; when some drive missed the removal the key goes on the
        MRF, so no stale copy can bring the version back."""
        n = len(self.disks)
        write_quorum = n // 2 + 1
        if (opts.versioned or opts.null_marker) and not opts.version_id:
            return self._write_delete_marker(bucket, object_, opts)
        try:
            _, errors = self._fanout([
                lambda d=d: d.delete_version(bucket, object_,
                                             opts.version_id)
                for d in self.disks])
        finally:
            self.metacache.bump(bucket)
        ok = sum(e is None for e in errors)
        missing = sum(isinstance(e, (FileNotFoundErr, VersionNotFoundErr))
                      for e in errors)
        if ok + missing < write_quorum:
            raise WriteQuorumError(bucket, object_,
                                   f"deleted on {ok + missing}/{n}")
        if ok + missing < n and ok > 0:
            self.mrf.enqueue(bucket, object_, opts.version_id)
        return DeletedObject(object_name=object_, version_id=opts.version_id)

    def _write_delete_marker(self, bucket: str, object_: str,
                             opts: DeleteOptions) -> DeletedObject:
        """A delete marker (a null marker when `opts.null_marker`), under
        the key's lock. Markers are journal-only commits, the shape of an
        inline PUT, so a concurrent delete storm coalesces through the
        same group lanes (minio_tpu/object/erasure_object.py
        `_delete_object_locked`)."""
        marker_vid = "" if opts.null_marker else new_uuid()
        fi = FileInfo(volume=bucket, name=object_, version_id=marker_vid,
                      deleted=True, mod_time=now_ns())
        gc = self.group_commit
        used_group = False
        try:
            with gc.tracking() if gc is not None else nullcontext():
                if gc is not None and gc.worth_batching():
                    used_group = True
                    errors = gc.commit_fanout(
                        [GroupOp.write_meta(bucket, object_, fi)
                         for _ in self.disks])
                else:
                    if gc is not None:
                        gc.note_solo()
                    _, errors = self._fanout(
                        [lambda d=d: d.write_metadata(bucket, object_, fi)
                         for d in self.disks])
        finally:
            if not used_group:
                self.metacache.bump(bucket)
        if sum(e is None for e in errors) < len(self.disks) // 2 + 1:
            raise WriteQuorumError(bucket, object_)
        return DeletedObject(object_name=object_, delete_marker=True,
                             delete_marker_version_id=marker_vid or "null")

    # ------------------------------------------------------------------
    # listing
    # ------------------------------------------------------------------

    def _walk_resolved(self, bucket: str, prefix: str, start: str = "",
                       shallow: bool = False):
        """Sorted (path, entry) stream of the keys at or after
        max(start, prefix), the metacache's production side
        (minio_tpu/object/erasure_object.py `_walk_resolved`): each walked
        drive's sorted walk_scan (summaries, storage/meta_scan), over a
        majority of the drives (any write quorum meets the walked set,
        so a committed object is listed even where some drives missed
        it), k-way merged, each key resolved into a trimmed stream entry
        (`_resolve_walked`). The walked drives rotate from one walk to
        the next, so a drive failing mid-walk shadows only some walks.
        `shallow` walks one level and passes prefix markers through (the
        "/" delimiter pages); a marker on any walked drive lists the
        prefix, as the deep walk's union would."""
        base_dir = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
        forward = max(start, prefix)

        def disk_iter(d):
            try:
                yield from d.walk_scan(bucket, base_dir=base_dir,
                                       forward_from=forward,
                                       shallow=shallow)
            except Exception:  # noqa: BLE001 - a lost drive walks nothing
                return

        n = len(self.disks)
        with self._stat_mu:
            rotor = self._walk_rotor
            self._walk_rotor = (rotor + 1) % n
        walked = [self.disks[(rotor + i) % n] for i in range(n // 2 + 1)]
        merged = heapq.merge(*[disk_iter(d) for d in walked],
                             key=lambda t: t[0])
        for path, grp in groupby(merged, key=lambda t: t[0]):
            items = [(v, b) for _, v, b in grp]
            if any(v is PREFIX_MARK for v, _ in items):
                yield path, PREFIX_MARK
                continue
            entry = self._resolve_walked(bucket, path, items, len(walked))
            if entry is not None:
                yield path, entry

    def _resolve_walked(self, bucket: str, path: str, items: list,
                        total_walked: int):
        """One walked key's per-drive (summary, blob) copies -> its stream
        entry (minio_tpu/object/erasure_object.py `_resolve_walked`).
        When every walked drive has the key and the copies agree on the
        latest version, the journal is the answer: a summary that serves
        listings becomes ("s", vlist) with no journal parsed here, else
        one copy's journal is parsed into ("m", version maps). Otherwise
        (a drive missed a delete or an overwrite, or the object never
        reached every walked drive) a quorum read decides and only its
        version is listed, so a lone stale copy cannot bring a deleted
        object back and a quorum-thin write is still listed. None: the
        key is not listed."""
        parsed = []      # (latest version's key, vlist, blob, parsed journal)
        for vlist, blob in items:
            if vlist is not None:
                if not vlist:
                    continue           # an empty journal lists nothing
                lv = vlist[0]
                parsed.append(((lv[1], lv[3], bool(lv[0] & FLAG_DELETED),
                                lv[4]), vlist, blob, None))
                continue
            try:
                xl = XLMeta.load(blob)
                v0 = xl.versions[0]
            except (MetaError, IndexError):   # an unreadable or empty copy
                continue
            parsed.append(((v0["mt"], v0["vid"],
                            v0["kind"] == KIND_DELETE_MARKER,
                            v0.get("ddir", "") or ""), None, blob, xl))
        if len(parsed) == total_walked and len({p[0] for p in parsed}) == 1:
            for _, vlist, _, _ in parsed:
                if vlist is not None and summary_sufficient(vlist):
                    return ("s", vlist)
            for _, _, blob, xl in parsed:
                try:
                    return ("m", list((xl or XLMeta.load(blob)).versions))
                except MetaError:
                    continue
        try:
            fi, _, _ = self._quorum_fileinfo(bucket, path, False)
        except ObjectError:               # dangling or below quorum
            return None
        return ("m", [fi.to_version_map()])

    @staticmethod
    def _shallow_ok(delimiter: str) -> bool:
        """Whether a delimiter page rides the one-level shallow walk: the
        delimiter is the path separator, so collapse boundaries are
        directory boundaries (minio_tpu/object/erasure_object.py
        `_shallow_ok`; MTPU_LIST_SHALLOW=off turns it off)."""
        return delimiter == "/" and os.environ.get(
            "MTPU_LIST_SHALLOW", "on").lower() not in ("0", "off", "false")

    @staticmethod
    def _entry_fileinfos(bucket: str, path: str, entry) -> list[FileInfo]:
        """A stream entry -> its FileInfos, latest first. A summary
        rebuilds the fields a listing reads (no parts: no listing shows
        them)."""
        kind, payload = entry
        if kind == "m":
            xl = XLMeta()
            xl.versions = list(payload)
            return xl.list_versions(bucket, path)
        out = []
        for i, (flags, mt, size, vid, ddir, etag, ctype, tags) in \
                enumerate(payload):
            fi = FileInfo(volume=bucket, name=path,
                          version_id="" if vid == NULL_VERSION_ID else vid,
                          is_latest=i == 0,
                          deleted=bool(flags & FLAG_DELETED), mod_time=mt)
            fi.metadata = {k: v for k, v in (("etag", etag),
                                             ("content-type", ctype),
                                             ("x-amz-tagging", tags)) if v}
            if not fi.deleted:
                fi.data_dir = ddir
                fi.size = size
                if flags & FLAG_INLINE:
                    fi.inline_data = b""       # inline, not loaded
            out.append(fi)
        return out

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000,
                     include_versions: bool = False) -> ListObjectsInfo:
        """One page of the sorted listing with S3's prefix, marker,
        delimiter and max-keys semantics, served from the shared walk
        stream of object/metacache (minio_tpu/object/erasure_object.py
        `list_objects`; reference cmd/metacache-set.go:700): every page,
        every concurrent listing of the prefix and every follow-up
        within the reuse window read ONE background walk, and a write
        to the bucket orphans it. Keys after `marker`; those holding
        `delimiter` after the prefix collapse into common prefixes (a
        marker strictly inside a collapsed prefix brings that prefix
        back); keys whose latest version is a delete marker are left out
        unless `include_versions`, which lists every version of each
        key. A page holds at most max_keys (<= 1000) keys and prefixes;
        `next_marker` is the last one of a truncated page. "/" pages
        read a shallow stream (one directory level and prefix markers),
        so a page costs O(page), not O(subtree)."""
        self._check_bucket(bucket)
        max_keys = max(1, min(max_keys, 1000))
        shallow = self._shallow_ok(delimiter)
        floor = marker if marker > prefix else prefix
        # A marker strictly inside a collapsed prefix must bring that
        # prefix back. The deep stream does so by itself (later keys
        # collapse again); the shallow stream holds ONE entry a prefix,
        # sorted before such a marker: the page's scan starts there.
        page_floor, floor_left = marker, False
        if shallow and marker and marker.startswith(prefix):
            di = marker[len(prefix):].find("/")
            if di >= 0:
                cp = marker[:len(prefix) + di + 1]
                if cp != marker:
                    page_floor, floor_left = cp, True
        walk = self.metacache.walk_for(
            self, bucket, prefix, shallow=shallow,
            seek=page_floor if floor_left else marker)
        if walk.truncated and walk.done and walk.keys and \
                marker >= walk.keys[-1]:
            # Past a capped stream: a start-floored walk (shared by the
            # continuations after it) keeps the pages moving.
            walk = self.metacache.walk_for(self, bucket, prefix,
                                           start=marker, shallow=shallow)
        need = max_keys + 1
        while True:
            count, done = walk.wait_past(floor, need)
            # keys and entries only grow: indices below count are stable.
            keys, entries = walk.keys, walk.entries
            info = ListObjectsInfo()
            seen_prefixes: set[str] = set()
            last_added = ""
            complete = False          # the page filled or the range ended
            if not marker:
                idx = 0
            elif floor_left:
                idx = bisect.bisect_left(keys, page_floor, 0, count)
            else:
                idx = bisect.bisect_right(keys, marker, 0, count)
            for i in range(idx, count):
                path = keys[i]
                if not path.startswith(prefix):
                    if path > prefix and not prefix.startswith(path):
                        complete = True
                        break         # the sorted stream passed the prefix
                    continue
                if delimiter:
                    rest = path[len(prefix):]
                    di = rest.find(delimiter)
                    if di >= 0:
                        cp = prefix + rest[:di + len(delimiter)]
                        if cp in seen_prefixes or (
                                marker and cp <= marker
                                and not (marker.startswith(cp)
                                         and marker != cp)):
                            continue
                        if len(info.objects) + len(seen_prefixes) \
                                >= max_keys:
                            info.is_truncated = True
                            info.next_marker = last_added
                            complete = True
                            break
                        seen_prefixes.add(cp)
                        last_added = cp
                        continue
                entry = entries[i]
                if entry is PREFIX_MARK:
                    continue          # reachable only with a delimiter
                fis = self._entry_fileinfos(bucket, path, entry)
                if not fis or (fis[0].deleted and not include_versions):
                    continue
                if len(info.objects) + len(seen_prefixes) >= max_keys:
                    info.is_truncated = True
                    info.next_marker = last_added
                    complete = True
                    break
                info.objects += [object_info(bucket, path, v) for v in
                                 (fis if include_versions else fis[:1])]
                last_added = path
            if complete or done:
                if walk.error is not None and not complete:
                    # The walk failed before this page's range ended: a
                    # short page would drop every key past the failure.
                    raise walk.error
                if done and not complete and walk.truncated:
                    # The stream stopped (its cap, or a write orphaned
                    # it) before the range ended: page out what is here;
                    # the next page walks on from its marker.
                    info.is_truncated = True
                    info.next_marker = last_added or (
                        keys[count - 1] if count else "")
                info.prefixes = sorted(seen_prefixes)
                return info
            # Not deep enough to fill the page yet (collapsing can use
            # many entries a prefix): wait for more.
            need *= 2

    # ------------------------------------------------------------------
    # pool migrations
    # ------------------------------------------------------------------

    def restore_version(self, bucket: str, object_: str, src_fi: FileInfo,
                        data, skip_if_newer_null: bool = False) -> None:
        """Write one version copied from another erasure set into this
        set's geometry: the transfer primitive of a pool decommission or
        rebalance (minio_tpu/object/erasure_object.py `restore_version`;
        reference decommissionObject, cmd/erasure-server-pool-decom.go).

        `src_fi` keeps its version id, mod time, metadata (the ETag
        among it) and part boundaries verbatim; `data` (None for a delete
        marker or a version whose data lives in a warm tier) is the
        whole stored byte stream, re-encoded here at this
        set's (k, m): each part streams through the PUT framer into its
        own `part.N` data file, as the JAX package writes it (never
        inline), and the version commits under the key's lock. With
        `skip_if_newer_null`, a null version already here at least as
        new as the one restored wins (one null slot a key: restoring an
        old null over a newer one would lose an acknowledged write)."""
        self._check_bucket(bucket)
        n = len(self.disks)

        def newer_null_exists() -> bool:
            if not skip_if_newer_null or src_fi.version_id:
                return False
            try:
                return any(v.version_id == "" and
                           v.mod_time >= src_fi.mod_time
                           for v in self.list_versions_all(bucket, object_))
            except ObjectNotFound:
                return False

        if src_fi.deleted or data is None:
            # A delete marker, or a version whose data lives in a warm
            # tier: its metadata alone moves.
            fi = FileInfo(volume=bucket, name=object_,
                          version_id=src_fi.version_id,
                          deleted=src_fi.deleted, mod_time=src_fi.mod_time)
            if not src_fi.deleted:
                fi.size = src_fi.size
                fi.metadata = dict(src_fi.metadata)
                fi.parts = [dataclasses.replace(p) for p in src_fi.parts]
            with self.ns.write(bucket, object_):
                if newer_null_exists():
                    return
                _, errors = self._fanout(
                    [lambda d=d: d.write_metadata(bucket, object_, fi)
                     for d in self.disks])
            self.metacache.bump(bucket)
            if sum(e is None for e in errors) < n // 2 + 1:
                raise WriteQuorumError(bucket, object_)
            return
        m = self.default_parity
        k = n - m
        write_quorum = k + (1 if k == m else 0)
        distribution = hash_order(f"{bucket}/{object_}", n)
        e = Erasure(k, m, BLOCK_SIZE, backend=self.backend)
        parts = list(src_fi.parts) or [
            ObjectPartInfo(number=1, size=len(data), actual_size=len(data))]
        data_dir = new_uuid()
        staging = f"{STAGING_PREFIX}/p{os.getpid()}-{new_uuid()}"
        errors: list = [None] * n
        view = memoryview(data)
        try:
            off = 0
            for p in parts:
                self._stream_framed_writes(
                    Payload.wrap(view[off:off + p.size]), e, distribution,
                    f"{staging}/{data_dir}/part.{p.number}", write_quorum,
                    errors)
                off += p.size

            def staged_fi(i: int) -> FileInfo:
                return FileInfo(
                    volume=bucket, name=object_,
                    version_id=src_fi.version_id, data_dir=data_dir,
                    mod_time=src_fi.mod_time, size=src_fi.size,
                    metadata=dict(src_fi.metadata),
                    parts=[dataclasses.replace(p) for p in parts],
                    erasure=ErasureInfo(
                        data_blocks=k, parity_blocks=m,
                        block_size=BLOCK_SIZE,
                        index=distribution[i], distribution=tuple(
                            distribution)))
            with self.ns.write(bucket, object_):
                if newer_null_exists():
                    return
                _, cerrs = self._fanout([
                    (lambda i=i: self.disks[i].rename_data(
                        SYS_VOL, staging, staged_fi(i), bucket, object_))
                    if errors[i] is None else None for i in range(n)])
                for i, err in enumerate(cerrs):
                    errors[i] = errors[i] or err
                ok = sum(err is None for err in errors)
                if ok < write_quorum:
                    self._fanout([lambda d=d: d.delete_version(
                        bucket, object_, src_fi.version_id)
                        if err is None else None
                        for d, err in zip(self.disks, errors)])
            self.metacache.bump(bucket)
        finally:
            self._fanout([functools.partial(_quiet, functools.partial(
                d.delete, SYS_VOL, staging, recursive=True))
                for d in self.disks])
        if ok < write_quorum:
            raise WriteQuorumError(bucket, object_,
                                   f"restored {ok}/{n}, need {write_quorum}")
        if ok < n:
            self.mrf.enqueue(bucket, object_, src_fi.version_id)

    def list_versions_all(self, bucket: str, object_: str) -> list[FileInfo]:
        """Every version of one key, latest first, from the first drive
        that holds any."""
        results, _ = self._fanout([lambda d=d: d.list_versions(bucket,
                                                               object_)
                                   for d in self.disks])
        for r in results:
            if r:
                return r
        raise ObjectNotFound(bucket, object_)

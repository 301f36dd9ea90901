"""Erasure object store: one erasure set of n drives, device-backed.

The port of minio_tpu/object/erasure_object.py's main path (reference
erasureObjects, cmd/erasure-object.go) for one set of local drives:

  * PutObject splits the object into 1 MiB erasure blocks and walks them
    in windows of STREAM_WINDOW_BLOCKS blocks, so device memory stays
    O(window) for any object size. Every window's full blocks go
    through the fused device framer (ops/hh_device.make_mesh_framer:
    RS parity + the HighwayHash-256 of every shard block); the ragged
    last block goes through ops/rs_device.gf_apply and
    ops/hh_device.hash_blocks_device. Shard files (`digest || block`
    per erasure block) are staged on every drive in parallel and
    committed with quorum-counted renames (write quorum k, +1 when
    k == m). Objects whose shard files fit SMALL_FILE_THRESHOLD go
    inline into xl.meta.
  * GetObject picks the version agreed by read quorum, reads the k data
    shards window by window and verifies every block digest on the
    device (ops/hh_device.make_mesh_deframer); the payload is served from
    the host's own framed bytes.
  * With drives missing, or blocks failing their digest, GetObject
    verifies the surviving shards on the device and rebuilds the data
    shards through the decode matrix on the device
    (ops/rs_device.make_mesh_matrix; the ragged tail through GpuBackend).

Full blocks of every window go through the cross-request stripe batcher
(ops/batcher.StripeBatcher), one per route and config: the PUT framer,
the GET verify and the degraded-read reconstruct. Windows of concurrent
requests coalesce into one device dispatch from pinned staging; a lone
window dispatches straight through (MIN_DEVICE_BLOCKS is 1 here). The
ragged tail of a window keeps its direct kernel calls.

There is no host cutover: on the card every window runs the kernels, and
with device="cpu" their plain PyTorch versions. The batchers' host rivals
(`_host_rows`, `_host_deframe`, `_host_apply_rows`) run only when a
caller pins a route to the host (MTPU_BATCH_FORCE=host, or force(False)),
and such windows are counted as host windows. A device exception fails
the request; nothing retries it on the host. The on-disk bytes are
identical to the TPU package's for the same objects.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.erasure.codec import _HOST, Erasure
from minio_tpu_torch.io.bufpool import global_pool
from minio_tpu_torch.io.engine import kernel_lane, shutdown_kernel_lane
from minio_tpu_torch.object.types import (BucketExists, BucketNotFound,
                                          InvalidRange, ObjectInfo,
                                          ObjectNotFound, ReadQuorumError,
                                          WriteQuorumError)
from minio_tpu_torch.ops import gf256, hh_device, rs_device
from minio_tpu_torch.ops.batcher import StripeBatcher, merge_route_stats
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.storage.local import SYS_VOL, VolumeExists
from minio_tpu_torch.storage.meta import (ErasureInfo, FileInfo,
                                          FileNotFoundErr, ObjectPartInfo,
                                          VersionNotFoundErr, new_uuid, now_ns)
from minio_tpu_torch.utils.highwayhash import MAGIC_KEY, highwayhash256_many

BLOCK_SIZE = 1 << 20              # reference blockSizeV2 (cmd/object-api-common.go:37)
SMALL_FILE_THRESHOLD = 128 << 10  # inline threshold (storage-class.go:278)
STAGING_PREFIX = "staging"
# Erasure blocks per device window, PUT and GET alike: a 32 MiB window is
# one framer or deframer dispatch and bounds device memory per request.
STREAM_WINDOW_BLOCKS = 32
DIGEST = bitrot.digest_size(bitrot.DEFAULT_ALGORITHM)
# Full blocks a window needs before it may take the device route on its
# own. The JAX package's 8 was tuned on a TPU; until an H100 measurement
# sets it, every window of full blocks goes to the card.
MIN_DEVICE_BLOCKS = 1


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


def _reconstruct_batcher_for(k: int, m: int, use: tuple, missing: tuple,
                             device: str) -> StripeBatcher:
    """Batched reconstruct for one (EC config, surviving-shard set):
    degraded-read windows stack their survivors [B, k, S] and the
    decode-matrix rows of the missing data shards apply in one dispatch
    (ops/rs_device.make_mesh_matrix). Concurrent degraded GETs coalesce
    when their objects share a survivor set."""
    dec = gf256.decode_matrix(k, m, use)
    rows = np.ascontiguousarray(dec[list(missing), :])
    return StripeBatcher(
        rs_device.make_mesh_matrix(rows, device=device),
        functools.partial(_host_apply_rows, rows),
        min_device_blocks=MIN_DEVICE_BLOCKS, pool=global_pool(device),
        name=f"rec:{k}+{m}:" + ",".join(map(str, use)),
        route="reconstruct",
        split_fn=lambda out, off, c, _member: out[off:off + c],
        concat_fn=lambda a, b: np.concatenate([a, b]))


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


class _KeyLocks:
    """Per-object mutexes serializing commits and deletes of one key."""

    def __init__(self):
        self._mu = threading.Lock()
        self._locks: dict[str, list] = {}     # key -> [lock, holders]

    def hold(self, key: str):
        locks = self

        class _Held:
            def __enter__(self):
                with locks._mu:
                    ent = locks._locks.setdefault(key, [threading.Lock(), 0])
                    ent[1] += 1
                ent[0].acquire()

            def __exit__(self, *exc):
                with locks._mu:
                    ent = locks._locks[key]
                    ent[0].release()
                    ent[1] -= 1
                    if not ent[1]:
                        del locks._locks[key]
        return _Held()


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
        self._ns = _KeyLocks()
        # Windows of full blocks by route, as the batcher routed them:
        # through the device kernels, or through a host rival (only when
        # a caller pinned the route to the host).
        self.device_windows = {"put": 0, "get": 0, "reconstruct": 0}
        self.host_windows = {"put": 0, "get": 0, "reconstruct": 0}
        self._stat_mu = threading.Lock()
        # Stripe batchers, keyed (route, k, m, use, missing, device).
        self._batchers: dict[tuple, StripeBatcher] = {}
        self._batchers_mu = threading.Lock()

    def close(self) -> None:
        """Stop the drive fan-out pool and the batchers, then join the
        kernel lane, whose worker calls into CUDA and must not outlive
        the process's useful life."""
        self.pool.shutdown(wait=True)
        with self._batchers_mu:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for sb in batchers:
            sb.close()
        shutdown_kernel_lane()

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

    def bucket_exists(self, bucket: str) -> bool:
        results, _ = self._fanout([lambda d=d: d.stat_vol(bucket)
                                   for d in self.disks])
        return any(r is not None for r in results)

    def _check_bucket(self, bucket: str) -> None:
        if not self.bucket_exists(bucket):
            raise BucketNotFound(bucket)

    # ------------------------------------------------------------------
    # PutObject
    # ------------------------------------------------------------------

    def _frame_window(self, e: Erasure, buf: np.ndarray) -> list[list]:
        """Encode + digest one window of object bytes on the device: per
        shard index, the [(digest, block), ...] pieces of its frames."""
        k, m = e.data_blocks, e.parity_blocks
        n, ss = k + m, e.shard_size()
        rows: list[list] = [[] for _ in range(n)]
        full = buf.size // BLOCK_SIZE
        if full:
            if k * ss == BLOCK_SIZE:
                stacked = buf[:full * BLOCK_SIZE].reshape(full, k, ss)
            else:
                # Split pads each block to k*ceil(block/k) with zeros
                # (reference Split semantics).
                stacked = np.zeros((full, k * ss), dtype=np.uint8)
                stacked[:, :BLOCK_SIZE] = buf[:full * BLOCK_SIZE] \
                    .reshape(full, BLOCK_SIZE)
                stacked = stacked.reshape(full, k, ss)
            sb = self._batcher("put", k, m)
            for i, pieces in enumerate(sb.frame(stacked)):
                rows[i].extend(pieces)
            self._count("put", sb.last_route())
        if buf.size > full * BLOCK_SIZE:
            data = e.split(buf[full * BLOCK_SIZE:])           # [k, per]
            shards = rs_device.host_tensor(data).to(self.device)
            if m:
                parity = rs_device.gf_apply(gf256.parity_matrix(k, m),
                                            shards[None])[0]
                shards = torch.cat([shards, parity])
            digs = hh_device.hash_blocks_device(MAGIC_KEY, shards).cpu() \
                .numpy()
            blocks = list(data) + list(shards[k:].cpu().numpy())
            for i in range(n):
                rows[i].append((digs[i], blocks[i]))
        return rows

    def put_object(self, bucket: str, object_: str, data,
                   content_type: str = "",
                   user_metadata: Optional[dict] = None) -> ObjectInfo:
        """data: bytes-like. Writes every shard file in
        STREAM_WINDOW_BLOCKS windows, then commits under quorum."""
        self._check_bucket(bucket)
        buf = np.frombuffer(data, dtype=np.uint8)
        n = len(self.disks)
        m = self.default_parity
        k = n - m
        write_quorum = k + (1 if k == m else 0)
        distribution = hash_order(f"{bucket}/{object_}", n)
        e = Erasure(k, m, BLOCK_SIZE, backend=self.backend)
        size = buf.size
        inline = e.shard_file_size(size) <= SMALL_FILE_THRESHOLD
        data_dir = "" if inline else new_uuid()
        staging = f"{STAGING_PREFIX}/p{os.getpid()}-{new_uuid()}"
        part = f"{staging}/{data_dir}/part.1"
        md5 = hashlib.md5()
        errors: list = [None] * n
        window = STREAM_WINDOW_BLOCKS * BLOCK_SIZE
        inline_rows: list[list] = [[] for _ in range(n)]
        try:
            for off in range(0, max(size, 1), window):
                chunk = buf[off:off + window]
                md5.update(chunk)
                rows = self._frame_window(e, chunk) if chunk.size \
                    else [[] for _ in range(n)]
                if inline:
                    for i in range(n):
                        inline_rows[i].extend(rows[i])
                    continue
                last = off + window >= size

                def write(i, rows=rows, first=off == 0, last=last):
                    pieces = rows[distribution[i] - 1]
                    self.disks[i].create_file(
                        SYS_VOL, part, (p for pair in pieces for p in pair),
                        append=not first, sync=last)
                _, errs = self._fanout([
                    (lambda i=i: write(i)) if errors[i] is None else None
                    for i in range(n)])
                for i, err in enumerate(errs):
                    errors[i] = errors[i] or err
                if sum(err is None for err in errors) < write_quorum:
                    raise WriteQuorumError(
                        bucket, object_,
                        f"{sum(err is not None for err in errors)}/{n} "
                        "shard writers failed")
            etag = md5.hexdigest()
            mod_time = now_ns()

            def make_fi(shard_idx: int) -> FileInfo:
                return FileInfo(
                    volume=bucket, name=object_, data_dir=data_dir,
                    mod_time=mod_time, size=size,
                    metadata={"etag": etag, **({"content-type": content_type}
                                               if content_type else {}),
                              **(user_metadata or {})},
                    parts=[ObjectPartInfo(number=1, size=size,
                                          actual_size=size, etag=etag)],
                    erasure=ErasureInfo(
                        data_blocks=k, parity_blocks=m, block_size=BLOCK_SIZE,
                        index=shard_idx + 1,
                        distribution=tuple(distribution)),
                    inline_data=bitrot.join_frames(inline_rows[shard_idx])
                    if inline else None)

            def commit(i: int):
                fi = make_fi(distribution[i] - 1)
                if inline:
                    self.disks[i].write_metadata(bucket, object_, fi)
                else:
                    self.disks[i].rename_data(SYS_VOL, staging, fi,
                                              bucket, object_)
            with self._ns.hold(f"{bucket}/{object_}"):
                _, cerrs = self._fanout([
                    (lambda i=i: commit(i)) if errors[i] is None else None
                    for i in range(n)])
            for i, err in enumerate(cerrs):
                errors[i] = errors[i] or err
        finally:
            if not inline:
                # Committed drives already moved their data dir out;
                # whatever staging is left is debris (errors ignored).
                self._fanout([lambda d=d: d.delete(SYS_VOL, staging,
                                                   recursive=True)
                              for d in self.disks])
        ok = sum(err is None for err in errors)
        if ok < write_quorum:
            self._fanout([lambda d=d: d.delete_version(bucket, object_)
                          if err is None else None
                          for d, err in zip(self.disks, errors)])
            raise WriteQuorumError(bucket, object_,
                                   f"wrote {ok}/{n}, need {write_quorum}")
        return ObjectInfo(bucket=bucket, name=object_, mod_time=mod_time,
                          size=size, etag=etag, content_type=content_type,
                          user_metadata=dict(user_metadata or {}))

    # ------------------------------------------------------------------
    # metadata quorum
    # ------------------------------------------------------------------

    def _quorum_fileinfo(self, bucket: str, object_: str,
                         read_data: bool) -> tuple[FileInfo, list]:
        fis, errors = self._fanout([
            lambda d=d: d.read_version(bucket, object_, "",
                                       read_data=read_data)
            for d in self.disks])
        n = len(self.disks)
        if sum(isinstance(e, FileNotFoundErr) for e in errors) > n // 2:
            self._check_bucket(bucket)
            raise ObjectNotFound(bucket, object_)
        any_fi = next((f for f in fis if f is not None), None)
        if any_fi is None:
            raise ReadQuorumError(bucket, object_, "no readable metadata")
        k = any_fi.erasure.data_blocks
        quorum = max(k, n // 2) if k else n // 2 + 1
        groups: dict[tuple, list[int]] = {}
        for i, fi in enumerate(fis):
            if fi is not None:
                groups.setdefault((fi.mod_time, fi.storage_version_id(),
                                   fi.data_dir, fi.deleted, fi.size),
                                  []).append(i)
        best = max((key for key, idx in groups.items()
                    if len(idx) >= quorum), default=None)
        if best is None:
            raise ReadQuorumError(bucket, object_,
                                  f"no version agreed by {quorum} drives")
        fi = fis[groups[best][0]]
        if fi.deleted:
            raise ObjectNotFound(bucket, object_)
        return fi, fis

    @staticmethod
    def _to_info(bucket: str, object_: str, fi: FileInfo) -> ObjectInfo:
        meta = dict(fi.metadata)
        etag = meta.pop("etag", "")
        ctype = meta.pop("content-type", "")
        return ObjectInfo(bucket=bucket, name=object_, mod_time=fi.mod_time,
                          size=fi.size, etag=etag, content_type=ctype,
                          version_id=fi.version_id, user_metadata=meta)

    def get_object_info(self, bucket: str, object_: str) -> ObjectInfo:
        fi, _ = self._quorum_fileinfo(bucket, object_, read_data=False)
        return self._to_info(bucket, object_, fi)

    # ------------------------------------------------------------------
    # GetObject
    # ------------------------------------------------------------------

    def get_object(self, bucket: str, object_: str) -> tuple[ObjectInfo, bytes]:
        info, chunks = self.get_object_stream(bucket, object_)
        return info, b"".join(chunks)

    def get_object_stream(self, bucket: str, object_: str, offset: int = 0,
                          length: Optional[int] = None
                          ) -> tuple[ObjectInfo, Iterator[memoryview]]:
        """(info, iterator over bytes [offset, offset + length) of the
        object, one window each; length None reads to the end). Only the
        erasure blocks that cover the range are read, in windows of
        STREAM_WINDOW_BLOCKS from block offset // BLOCK_SIZE; the first
        and last windows are sliced. A range past the object's end is
        InvalidRange."""
        fi, fis = self._quorum_fileinfo(bucket, object_, read_data=True)
        if length is None:
            length = fi.size - offset
        if offset < 0 or length < 0 or offset + length > fi.size:
            raise InvalidRange(bucket, object_)
        end = offset + length

        def gen():
            if not length:
                return
            last = (end - 1) // BLOCK_SIZE
            for b0 in range(offset // BLOCK_SIZE, last + 1,
                            STREAM_WINDOW_BLOCKS):
                b1 = min(last, b0 + STREAM_WINDOW_BLOCKS - 1)
                win = self._read_window(bucket, object_, fi, fis, b0, b1)
                lo = b0 * BLOCK_SIZE
                yield memoryview(win)[max(offset, lo) - lo:
                                      min(end, lo + win.size) - lo]
        return self._to_info(bucket, object_, fi), gen()

    def _read_window(self, bucket: str, object_: str, fi: FileInfo,
                     fis: list, start_b: int, end_b: int) -> np.ndarray:
        """Object bytes of erasure blocks [start_b, end_b]."""
        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        n = k + m
        e = Erasure(k, m, fi.erasure.block_size, backend=self.backend)
        ss = e.shard_size()
        frame = DIGEST + ss
        shard_file_len = e.shard_file_size(fi.size)
        win_len = min(shard_file_len, (end_b + 1) * ss) - start_b * ss
        framed_lo = start_b * frame
        framed_hi = min(bitrot.shard_file_size(shard_file_len, ss),
                        (end_b + 1) * frame)
        nb = end_b - start_b + 1
        slast = win_len - (nb - 1) * ss
        full = nb if slast == ss else nb - 1

        holders: dict[int, int] = {}
        for di, dfi in enumerate(fis):
            if dfi is not None and not dfi.deleted and \
                    (dfi.mod_time, dfi.data_dir) == (fi.mod_time, fi.data_dir):
                holders[dfi.erasure.index - 1] = di

        def fetch(shard_idx: int):
            di = holders.get(shard_idx)
            if di is None:
                return None
            if fis[di].inline_data is not None:
                return fis[di].inline_data[framed_lo:framed_hi]
            try:
                return self.disks[di].read_file(
                    bucket, f"{object_}/{fi.data_dir}/part.1",
                    offset=framed_lo, length=framed_hi - framed_lo)
            except (OSError, FileNotFoundErr):
                return None                  # unreadable shard == missing

        def fetch_many(idxs) -> list:
            fns: list = [None] * len(self.disks)
            for s in idxs:
                if s in holders:
                    fns[holders[s]] = functools.partial(fetch, s)
            results, _ = self._fanout(fns)
            return [results[holders[s]] if s in holders else None
                    for s in idxs]

        raw = fetch_many(range(k))
        expect = nb * DIGEST + win_len
        shards: list[Optional[np.ndarray]] = [None] * n
        if all(r is not None and len(r) == expect for r in raw):
            # Healthy path: every data-shard block verifies on the device.
            blobs = [np.frombuffer(r, dtype=np.uint8) for r in raw]
            bad = self._verify_data_shards(blobs, k, m, ss, full, slast)
            if not bad:
                return self._assemble(
                    fi, [self._unframe(b, ss, full, slast) for b in blobs],
                    k, ss, start_b, nb)
            for i in range(k):
                if i not in bad:
                    shards[i] = self._unframe(blobs[i], ss, full, slast)
            verify = {k + j: r for j, r in enumerate(fetch_many(range(k, n)))}
        else:
            verify = dict(zip(range(n), raw + fetch_many(range(k, n))))
        got = bitrot.read_framed_blocks_many(list(verify.values()), ss,
                                             win_len, device=self.device)
        for idx, arr in zip(verify, got):
            shards[idx] = arr
        available = sum(s is not None for s in shards)
        if available < k:
            raise ReadQuorumError(bucket, object_,
                                  f"{available}/{n} shards readable")
        self._decode_missing(shards, k, m, ss, win_len)
        return self._assemble(fi, shards, k, ss, start_b, nb)

    def _verify_data_shards(self, blobs, k, m, ss, full, slast) -> set[int]:
        """Indices of data shards with a block failing its digest: the
        full frames through the get batcher, the ragged tail directly."""
        frame = DIGEST + ss
        bad: set[int] = set()
        if full:
            stacked = np.empty((full, k, frame), dtype=np.uint8)
            for i, arr in enumerate(blobs):
                stacked[:, i, :] = arr[:full * frame].reshape(full, frame)
            sb = self._batcher("get", k, m)
            ok, _ = sb.frame(stacked)
            self._count("get", sb.last_route())
            bad |= {i for i in range(k) if not ok[:, i].all()}
        if slast != ss:
            off = full * frame
            tails = np.stack([a[off + DIGEST:off + DIGEST + slast]
                              for a in blobs])
            digs = hh_device.hash_blocks_device(MAGIC_KEY, tails,
                                                device=self.device)
            bad |= {i for i, a in enumerate(blobs)
                    if not np.array_equal(digs[i], a[off:off + DIGEST])}
        return bad

    @staticmethod
    def _unframe(arr: np.ndarray, ss: int, full: int, slast: int) -> np.ndarray:
        frame = DIGEST + ss
        out = np.empty(full * ss + (slast if slast != ss else 0),
                       dtype=np.uint8)
        if full:
            out[:full * ss].reshape(full, ss)[:] = \
                arr[:full * frame].reshape(full, frame)[:, DIGEST:]
        if slast != ss:
            off = full * frame + DIGEST
            out[full * ss:] = arr[off:off + slast]
        return out

    @staticmethod
    def _assemble(fi: FileInfo, shards, k: int, ss: int, start_b: int,
                  nb: int) -> np.ndarray:
        """Interleave k data-shard windows block-major, trimming each
        block's zero padding (k*ss may exceed the block size)."""
        bs = fi.erasure.block_size
        total = min(fi.size, (start_b + nb) * bs) - start_b * bs
        out = np.empty(total, dtype=np.uint8)
        pos = 0
        for b in range(nb):
            take = min(bs, fi.size - (start_b + b) * bs)
            lo = b * ss
            block = np.concatenate([s[lo:lo + ss] for s in shards[:k]])
            out[pos:pos + take] = block[:take]
            pos += take
        return out

    def _decode_missing(self, shards: list, k: int, m: int, ss: int,
                        win_len: int) -> None:
        """Rebuild missing data shards from the first k survivors through
        the decode matrix: the full shard blocks through the reconstruct
        batcher of this survivor set, the ragged tail directly."""
        missing = [i for i in range(k) if shards[i] is None]
        if not missing:
            return
        use = tuple(i for i, s in enumerate(shards) if s is not None)[:k]
        rows = np.ascontiguousarray(gf256.decode_matrix(k, m, use)[missing])
        full = win_len // ss
        rebuilt = [np.empty(win_len, dtype=np.uint8) for _ in missing]
        if full:
            stacked = np.stack([shards[i][:full * ss].reshape(full, ss)
                                for i in use], axis=1)       # [full, k, ss]
            sb = self._batcher("reconstruct", k, m, use, tuple(missing))
            out = sb.frame(stacked)                          # [full, r, ss]
            self._count("reconstruct", sb.last_route())
            for r, arr in enumerate(rebuilt):
                arr[:full * ss] = out[:, r].reshape(-1)
        if win_len > full * ss:
            tail = np.stack([shards[i][full * ss:] for i in use])
            tout = self.backend.apply_matrix(rows, tail)
            for r, arr in enumerate(rebuilt):
                arr[full * ss:] = tout[r]
        for r, i in enumerate(missing):
            shards[i] = rebuilt[r]

    # ------------------------------------------------------------------
    # DeleteObject
    # ------------------------------------------------------------------

    def delete_object(self, bucket: str, object_: str) -> None:
        n = len(self.disks)
        with self._ns.hold(f"{bucket}/{object_}"):
            _, errors = self._fanout([
                lambda d=d: d.delete_version(bucket, object_)
                for d in self.disks])
        gone = (FileNotFoundErr, VersionNotFoundErr)
        if all(isinstance(e, gone) for e in errors):
            self._check_bucket(bucket)
            return
        ok = sum(e is None or isinstance(e, gone) for e in errors)
        k = n - self.default_parity
        if ok < k + (1 if k == self.default_parity else 0):
            raise WriteQuorumError(bucket, object_, f"deleted on {ok}/{n}")

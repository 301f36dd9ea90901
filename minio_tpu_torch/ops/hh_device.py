"""Keyed HighwayHash-256 on the card, and the fused PUT/GET pipelines.

The bitrot layer protects every shard block with keyed HighwayHash-256
under the magic key (reference: cmd/bitrot.go:37, 105-110). Here:

  * `hash_rows` — HH-256 of every row of a uint8 [S, F] tensor (from a
    byte offset to the row's end). On a CUDA tensor it launches the
    hand-written kernel `csrc/highwayhash.cu` (which replaces
    minio_tpu/ops/hh_device.py's _hh_kernel_nt, _hh_kernel and the XLA
    ragged-remainder path: any length, natural layout, one kernel) in the
    shape `launch_shape` gives; on a CPU tensor it runs
    `hash_bytes_plain`. No other fallback.
  * `hash_words` / `hash_words_plain` — the u32 contract of
    minio_tpu.ops.hh_device._hash_words_pallas: words [S, W] or [B, X, W]
    (int32 storage, lane w = bytes 4w..4w+3 LE) -> digest words [S, 8].
  * `hash_blocks_device`, `framed_digests_device` — byte and framed-blob
    entry points for the codec and the bitrot layer.
  * `make_encode_framer` — PutObject's stripe window on the card: RS
    parity (ops/rs_device.gf_apply) plus the digest of every shard block,
    returned as per-drive (digest, block) pieces with the data blocks as
    zero-copy views of the caller's buffer.
  * `make_deframer` — GetObject's verify: framed [B, k, 32+S] -> ok [B, k].
  * `make_mesh_framer`, `make_mesh_deframer` — the same run() contracts
    for the stripe batcher's put and get routes (ops/batcher.py): a
    staged batch from many requests, copied to the card without blocking
    on the kernel lane's stream, on one card (`mesh_batch_devices`).

The plain version runs the packet recurrence of the reference algorithm
on int64 tensors holding 32-bit halves masked with 0xFFFFFFFF (PyTorch has
no full uint64 arithmetic, and `>>` on int64 is arithmetic).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.io.bufpool import LeasedRows, global_pool
from minio_tpu_torch.ops import _build, rs_device
from minio_tpu_torch.utils.highwayhash import MAGIC_KEY

# Kernel launches since the last reset (plain-version calls never count).
LAUNCHES = 0
_count_lock = threading.Lock()

DIGEST = 32
_M32 = 0xFFFFFFFF


def _count() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("highwayhash").mtt_hh256
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_uint64, ctypes.c_uint64,
                   ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
                   *[ctypes.c_int] * len(LaunchShape._fields),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Launch shape of csrc/highwayhash.cu (its C entry point checks it)
# ---------------------------------------------------------------------------

MAX_STREAMS_PER_BLOCK = 64
RING_STAGES = 4
STAGE_MAX = 4096            # bytes of one stream in one ring stage
SLOT_PAD = 32               # kSlotPad: bytes after each stream's ring slot
SMEM_MAX = 232448           # kMaxSmem: shared memory a block may use
_BARRIER_BYTES = 16         # a full and an empty mbarrier per stage


class LaunchShape(NamedTuple):
    """How `hash_rows` launches the kernel, in the C entry point's order."""
    streams_per_block: int
    blocks: int
    threads: int            # 2 per stream, in whole warps, + the producer
    stages: int             # ring slots; 0 = the byte-load path, no ring
    stage_bytes: int        # bytes of one stream in one stage
    smem_bytes: int         # dynamic shared memory: the ring + its barriers


def block_streams(block: int, streams: int, blocks: int) -> range:
    """The streams that `block` of a `blocks`-block launch hashes (the
    kernel's own split: floor(b * S / blocks) onward)."""
    return range(block * streams // blocks, (block + 1) * streams // blocks)


def launch_shape(streams: int, length: int, sm_count: int, base: int = 0,
                 stride: int = 0) -> LaunchShape:
    """Launch shape for `streams` streams of `length` bytes each, the
    first at address `base`, `stride` bytes apart, on a card of
    `sm_count` SMs.

    The streams are split evenly over max(min(S, SMs), ceil(S / 64))
    blocks, so every SM gets a block, no block has more than 64 streams
    and none is empty. Whole packets go through a ring of up to 4 stages
    in shared memory; a stage holds a power of two of bytes per stream
    (at most 4 KiB, less where 4 stages of the block's streams would not
    fit in a block's shared memory, and never more than the stream's
    whole packets). A base or stride that is not 16-byte aligned, or a
    stream without a whole packet, takes the byte path (stages 0)."""
    if streams < 1 or sm_count < 1 or length < 0:
        raise ValueError(f"launch_shape: {streams} streams of {length} "
                         f"bytes on {sm_count} SMs")
    blocks = max(min(streams, sm_count), -(-streams // MAX_STREAMS_PER_BLOCK))
    spb = -(-streams // blocks)
    threads = 32 * (-(-2 * spb // 32) + 1)
    body = length // 32 * 32
    aligned = base % 16 == 0 and (streams == 1 or stride % 16 == 0)
    if not aligned or body == 0:
        return LaunchShape(spb, blocks, threads, 0, 0, 0)
    fit = (SMEM_MAX - _BARRIER_BYTES * RING_STAGES) \
        // (RING_STAGES * spb) - SLOT_PAD
    stage = min(STAGE_MAX, 1 << (fit.bit_length() - 1), body)
    stages = min(RING_STAGES, -(-body // stage))
    smem = stages * spb * (stage + SLOT_PAD) + _BARRIER_BYTES * stages
    return LaunchShape(spb, blocks, threads, stages, stage, smem)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SM count (cudaDevAttrMultiProcessorCount), queried once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _key_lanes(key: bytes) -> list[int]:
    if len(key) != 32:
        raise ValueError("HighwayHash-256 requires a 32-byte key")
    return [int(x) for x in np.frombuffer(key, dtype="<u8")]


@functools.lru_cache(maxsize=16)
def init_state(key: bytes) -> np.ndarray:
    """Initial state as uint32 [8, 4]: row 2*var + (0 lo, 1 hi) for var in
    (v0, v1, mul0, mul1), column = HH lane. Same array as
    minio_tpu.ops.hh_device._init_smem_np (reshape (8, 2, 2) for
    _init_state_np)."""
    init0 = np.array([0xDBE6D5D5FE4CCE2F, 0xA4093822299F31D0,
                      0x13198A2E03707344, 0x243F6A8885A308D3], dtype=np.uint64)
    init1 = np.array([0x3BD39E10CB0EF593, 0xC0ACF169B5F18A8C,
                      0xBE5466CF34E90C6C, 0x452821E638D01377], dtype=np.uint64)
    k = np.array(_key_lanes(key), dtype=np.uint64)
    rot = (k >> np.uint64(32)) | (k << np.uint64(32))
    out = np.empty((8, 4), dtype=np.uint32)
    for i, v in enumerate((init0 ^ k, init1 ^ rot, init0, init1)):
        out[2 * i] = (v & np.uint64(_M32)).astype(np.uint32)
        out[2 * i + 1] = (v >> np.uint64(32)).astype(np.uint32)
    out.setflags(write=False)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version (32-bit halves in int64)
# ---------------------------------------------------------------------------
# A 64-bit lane is a (lo, hi) pair of int64 tensors [S, 4] holding values
# in [0, 2^32). Sums are masked after the carry is taken; 32x32 products
# are built from 16-bit limbs so no int64 intermediate overflows.

def _add(alo, ahi, blo, bhi):
    lo = alo + blo
    hi = ahi + bhi + (lo >> 32)
    return lo & _M32, hi & _M32


def _mul(a, b):
    """(lo, hi) of the 64-bit product of a, b < 2^32."""
    p1 = (a & 0xFFFF) * b                       # < 2^48
    p2 = (a >> 16) * b                          # < 2^48
    s = p1 + ((p2 & 0xFFFF) << 16)              # < 2^49
    return s & _M32, (s >> 32) + (p2 >> 16)     # hi < 2^32 exactly


def _zipper_index(device) -> torch.Tensor:
    """Byte gather for the zipper merge of both lane pairs, over a lane's
    bytes laid out [lane, byte] (8 bytes per lane, LSB first):
    even' = [e3, o4, e2, e5, o6, e1, o7, e0], odd' = [o3, e4, o2, o5, o1,
    e6, o0, e7] (utils/highwayhash.py _zipper_merge_add as a permutation)."""
    even = [("e", 3), ("o", 4), ("e", 2), ("e", 5), ("o", 6), ("e", 1),
            ("o", 7), ("e", 0)]
    odd = [("o", 3), ("e", 4), ("o", 2), ("o", 5), ("o", 1), ("e", 6),
           ("o", 0), ("e", 7)]
    idx = []
    for pair in range(2):
        base = {"e": 16 * pair, "o": 16 * pair + 8}
        idx += [base[w] + b for w, b in even] + [base[w] + b for w, b in odd]
    return torch.tensor(idx, dtype=torch.int64, device=device)


_BYTE_SHIFTS = (0, 8, 16, 24)
_PLAIN_CHUNK = 256          # packets widened to int64 at a time


class _PlainState:
    """HighwayHash state of S streams as (lo, hi) int64 tensors [S, 4]."""

    def __init__(self, key: bytes, streams: int, device):
        init = torch.from_numpy(init_state(key).astype(np.int64)).to(device)
        rows = [init[i].expand(streams, 4).clone() for i in range(8)]
        (self.v0l, self.v0h, self.v1l, self.v1h,
         self.m0l, self.m0h, self.m1l, self.m1h) = rows
        self.zidx = _zipper_index(device)
        self.shifts = torch.tensor(_BYTE_SHIFTS, dtype=torch.int64,
                                   device=device)

    def _zipper(self, lo, hi):
        s = lo.shape[0]
        w = torch.stack((lo, hi), dim=-1)                     # [S, 4, 2]
        b = (w[..., None] >> self.shifts) & 0xFF              # [S, 4, 2, 4]
        z = b.reshape(s, 32).index_select(1, self.zidx)
        z = (z.view(s, 4, 2, 4) << self.shifts).sum(-1)       # [S, 4, 2]
        return z[..., 0], z[..., 1]

    def update(self, plo, phi):
        """One 32-byte packet per stream: lanes as (lo, hi) [S, 4]."""
        v1l = self.v1l + self.m0l + plo
        v1h = self.v1h + self.m0h + phi + (v1l >> 32)
        v1l, v1h = v1l & _M32, v1h & _M32
        xlo, xhi = _mul(v1l, self.v0h)
        m0l, m0h = self.m0l ^ xlo, self.m0h ^ xhi
        v0l, v0h = _add(self.v0l, self.v0h, self.m1l, self.m1h)
        ylo, yhi = _mul(v0l, v1h)
        m1l, m1h = self.m1l ^ ylo, self.m1h ^ yhi
        zlo, zhi = self._zipper(v1l, v1h)
        v0l, v0h = _add(v0l, v0h, zlo, zhi)
        zlo, zhi = self._zipper(v0l, v0h)
        v1l, v1h = _add(v1l, v1h, zlo, zhi)
        (self.v0l, self.v0h, self.v1l, self.v1h,
         self.m0l, self.m0h, self.m1l, self.m1h) = \
            (v0l, v0h, v1l, v1h, m0l, m0h, m1l, m1h)

    def remainder(self, tail: torch.Tensor, mod: int) -> None:
        """Final partial packet: tail uint8 [S, mod], 0 < mod < 32."""
        s = tail.shape[0]
        mod4, rem = mod & 3, mod & ~3
        self.v0l, self.v0h = _add(self.v0l, self.v0h, mod, mod)
        self.v1l = ((self.v1l << mod) | (self.v1l >> (32 - mod))) & _M32
        self.v1h = ((self.v1h << mod) | (self.v1h >> (32 - mod))) & _M32
        packet = torch.zeros((s, 32), dtype=torch.int64, device=tail.device)
        t = tail.long()
        packet[:, :rem] = t[:, :rem]
        if mod & 16:
            for i in range(4):
                packet[:, 28 + i] = t[:, rem + i + mod4 - 4]
        elif mod4:
            packet[:, 16] = t[:, rem]
            packet[:, 17] = t[:, rem + (mod4 >> 1)]
            packet[:, 18] = t[:, rem + mod4 - 1]
        words = (packet.view(s, 8, 4) << self.shifts).sum(-1)  # [S, 8]
        self.update(words[:, 0::2], words[:, 1::2])

    def finalize(self) -> torch.Tensor:
        """10 permute rounds + modular reduction -> uint8 [S, 32]."""
        for _ in range(10):
            # permuted lane i = rot32(v0 lane (i + 2) % 4): swap halves
            self.update(self.v0h[:, [2, 3, 0, 1]], self.v0l[:, [2, 3, 0, 1]])
        words = []
        for e, o in ((0, 1), (2, 3)):
            a3l, a3h = _add(self.v1l[:, o], self.v1h[:, o],
                            self.m1l[:, o], self.m1h[:, o])
            a2l, a2h = _add(self.v1l[:, e], self.v1h[:, e],
                            self.m1l[:, e], self.m1h[:, e])
            a1l, a1h = _add(self.v0l[:, o], self.v0h[:, o],
                            self.m0l[:, o], self.m0h[:, o])
            a0l, a0h = _add(self.v0l[:, e], self.v0h[:, e],
                            self.m0l[:, e], self.m0h[:, e])
            a3h = a3h & 0x3FFFFFFF                      # a3 &= 2^62 - 1
            # odd = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62))
            s1l = ((a3l << 1) & _M32) | (a2h >> 31)
            s1h = ((a3h << 1) | (a3l >> 31)) & _M32
            s2l = ((a3l << 2) & _M32) | (a2h >> 30)
            s2h = ((a3h << 2) | (a3l >> 30)) & _M32
            # even = a0 ^ (a2 << 1) ^ (a2 << 2)
            t1l, t1h = (a2l << 1) & _M32, ((a2h << 1) | (a2l >> 31)) & _M32
            t2l, t2h = (a2l << 2) & _M32, ((a2h << 2) | (a2l >> 30)) & _M32
            words += [a0l ^ t1l ^ t2l, a0h ^ t1h ^ t2h,
                      a1l ^ s1l ^ s2l, a1h ^ s1h ^ s2h]
        w = torch.stack(words, dim=1)                        # [S, 8]
        b = (w[..., None] >> self.shifts) & 0xFF             # [S, 8, 4]
        return b.reshape(w.shape[0], 32).to(torch.uint8)


@torch.inference_mode()
def hash_bytes_plain(blocks: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """The plain PyTorch version: HH-256 of each row of uint8 [S, L] (any
    L) -> uint8 [S, 32] on the same device."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError("hash_bytes_plain: need uint8 [S, L]")
    s, length = blocks.shape
    st = _PlainState(key, s, blocks.device)
    n_packets = length // 32
    for p0 in range(0, n_packets, _PLAIN_CHUNK):
        p1 = min(n_packets, p0 + _PLAIN_CHUNK)
        # Little-endian u32 words of packets [p0, p1), widened to int64.
        # Flattened first: a one-row slice counts as contiguous whatever
        # its row stride, which the dtype view would refuse.
        w = blocks[:, p0 * 32:p1 * 32].contiguous().reshape(-1) \
            .view(torch.int32).long().view(s, -1) & _M32  # [S, 8 * (p1 - p0)]
        lanes = w.view(s, p1 - p0, 4, 2).permute(1, 3, 0, 2) \
            .contiguous()                                # [P, lo/hi, S, 4]
        for p in range(p1 - p0):
            st.update(lanes[p, 0], lanes[p, 1])
    if length % 32:
        st.remainder(blocks[:, n_packets * 32:], length % 32)
    return st.finalize()


def hash_words_plain(words: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """Plain version of the u32 contract: int32 words [S, W] or [B, X, W]
    -> digest words int32 [S, 8]."""
    w = _words_2d(words)
    return hash_bytes_plain(w.view(torch.uint8), key).view(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _words_2d(words: torch.Tensor) -> torch.Tensor:
    if words.dtype != torch.int32 or words.dim() not in (2, 3):
        raise ValueError("need int32 words [S, W] or [B, X, W]")
    return words.reshape(-1, words.shape[-1])


def hash_rows(rows: torch.Tensor, skip: int = 0,
              key: bytes = MAGIC_KEY) -> torch.Tensor:
    """HH-256 of rows[i, skip:] for every row of a uint8 [S, F] tensor
    whose rows are each contiguous (rows may be strided, e.g. the block
    payloads of framed `digest || block` rows with skip=32). Returns
    uint8 [S, 32] on rows' device: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("hash_rows: need uint8 [S, F]")
    s, f = rows.shape
    if not 0 <= skip <= f:
        raise ValueError(f"hash_rows: skip {skip} outside row of {f}")
    if f > 1 and rows.stride(1) != 1:
        raise ValueError("hash_rows: rows must be contiguous")
    if rows.device.type == "cpu":
        return hash_bytes_plain(rows[:, skip:], key)
    if rows.device.type != "cuda":
        raise ValueError(f"hash_rows: unsupported device {rows.device}")
    out = torch.empty((s, DIGEST), dtype=torch.uint8, device=rows.device)
    if s == 0:
        return out
    stride = rows.stride(0) if s > 1 else f
    base = rows.data_ptr() + skip
    shape = launch_shape(s, f - skip, sm_count(rows.device), base, stride)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = _kernel()(base, s, stride, f - skip, *_key_lanes(key),
                   out.data_ptr(), *shape, stream)
    _build.check(rc, "highwayhash256 launch")
    _count()
    return out


def hash_words(words: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """int32 words [S, W] or [B, X, W] -> digest words int32 [S, 8]: the
    port of minio_tpu.ops.hh_device._hash_words_pallas (any W)."""
    w = _words_2d(words)
    return hash_rows(w.view(torch.uint8), key=key).view(torch.int32)


def hash_blocks_device(key: bytes, blocks, device=None):
    """Keyed HH-256 of S equal-length blocks, any length.

    blocks: a uint8 [S, L] tensor (hashed on its own device, tensor
    returned) or numpy array (hashed on `device`, default the card,
    numpy uint8 [S, 32] returned)."""
    if isinstance(blocks, torch.Tensor):
        return hash_rows(blocks, key=key)
    dev = device_mod.resolve(device)
    t = rs_device.host_tensor(np.ascontiguousarray(blocks, dtype=np.uint8))
    return rs_device.to_host(hash_rows(t.to(dev), key=key))


def framed_digests_device(blobs: list[np.ndarray], device=None) -> np.ndarray:
    """Digests of every framed block across same-width shard blobs.

    blobs: arrays [nb_i, F] (uint8, or uint32 words as the TPU package
    passes them), each row one on-disk frame `digest || block`
    (reference cmd/bitrot-streaming.go:44-75). Returns uint8
    [sum(nb_i), 32] recomputed digests of the block payloads, hashed on
    `device` in one kernel launch."""
    dev = device_mod.resolve(device)
    u8 = [np.ascontiguousarray(b).view(np.uint8) for b in blobs]
    width = u8[0].shape[1]
    if any(b.ndim != 2 or b.shape[1] != width for b in u8):
        raise ValueError("framed_digests_device: blobs must share a frame width")
    total = sum(b.shape[0] for b in u8)
    frames = torch.empty((total, width), dtype=torch.uint8, device=dev)
    off = 0
    for b in u8:
        frames[off:off + b.shape[0]].copy_(rs_device.host_tensor(b))
        off += b.shape[0]
    return rs_device.to_host(hash_rows(frames, skip=DIGEST))


# ---------------------------------------------------------------------------
# Fused encode + bitrot digests (PutObject)
# ---------------------------------------------------------------------------

def make_encode_framer(matrix: np.ndarray, device=None):
    """PutObject's stripe window on the card.

    Returns run(data uint8 numpy [B, k, L]) -> n = k + m per-drive lists
    (a bufpool.LeasedRows); entry i is [(digest32, block), ...] per
    erasure block, whose concatenation is drive-slot i's framed
    shard-file bytes. Data-block pieces are views of `data` (zero copy);
    only parity and digests come back from the device, into leases of
    the device's pool that the rows hold (the caller releases each of
    rows.leases once the pieces are written). run.device_step(int32 words [B, k, L4] on the
    device) -> (parity words [B, m, L4], data digests [B, k, 8], parity
    digests [B, m, 8]) is the device part alone, for timing."""
    matrix = rs_device._as_matrix(matrix)
    m, k = matrix.shape
    n = k + m
    dev = device_mod.resolve(device)
    pool = global_pool(dev)

    def frame_on_device(stripes: torch.Tensor):
        """stripes uint8 [B, k, L] on dev -> (shards [B, n, L], digests
        [B, n, 32]): one GF launch writing the parity slots, one hash
        launch over all B*n shard blocks."""
        b, _, length = stripes.shape
        shards = torch.empty((b, n, length), dtype=torch.uint8, device=dev)
        shards[:, :k].copy_(stripes)
        rs_device.gf_apply(matrix, shards[:, :k], out=shards[:, k:])
        digs = hash_rows(shards.view(b * n, length)).view(b, n, DIGEST)
        return shards, digs

    def run(data: np.ndarray) -> LeasedRows:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        b, kk, _ = data.shape
        if kk != k:
            raise ValueError(f"framer for k={k} got {kk} data shards")
        # Non-blocking: from pinned staging a DMA queued on the current
        # stream; the copies back below wait for it before run() returns.
        shards, digs = frame_on_device(
            rs_device.host_tensor(data).to(dev, non_blocking=True))
        # Parity and digests come back into pooled (pinned) leases,
        # which the rows hold until the drive writers release them.
        leases, (parity, digs) = rs_device.to_host_lease(
            pool, shards[:, k:], digs)
        blocks = [data[:, i] for i in range(k)] \
            + [parity[:, j] for j in range(m)]
        return LeasedRows([[(digs[bi, i], blocks[i][bi]) for bi in range(b)]
                           for i in range(n)], leases)

    def device_step(words: torch.Tensor):
        shards, digs = frame_on_device(words.view(torch.uint8))
        digs = digs.view(torch.int32)
        return (shards[:, k:].view(torch.int32), digs[:, :k], digs[:, k:])

    run.device_step = device_step
    return run


# ---------------------------------------------------------------------------
# Fused GET verify (GetObject)
# ---------------------------------------------------------------------------

def make_deframer(k: int, device=None):
    """GetObject's verify on the card for k-data-shard stripes.

    Returns run(framed uint8 numpy [B, k, F]) -> ok bool numpy [B, k],
    F = 32 + shard block size, row b holding erasure block b's k on-disk
    frames; ok[b, i] is True when shard i's block b digest verifies. The
    payload itself never comes back from the device: callers serve it
    from their own framed bytes."""
    dev = device_mod.resolve(device)

    def run(framed: np.ndarray) -> np.ndarray:
        framed = np.ascontiguousarray(framed, dtype=np.uint8)
        b, kk, f = framed.shape
        if kk != k:
            raise ValueError(f"deframer for k={k} got {kk} shards")
        rows = rs_device.host_tensor(framed).to(dev, non_blocking=True) \
            .view(b * kk, f)
        digs = hash_rows(rows, skip=DIGEST)
        ok = (digs == rows[:, :DIGEST]).all(dim=1).view(b, kk)
        return rs_device.to_host(ok)
    return run


# ---------------------------------------------------------------------------
# Cross-request pipelines (the stripe batcher's device functions)
# ---------------------------------------------------------------------------

def mesh_batch_devices(device=None) -> list[torch.device]:
    """The devices one batched dispatch spreads its batch over: one card
    (or the CPU). Sharding the batch over several cards, as the JAX
    package's mesh does over its chips, is still to be ported."""
    return [device_mod.resolve(device)]


def make_mesh_framer(matrix: np.ndarray, device=None):
    """The put batcher's device function: make_encode_framer's run()
    contract (stacked uint8 [B, k, L] -> k+m per-drive lists of
    (digest, block) pieces) for a batch of stripes from many concurrent
    PutObject windows, run on the kernel lane's stream. The batch is the
    batcher's pinned staging buffer, copied to the card without blocking;
    the data-block pieces it returns are views of that buffer, which the
    batcher re-points to each member's own window before the buffer goes
    back to the pool."""
    dev = device_mod.resolve(device)
    frame = make_encode_framer(matrix, device=dev)

    def run(data: np.ndarray) -> list[list[tuple]]:
        with device_mod.lane_stream(dev):
            return frame(data)

    run.mesh_devices = len(mesh_batch_devices(dev))
    return run


def make_mesh_deframer(k: int, device=None):
    """The get batcher's device function: make_deframer's run() contract
    (framed uint8 [B, k, F] -> ok bool [B, k]) for a batch of framed
    blocks from many concurrent GetObject windows, run on the kernel
    lane's stream. Only the B*k verdicts come back from the card."""
    dev = device_mod.resolve(device)
    verify = make_deframer(k, device=dev)

    def run(framed: np.ndarray) -> np.ndarray:
        with device_mod.lane_stream(dev):
            return verify(framed)

    run.mesh_devices = len(mesh_batch_devices(dev))
    return run

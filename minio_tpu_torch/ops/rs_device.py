"""GF(2^8) matrix apply on the card: the Reed-Solomon transform.

`gf_apply(matrix, data)` computes out[b, j, t] = XOR_i M[j, i] * data[b, i, t]
over GF(2^8) for any r x k matrix: parity rows for PutObject's encode,
decode-matrix rows for a degraded GetObject's reconstruct. On a CUDA
tensor it launches the hand-written kernel `csrc/gf_apply.cu` (which
replaces minio_tpu/ops/rs_device.py's _rs_kernel32 and _rs_kernel) on the
row-packed tables of `packed_tables` (one word holds four output rows'
products of one input byte); on a
CPU tensor it runs `gf_apply_plain`, the same function as a table gather
in PyTorch. There is no other fallback: a CUDA tensor gets the kernel or
an exception.

Two contracts, as in minio_tpu/ops/rs_device.py:
  * bytes (`make_encoder`): uint8 [B, k, L] -> uint8 [B, r, L];
  * u32 lanes (`make_encoder32`): int32 storage [B, k, L4] -> [B, r, L4],
    lane t holding shard bytes 4t..4t+3 little-endian. A contiguous word
    tensor viewed as bytes IS the byte layout, so both contracts run the
    one byte kernel.

`GpuBackend` is the codec's ECBackend on the card: numpy in, numpy out.
`make_mesh_matrix` is the reconstruct batcher's device function: a staged
batch of survivor stripes through `gf_apply` on the kernel lane's stream.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.ops import _build, gf256

# Kernel launches since the last reset (plain-version calls never count),
# in all and by the number of matrix rows r (r = 1: the rebuild of one
# lost shard, as a replaced drive's bulk heal launches it).
LAUNCHES = 0
LAUNCHES_BY_R: dict[int, int] = {}
_count_lock = threading.Lock()

_MAX_BATCH = 65535          # grid.y limit of the kernel launch


def _count(r: int) -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
        LAUNCHES_BY_R[r] = LAUNCHES_BY_R.get(r, 0) + 1


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("gf_apply").mtt_gf_apply
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _as_matrix(matrix) -> np.ndarray:
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if m.ndim != 2 or 0 in m.shape:
        raise ValueError(f"GF matrix must be a non-empty 2-D array, got {m.shape}")
    return m


def device_constant(a: np.ndarray, device: str) -> torch.Tensor:
    """A fixed kernel operand on `device`, complete before it returns:
    the upload is synchronised, so a kernel on any stream (the kernel
    lane's or a request thread's) may read it at once."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()
    return t


@functools.lru_cache(maxsize=256)
def _tables_cached(key: bytes, r: int, k: int, device: str) -> torch.Tensor:
    """Product-table rows [r, k, 256]: row (j, i) = MUL[M[j, i]][x]."""
    m = np.frombuffer(key, dtype=np.uint8).reshape(r, k)
    return device_constant(gf256.MUL_TABLE[m], device)


def product_tables(matrix, device) -> torch.Tensor:
    m = _as_matrix(matrix)
    return _tables_cached(m.tobytes(), m.shape[0], m.shape[1], str(device))


ROWS_PER_WORD = 4           # output rows packed into one table word


@functools.lru_cache(maxsize=256)
def _packed_cached(key: bytes, r: int, k: int, device: str) -> torch.Tensor:
    m = np.frombuffer(key, dtype=np.uint8).reshape(r, k)
    groups = -(-r // ROWS_PER_WORD)
    rows = np.zeros((groups * ROWS_PER_WORD, k, 256), dtype=np.uint8)
    rows[:r] = gf256.MUL_TABLE[m]
    words = np.ascontiguousarray(
        rows.reshape(groups, ROWS_PER_WORD, k, 256).transpose(0, 2, 3, 1))
    return device_constant(words.view("<i4")[..., 0], device)


def packed_tables(matrix, device) -> torch.Tensor:
    """The kernel's operand: row-packed product tables, int32 storage
    [ceil(r/4), k, 256]. Byte jj (little-endian) of word [g, i, x] is
    MUL[M[4g + jj, i]][x], 0 for rows past r: one lookup gives the
    products of four output rows."""
    m = _as_matrix(matrix)
    return _packed_cached(m.tobytes(), m.shape[0], m.shape[1], str(device))


def _check_stripes(data: torch.Tensor, k: int, what: str) -> None:
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError(f"{what}: need uint8 [B, {k}, L], got "
                         f"{data.dtype} {tuple(data.shape)}")
    if data.shape[1] != k:
        raise ValueError(f"{what}: matrix has {k} columns, data "
                         f"{data.shape[1]} shards")
    if data.shape[2] and (data.stride(2) != 1
                          or (data.shape[1] > 1
                              and data.stride(1) != data.shape[2])):
        raise ValueError(f"{what}: shard rows must be contiguous and "
                         f"L bytes apart")


def gf_apply_plain(matrix, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a uint8 table gather per (row, shard)."""
    m = _as_matrix(matrix)
    r, k = m.shape
    _check_stripes(data, k, "gf_apply_plain")
    b, _, length = data.shape
    tab = product_tables(m, data.device)
    out = torch.zeros((b, r, length), dtype=torch.uint8, device=data.device)
    for i in range(k):
        idx = data[:, i].long()
        for j in range(r):
            out[:, j] ^= tab[j, i][idx]
    return out


def gf_apply(matrix, data: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """out[b, j, t] = XOR_i M[j, i] * data[b, i, t]: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor.

    data: uint8 [B, k, L] whose shard rows are contiguous and L bytes
    apart (stripes may be strided). out: optional [B, r, L] destination
    with the same row layout, e.g. the parity slots of a [B, k+m, L]
    shard buffer."""
    m = _as_matrix(matrix)
    r, k = m.shape
    _check_stripes(data, k, "gf_apply")
    b, _, length = data.shape
    if out is None:
        out = torch.empty((b, r, length), dtype=torch.uint8,
                          device=data.device)
    else:
        if out.device != data.device or tuple(out.shape) != (b, r, length):
            raise ValueError(f"gf_apply: out must be uint8 {(b, r, length)} "
                             f"on {data.device}")
        _check_stripes(out, r, "gf_apply out")
    if data.device.type == "cpu":
        out.copy_(gf_apply_plain(m, data))
        return out
    if data.device.type != "cuda":
        raise ValueError(f"gf_apply: unsupported device {data.device}")
    if b > _MAX_BATCH:
        raise ValueError(f"gf_apply: batch {b} exceeds {_MAX_BATCH}")
    if b == 0 or length == 0:
        return out
    tab = packed_tables(m, data.device)
    vec = all(x % 16 == 0 for x in (data.data_ptr(), out.data_ptr(), length,
                                    data.stride(0), out.stride(0)))
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = _kernel()(tab.data_ptr(), r, k, data.data_ptr(), data.stride(0),
                   out.data_ptr(), out.stride(0), b, length, int(vec),
                   stream)
    _build.check(rc, "gf_apply launch")
    _count(r)
    return out


def make_encoder(matrix):
    """fn(data uint8 [B, k, L]) -> uint8 [B, r, L] on data's device."""
    m = _as_matrix(matrix)
    return lambda data: gf_apply(m, data)


def make_encoder32(matrix):
    """u32-lane encoder: fn(int32 words [B, k, L4]) -> int32 [B, r, L4].

    Lane t of shard i holds bytes 4t..4t+3 little-endian, so the words
    viewed as bytes are the byte contract's [B, k, 4*L4] stripes and the
    output views back to words: bitcast-equal to the byte path."""
    m = _as_matrix(matrix)

    def run(words: torch.Tensor) -> torch.Tensor:
        if words.dtype != torch.int32 or not words.is_contiguous():
            raise ValueError("make_encoder32: need contiguous int32 words")
        return gf_apply(m, words.view(torch.uint8)).view(torch.int32)
    return run


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing a numpy array's memory (read-only arrays
    included: the port never writes through it)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        # torch warns on non-writable arrays; the tensor is only read.
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(a)
    return torch.from_numpy(a)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor's values as a numpy array. From the card the copy
    lands in pinned host memory (torch's caching host allocator, freed
    with the array), so it is one DMA; on the CPU it is the tensor's own
    memory."""
    if t.device.type != "cuda":
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def to_host_lease(pool, *tensors: torch.Tensor):
    """Copy uint8 device tensors into leases of `pool` (pinned for a pool
    of the card), one lease each so that each takes the size class that
    fits it: ([leases], [numpy views of them, one per tensor]). The
    views are valid while the leases are held. Each copy is one
    synchronous DMA: a single call that gives up the interpreter lock
    once, which matters on the kernel lane's thread under many request
    threads."""
    leases, outs = [], []
    try:
        for t in tensors:
            leases.append(pool.lease(t.numel()))
            dst = leases[-1].tensor[:t.numel()].view(t.shape)
            dst.copy_(t)
            outs.append(dst.numpy())
    except BaseException:
        for lease in leases:
            lease.release()
        raise
    return leases, outs


def make_mesh_matrix(matrix, device=None):
    """Batched GF(2^8) matrix application for the reconstruct batcher:
    run(stacked uint8 numpy [B, k, L]) -> numpy [B, r, L] through
    `gf_apply` on `device`. The batch (a staged, pinned buffer behind the
    batcher) goes to the card with a non-blocking copy on the kernel
    lane's stream; the copy of the result back synchronises that stream,
    so the staging buffer is free again when run() returns."""
    from minio_tpu_torch.ops.hh_device import mesh_batch_devices
    m = _as_matrix(matrix)
    dev = device_mod.resolve(device)

    def run(stacked: np.ndarray) -> np.ndarray:
        stacked = np.ascontiguousarray(stacked, dtype=np.uint8)
        with device_mod.lane_stream(dev):
            data = host_tensor(stacked).to(dev, non_blocking=True)
            return to_host(gf_apply(m, data))

    run.mesh_devices = len(mesh_batch_devices(dev))
    return run


def mesh_info(device=None) -> dict:
    """Device summary for stats surfaces: the backend, the devices torch
    sees, and how many of them a batched dispatch spreads over."""
    from minio_tpu_torch.ops.hh_device import mesh_batch_devices
    dev = device_mod.resolve(device)
    return {"backend": dev.type,
            "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "mesh_devices": len(mesh_batch_devices(dev))}


class GpuBackend:
    """ECBackend on the card (minio_tpu_torch/erasure/codec.py): numpy in,
    numpy out, every product through `gf_apply` on `device`."""

    def __init__(self, device=None):
        self.device = device_mod.resolve(device)

    def apply_matrix(self, matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        m = _as_matrix(matrix)
        if shards.shape[1] == 0:
            return np.zeros((m.shape[0], 0), dtype=np.uint8)
        data = host_tensor(shards).to(self.device)[None]
        return to_host(gf_apply(m, data)[0])

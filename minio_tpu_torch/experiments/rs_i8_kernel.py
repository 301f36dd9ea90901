"""GF(2^8) apply as a GF(2) bit-matrix product on the tensor cores.

The port of experiments/rs_i8_kernel.py (rs_apply8 / _rs_kernel8): the
Reed-Solomon transform out[b, j, t] = XOR_i M[j, i] * data[b, i, t] as
bits(out) = bit_matrix(M) @ bits(data) mod 2, an int8 product with int32
accumulation, then the bits packed back into bytes. On a CUDA tensor
`rs_apply8` launches the hand-written kernel `ops/csrc/rs_i8.cu`
(mma.sync m16n8k32, s8 operands, s32 accumulation); on a CPU tensor it
runs `rs_apply8_plain`. Its output is byte-identical to
ops/rs_device.make_encoder32 and gf_apply.

Like the JAX experiment, this is off the server's path: the stripe
batcher's routes use gf_apply. Its entry point checks the kernel against
the u32 encoder and times both at the cross-request batcher's largest
bucket, 256 blocks of EC 8+4 (B = 256, k = 8, L4 = 32768 words):

    python -m minio_tpu_torch.experiments.rs_i8_kernel      (needs a card)

Two contracts, as rs_device has: bytes, uint8 [B, k, L] -> [B, r, L]; and
u32 lanes, int32 storage [B, k, L4] -> [B, r, L4] with lane t holding
shard bytes 4t..4t+3 little-endian, which viewed as bytes is the byte
contract.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import threading

import numpy as np
import torch

from minio_tpu_torch.ops import _build, gf256, rs_device

# Kernel launches since the last reset (plain-version calls never count).
LAUNCHES = 0
_count_lock = threading.Lock()

MAX_K = 16                  # the kernel keeps ceil(k/4) <= 4 k-tiles
MAX_R = 32                  # and ceil(r/2) m-tiles of A in shared memory


def _count() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1


@functools.lru_cache(maxsize=1)
def _kernel():
    fn = _build.load("rs_i8").mtt_rs_i8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def a_fragments(matrix) -> np.ndarray:
    """The [8r, 8k] bit matrix laid out as mma.m16n8k32 A fragments:
    int32 [ceil(r/2), ceil(k/4), 32 lanes, 4 registers], zero padded to
    whole 16 x 32 tiles. Lane (g = lane >> 2, tig = lane & 3) holds rows
    g and g+8 of the tile at columns tig*4..+3 (registers 0, 1) and
    16+tig*4..+3 (registers 2, 3), one int8 per byte, little-endian."""
    m = rs_device._as_matrix(matrix)
    r, k = m.shape
    mt, kt = (r + 1) // 2, (k + 3) // 4
    a = np.zeros((mt * 16, kt * 32), dtype=np.uint8)
    a[:8 * r, :8 * k] = gf256.bit_matrix(m)
    tiles = a.reshape(mt, 16, kt, 32).transpose(0, 2, 1, 3)   # [MT, KT, 16, 32]
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    frag = np.empty((mt, kt, 32, 4, 4), dtype=np.uint8)
    for reg, (row0, col0) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        rows = (g + row0)[:, None]                            # [32, 1]
        cols = col0 + tig[:, None] * 4 + np.arange(4)         # [32, 4]
        frag[:, :, :, reg, :] = tiles[:, :, rows, cols]
    return np.ascontiguousarray(frag).reshape(mt, kt, 32, 16).view(np.int32)


@functools.lru_cache(maxsize=256)
def _fragments_cached(key: bytes, r: int, k: int, device: str) -> torch.Tensor:
    m = np.frombuffer(key, dtype=np.uint8).reshape(r, k)
    return rs_device.device_constant(a_fragments(m), device)


def _bytes_view(data: torch.Tensor) -> torch.Tensor:
    if data.dtype == torch.int32:
        if not data.is_contiguous():
            raise ValueError("rs_apply8: int32 words must be contiguous")
        return data.view(torch.uint8)
    return data


def rs_apply8_plain(matrix, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the same bit-matrix algebra, on data's
    device: unpack every byte to 8 bit planes, one float32 matrix product
    with the bit matrix (sums of at most 8k ones are exact in float32),
    keep the low bit, and a second float32 product with the byte-repack
    weights 2^c (sums <= 255, exact). uint8 [B, k, L] -> uint8 [B, r, L],
    or int32 words [B, k, L4] -> int32 [B, r, L4]."""
    m = rs_device._as_matrix(matrix)
    r, k = m.shape
    x = _bytes_view(data)
    rs_device._check_stripes(x, k, "rs_apply8_plain")
    b, _, length = x.shape
    dev = x.device
    bm = torch.from_numpy(gf256.bit_matrix(m).astype(np.float32)).to(dev)
    # Repack weights for rows j*8 + c (byte-major): out[j] = sum_c 2^c bit.
    wrep = np.zeros((r, 8 * r), dtype=np.float32)
    for j in range(r):
        wrep[j, 8 * j:8 * j + 8] = 2.0 ** np.arange(8)
    wrep = torch.from_numpy(wrep).to(dev)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((x[:, :, None, :] >> shifts[None, None, :, None]) & 1) \
        .to(torch.float32).reshape(b, 8 * k, length)     # row i*8 + bit
    # Full float32 products: TF32 is exact for these 0/1 and 2^c operands
    # too, but the reference states its precision instead of inheriting
    # whatever a caller set.
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.matmul(bm, bits)                      # [B, 8r, L]
        planes = (acc.to(torch.int32) & 1).to(torch.float32)
        out = torch.matmul(wrep, planes).to(torch.uint8)  # [B, r, L]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.view(torch.int32) if data.dtype == torch.int32 else out


def rs_apply8(matrix, data: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """out[b, j, t] = XOR_i M[j, i] * data[b, i, t]: the tensor-core kernel
    on a CUDA tensor, the plain version on a CPU tensor.

    data: uint8 [B, k, L] whose shard rows are contiguous and L bytes
    apart, or contiguous int32 words [B, k, L4] (the u32 contract). out:
    optional destination of the same dtype and layout, [B, r, L] or
    [B, r, L4]."""
    m = rs_device._as_matrix(matrix)
    r, k = m.shape
    x = _bytes_view(data)
    rs_device._check_stripes(x, k, "rs_apply8")
    b, _, length = x.shape
    if out is None:
        out = torch.empty((b, r, length), dtype=torch.uint8, device=x.device)
        if data.dtype == torch.int32:
            out = out.view(torch.int32)
    if out.dtype != data.dtype or out.device != data.device:
        raise ValueError("rs_apply8: out must match data's dtype and device")
    o = _bytes_view(out)
    if tuple(o.shape) != (b, r, length):
        raise ValueError(f"rs_apply8: out must be {(b, r, length)} bytes")
    rs_device._check_stripes(o, r, "rs_apply8 out")
    if x.device.type == "cpu":
        o.copy_(_bytes_view(rs_apply8_plain(m, x)))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"rs_apply8: unsupported device {x.device}")
    if k > MAX_K or r > MAX_R:
        raise ValueError(f"rs_apply8: the kernel takes k <= {MAX_K} and "
                         f"r <= {MAX_R}, got {r} x {k}")
    if b > 65535:
        raise ValueError(f"rs_apply8: batch {b} exceeds 65535")
    if b == 0 or length == 0:
        return out
    frags = _fragments_cached(m.tobytes(), r, k, str(x.device))
    vec = all(v % 16 == 0 for v in (x.data_ptr(), o.data_ptr(), length,
                                    x.stride(0), o.stride(0)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(frags.data_ptr(), r, k, x.data_ptr(), x.stride(0),
                   o.data_ptr(), o.stride(0), b, length, int(vec), stream)
    _build.check(rc, "rs_i8 launch")
    _count()
    return out


def make_encoder8(matrix):
    """u32-lane encoder on the tensor cores: fn(int32 words [B, k, L4]) ->
    int32 [B, r, L4], byte-identical to rs_device.make_encoder32."""
    m = rs_device._as_matrix(matrix)

    def run(words: torch.Tensor) -> torch.Tensor:
        if words.dtype != torch.int32:
            raise ValueError("make_encoder8: need contiguous int32 words")
        return rs_apply8(m, words)
    return run


def main(argv=None) -> int:
    """Check the kernel against make_encoder32 on 4 windows, then time both
    at [256, 8, 32768] words (CUDA events, inputs rotated over buffers
    larger than L2)."""
    if not torch.cuda.is_available():
        print("rs_i8_kernel: needs a CUDA device", file=sys.stderr)
        return 2
    k, m, batch, l4 = 8, 4, 256, (1 << 20) // 8 // 4
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    pm = gf256.parity_matrix(k, m)
    bufs = [torch.from_numpy(rng.integers(0, 2 ** 31, size=(batch, k, l4),
                                          dtype=np.int32)).to(dev)
            for _ in range(2)]                       # 2 x 256 MiB
    enc32, enc8 = rs_device.make_encoder32(pm), make_encoder8(pm)
    want, got = enc32(bufs[0][:4]), enc8(bufs[0][:4])
    torch.cuda.synchronize()
    if not torch.equal(want, got):
        print("rs_i8_kernel: differs from make_encoder32", file=sys.stderr)
        return 1
    print("correctness OK")
    nbytes = batch * k * l4 * 4

    def timed(fn, iters=20) -> float:
        for i in range(2):
            fn(bufs[i % 2])
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(iters):
            fn(bufs[i % 2])
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters / 1e3

    for name, fn in (("u32 kernel (gf_apply)", enc32),
                     ("i8 tensor-core kernel (rs_i8)", enc8)):
        t = timed(fn)
        print(f"{name}: {t * 1e3:.4f} ms  {nbytes / t / 2 ** 30:.1f} GiB/s "
              f"of data in ({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

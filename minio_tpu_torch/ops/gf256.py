"""GF(2^8) arithmetic and Reed-Solomon matrix construction.

Field: GF(2^8) with the reducing polynomial x^8+x^4+x^3+x^2+1 (0x11D),
generator element 2 — the same field the reference's erasure codec uses
(reference: cmd/erasure-coding.go:63 dispatching to klauspost/reedsolomon,
which ports Backblaze's JavaReedSolomon Galois tables). The encoding matrix
is the classic systematic Vandermonde construction: build V[r][c] = r^c over
GF(2^8) for r in [0, n), invert the top k x k block, and right-multiply so
the first k rows become the identity. Parity rows are then a pure GF matmul
against the data shards. Reproducing this construction exactly is what makes
our shards byte-identical to the reference's (validated by the golden
xxhash64 digests from cmd/erasure-coding.go:163).

Everything here is host-side (numpy) table math: building the (tiny) coding
matrices, inverting sub-matrices for reconstruct, and the 256x256
multiplication table whose rows the CUDA GF kernel stages in shared memory
(minio_tpu_torch/ops/rs_device.py), and the GF(2) bit-matrix expansion
that the tensor-core kernel of minio_tpu_torch/experiments/rs_i8_kernel.py
multiplies by. A copy of minio_tpu/ops/gf256.py.
"""

from __future__ import annotations

import functools

import numpy as np

_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^8) with generator 2."""
    exp = np.zeros(512, dtype=np.uint16)
    log = np.zeros(256, dtype=np.uint16)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    # Duplicate so exp[(log a + log b)] never needs an explicit mod.
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp.astype(np.uint8), log

EXP_TABLE, LOG_TABLE = _build_tables()

def _build_mul_table() -> np.ndarray:
    """Full 256x256 multiplication table (64 KiB) — the workhorse for
    host-side encode/verify paths and per-coefficient lookup tables."""
    nz = np.arange(1, 256, dtype=np.uint16)
    log_sum = (LOG_TABLE[nz][:, None].astype(np.int32)
               + LOG_TABLE[nz][None, :].astype(np.int32))
    mul = np.zeros((256, 256), dtype=np.uint8)
    mul[1:, 1:] = EXP_TABLE[log_sum % 255]
    return mul

MUL_TABLE = _build_mul_table()


def gf_mul(a: int, b: int) -> int:
    return int(MUL_TABLE[a, b])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) - int(LOG_TABLE[b])) % 255])


def gf_exp(a: int, n: int) -> int:
    """a**n in GF(2^8) (matches the reference dependency's galExp)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * n) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of small uint8 matrices (table lookups + XOR)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.shape[1] == b.shape[0]
    # products[i, k, j] = a[i, k] * b[k, j]; XOR-reduce over k.
    prod = MUL_TABLE[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_inverse(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix via Gauss-Jordan elimination.

    Raises ValueError if singular. Mirrors the augmented-matrix elimination
    the reference's dependency uses, so reconstruct picks identical inverses.
    """
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    work = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    for r in range(n):
        if work[r, r] == 0:
            # Find a row below with a non-zero entry in this column and swap.
            for r2 in range(r + 1, n):
                if work[r2, r] != 0:
                    work[[r, r2]] = work[[r2, r]]
                    break
            else:
                raise ValueError("singular matrix")
        # Scale pivot row so the pivot becomes 1.
        pivot = int(work[r, r])
        if pivot != 1:
            inv_pivot = gf_div(1, pivot)
            work[r] = MUL_TABLE[inv_pivot, work[r]]
        # Eliminate this column from every other row.
        for r2 in range(n):
            if r2 != r and work[r2, r] != 0:
                work[r2] ^= MUL_TABLE[int(work[r2, r]), work[r]]
    return work[:, n:].copy()


@functools.lru_cache(maxsize=4096)
def coding_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (k+m) x k systematic coding matrix, identical to the reference's.

    Top k rows are the identity; bottom m rows are the parity coefficients.
    Construction: Vandermonde V[r][c] = r^c, right-multiplied by the inverse
    of its top k x k block.
    """
    k, m = data_shards, parity_shards
    n = k + m
    if k <= 0 or m < 0:
        raise ValueError("invalid shard counts")
    if n > 256:
        raise ValueError("too many shards for GF(2^8)")
    vm = np.zeros((n, k), dtype=np.uint8)
    for r in range(n):
        for c in range(k):
            vm[r, c] = gf_exp(r, c)
    top_inv = gf_inverse(vm[:k, :k])
    mat = gf_matmul(vm, top_inv)
    mat.setflags(write=False)
    return mat


def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Just the m x k parity rows of the coding matrix."""
    return coding_matrix(data_shards, parity_shards)[data_shards:, :]


@functools.lru_cache(maxsize=4096)
def decode_matrix(data_shards: int, parity_shards: int,
                  available: tuple[int, ...]) -> np.ndarray:
    """k x k matrix that maps k surviving shards back to the k data shards.

    `available` is a sorted tuple of exactly k surviving shard indices
    (0..k+m-1). Rows of the coding matrix for those shards are gathered and
    inverted, exactly as the reference's ReconstructData does with the first
    k valid shards.
    """
    k = data_shards
    if len(available) != k:
        raise ValueError(f"need exactly {k} surviving shards")
    full = coding_matrix(data_shards, parity_shards)
    sub = full[list(available), :]
    out = gf_inverse(sub)
    out.setflags(write=False)
    return out


def gf_matvec_bytes(matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Apply an (r x k) GF matrix to k shards of bytes: out[r] = XOR_j m[r,j]*in[j].

    shards: uint8 array [k, shard_len]. Returns [r, shard_len]. Host (numpy)
    path of the codec; the device path lives in rs_device.py.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    shards = np.asarray(shards, dtype=np.uint8)
    r, k = matrix.shape
    assert shards.shape[0] == k
    out = np.zeros((r, shards.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = out[i]
        for j in range(k):
            c = int(matrix[i, j])
            if c == 0:
                continue
            if c == 1:
                acc ^= shards[j]
            else:
                acc ^= MUL_TABLE[c][shards[j]]
    return out


# ---------------------------------------------------------------------------
# GF(2) bit-matrix decomposition: the bridge to an int8 matrix unit.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _const_mul_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix B such that bits(c*x) = B @ bits(x) mod 2.

    Bit order: index 0 = least-significant bit. Multiplication by a
    constant is GF(2)-linear, so it is fully described by its action on
    the 8 basis bytes 1<<j.
    """
    b = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        y = gf_mul(c, 1 << j)
        for i in range(8):
            b[i, j] = (y >> i) & 1
    return b


def bit_matrix(matrix: np.ndarray) -> np.ndarray:
    """Expand an (r x k) GF(2^8) matrix into an (r*8 x k*8) GF(2) matrix:
    row j*8 + c (output byte j, bit c), column i*8 + b (input byte i,
    bit b).

    With data bytes unpacked to bit planes, the whole Reed-Solomon
    transform becomes a binary matrix product followed by mod 2. Sums
    reach k*8 ones, so the product must accumulate exactly: int8
    operands with int32 accumulation on the tensor cores, or float32 on
    0/1 values in the plain version (exact below 2^24).
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    r, k = matrix.shape
    out = np.zeros((r * 8, k * 8), dtype=np.uint8)
    for i in range(r):
        for j in range(k):
            out[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = \
                _const_mul_bitmatrix(int(matrix[i, j]))
    return out

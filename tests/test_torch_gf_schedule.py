"""The GF(2^8) apply kernel's data flow, checked on the CPU.

`csrc/gf_apply.cu` runs only on the card. `_emulate` runs it in numpy as
it is written: `rs_device.packed_tables` (one word per input byte holds
the products of four output rows), each thread's tile of 16 byte
positions per shard (a partial tile loads its bytes past L as 0 and
stores only the bytes before L), the shard loads of a group of
`kShardGroup` issued before their lookups (and kept across row groups
when k fits one group), each lookup's word index in the block's shared
tables built by one `__byte_perm`, one row-packed accumulator per byte
position, and after the last shard the 4 x 4 byte transpose through
`__byte_perm`. Every selector is read from the kernel source, so a
wrong one fails here. Exact byte equality with `gf_apply_plain` (what
`gf_apply` runs on a CPU tensor) and with the TPU package's host codec.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from minio_tpu.erasure.codec import HostBackend as RefHost

from minio_tpu_torch.ops import gf256, rs_device

SRC = (Path(rs_device.__file__).parent / "csrc" / "gf_apply.cu").read_text()
SEL = {name: int(v, 16) for name, v in re.findall(
    r"constexpr uint32_t (k\w+) = (0x[0-9a-fA-F]+);", SRC)}
CONST = {name: int(v) for name, v in re.findall(
    r"constexpr int (k\w+) = (\d+);", SRC)}
GROUP = CONST["kShardGroup"]


def _byte_perm(x, y, sel: int):
    """CUDA __byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of (x, y), y's bytes being 4..7."""
    src = [(v >> np.uint32(8 * b)) & np.uint32(0xFF) for v in (x, y)
           for b in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def _transpose4(a, b, c, d):
    """gf_apply.cu transpose4."""
    p0, p1 = _byte_perm(a, b, SEL["kPairLo"]), _byte_perm(a, b, SEL["kPairHi"])
    p2, p3 = _byte_perm(c, d, SEL["kPairLo"]), _byte_perm(c, d, SEL["kPairHi"])
    return (_byte_perm(p0, p2, SEL["kHalfLo"]), _byte_perm(p0, p2, SEL["kHalfHi"]),
            _byte_perm(p1, p3, SEL["kHalfLo"]), _byte_perm(p1, p3, SEL["kHalfHi"]))


def _emulate(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """uint8 [B, r, L] as csrc/gf_apply.cu computes it from uint8
    [B, k, L]; every thread tile of every stripe at once."""
    r, k = matrix.shape
    tab = rs_device.packed_tables(matrix, "cpu").numpy().view(np.uint32)
    groups = tab.shape[0]
    assert tab.shape == (-(-r // CONST["kRowsPerWord"]), k, 256)
    smem = tab.reshape(-1)                          # the block's shared copy
    b, _, length = data.shape
    tiles = -(-length // 16)
    buf = np.zeros((b, k, tiles * 16), dtype=np.uint8)
    buf[..., :length] = data                        # load16: 0 past L
    words = buf.reshape(b, k, tiles, 16).view("<u4")    # [B, k, tiles, 4]
    out = np.zeros((b, r, tiles * 16), dtype=np.uint8)
    w = [None] * GROUP
    for g in range(groups):
        acc = np.zeros((b, tiles, 16), dtype=np.uint32)
        for i0 in range(0, k, GROUP):
            if g == 0 or k > GROUP:                 # all loads of the group
                for s in range(min(GROUP, k - i0)):
                    w[s] = words[:, i0 + s]
            for s in range(min(GROUP, k - i0)):
                t = np.full_like(w[s][..., 0], g * k + i0 + s)
                for q in range(4):
                    for c in range(4):
                        acc[..., 4 * q + c] ^= smem[_byte_perm(
                            w[s][..., q], t, SEL["kLookup"] + c)]
        for q in range(4):
            quad = [acc[..., 4 * q + n].copy() for n in range(4)]
            for n, v in enumerate(_transpose4(*quad)):
                acc[..., 4 * q + n] = v
        # acc[4q + jj] is word q of output row 4g + jj.
        for jj in range(CONST["kRowsPerWord"]):
            j = g * CONST["kRowsPerWord"] + jj
            if j < r:
                row_words = np.ascontiguousarray(acc[..., jj::4], dtype="<u4")
                out[:, j] = row_words.view(np.uint8).reshape(b, tiles * 16)
    return out[..., :length]


def _plain(matrix, data: np.ndarray) -> np.ndarray:
    return rs_device.gf_apply_plain(matrix, torch.from_numpy(data)).numpy()


def _stripes(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def test_constants_read_from_kernel_source():
    assert set(SEL) == {"kLookup", "kPairLo", "kPairHi", "kHalfLo",
                        "kHalfHi"}
    assert CONST["kRowsPerWord"] == rs_device.ROWS_PER_WORD == 4
    assert CONST["kShardGroup"] >= 1


def test_transpose4_is_a_byte_transpose():
    rows = _stripes(3, (64, 4, 4))                    # [n, position, row]
    quad = [rows[:, p].copy().view("<u4")[:, 0] for p in range(4)]
    got = np.stack([v.astype("<u4").view(np.uint8).reshape(64, 4)
                    for v in _transpose4(*quad)], axis=1)   # [n, row, pos]
    assert np.array_equal(got, rows.transpose(0, 2, 1))


@pytest.mark.parametrize("k", [1, 8, 15])
@pytest.mark.parametrize("r", list(range(1, 9)))
def test_schedule_matches_plain_any_matrix(r, k):
    """One and two row groups, r not a multiple of 4, one shard, one full
    load group, and a second group (k > kShardGroup, words read again
    for the second row group)."""
    rng = np.random.default_rng(100 * r + k)
    m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    data = _stripes(r + k, (2, k, 100))
    assert np.array_equal(_emulate(m, data), _plain(m, data))


def _ec84(rows: str) -> np.ndarray:
    if rows == "parity":
        return gf256.parity_matrix(8, 4)
    return np.ascontiguousarray(gf256.decode_matrix(8, 4, tuple(range(4, 12)))[:4])


@pytest.mark.parametrize("length", [1, 98, 1543, 3200])
@pytest.mark.parametrize("rows", ["parity", "decode"])
def test_schedule_matches_plain_ec84_ragged(rows, length):
    m = _ec84(rows)
    data = _stripes(length, (3, 8, length))
    got = _emulate(m, data)
    assert np.array_equal(got, _plain(m, data))
    for b in range(3):
        assert np.array_equal(got[b], RefHost().apply_matrix(m, data[b]))


@pytest.mark.parametrize("k,m", [(8, 4), (7, 8)])
def test_packed_tables_are_product_tables_repacked(k, m):
    mat = gf256.parity_matrix(k, m)
    byte_tab = rs_device.product_tables(mat, "cpu").numpy()          # [r, k, 256]
    packed = rs_device.packed_tables(mat, "cpu").numpy().view(np.uint32)
    assert packed.shape == (-(-m // 4), k, 256)
    for g in range(packed.shape[0]):
        for jj in range(4):
            want = byte_tab[4 * g + jj] if 4 * g + jj < m else 0
            assert np.array_equal((packed[g] >> np.uint32(8 * jj)) & 0xFF, want)
    assert rs_device.packed_tables(mat, "cpu") is rs_device.packed_tables(mat, "cpu")

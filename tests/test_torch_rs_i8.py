"""The port of B5 (experiments/rs_i8_kernel.py) against the TPU package's.

`rs_apply8_plain` (what `rs_apply8` runs on a CPU tensor) must equal the
JAX B5 kernel itself, `make_encoder8` run under Pallas's TPU interpret
mode, and the JAX u32 encoder `make_encoder32`, byte for byte; and the
port's own `gf_apply_plain` on the byte view. The kernel's B layout
(`b_fragments`) and its data flow (A words from 16-byte loads through a
4 x 4 byte transpose, binary m16n8k128 products, one bit-field insert
per output bit) are checked by a numpy emulation of one warp step that
reads the transpose selectors from the source.
The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py. Integer math throughout: exact equality.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from minio_tpu.ops import gf256 as ref_gf256
from minio_tpu.ops.rs_device import make_encoder32 as ref_encoder32

from minio_tpu_torch.experiments import rs_i8_kernel as ri
from minio_tpu_torch.ops import gf256, rs_device

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_b5():
    """experiments/rs_i8_kernel.py, loaded as a file (it is a script)."""
    spec = importlib.util.spec_from_file_location(
        "ref_rs_i8_kernel", REPO / "experiments" / "rs_i8_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode_rows():
    return np.ascontiguousarray(
        gf256.decode_matrix(8, 4, tuple(range(4, 12)))[:4])


MATRICES = {"8+4": lambda: gf256.parity_matrix(8, 4),
            "4+2": lambda: gf256.parity_matrix(4, 2),
            "decode 4x8": _decode_rows}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bit_matrix_matches_reference(name):
    mat = MATRICES[name]()
    assert np.array_equal(gf256.bit_matrix(mat), ref_gf256.bit_matrix(mat))


@pytest.mark.parametrize("name", ["8+4", "decode 4x8"])
def test_plain_matches_jax_b5_kernel_in_interpret_mode(ref_b5, name):
    mat = MATRICES[name]()
    words = np.random.default_rng(5).integers(0, 2 ** 32, size=(2, 8, 1024),
                                              dtype=np.uint32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_b5.make_encoder8(mat, tile4=512)(
            jnp.asarray(words)))
    assert np.array_equal(want, np.asarray(ref_encoder32(mat)(
        jnp.asarray(words))))
    got = ri.rs_apply8_plain(mat, torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (2, 4, 1024)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    enc = ri.make_encoder8(mat)(torch.from_numpy(words.view(np.int32)))
    assert np.array_equal(enc.numpy().view(np.uint32), want)


@pytest.mark.parametrize("k,m", [(2, 2), (4, 2), (8, 4), (12, 4), (5, 3)])
@pytest.mark.parametrize("length", [1, 17, 100, 4000])
def test_plain_matches_gf_apply_plain(k, m, length):
    pm = gf256.parity_matrix(k, m)
    data = torch.from_numpy(np.random.default_rng(k * 1000 + length).integers(
        0, 256, size=(3, k, length), dtype=np.uint8))
    assert torch.equal(ri.rs_apply8_plain(pm, data),
                       rs_device.gf_apply_plain(pm, data))


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    pm = gf256.parity_matrix(8, 4)
    data = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(2, 8, 400), dtype=np.uint8))
    before = ri.LAUNCHES
    out = torch.zeros((2, 4, 400), dtype=torch.uint8)
    assert ri.rs_apply8(pm, data, out=out) is out
    assert torch.equal(out, rs_device.gf_apply_plain(pm, data))
    assert ri.LAUNCHES == before


def test_rejects_bad_inputs():
    pm = gf256.parity_matrix(4, 2)
    with pytest.raises(ValueError):
        ri.rs_apply8(pm, torch.zeros((1, 3, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ri.rs_apply8(pm, torch.zeros((1, 4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        ri.rs_apply8(pm, torch.zeros((1, 4, 8), dtype=torch.uint8),
                     out=torch.zeros((1, 2, 9), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ri.make_encoder8(pm)(torch.zeros((1, 4, 8), dtype=torch.uint8))


SRC = (Path(ri.__file__).parents[1] / "ops" / "csrc" / "rs_i8.cu").read_text()
SEL = {name: int(v, 16) for name, v in re.findall(
    r"constexpr uint32_t (k\w+) = (0x[0-9a-fA-F]+);", SRC)}
CONST = {name: int(v) for name, v in re.findall(
    r"constexpr int (k\w+) = (\d+);", SRC)}


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA __byte_perm: byte n of the result is byte (sel >> 4n) & 7 of
    (x, y), y's bytes being 4..7."""
    src = (x | (y << 32)).to_bytes(8, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * n)) & 7] for n in range(4)),
                          "little")


def _transpose4(a, b, c, d):
    """rs_i8.cu transpose4, selectors read from the source."""
    p0, p1 = _byte_perm(a, b, SEL["kPairLo"]), _byte_perm(a, b, SEL["kPairHi"])
    p2, p3 = _byte_perm(c, d, SEL["kPairLo"]), _byte_perm(c, d, SEL["kPairHi"])
    return (_byte_perm(p0, p2, SEL["kHalfLo"]), _byte_perm(p0, p2, SEL["kHalfHi"]),
            _byte_perm(p1, p3, SEL["kHalfLo"]), _byte_perm(p1, p3, SEL["kHalfHi"]))


def _bits(word: int) -> np.ndarray:
    return (word >> np.arange(32)) & 1


def _mma_b1(a, b) -> np.ndarray:
    """mma.sync m16n8k128 b1 AND+POPC from the warp's fragments: a[lane]
    = (a0, a1) holds K bits 32tig..+31 of rows g and g + 8, b[lane] = b0
    holds the same K bits of column g. Returns d[lane] = (d0..d3): rows
    g, g, g + 8, g + 8 at columns 2tig, 2tig + 1, 2tig, 2tig + 1."""
    am = np.zeros((16, 128), dtype=np.int64)
    bm = np.zeros((128, 8), dtype=np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        am[g, 32 * tig:32 * tig + 32] = _bits(a[lane][0])
        am[g + 8, 32 * tig:32 * tig + 32] = _bits(a[lane][1])
        bm[32 * tig:32 * tig + 32, g] = _bits(b[lane])
    dm = am @ bm
    return [(dm[lane >> 2, 2 * (lane & 3)], dm[lane >> 2, 2 * (lane & 3) + 1],
             dm[8 + (lane >> 2), 2 * (lane & 3)],
             dm[8 + (lane >> 2), 2 * (lane & 3) + 1]) for lane in range(32)]


def _emulate_warp_step(matrix, chunk):
    """One warp step of csrc/rs_i8.cu in numpy: chunk uint8 [k, L <= 128]
    -> [r, L]. Thread (g, tig) loads lanes 16g..16g+15 of shards 4tig..
    4tig+3 (0 past k and past L), byte-transposes each quarter into one
    word per lane (selectors from the source), feeds lanes 16g + q and
    16g + 8 + q as m-tile q's A rows, the wrapper's `b_fragments` as B,
    inserts each accumulator's low bit at bit 8(q & 3) + 2t + e of its
    output word and stores lanes 16g.. of row 4grp + tig, as the kernel
    does."""
    r, k = matrix.shape
    chunk_len = chunk.shape[1]
    step = CONST["kChunk"]
    buf = np.zeros((CONST["kMaxShards"], step), dtype=np.uint8)
    buf[:k, :chunk_len] = chunk
    frag = ri.b_fragments(matrix).view(np.uint32)
    assert frag.shape == (-(-r // 4), 32, 4)
    a = []
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        loads = [buf[4 * tig + e, 16 * g:16 * g + 16].view("<u4")
                 for e in range(4)]
        words = []
        for qr in range(4):
            words += _transpose4(*(int(loads[e][qr]) for e in range(4)))
        a.append(words)
    out = np.zeros((r, step), dtype=np.uint8)
    for grp in range(frag.shape[0]):
        res = [[0] * 4 for _ in range(32)]
        for q in range(8):
            for t in range(4):
                d = _mma_b1([(a[lane][q], a[lane][8 + q]) for lane in range(32)],
                            [int(frag[grp, lane, t]) for lane in range(32)])
                for lane in range(32):
                    bit = 8 * (q & 3) + 2 * t
                    for i, (word, pos) in enumerate(
                            ((q >> 2, bit), (q >> 2, bit + 1),
                             (2 + (q >> 2), bit), (2 + (q >> 2), bit + 1))):
                        w = res[lane][word] & ~(1 << pos)
                        res[lane][word] = w | ((int(d[lane][i]) & 1) << pos)
        for lane in range(32):
            row = 4 * grp + (lane & 3)
            if row < r:
                col = 16 * (lane >> 2)
                out[row, col:col + 16] = np.array(res[lane], "<u4").view(
                    np.uint8)
    return out[:, :chunk_len]


@pytest.mark.parametrize("r,k,length", [(4, 8, 128), (3, 5, 128),
                                        (5, 12, 128), (1, 2, 128),
                                        (4, 16, 128), (32, 16, 128),
                                        (4, 8, 100), (7, 3, 17)])
def test_kernel_index_algebra_emulated(r, k, length):
    rng = np.random.default_rng(r * 100 + k)
    mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    chunk = rng.integers(0, 256, size=(k, length), dtype=np.uint8)
    want = rs_device.gf_apply_plain(mat, torch.from_numpy(chunk)[None])[0]
    assert np.array_equal(_emulate_warp_step(mat, chunk), want.numpy())


def test_source_limits_match_the_wrapper():
    assert CONST["kMaxShards"] == ri.MAX_K == 16
    assert CONST["kMaxRows"] == ri.MAX_R == 32
    assert "__ballot_sync" not in SRC and "gather8" not in SRC \
        and "spread4" not in SRC


def test_b_fragments_column_permutation():
    """Column g of n-tile t in row group grp is output byte 4grp + g // 2,
    bit 2t + g % 2; bit p of lane tig's word is shard 4tig + p // 8, bit
    p % 8. One nonzero coefficient lights exactly its 8 x 8 block."""
    mat = np.zeros((6, 11), dtype=np.uint8)
    mat[5, 9] = 1                                   # identity block
    frag = ri.b_fragments(mat).view(np.uint32)
    assert frag.shape == (2, 32, 4)
    for grp, lane, t in zip(*np.nonzero(frag)):
        g, tig = lane >> 2, lane & 3
        j, c = 4 * grp + g // 2, 2 * t + g % 2
        (p,) = np.nonzero(_bits(int(frag[grp, lane, t])))[0]
        assert (j, 4 * tig + p // 8, p % 8) == (5, 9, c)
    assert np.count_nonzero(frag) == 8

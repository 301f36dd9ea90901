"""The port of B5 (experiments/rs_i8_kernel.py) against the TPU package's.

`rs_apply8_plain` (what `rs_apply8` runs on a CPU tensor) must equal the
JAX B5 kernel itself, `make_encoder8` run under Pallas's TPU interpret
mode, and the JAX u32 encoder `make_encoder32`, byte for byte; and the
port's own `gf_apply_plain` on the byte view. The kernel's fragment
layout (`a_fragments`) and its index algebra (B operands from 16-byte
loads, ballot repack) are checked by a numpy emulation of one warp step.
The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py. Integer math throughout: exact equality.
"""

import importlib.util
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


def _emulate_warp_step(matrix, chunk):
    """One warp step of csrc/rs_i8.cu in numpy: chunk uint8 [k, 128] ->
    [r, 128]. A tiles are read back from `a_fragments` through the
    m16n8k32 fragment layout; B operands come from each lane's 16-byte
    loads; the accumulator's low bits go through warp ballots and the
    every-4th-bit gather, as the kernel does."""
    r, k = matrix.shape
    frag = ri.a_fragments(matrix).view(np.uint8)
    mt, kt_n = frag.shape[0], frag.shape[1]
    frag = frag.reshape(mt, kt_n, 32, 4, 4)
    a = np.zeros((mt, kt_n, 16, 32), dtype=np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for reg, (row0, col0) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
            a[:, :, g + row0, col0 + tig * 4:col0 + tig * 4 + 4] = \
                frag[:, :, lane, reg]
    loads = np.zeros((32, kt_n, 2, 16), dtype=np.int64)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for kt in range(kt_n):
            for h in range(2):
                s = 4 * kt + 2 * h + (tig >> 1)
                if s < k:
                    loads[lane, kt, h] = chunk[s, 16 * g:16 * g + 16]
    out = np.zeros((r, 128), dtype=np.uint8)
    for grp in range((r + 3) // 4):
        res = np.zeros((32, 16), dtype=np.uint8)
        for q in range(16):
            b = np.zeros((kt_n, 32, 8), dtype=np.int64)
            for lane in range(32):
                g, tig = lane >> 2, lane & 3
                for kt in range(kt_n):
                    for h in range(2):
                        nibble = (loads[lane, kt, h, q] >> ((tig & 1) * 4)) & 0xF
                        spread = (int(nibble) * 0x00204081) & 0x01010101
                        for e in range(4):
                            b[kt, 16 * h + 4 * tig + e, g] = \
                                (spread >> (8 * e)) & 1
            ballots = np.zeros((2, 4), dtype=np.int64)
            for u in range(2):
                ut = 2 * grp + u
                d = sum(a[ut, kt] @ b[kt] for kt in range(kt_n)) \
                    if ut < mt else np.zeros((16, 8), dtype=np.int64)
                for i in range(4):
                    for lane in range(32):
                        g, tig = lane >> 2, lane & 3
                        if d[g + 8 * (i >> 1), 2 * tig + (i & 1)] & 1:
                            ballots[u, i] |= 1 << lane
            for lane in range(32):
                srow, scol = lane >> 3, lane & 7
                mask = int(ballots[srow >> 1, (srow & 1) * 2 + (scol & 1)]) \
                    >> (scol >> 1)
                res[lane, q] = sum(((mask >> (4 * gg)) & 1) << gg
                                   for gg in range(8))
        for lane in range(32):
            row = 4 * grp + (lane >> 3)
            if row < r:
                col = 16 * (lane & 7)
                out[row, col:col + 16] = res[lane]
    return out


@pytest.mark.parametrize("r,k", [(4, 8), (3, 5), (5, 12), (1, 2)])
def test_kernel_index_algebra_emulated(r, k):
    rng = np.random.default_rng(r * 100 + k)
    mat = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
    chunk = rng.integers(0, 256, size=(k, 128), dtype=np.uint8)
    want = rs_device.gf_apply_plain(mat, torch.from_numpy(chunk)[None])[0]
    assert np.array_equal(_emulate_warp_step(mat, chunk), want.numpy())

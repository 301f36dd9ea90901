"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch sees no CUDA
device. The file imports neither JAX nor the TPU package, so on a machine
with a card and no JAX it runs alone, without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Exact byte equality throughout: the arithmetic is integer.
"""

import numpy as np
import pytest
import torch

from minio_tpu_torch.erasure.selftest import erasure_self_test
from minio_tpu_torch.experiments import rs_i8_kernel
from minio_tpu_torch.io.bufpool import BufferPool, global_pool
from minio_tpu_torch.ops import gf256, hh_device, rs_device
from minio_tpu_torch.ops.batcher import StripeBatcher
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.utils.highwayhash import MAGIC_KEY, highwayhash256_many

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(dev, seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("b,k,m,length", [
    (32, 8, 4, 131072), (3, 8, 4, 1543), (2, 4, 2, 77), (1, 12, 4, 4096),
    (4, 8, 4, 131072 + 16), (1, 5, 3, 1), (1, 8, 4, 98)])
def test_gf_apply_matches_plain(dev, b, k, m, length):
    pm = gf256.parity_matrix(k, m)
    data = _rand(dev, length, b, k, length)
    before = rs_device.LAUNCHES
    got = rs_device.gf_apply(pm, data)
    torch.cuda.synchronize()
    assert rs_device.LAUNCHES == before + 1
    assert torch.equal(got, rs_device.gf_apply_plain(pm, data))


def test_gf_apply_decode_rows_u32_and_strided_out(dev):
    rows = np.ascontiguousarray(
        gf256.decode_matrix(8, 4, tuple(range(4, 12)))[:4])
    data = _rand(dev, 9, 32, 8, 131072)
    assert torch.equal(rs_device.gf_apply(rows, data),
                       rs_device.gf_apply_plain(rows, data))
    pm = gf256.parity_matrix(8, 4)
    words = rs_device.make_encoder32(pm)(data.view(torch.int32))
    assert words.dtype == torch.int32
    assert torch.equal(words.view(torch.uint8),
                       rs_device.gf_apply_plain(pm, data))
    shards = torch.zeros((2, 12, 1000), dtype=torch.uint8, device=dev)
    shards[:, :8] = data[:2, :, :1000]
    rs_device.gf_apply(pm, shards[:, :8], out=shards[:, 8:])
    assert torch.equal(shards[:, 8:], rs_device.gf_apply_plain(pm,
                                                               shards[:, :8]))


def test_gpu_backend_golden_selftest(dev):
    erasure_self_test(rs_device.GpuBackend(dev))


@pytest.mark.parametrize("s,length", [(384, 131072), (9, 1024), (6, 4097),
                                      (64, 63), (5, 0), (3, 17)])
def test_highwayhash_matches_plain_and_host(dev, s, length):
    rows = _rand(dev, length, s, length)
    before = hh_device.LAUNCHES
    got = hh_device.hash_rows(rows)
    torch.cuda.synchronize()
    assert hh_device.LAUNCHES == before + 1
    assert torch.equal(got, hh_device.hash_bytes_plain(rows))
    sub = min(s, 4)
    want = highwayhash256_many(MAGIC_KEY, rows[:sub].cpu().numpy())
    assert np.array_equal(got[:sub].cpu().numpy(), want)


def test_highwayhash_unaligned_rows_words_and_selftest(dev):
    rows = np.random.default_rng(1).integers(0, 256, size=(10, 1000),
                                             dtype=np.uint8)
    got = hh_device.hash_rows(torch.from_numpy(rows).to(dev), skip=5)
    assert np.array_equal(got.cpu().numpy(),
                          highwayhash256_many(MAGIC_KEY, rows[:, 5:]))
    words = _rand(dev, 2, 4, 3, 4096).view(torch.int32)
    assert torch.equal(hh_device.hash_words(words),
                       hh_device.hash_words_plain(words))
    bitrot.device_self_test(dev)


def test_framer_and_deframer_on_card(dev):
    k, m, b, length = 8, 4, 3, 4096
    data = np.random.default_rng(3).integers(0, 256, size=(b, k, length),
                                             dtype=np.uint8)
    pm = gf256.parity_matrix(k, m)
    got = hh_device.make_encode_framer(pm, device=dev)(data)
    want = hh_device.make_encode_framer(pm, device="cpu")(data)
    for i in range(k + m):
        for (dg, bg), (dw, bw) in zip(got[i], want[i]):
            assert np.array_equal(dg, dw) and np.array_equal(bg, bw)
    framed = np.empty((b, k, 32 + length), dtype=np.uint8)
    for i in range(k):
        for bi, (dig, blk) in enumerate(got[i]):
            framed[bi, i, :32], framed[bi, i, 32:] = dig, blk
    framed[1, 5, 40] ^= 1
    ok = hh_device.make_deframer(k, device=dev)(framed)
    assert (~ok).sum() == 1 and not ok[1, 5]


@pytest.mark.parametrize("b,k,r,length", [
    (32, 8, 4, 131072), (2, 8, 4, 4), (3, 8, 4, 100), (2, 8, 4, 4000),
    (2, 5, 3, 1000), (2, 12, 5, 4096), (1, 16, 16, 640), (1, 1, 1, 17)])
def test_rs_i8_matches_plain_and_gf_apply(dev, b, k, r, length):
    mat = np.random.default_rng(k * r).integers(0, 256, size=(r, k),
                                                dtype=np.uint8)
    data = _rand(dev, length + k, b, k, length)
    before = rs_i8_kernel.LAUNCHES
    got = rs_i8_kernel.rs_apply8(mat, data)
    torch.cuda.synchronize()
    assert rs_i8_kernel.LAUNCHES == before + 1
    assert torch.equal(got, rs_i8_kernel.rs_apply8_plain(mat, data))
    assert torch.equal(got, rs_device.gf_apply(mat, data))


def test_rs_i8_u32_contract_matches_encoder32(dev):
    pm = gf256.parity_matrix(8, 4)
    words = _rand(dev, 11, 4, 8, 4 * 1000).view(torch.int32)
    got = rs_i8_kernel.make_encoder8(pm)(words)
    assert got.dtype == torch.int32 and got.shape == (4, 4, 1000)
    assert torch.equal(got, rs_device.make_encoder32(pm)(words))


def test_pinned_pool_returns_pinned_reused_buffers(dev):
    pool = BufferPool(pinned=True)
    a = pool.lease(3 << 20)
    assert a.tensor.is_pinned() and a.tensor.numel() >= 3 << 20
    ptr = a.tensor.data_ptr()
    view = a.ndarray((3, 1 << 20))
    assert torch.from_numpy(view).is_pinned()
    a.release()
    b = pool.lease(3 << 20)
    assert b.tensor.data_ptr() == ptr
    assert pool.stats()["hits"] == 1 and pool.stats()["outstanding"] == 1
    b.release()
    assert global_pool(dev).pinned and not global_pool("cpu").pinned


class _Recorder:
    """Wraps a device function; keeps a copy of every staged batch and
    its full (padded) result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, stacked):
        out = self.fn(stacked)
        self.calls.append((stacked.copy(), [[(d.copy(), blk.copy())
                                              for d, blk in drive]
                                             for drive in out]))
        return out


def _rows_equal(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert len(da) == len(db)
        for (ha, ba), (hb, bb) in zip(da, db):
            assert np.array_equal(ha, hb) and np.array_equal(ba, bb)


def test_batched_framer_from_pinned_staging_equals_solo(dev):
    pm = gf256.parity_matrix(8, 4)
    rec = _Recorder(hh_device.make_mesh_framer(pm, device=dev))
    pool = BufferPool(pinned=True)
    sb = StripeBatcher(rec, None, min_device_blocks=1, pool=pool)
    sb.force(True)
    win = np.random.default_rng(4).integers(0, 256, size=(3, 8, 4096),
                                            dtype=np.uint8)
    rows = sb.frame(win)
    assert sb.last_route() == "device" and pool.stats()["misses"] == 1
    staged, full = rec.calls[0]
    assert staged.shape == (8, 8, 4096) and not staged[3:].any()
    solo = hh_device.make_encode_framer(pm, device=dev)(staged)
    _rows_equal(full, solo)                    # pad rows included
    _rows_equal(rows, [drive[:3] for drive in solo])
    _rows_equal(rows, hh_device.make_encode_framer(pm, device="cpu")(win))


def test_member_rows_survive_staging_reuse(dev):
    pm = gf256.parity_matrix(8, 4)
    pool = BufferPool(pinned=True)
    sb = StripeBatcher(hh_device.make_mesh_framer(pm, device=dev), None,
                       min_device_blocks=1, pool=pool)
    sb.force(True)
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, size=(3, 8, 4096), dtype=np.uint8)
    b = rng.integers(0, 256, size=(3, 8, 4096), dtype=np.uint8)
    rows_a = sb.frame(a)
    sb.frame(b)                     # reuses the same pinned staging buffer
    assert pool.stats()["hits"] == 1
    want = hh_device.make_encode_framer(pm, device="cpu")(a)
    _rows_equal(rows_a, want)
    for i in range(8):
        assert all(np.shares_memory(blk, a) for _, blk in rows_a[i])

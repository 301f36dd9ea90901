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


@pytest.mark.parametrize("b,k,m,length,offset", [
    (32, 8, 4, 131072, 0), (3, 8, 4, 1543, 0), (2, 4, 2, 77, 0),
    (1, 12, 4, 4096, 0), (4, 8, 4, 131072 + 16, 0), (1, 5, 3, 1, 0),
    (1, 8, 4, 98, 0),
    # Two row groups of the packed tables, two groups of shard loads (and
    # both together), the batcher's bucket 8, unaligned base pointers.
    (2, 8, 5, 4096 + 3, 0), (3, 8, 8, 131072, 0), (2, 15, 4, 20000, 0),
    (2, 15, 8, 1543, 0), (8, 8, 4, 131072, 0), (2, 8, 4, 131072, 3),
    (3, 8, 6, 1000, 1)])
def test_gf_apply_matches_plain(dev, b, k, m, length, offset):
    pm = gf256.parity_matrix(k, m)
    data = _rand(dev, length, b * k * length + offset)[offset:].view(
        b, k, length)
    before = rs_device.LAUNCHES
    got = rs_device.gf_apply(pm, data)
    torch.cuda.synchronize()
    assert rs_device.LAUNCHES == before + 1
    assert torch.equal(got, rs_device.gf_apply_plain(pm, data))


@pytest.mark.parametrize("r,k", [
    (8, 129),       # 2 x 129 row-packed tables: past the lookup's table byte
    (4, 240)])      # 240 KiB of tables: past a block's shared memory
def test_gf_apply_refuses_tables_past_shared_memory(dev, r, k):
    mat = np.random.default_rng(r * k).integers(1, 256, size=(r, k),
                                                dtype=np.uint8)
    data = _rand(dev, k, 2, k, 1000)
    before = rs_device.LAUNCHES
    with pytest.raises(RuntimeError, match="gf_apply launch"):
        rs_device.gf_apply(mat, data)
    assert rs_device.LAUNCHES == before
    # The refusal leaves no error behind for the next launch.
    pm = gf256.parity_matrix(8, 4)
    ok = _rand(dev, 5, 2, 8, 1000)
    assert torch.equal(rs_device.gf_apply(pm, ok),
                       rs_device.gf_apply_plain(pm, ok))


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


STAGE = hh_device.STAGE_MAX        # the ring stage of one stream a block
# (streams, length, skip, pad): rows of skip + length bytes; pad > 0 makes
# them a slice of a buffer whose rows lie a multiple of pad bytes apart
# (pad 16 sends any length through the kernel's shared-memory ring).
HH_CASES = [(384, 131072, 0, 0), (96, 131072, 0, 0), (3072, 131072, 0, 0),
            (64, 131072, 32, 0),               # framed `digest || block`
            (9, 1024, 0, 0), (6, 4097, 0, 0), (64, 63, 0, 0), (5, 0, 0, 0),
            (3, 17, 0, 0)]
HH_CASES += [(9, STAGE + d, 0, 16) for d in (-31, -16, -1, 1, 16, 31)]
HH_CASES += [(9, 3 * STAGE + 5, 0, 16), (3072, 2048 * 3 + 5, 0, 16)]


@pytest.mark.parametrize("s,length,skip,pad", HH_CASES)
def test_highwayhash_matches_plain_and_host(dev, s, length, skip, pad):
    width = skip + length
    buf = _rand(dev, length + s, s, -(-width // pad) * pad if pad else width)
    rows = buf[:, :width]
    before = hh_device.LAUNCHES
    got = hh_device.hash_rows(rows, skip=skip)
    torch.cuda.synchronize()
    assert hh_device.LAUNCHES == before + 1
    # All rows against the plain version up to 384 streams, 16 sampled
    # rows beyond.
    pick = np.arange(s) if s <= 384 else np.sort(
        np.random.default_rng(s).choice(s, size=16, replace=False))
    pick = torch.from_numpy(pick).to(dev)
    assert torch.equal(got[pick], hh_device.hash_bytes_plain(
        rows[:, skip:].index_select(0, pick)))
    sub = min(s, 4)
    want = highwayhash256_many(MAGIC_KEY, rows[:sub, skip:].cpu().numpy())
    assert np.array_equal(got[:sub].cpu().numpy(), want)


def test_highwayhash_refuses_a_bad_launch_shape(dev, monkeypatch):
    """The C entry point checks the shape it is given; the wrapper raises
    and counts no launch."""
    good = hh_device.launch_shape
    monkeypatch.setattr(hh_device, "launch_shape", lambda *a: good(*a)._replace(
        smem_bytes=good(*a).smem_bytes + 16))
    rows = _rand(dev, 1, 12, 4096)
    before = hh_device.LAUNCHES
    with pytest.raises(RuntimeError, match="highwayhash256 launch"):
        hh_device.hash_rows(rows)
    assert hh_device.LAUNCHES == before


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


@pytest.mark.parametrize("b,k,r,length,offset", [
    (32, 8, 4, 131072, 0), (2, 8, 4, 4, 0), (3, 8, 4, 100, 0),
    (2, 8, 4, 4000, 0), (2, 5, 3, 1000, 0), (2, 12, 5, 4096, 0),
    (1, 16, 16, 640, 0), (1, 1, 1, 17, 0),
    # The widest matrix (k = 16: one full 128-bit K; r = 32: 8 row groups),
    # one output row, unaligned bases (the masked path at full width) and
    # a ragged tail past several warp steps.
    (2, 16, 32, 131072, 0), (3, 16, 32, 1543, 0), (4, 8, 1, 131072, 0),
    (2, 15, 1, 777, 0), (2, 8, 4, 131072, 3), (3, 12, 4, 4096 + 5, 1),
    (1, 16, 32, 513, 7)])
def test_rs_i8_matches_plain_and_gf_apply(dev, b, k, r, length, offset):
    mat = np.random.default_rng(k * r).integers(0, 256, size=(r, k),
                                                dtype=np.uint8)
    data = _rand(dev, length + k, b * k * length + offset)[offset:].view(
        b, k, length)
    before = rs_i8_kernel.LAUNCHES
    got = rs_i8_kernel.rs_apply8(mat, data)
    torch.cuda.synchronize()
    assert rs_i8_kernel.LAUNCHES == before + 1
    assert torch.equal(got, rs_i8_kernel.rs_apply8_plain(mat, data))
    assert torch.equal(got, rs_device.gf_apply(mat, data))


def test_mma_probe_rates(dev):
    rates = rs_i8_kernel.mma_rates(dev, iters=256)
    assert [name for name, _ in rs_i8_kernel.PROBE_SHAPES] == list(rates)
    assert all(v > 1e12 for v in rates.values())


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


@pytest.mark.parametrize("use,targets", [
    (tuple(range(1, 9)), (0,)),                 # one data shard (heal r = 1)
    (tuple(range(4, 12)), (0, 1, 2, 3)),        # four data shards
    ((0, 2, 3, 4, 5, 7, 9, 10), (1, 6, 8, 11)),  # two data and two parity
    (tuple(range(8)), (10,))])                  # one parity shard
def test_rebuild_rows_on_card(dev, use, targets):
    """Heal's rebuild rows through gf_apply on the card equal the plain
    version and the JAX package's two steps (data shards from the
    survivors, then parity from the data)."""
    from minio_tpu_torch.erasure.codec import Erasure
    from minio_tpu_torch.object.erasure_object import rebuild_rows
    rows = rebuild_rows(8, 4, use, targets)
    body = np.random.default_rng(len(targets)).integers(
        0, 256, size=8 * 4096, dtype=np.uint8)
    shards = Erasure(8, 4, 1 << 20).encode_data(body)     # 12 x 4096 B
    surv = torch.from_numpy(np.stack([shards[i] for i in use]))[None].to(dev)
    got = rs_device.gf_apply(rows, surv)
    assert torch.equal(got, rs_device.gf_apply_plain(rows, surv))
    want = np.stack([shards[t] for t in targets])
    assert np.array_equal(got[0].cpu().numpy(), want)


def _drive_files(root) -> dict:
    import os
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if f != "xl.meta":
                p = os.path.join(base, f)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_multipart_and_heal_on_card(dev, tmp_path):
    """A multipart object and a 40 MiB object on a set on the card: the
    part files equal a CPU set's; with two data and two parity drives
    wiped, heal launches both kernels and restores the drives' files
    byte for byte."""
    import shutil
    from minio_tpu_torch.object.erasure_object import ErasureSet, hash_order
    from minio_tpu_torch.storage.local import LocalStorage
    rng = np.random.default_rng(12)
    parts = [rng.bytes(5 << 20), rng.bytes(3 << 20)]
    big = rng.bytes(40 << 20)
    sets = {}
    for name, device in (("c", "cuda"), ("h", "cpu")):
        es = ErasureSet([LocalStorage(str(tmp_path / f"{name}{i}"))
                         for i in range(12)], device=device)
        es._mrf_closed = True
        es.make_bucket("b")
        uid = es.new_multipart_upload("b", "mp")
        done = [es.put_object_part("b", "mp", uid, n + 1, p)
                for n, p in enumerate(parts)]
        es.complete_multipart_upload("b", "mp", uid,
                                     [(p.number, p.etag) for p in done])
        sets[name] = es
    es = sets["c"]
    try:
        for i in range(12):
            assert sorted(_drive_files(tmp_path / f"c{i}" / "b").values()) \
                == sorted(_drive_files(tmp_path / f"h{i}" / "b").values())
        es.put_object("b", "big", big)
        for key in ("mp", "big"):
            dist = hash_order(f"b/{key}", 12)
            drives = [dist.index(s + 1) for s in (1, 6, 8, 11)]
            copies = {i: _drive_files(tmp_path / f"c{i}" / "b" / key)
                      for i in drives}
            for i in drives:
                shutil.rmtree(tmp_path / f"c{i}" / "b" / key)
            before = (rs_device.LAUNCHES, hh_device.LAUNCHES)
            r = es.heal_object("b", key)
            assert r.healed == 4 and r.after == ["ok"] * 12
            assert rs_device.LAUNCHES > before[0]
            assert hh_device.LAUNCHES > before[1]
            for i in drives:
                assert _drive_files(tmp_path / f"c{i}" / "b" / key) == \
                    copies[i]
        assert es.get_object("b", "mp")[1] == b"".join(parts)
        assert es.get_object("b", "big")[1] == big
    finally:
        for s in sets.values():
            s.close()

"""The port's keyed HighwayHash-256 and PUT/GET pipelines against the TPU
package's.

`hash_words_plain` / `hash_bytes_plain` (what the wrappers run on a CPU
tensor) must equal the TPU package's Pallas hash kernels in interpret
mode at the shapes tests/test_hh_device.py uses, its portable XLA path on
ragged lengths, and the host numpy hash. The framer and deframer must
give the TPU package's rows and verdicts. Exact byte equality throughout.
The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import hh_device as ref_hh
from minio_tpu.utils import highwayhash as ref_highwayhash

from minio_tpu_torch.ops import gf256, hh_device
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.utils.highwayhash import MAGIC_KEY, highwayhash256_many


def _ref_words(words: np.ndarray, pchunk: int) -> np.ndarray:
    """The TPU package's word kernel in interpret mode -> uint32 [S, 8]."""
    out = ref_hh._hash_words_pallas(
        jnp.asarray(words), jnp.asarray(ref_hh._init_smem_np(MAGIC_KEY)),
        pchunk=pchunk, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("shape,pchunk", [
    ((130, 512 // 4), 16),        # B3 natural layout, 2-D
    ((10, 8, 4096 // 4), 16),     # B3, 3-D [B, X, W]
    ((5, 4, 1024 // 4), 16),      # B3, 3-D, parity-shaped X
    ((7, 256 // 4), 4),           # B4 packet-major branch ((8*4) % 128 != 0)
])
def test_plain_words_match_pallas_kernels(shape, pchunk):
    words = np.random.default_rng(sum(shape)).integers(
        0, 2 ** 32, size=shape, dtype=np.uint32)
    want = _ref_words(words, pchunk)
    got = hh_device.hash_words_plain(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # hash_words on a CPU tensor is the same plain version.
    assert torch.equal(hh_device.hash_words(
        torch.from_numpy(words.view(np.int32))), got)


@pytest.mark.parametrize("length", [1, 31, 33, 4097])
def test_ragged_lengths_match_reference(length):
    blocks = np.random.default_rng(length).integers(
        0, 256, size=(5, length), dtype=np.uint8)
    want = ref_hh.hash_blocks_device(MAGIC_KEY, blocks, mode="xla")
    got = hh_device.hash_blocks_device(MAGIC_KEY, blocks, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(got, highwayhash256_many(MAGIC_KEY, blocks))


@pytest.mark.parametrize("length", [0, 16, 32, 63, 64, 100])
def test_every_tail_case_matches_host(length):
    """The three byte placements of the final packet (mod & 16, mod4)
    and whole packets, under an arbitrary key."""
    key = bytes(range(32))
    blocks = np.random.default_rng(length + 1).integers(
        0, 256, size=(3, length), dtype=np.uint8)
    got = hh_device.hash_rows(torch.from_numpy(blocks), key=key).numpy()
    assert np.array_equal(got, ref_highwayhash.highwayhash256_many(key, blocks))


@pytest.mark.parametrize("length", [98, 3200, 4097])
def test_one_row_of_any_stride(length):
    """A single row sliced out of a wider one (one rebuilt shard's ragged
    block in a heal) hashes as the host does, whatever its row stride."""
    rows = np.random.default_rng(length).integers(
        0, 256, size=(1, length + 5), dtype=np.uint8)
    got = hh_device.hash_rows(torch.from_numpy(rows)[:, :length]).numpy()
    assert np.array_equal(got, highwayhash256_many(MAGIC_KEY,
                                                   rows[:, :length]))


def test_hash_rows_skips_frame_header():
    """hash_rows(skip=32) hashes the payload of `digest || block` rows."""
    rows = np.random.default_rng(3).integers(0, 256, size=(4, 32 + 300),
                                             dtype=np.uint8)
    got = hh_device.hash_rows(torch.from_numpy(rows), skip=32).numpy()
    assert np.array_equal(got, highwayhash256_many(MAGIC_KEY, rows[:, 32:]))


def test_initial_state_and_key_carried_across():
    assert MAGIC_KEY == ref_highwayhash.MAGIC_KEY
    for key in (MAGIC_KEY, bytes(range(32))):
        assert np.array_equal(hh_device.init_state(key),
                              ref_hh._init_smem_np(key))
        assert np.array_equal(hh_device.init_state(key).reshape(8, 2, 2),
                              ref_hh._init_state_np(key))


def _join(row) -> bytes:
    return b"".join(bytes(np.ascontiguousarray(p)) for pair in row
                    for p in pair)


@pytest.mark.parametrize("k,m,b,l", [(4, 2, 3, 512), (8, 4, 2, 1024)])
def test_framer_rows_match_reference(k, m, b, l):
    data = np.random.default_rng(k * m).integers(0, 256, size=(b, k, l),
                                                 dtype=np.uint8)
    pm = gf256.parity_matrix(k, m)
    want = ref_hh.make_encode_framer(pm)(data)
    framer = hh_device.make_encode_framer(pm, device="cpu")
    got = framer(data)
    assert len(got) == len(want) == k + m
    for i in range(k + m):
        assert _join(got[i]) == _join(want[i]), f"drive slot {i} differs"
    # Data blocks are zero-copy views of the caller's buffer.
    assert np.shares_memory(got[0][0][1], data)
    # device_step: the same bytes through the u32 contract.
    parity, dig_d, dig_p = framer.device_step(
        torch.from_numpy(data.view(np.int32)))
    assert parity.numpy().view(np.uint8).tobytes() == b"".join(
        bytes(want[k + j][bi][1]) for bi in range(b) for j in range(m))
    assert bytes(dig_d.numpy().view(np.uint8)[1, 2]) == bytes(want[2][1][0])
    assert bytes(dig_p.numpy().view(np.uint8)[0, 1]) == bytes(want[k + 1][0][0])


def test_deframer_flags_corrupt_block_like_reference():
    k, b, l = 4, 3, 256
    data = np.random.default_rng(11).integers(0, 256, size=(b, k, l),
                                              dtype=np.uint8)
    rows = ref_hh.make_encode_framer(gf256.parity_matrix(k, 2))(data)
    framed = np.empty((b, k, 32 + l), dtype=np.uint8)
    for i in range(k):
        for bi, (dig, blk) in enumerate(rows[i]):
            framed[bi, i, :32] = dig
            framed[bi, i, 32:] = blk
    framed[1, 2, 32 + 7] ^= 0x40          # one payload byte
    framed[2, 0, 5] ^= 0x01               # one stored digest byte
    want = ref_hh.make_deframer(k)(framed)
    got = hh_device.make_deframer(k, device="cpu")(framed)
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert (~got).sum() == 2 and not got[1, 2] and not got[2, 0]


def test_framed_digests_across_blobs():
    rng = np.random.default_rng(5)
    blobs = [rng.integers(0, 256, size=(n, 32 + 200), dtype=np.uint8)
             for n in (2, 3)]
    got = hh_device.framed_digests_device(blobs, device="cpu")
    want = highwayhash256_many(MAGIC_KEY, np.concatenate(blobs)[:, 32:])
    assert np.array_equal(got, want)


def test_bitrot_self_tests():
    bitrot.bitrot_self_test()
    bitrot.device_self_test("cpu")


def test_read_framed_blocks_many_device_matches_host():
    rng = np.random.default_rng(8)
    ss, size = 256, 256 * 3 + 77
    blocks = [rng.integers(0, 256, size=size, dtype=np.uint8)
              for _ in range(3)]

    def frame(arr):
        parts = [arr[o:o + ss] for o in range(0, size, ss)]
        return b"".join(bitrot.hash_block(bitrot.HIGHWAYHASH256S, p)
                        + p.tobytes() for p in parts)
    blobs = [frame(a) for a in blocks] + [None]
    bad = bytearray(blobs[1])
    bad[40] ^= 1
    blobs[1] = bytes(bad)
    host = bitrot.read_framed_blocks_many(blobs, ss, size)
    dev = bitrot.read_framed_blocks_many(blobs, ss, size, device="cpu")
    for h, d in zip(host, dev):
        assert (h is None) == (d is None)
        if h is not None:
            assert np.array_equal(h, d)
    assert host[1] is None and host[3] is None
    assert np.array_equal(dev[2], blocks[2])


def test_plain_calls_do_not_count_launches():
    before = hh_device.LAUNCHES
    hh_device.hash_rows(torch.zeros((2, 64), dtype=torch.uint8))
    assert hh_device.LAUNCHES == before


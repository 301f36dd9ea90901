"""The HighwayHash kernel's schedule and launch shape, checked on the CPU.

`csrc/highwayhash.cu` runs only on the card. Its index algebra is held
here against the TPU package's hash without one: `_emulate` runs the
kernel in numpy uint64 exactly as it is scheduled — the launch shape of
`hh_device.launch_shape`, each block's streams from `block_streams`,
whole packets copied stage by stage into a ring of the shape's stages
(a slot is refilled only after its stage was consumed, and bytes past a
stage's end are poison), lane pairs {0,1} and {2,3} carried apart as the
kernel's two threads per stream carry them (with the last merge of each
update into v1 left pending until the next packet, as the kernel adds
it), the ragged final packet, and the 10 finalisation rounds with the
pair exchange. The zipper merge runs
`__byte_perm` with the selector constants read from the kernel source.
Exact byte equality with `_hash_words_pallas` in interpret mode and with
the host reference hash.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from minio_tpu.ops import hh_device as ref_hh
from minio_tpu.utils import highwayhash as ref_highwayhash

from minio_tpu_torch.ops import hh_device

KEY = ref_highwayhash.MAGIC_KEY
SRC = Path(hh_device.__file__).parent / "csrc" / "highwayhash.cu"
SEL = {name: int(v, 16) for name, v in re.findall(
    r"constexpr uint32_t (kZip\w+) = (0x[0-9a-fA-F]+);", SRC.read_text())}

U = np.uint64
M32 = U(0xFFFFFFFF)
POISON = 0xA5


def _byte_perm(x, y, sel: int):
    """CUDA __byte_perm on 32-bit values held in uint64 arrays."""
    src = [(v >> U(8 * k)) & U(0xFF) for v in (x, y) for k in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << U(8 * n)
    return out


def _zipper_merge_add(v1, v0, add1, add0):
    """highwayhash.cu zipper_merge_add: returns (add1', add0')."""
    el, eh, ol, oh = v0 & M32, v0 >> U(32), v1 & M32, v1 >> U(32)
    even = _byte_perm(_byte_perm(el, oh, SEL["kZipLoA"]), eh, SEL["kZipLoB"]) \
        | (_byte_perm(el, oh, SEL["kZipEvenHi"]) << U(32))
    odd = _byte_perm(_byte_perm(ol, eh, SEL["kZipLoA"]), oh, SEL["kZipLoB"]) \
        | (_byte_perm(ol, eh, SEL["kZipOddHi"]) << U(32))
    return add1 + odd, add0 + even


def _update(pair, a, b):
    """One packet update of a lane pair (v0, v1, mul0, mul1, z1), each a
    list of the pair's two lanes; z1 is the merge of v0 into v1 that the
    kernel adds with the next packet (see _flush)."""
    v0, v1, m0, m1, z1 = pair
    for i, lane in enumerate((a, b)):
        v1[i] = (v1[i] + m0[i] + lane) + z1[i]
        m0[i] = m0[i] ^ ((v1[i] & M32) * (v0[i] >> U(32)))
        v0[i] = v0[i] + m1[i]
        m1[i] = m1[i] ^ ((v0[i] & M32) * (v1[i] >> U(32)))
    v0[1], v0[0] = _zipper_merge_add(v1[1], v1[0], v0[1], v0[0])
    zero = np.zeros_like(v0[0])
    z1[1], z1[0] = _zipper_merge_add(v0[1], v0[0], zero, zero)


def _flush(pair):
    """highwayhash.cu flush: the pending merge into v1."""
    v1, z1 = pair[1], pair[4]
    for i in range(2):
        v1[i], z1[i] = v1[i] + z1[i], np.zeros_like(z1[i])


def _rot32(x):
    return (x >> U(32)) | (x << U(32))


def _lanes(b16):
    """[..., 16] uint8 -> the two little-endian u64 lanes [...]."""
    w = np.ascontiguousarray(b16).view("<u8")
    return w[..., 0], w[..., 1]


def _emulate(rows: np.ndarray, skip: int, sm_count: int, stride: int):
    """Digests uint8 [S, 32] of rows[:, skip:] as csrc/highwayhash.cu
    computes them in hh_device.launch_shape's shape, for rows `stride`
    bytes apart in a buffer that starts 16-byte aligned. Returns
    (digests, shape)."""
    s, f = rows.shape
    length = f - skip
    shape = hh_device.launch_shape(s, length, sm_count, base=skip,
                                   stride=stride)
    blocks, spb = shape.blocks, shape.streams_per_block
    # Block b's thread pair j hashes stream idx[b, j] (-1: no stream).
    idx = np.full((blocks, spb), -1)
    for b in range(blocks):
        mine = hh_device.block_streams(b, s, blocks)
        assert 1 <= len(mine) <= spb
        idx[b, :len(mine)] = mine
    valid = idx >= 0
    assert np.array_equal(np.sort(idx[valid]), np.arange(s))
    data = np.where(valid[..., None], rows[idx, skip:], 0).astype(np.uint8)

    init = hh_device.init_state(KEY).astype(np.uint64)      # [8, 4]
    full = [init[2 * v] | (init[2 * v + 1] << U(32)) for v in range(4)]
    ones = np.ones((blocks, spb), dtype=np.uint64)
    # pairs[h] = (v0, v1, mul0, mul1, z1), each [lane 2h, lane 2h + 1]
    pairs = [[[ones * full[v][2 * h + i] for i in range(2)]
              for v in range(4)] + [[ones * U(0), ones * U(0)]]
             for h in range(2)]

    body = length // 32 * 32
    if shape.stages:
        stage, stages = shape.stage_bytes, shape.stages
        ring = np.full((stages, blocks, spb, stage + hh_device.SLOT_PAD),
                       POISON, dtype=np.uint8)
        held = [None] * stages
        nstg = -(-body // stage)

        def produce(t):
            st, off = t % stages, t * stage
            n = min(stage, body - off)
            ring[st] = POISON
            ring[st, :, :, :n] = data[:, :, off:off + n]
            held[st] = t

        for t in range(min(stages, nstg)):
            produce(t)
        for t in range(nstg):
            st = t % stages
            assert held[st] == t
            for pk in range(min(stage, body - t * stage) // 32):
                for h in range(2):
                    _update(pairs[h], *_lanes(
                        ring[st, :, :, 32 * pk + 16 * h:32 * pk + 16 * h + 16]))
            if t + stages < nstg:                  # the slot is empty now
                produce(t + stages)
    else:
        for pk in range(body // 32):
            for h in range(2):
                _update(pairs[h], *_lanes(
                    data[:, :, 32 * pk + 16 * h:32 * pk + 16 * h + 16]))

    mod = length & 31
    if mod:
        tail = data[:, :, body:]
        mod4, rem = mod & 3, mod & ~3
        for pair in pairs:
            _flush(pair)
            v0, v1 = pair[0], pair[1]
            for i in range(2):
                v0[i] = v0[i] + ((U(mod) << U(32)) + U(mod))
                lo, hi = v1[i] & M32, v1[i] >> U(32)
                rl = ((lo << U(mod)) | (lo >> U(32 - mod))) & M32
                rh = ((hi << U(mod)) | (hi >> U(32 - mod))) & M32
                v1[i] = (rh << U(32)) | rl
        packet = np.zeros((blocks, spb, 32), dtype=np.uint8)
        packet[..., :rem] = tail[..., :rem]
        if mod & 16:
            for i in range(4):
                packet[..., 28 + i] = tail[..., rem + i + mod4 - 4]
        elif mod4:
            packet[..., 16] = tail[..., rem]
            packet[..., 17] = tail[..., rem + (mod4 >> 1)]
            packet[..., 18] = tail[..., rem + mod4 - 1]
        for h in range(2):
            _update(pairs[h], *_lanes(packet[..., 16 * h:16 * h + 16]))

    for _ in range(10):
        # __shfl_xor_sync(pair_mask, v0[i], 1): each thread reads the other
        # pair's v0 before either thread updates.
        other = [list(pairs[1][0]), list(pairs[0][0])]
        for h in range(2):
            _update(pairs[h], _rot32(other[h][0]), _rot32(other[h][1]))

    out = np.zeros((blocks, spb, 4), dtype=np.uint64)
    for h, pair in enumerate(pairs):
        _flush(pair)
        v0, v1, m0, m1, _ = pair
        a3 = (v1[1] + m1[1]) & U(0x3FFFFFFFFFFFFFFF)
        a2 = v1[0] + m1[0]
        a1 = v0[1] + m0[1]
        a0 = v0[0] + m0[0]
        out[..., 2 * h] = a0 ^ (a2 << U(1)) ^ (a2 << U(2))
        out[..., 2 * h + 1] = a1 ^ ((a3 << U(1)) | (a2 >> U(63))) \
            ^ ((a3 << U(2)) | (a2 >> U(62)))
    digests = np.empty((s, 32), dtype=np.uint8)
    digests[idx[valid]] = out.astype("<u8").view(np.uint8).reshape(
        blocks, spb, 32)[valid]
    return digests, shape


def _pallas(rows: np.ndarray) -> np.ndarray:
    """The TPU package's word kernel in interpret mode -> uint8 [S, 32]."""
    s, length = rows.shape
    words = jnp.asarray(rows.view(np.uint32))
    out = ref_hh._hash_words_pallas(
        words, jnp.asarray(ref_hh._init_smem_np(KEY)),
        pchunk=ref_hh._pick_pchunk(length // 32), interpret=True)
    return np.asarray(out).view(np.uint8).reshape(s, 32)


def test_selectors_read_from_kernel_source():
    assert set(SEL) == {"kZipLoA", "kZipLoB", "kZipEvenHi", "kZipOddHi"}


# (streams, SM count): one stream a block with 4 KiB stages; 48 streams a
# block on one SM with 1 KiB stages; the 256-block bucket's 3,072 streams
# over 132 SMs with 2 KiB stages.
SHAPES = [(12, 132), (96, 1), (3072, 132)]
# Lengths around the stage of the 128 KiB shape: a stage less one byte,
# one stage, one stage and a ragged packet, 3 stages and a ragged tail,
# 6 stages (the ring of 4 slots wraps).
EDGES = [("stage-1", -1, 1), ("stage", 0, 1), ("stage+31", 31, 1),
         ("3stage+5", 5, 3), ("6stage", 0, 6)]


@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
@pytest.mark.parametrize("s,sm", SHAPES, ids=[f"S{s}-sm{m}" for s, m in SHAPES])
def test_schedule_matches_references(s, sm, edge):
    _, extra, mult = edge
    stage = hh_device.launch_shape(s, 131072, sm).stage_bytes
    length = mult * stage + extra
    rows = np.random.default_rng(s + length).integers(
        0, 256, size=(s, length), dtype=np.uint8)
    # Rows of a buffer padded to 16-byte rows, as the ring needs.
    got, shape = _emulate(rows, 0, sm, -(-length // 16) * 16)
    assert shape.stages == min(hh_device.RING_STAGES,
                               -(-(length // 32 * 32) // shape.stage_bytes))
    assert np.array_equal(got, ref_highwayhash.highwayhash256_many(KEY, rows))
    if s <= 12 and extra == 0 and mult == 1:
        assert np.array_equal(got, _pallas(rows))


@pytest.mark.parametrize("skip,byte_path", [(32, False), (5, True)])
def test_schedule_framed_and_unaligned_rows(skip, byte_path):
    """`digest || block` rows hashed from byte 32 take the ring; a base
    that is not 16-byte aligned takes the byte path. Both are exact."""
    stage = hh_device.launch_shape(64, 131072, 132).stage_bytes
    rows = np.random.default_rng(skip).integers(
        0, 256, size=(64, 32 + 3 * stage + 5), dtype=np.uint8)
    got, shape = _emulate(rows, skip, 132, -(-rows.shape[1] // 16) * 16)
    assert (shape.stages == 0) == byte_path
    assert np.array_equal(
        got, ref_highwayhash.highwayhash256_many(KEY, rows[:, skip:]))


def test_schedule_whole_packets_match_pallas_with_pad_rows():
    """A block with fewer streams than the launch's most (2 and 3 streams
    a block) against the Pallas kernel in interpret mode."""
    rows = np.random.default_rng(7).integers(0, 256, size=(5, 2048),
                                             dtype=np.uint8)
    got, shape = _emulate(rows, 0, 2, 2048)
    assert shape.blocks == 2 and shape.streams_per_block == 3
    assert np.array_equal(got, _pallas(rows))


@pytest.mark.parametrize("sm", [1, 132])
@pytest.mark.parametrize("s", [1, 12, 96, 384, 3072])
def test_launch_shape(s, sm):
    for base, stride, length in ((0, 131072, 131072),      # shard blocks
                                 (32, 131104, 131072)):    # framed rows
        shape = hh_device.launch_shape(s, length, sm, base, stride)
        blocks, spb = shape.blocks, shape.streams_per_block
        covered = [i for b in range(blocks)
                   for i in hh_device.block_streams(b, s, blocks)]
        assert covered == list(range(s))                   # each stream once
        assert all(1 <= len(hh_device.block_streams(b, s, blocks)) <= spb
                   for b in range(blocks))
        assert blocks >= min(s, sm)
        assert spb <= hh_device.MAX_STREAMS_PER_BLOCK
        assert shape.threads == 32 * (-(-2 * spb // 32) + 1) <= 1024
        assert 2 <= shape.stages <= hh_device.RING_STAGES
        assert shape.stage_bytes % 32 == 0 and shape.stage_bytes >= 512
        assert shape.smem_bytes == shape.stages * spb * (
            shape.stage_bytes + hh_device.SLOT_PAD) + 16 * shape.stages
        assert shape.smem_bytes <= hh_device.SMEM_MAX == 232448
        if sm == 132:
            assert shape.stage_bytes >= 1024                # Little's law
    # An unaligned base or stride selects the byte path.
    for base, stride in ((5, 131072), (0, 131073), (32, 131080)):
        shape = hh_device.launch_shape(s, 131072, sm, base, stride)
        if s == 1 and base % 16 == 0:
            assert shape.stages > 0                         # stride unused
        else:
            assert shape.stages == shape.stage_bytes == shape.smem_bytes == 0


def test_launch_shape_examples():
    """The window's 384 streams fill all 132 SMs with 2-3 streams a block;
    the 256-block bucket's 3,072 with 23-24."""
    for s, lo, hi in ((384, 2, 3), (3072, 23, 24)):
        shape = hh_device.launch_shape(s, 131072, 132)
        assert shape.blocks == 132
        counts = {len(hh_device.block_streams(b, s, 132)) for b in range(132)}
        assert counts == {lo, hi} and shape.streams_per_block == hi
    assert hh_device.launch_shape(3072, 131072, 132).stage_bytes == 2048
    assert hh_device.launch_shape(384, 131072, 132).stage_bytes == 4096
    # No whole packet: nothing goes through the ring.
    assert hh_device.launch_shape(7, 31, 132).stages == 0
    with pytest.raises(ValueError):
        hh_device.launch_shape(0, 32, 132)

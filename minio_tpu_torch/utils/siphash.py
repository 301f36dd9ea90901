"""SipHash-2-4 (64-bit): the object-to-set routing hash.

The port's own copy of minio_tpu/utils/siphash.py. The reference routes
each object key to its erasure set with sipHashMod(key, numSets,
deploymentID) (cmd/erasure-sets.go:663, via dchest/siphash); written
from the public SipHash specification (Aumasson & Bernstein, 2012) and
held against the vectors published with it and against the JAX
package's function (tests/test_torch_topology.py). A key must land in
the same set under both packages, or neither reads the other's
multi-set data.
"""

from __future__ import annotations

MASK = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & MASK


def siphash24(key: bytes, data: bytes) -> int:
    """SipHash-2-4 of data under a 16-byte key -> 64-bit int."""
    if len(key) != 16:
        raise ValueError("siphash key must be 16 bytes")
    k0 = int.from_bytes(key[:8], "little")
    k1 = int.from_bytes(key[8:], "little")
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def rounds(n: int) -> None:
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & MASK
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & MASK
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & MASK
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & MASK
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)

    end = len(data) - len(data) % 8
    for off in range(0, end, 8):
        m = int.from_bytes(data[off:off + 8], "little")
        v3 ^= m
        rounds(2)
        v0 ^= m
    # The last word: the tail's bytes, the length's low byte on top.
    m = ((len(data) & 0xFF) << 56) | int.from_bytes(data[end:], "little")
    v3 ^= m
    rounds(2)
    v0 ^= m
    v2 ^= 0xFF
    rounds(4)
    return (v0 ^ v1 ^ v2 ^ v3) & MASK


def sip_hash_mod(key: str, cardinality: int, id_: bytes) -> int:
    """key -> [0, cardinality) under a 16-byte deployment id (reference
    sipHashMod, cmd/erasure-sets.go:663); -1 when there is no set."""
    if cardinality <= 0:
        return -1
    return siphash24(id_, key.encode()) % cardinality

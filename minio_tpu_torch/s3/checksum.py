"""S3 additional checksums (x-amz-checksum-*).

The port of minio_tpu/s3/checksum.py (reference internal/hash/checksum.go):
a client may declare a CRC32, SHA-1 or SHA-256 checksum of the payload,
as a header or as an aws-chunked trailer (what modern SDKs send by
default). The server computes it as the body streams, checks it in the
payload's finish hook before the commit, stores it under the
`x-internal-checksum-*` metadata keys, and returns it on the PUT
response and on GET/HEAD with `x-amz-checksum-mode: ENABLED`.

CRC32C and CRC64NVME need tables the standard library does not carry;
declaring them is answered NotImplemented rather than silently skipping
verification.
"""

from __future__ import annotations

import base64
import hashlib
import struct
import zlib

ALGOS = ("crc32", "sha1", "sha256")
UNSUPPORTED = ("crc32c", "crc64nvme")

META_PREFIX = "x-internal-checksum-"
H_PREFIX = "x-amz-checksum-"


class ChecksumError(Exception):
    def __init__(self, code: str, msg: str = ""):
        self.code = code
        super().__init__(msg or code)


class _CRC32:
    def __init__(self):
        self._v = 0

    def update(self, b) -> None:
        self._v = zlib.crc32(b, self._v)

    def digest(self) -> bytes:
        return struct.pack(">I", self._v & 0xFFFFFFFF)


def new_hasher(algo: str):
    if algo == "crc32":
        return _CRC32()
    if algo == "sha1":
        return hashlib.sha1()
    if algo == "sha256":
        return hashlib.sha256()
    raise ChecksumError("NotImplemented", f"checksum {algo!r}")


def _refuse(algo: str) -> ChecksumError:
    return ChecksumError("NotImplemented",
                         f"checksum algorithm {algo} is not supported; use "
                         "crc32, sha1 or sha256")


def declared_algos(h: dict) -> list[tuple[str, str]]:
    """(algo, expected base64) pairs declared as request headers; raises
    for an algorithm that cannot be verified."""
    out = [(algo, h[H_PREFIX + algo]) for algo in ALGOS
           if h.get(H_PREFIX + algo)]
    for algo in UNSUPPORTED:
        if h.get(H_PREFIX + algo):
            raise _refuse(algo)
    return out


def single_algo(declared: dict, t_algos: list) -> list:
    """The one algorithm a request may declare, header and trailer
    together; more than one is InvalidRequest, as S3 answers."""
    algos = set(declared) | set(t_algos)
    if len(algos) > 1:
        raise ChecksumError("InvalidRequest", "only one checksum algorithm "
                            "may be declared per request")
    return sorted(algos)


def trailer_algos(h: dict) -> list[str]:
    """Checksum algorithms announced in x-amz-trailer."""
    out = []
    for name in (h.get("x-amz-trailer") or "").split(","):
        name = name.strip().lower()
        if not name.startswith(H_PREFIX):
            continue
        algo = name[len(H_PREFIX):]
        if algo in ALGOS:
            out.append(algo)
        elif algo in UNSUPPORTED:
            raise _refuse(algo)
    return out


class ChecksumingReader:
    """A reader that feeds every payload byte through the declared
    checksums as it passes (read and readinto alike)."""

    def __init__(self, inner, algos):
        self._inner = inner
        self._hashers = {a: new_hasher(a) for a in algos}

    def read(self, n: int) -> bytes:
        b = self._inner.read(n)
        if b:
            for hsh in self._hashers.values():
                hsh.update(b)
        return b

    def readinto(self, view) -> int:
        n = self._inner.readinto(view)
        if n:
            for hsh in self._hashers.values():
                hsh.update(view[:n])
        return n

    def b64(self, algo: str) -> str:
        return base64.b64encode(self._hashers[algo].digest()).decode()


def verify_and_meta(reader: ChecksumingReader, expected: dict) -> dict:
    """Compare the computed digests with the declared ones; returns the
    internal-metadata entries to store. `expected[algo]` is None for a
    trailer algorithm whose value never arrived."""
    meta = {}
    for algo, want in expected.items():
        got = reader.b64(algo)
        if want is None:
            raise ChecksumError("InvalidRequest", "declared trailer checksum "
                                f"{H_PREFIX}{algo} never arrived")
        if got != want:
            raise ChecksumError("XAmzContentChecksumMismatch",
                                f"{algo} checksum mismatch: computed {got}, "
                                f"declared {want}")
        meta[META_PREFIX + algo] = got
    return meta


def response_headers(internal_meta: dict) -> dict:
    """Stored checksums -> x-amz-checksum-* response headers."""
    return {H_PREFIX + algo: internal_meta[META_PREFIX + algo]
            for algo in ALGOS if internal_meta.get(META_PREFIX + algo)}

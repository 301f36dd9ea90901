"""Drive arguments: `{a...b}` ellipses, pools and erasure-set sizes.

The port's own copy of minio_tpu/topology/ellipses.py (reference
cmd/endpoint-ellipses.go:48): `/data/d{1...16}` expands to 16 drive
paths; each ellipses argument is a server pool of its own, and all the
plain arguments together form one more; a pool's drives split into
equal erasure sets of 2-16 drives, the largest size that divides the
count unless `--set-size` names one. A comma-separated argument is a
pool of exactly its endpoints (the JAX package's extension).

Only local drives are served: an `http://` endpoint names another node
of a distributed deployment, whose grid plane (remote drives, dsync
locks, peer notifications) the port does not have yet, and parse_pools
refuses it with that reason.
"""

from __future__ import annotations

import re

_ELLIPSES = re.compile(r"\{(\d+)\.\.\.(\d+)\}")

SET_SIZES = tuple(range(2, 17))   # valid erasure set sizes (reference)


def has_ellipses(spec: str) -> bool:
    return bool(_ELLIPSES.search(spec))


def expand(spec: str) -> list[str]:
    """Every `{a...b}` range of the spec expanded (cartesian, left
    first); numbers keep their zero padding: `d{01...04}` -> d01..d04."""
    m = _ELLIPSES.search(spec)
    if not m:
        return [spec]
    lo_s, hi_s = m.group(1), m.group(2)
    lo, hi = int(lo_s), int(hi_s)
    if hi < lo:
        raise ValueError(f"bad ellipses range {m.group(0)} in {spec!r}")
    width = len(lo_s) if lo_s.startswith("0") else 0
    out = []
    for i in range(lo, hi + 1):
        num = str(i).zfill(width) if width else str(i)
        out.extend(expand(spec[:m.start()] + num + spec[m.end():]))
    return out


def choose_set_size(count: int) -> int:
    """The largest valid set size (2-16) that divides the drive count;
    one drive is a one-drive set."""
    if count == 1:
        return 1
    for size in sorted(SET_SIZES, reverse=True):
        if count % size == 0:
            return size
    raise ValueError(
        f"cannot split {count} drives into sets of 2-16; "
        f"use a drive count divisible by a number in 2..16")


def split_sets(drives: list, set_size: int | None = None) -> list[list]:
    size = set_size or choose_set_size(len(drives))
    return [drives[i:i + size] for i in range(0, len(drives), size)]


def _local(spec: str) -> str:
    if spec.startswith(("http://", "https://")):
        raise ValueError(
            f"endpoint {spec!r} names a node of a distributed deployment; "
            "the port serves local drives only until its distributed "
            "plane (the grid, remote drives, dsync) is ported")
    return spec


def parse_pools(args: list[str]) -> list[list[str]]:
    """Command-line drive arguments -> pools of drive paths."""
    pools: list[list[str]] = []
    plain: list[str] = []
    for a in args:
        if "," in a:
            eps = [e for e in (s.strip() for s in a.split(",")) if e]
            if not eps:
                raise ValueError(f"empty pool spec {a!r}")
            pools.append([_local(d) for e in eps for d in expand(e)])
        elif has_ellipses(a):
            pools.append([_local(d) for d in expand(a)])
        else:
            plain.append(_local(a))
    if plain:
        pools.append(plain)
    return pools

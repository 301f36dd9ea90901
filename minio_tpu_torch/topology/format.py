"""format.json: drive identity and set layout, quorum-verified at boot.

The port of minio_tpu/topology/format.py (reference formatErasureV3,
cmd/format-erasure.go:112-126, cmd/prepare-storage.go), with the same
JSON: every drive stores the deployment id, the sets layout (a matrix of
drive UUIDs) and its own UUID ("this"). At boot the layouts are
quorum-compared and the drives ordered into their format positions, so
shuffled command-line arguments cannot scramble shard placement; a fresh
drive is adopted into the slot of a missing UUID and marked healing (a
replaced drive), and a drive carrying a foreign identity is refused.
The port's server keeps one set of all its drives, so it writes a
one-set layout; pools and multi-set layouts are not ported yet.
"""

from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass
from typing import Optional, Sequence

FORMAT_VERSION = "1"
FORMAT_BACKEND = "xl"
XL_VERSION = "3"
DIST_ALGO = "SIPMOD+PARITY"


class FormatError(Exception):
    pass


@dataclass
class FormatInfo:
    deployment_id: str
    sets: list[list[str]]      # sets x drives-per-set of drive UUIDs
    this: str                  # this drive's UUID

    def to_json(self) -> dict:
        return {
            "version": FORMAT_VERSION,
            "format": FORMAT_BACKEND,
            "id": self.deployment_id,
            "xl": {
                "version": XL_VERSION,
                "this": self.this,
                "sets": self.sets,
                "distributionAlgo": DIST_ALGO,
            },
        }

    @classmethod
    def from_json(cls, m: dict) -> "FormatInfo":
        try:
            if m["format"] != FORMAT_BACKEND or m["version"] != FORMAT_VERSION:
                raise FormatError(f"unsupported format {m.get('format')!r}")
            xl = m["xl"]
            return cls(deployment_id=m["id"],
                       sets=[list(s) for s in xl["sets"]], this=xl["this"])
        except (KeyError, TypeError) as e:
            raise FormatError(f"malformed format.json: {e}") from None


def init_formats(disks: Sequence, set_size: int,
                 deployment_id: Optional[str] = None) -> list[FormatInfo]:
    """First boot: fresh UUIDs, format.json written on every drive."""
    n = len(disks)
    if n % set_size:
        raise FormatError(f"{n} drives not divisible into sets of {set_size}")
    deployment_id = deployment_id or str(uuid_mod.uuid4())
    uuids = [str(uuid_mod.uuid4()) for _ in range(n)]
    sets = [uuids[i:i + set_size] for i in range(0, n, set_size)]
    fmts = []
    for i, d in enumerate(disks):
        fmt = FormatInfo(deployment_id=deployment_id, sets=sets,
                         this=uuids[i])
        d.write_format(fmt.to_json())
        fmts.append(fmt)
    return fmts


def _layout_key(f: FormatInfo) -> tuple:
    return f.deployment_id, tuple(tuple(s) for s in f.sets)


def load_and_order(disks: Sequence, set_size: int) -> tuple[list, FormatInfo]:
    """Boot an existing or partial layout: (ordered drives, the quorum
    format with this=""). ordered[i] is the drive whose UUID holds
    position i of the flattened layout, None where that drive is
    missing or refused. A fresh (formatless) drive takes a missing
    position, gets that slot's format.json and a healing marker; a drive
    whose format disagrees with the quorum layout is refused and never
    written. FormatError when no layout has a majority of the drives;
    callers init only when every drive is fresh (a half-wiped set must
    not be re-initialized)."""
    read: list[Optional[FormatInfo]] = []
    for d in disks:
        try:
            raw = d.read_format()
            read.append(FormatInfo.from_json(raw) if raw else None)
        except Exception:  # noqa: BLE001 - corrupt or unreachable: absent
            read.append(None)

    if all(f is None for f in read):
        raise FormatError("all drives are fresh (no format.json)")

    votes: dict[tuple, int] = {}
    for f in read:
        if f is not None:
            votes[_layout_key(f)] = votes.get(_layout_key(f), 0) + 1
    (dep_id, layout), count = max(votes.items(), key=lambda kv: kv[1])
    if count < len(disks) // 2 + 1:
        raise FormatError(
            f"no format quorum: best layout has {count}/{len(disks)} votes")
    flat = [u for s in layout for u in s]
    if len(flat) != len(disks):
        raise FormatError(
            f"layout describes {len(flat)} drives, {len(disks)} given")
    if any(len(s) != set_size for s in layout):
        raise FormatError("layout set size disagrees with requested topology")

    ref = FormatInfo(deployment_id=dep_id, sets=[list(s) for s in layout],
                     this="")
    by_uuid = {}
    fresh = []
    for d, f in zip(disks, read):
        if f is None:
            fresh.append(d)
        elif _layout_key(f) == (dep_id, layout):
            by_uuid[f.this] = d
        # else: a foreign drive, refused and left untouched.

    ordered: list = []
    for pos, u in enumerate(flat):
        d = by_uuid.get(u)
        if d is None and fresh:
            d = fresh.pop(0)
            fmt = FormatInfo(deployment_id=dep_id,
                             sets=[list(s) for s in layout], this=u)
            try:
                d.write_format(fmt.to_json())
            except Exception:  # noqa: BLE001 - unwritable drive
                d = None
            if d is not None:
                # A fresh drive in a formatted slot is a replaced drive:
                # it misses every object committed before. The marker
                # makes the drive lifecycle manager run (or resume) its
                # bulk heal; reads meanwhile rebuild around it and
                # writes land on it at once.
                _mark_fresh_healing(d, pos, set_size)
        ordered.append(d)
    return ordered, ref


def _mark_fresh_healing(d, pos: int, set_size: int) -> None:
    """The healing marker of a drive adopted at boot (the reference's
    initHealingTracker, cmd/background-newdisks-heal-ops.go). Best
    effort: without it the scanner's heals still converge, only the
    checkpointed bulk heal does not start."""
    try:
        from minio_tpu_torch.object.drive_heal import mark_healing
        mark_healing(d, pos // set_size, pos % set_size,
                     getattr(d, "endpoint", ""))
    except Exception:  # noqa: BLE001 - the marker is an optimisation
        pass


def _safe_read(d) -> Optional[dict]:
    try:
        return d.read_format()
    except Exception:  # noqa: BLE001 - corrupt or unreachable == absent
        return None


def boot(disks: Sequence, set_size: int,
         deployment_id: Optional[str] = None) -> tuple[list, FormatInfo]:
    """init_formats on an all-fresh layout, load_and_order otherwise."""
    if all(_safe_read(d) is None for d in disks):
        fmts = init_formats(disks, set_size, deployment_id)
        return list(disks), FormatInfo(
            deployment_id=fmts[0].deployment_id, sets=fmts[0].sets, this="")
    return load_and_order(disks, set_size)

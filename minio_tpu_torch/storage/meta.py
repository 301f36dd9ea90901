"""Object metadata: the per-object version journal ("xl.meta" analogue).

The port of minio_tpu/storage/meta.py for the slice: the same version
journal semantics (latest-first versions, per-version data dirs, inline
shard data for small objects, reference cmd/xl-storage-format-v2.go) and
the same version-map fields, stored as JSON instead of msgpack:

    b"XTJ1" + JSON {"versions": [version-map, ...],
                    "inline": {version_id: base64(framed shard bytes)}}

`from_reference_map` carries a journal written by the TPU package (the
dict minio_tpu.storage.meta decodes from an XTP1 xl.meta) across, so the
port serves drive sets the TPU package wrote.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import time
import uuid as uuid_mod
from typing import Optional

MAGIC = b"XTJ1"

KIND_OBJECT = 1
KIND_DELETE_MARKER = 2

NULL_VERSION_ID = "null"


def new_uuid() -> str:
    return str(uuid_mod.uuid4())


def now_ns() -> int:
    return time.time_ns()


@dataclasses.dataclass
class ErasureInfo:
    """Per-disk erasure layout of one version (reference: ErasureInfo,
    cmd/storage-datatypes.go)."""
    algorithm: str = "rs-vandermonde"
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = 0
    index: int = 0               # 1-based shard index held by this disk
    distribution: tuple[int, ...] = ()
    checksums: list[dict] = dataclasses.field(default_factory=list)

    def to_map(self) -> dict:
        return {"alg": self.algorithm, "k": self.data_blocks,
                "m": self.parity_blocks, "bs": self.block_size,
                "idx": self.index, "dist": list(self.distribution),
                "cks": list(self.checksums)}

    @classmethod
    def from_map(cls, m: dict) -> "ErasureInfo":
        return cls(algorithm=m.get("alg", ""), data_blocks=m.get("k", 0),
                   parity_blocks=m.get("m", 0), block_size=m.get("bs", 0),
                   index=m.get("idx", 0),
                   distribution=tuple(m.get("dist", ())),
                   checksums=list(m.get("cks", ())))


@dataclasses.dataclass
class ObjectPartInfo:
    """One part of a version: every field of the JAX package's part map,
    so a carried journal keeps them all. `nonce` is an encrypted part's
    base nonce (base64), "" for a plain part (and always, until the port
    has SSE)."""
    number: int
    size: int
    actual_size: int
    mod_time: int = 0
    etag: str = ""
    nonce: str = ""

    def to_map(self) -> dict:
        m = {"n": self.number, "s": self.size, "as": self.actual_size,
             "mt": self.mod_time, "etag": self.etag}
        if self.nonce:
            m["nc"] = self.nonce
        return m

    @classmethod
    def from_map(cls, m: dict) -> "ObjectPartInfo":
        return cls(number=m["n"], size=m["s"], actual_size=m.get("as", m["s"]),
                   mod_time=m.get("mt", 0), etag=m.get("etag", ""),
                   nonce=m.get("nc", ""))


@dataclasses.dataclass
class FileInfo:
    """One version of one object as seen by one disk (reference:
    FileInfo, cmd/storage-datatypes.go:191): the unit quorum compares."""
    volume: str = ""
    name: str = ""
    version_id: str = ""         # "" == null version
    is_latest: bool = True
    deleted: bool = False        # delete marker
    data_dir: str = ""
    mod_time: int = 0            # ns since epoch
    size: int = 0
    metadata: dict = dataclasses.field(default_factory=dict)
    parts: list[ObjectPartInfo] = dataclasses.field(default_factory=list)
    erasure: ErasureInfo = dataclasses.field(default_factory=ErasureInfo)
    inline_data: Optional[bytes] = None

    def storage_version_id(self) -> str:
        return self.version_id or NULL_VERSION_ID

    def to_version_map(self) -> dict:
        v = {"kind": KIND_DELETE_MARKER if self.deleted else KIND_OBJECT,
             "vid": self.storage_version_id(), "mt": self.mod_time,
             "meta": dict(self.metadata)}
        if not self.deleted:
            v.update({"ddir": self.data_dir, "size": self.size,
                      "parts": [p.to_map() for p in self.parts],
                      "ec": self.erasure.to_map(),
                      "inline": self.inline_data is not None})
        return v


class MetaError(Exception):
    pass


class FileNotFoundErr(MetaError):
    pass


class VersionNotFoundErr(MetaError):
    pass


class XLMeta:
    """The parsed version journal of one object path on one disk."""

    def __init__(self) -> None:
        self.versions: list[dict] = []        # sorted latest-first
        self.inline: dict[str, bytes] = {}    # version_id -> shard bytes

    def dump(self) -> bytes:
        doc = {"versions": self.versions,
               "inline": {vid: base64.b64encode(b).decode("ascii")
                          for vid, b in self.inline.items()}}
        return MAGIC + json.dumps(doc, separators=(",", ":")).encode()

    @classmethod
    def load(cls, blob: bytes) -> "XLMeta":
        if len(blob) < 4 or blob[:4] != MAGIC:
            raise MetaError("bad object metadata magic")
        try:
            doc = json.loads(blob[4:])
        except ValueError as e:
            raise MetaError(f"corrupt object metadata: {e}") from None
        x = cls()
        x.versions = list(doc.get("versions", ()))
        x.inline = {vid: base64.b64decode(b)
                    for vid, b in doc.get("inline", {}).items()}
        return x

    def _sort(self) -> None:
        self.versions.sort(key=lambda v: (v["mt"], v["vid"]), reverse=True)

    def _find(self, vid: str) -> Optional[dict]:
        for v in self.versions:
            if v["vid"] == vid:
                return v
        return None

    def add_version(self, fi: FileInfo) -> str:
        """Insert/replace a version. Returns the replaced entry's data_dir
        ("" if none or still shared) so callers reclaim its shard files."""
        vid = fi.storage_version_id()
        old = self._find(vid)
        old_ddir = ""
        if old is not None:
            self.versions.remove(old)
            self.inline.pop(vid, None)
            old_ddir = old.get("ddir", "") or ""
        self.versions.append(fi.to_version_map())
        if fi.inline_data is not None:
            self.inline[vid] = bytes(fi.inline_data)
        self._sort()
        if old_ddir and old_ddir != fi.data_dir and \
                self.shared_data_dir_count(vid, old_ddir) == 0:
            return old_ddir
        return ""

    def version_unchanged(self, fi: FileInfo) -> bool:
        """True when add_version(fi) would change nothing: the resident
        entry of fi's version id equals fi's version map and its inline
        bytes (a heal or MRF rewrite of an agreeing copy then skips the
        journal rewrite)."""
        vid = fi.storage_version_id()
        old = self._find(vid)
        if old is None or old != fi.to_version_map():
            return False
        want = bytes(fi.inline_data) if fi.inline_data is not None \
            else None
        return self.inline.get(vid) == want

    def delete_version(self, version_id: str) -> str:
        """Remove a version; returns its data_dir ("" if none/inline)."""
        vid = version_id or NULL_VERSION_ID
        v = self._find(vid)
        if v is None:
            raise VersionNotFoundErr(vid)
        self.versions.remove(v)
        self.inline.pop(vid, None)
        ddir = v.get("ddir", "") if not v.get("inline") else ""
        if ddir and self.shared_data_dir_count(vid, ddir):
            return ""
        return ddir

    def shared_data_dir_count(self, vid: str, data_dir: str) -> int:
        """How many other versions reference data_dir."""
        return sum(1 for v in self.versions
                   if v.get("ddir") == data_dir and v["vid"] != vid)

    def to_fileinfo(self, volume: str, name: str, version_id: str = "",
                    read_data: bool = False) -> FileInfo:
        """Resolve a version (default: the latest) into a FileInfo. The
        latest version of an object whose latest is a delete marker
        comes back deleted=True; a named version that is absent raises
        VersionNotFoundErr."""
        if not self.versions:
            raise FileNotFoundErr(f"{volume}/{name}")
        if version_id:
            v = self._find(version_id)
            if v is None:
                raise VersionNotFoundErr(version_id)
        else:
            v = self.versions[0]
        return self._map_to_fileinfo(v, volume, name, read_data)

    def _map_to_fileinfo(self, v: dict, volume: str, name: str,
                         read_data: bool) -> FileInfo:
        vid = v["vid"]
        fi = FileInfo(volume=volume, name=name,
                      version_id="" if vid == NULL_VERSION_ID else vid,
                      is_latest=self.versions[0] is v,
                      deleted=v["kind"] == KIND_DELETE_MARKER,
                      mod_time=v["mt"], metadata=dict(v.get("meta", {})))
        if fi.deleted:
            return fi
        fi.data_dir = v.get("ddir", "")
        fi.size = v.get("size", 0)
        fi.parts = [ObjectPartInfo.from_map(p) for p in v.get("parts", ())]
        fi.erasure = ErasureInfo.from_map(v.get("ec", {}))
        if v.get("inline"):
            fi.inline_data = self.inline.get(vid, b"") if read_data else b""
        return fi

    def list_versions(self, volume: str, name: str) -> list[FileInfo]:
        """Every version, latest first, without inline data."""
        return [self._map_to_fileinfo(v, volume, name, read_data=False)
                for v in self.versions]


def _plain(x):
    """msgpack-decoded values -> JSON-able ones (tuples to lists)."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


_VERSION_KEYS = ("kind", "vid", "mt", "ddir", "size", "meta", "parts",
                 "ec", "inline")


def from_reference_map(m: dict) -> XLMeta:
    """One TPU-package journal (the dict minio_tpu.storage.meta decodes
    from an XTP1 xl.meta: {"versions": [...], "inline": {vid: bytes}})
    -> the port's journal, field for field. The shard files it points
    at are byte-identical between the two packages and stay in place."""
    x = XLMeta()
    for v in m.get("versions", ()):
        x.versions.append({k: _plain(v[k]) for k in _VERSION_KEYS if k in v})
    x.inline = {str(vid): bytes(b) for vid, b in m.get("inline", {}).items()}
    x._sort()
    return x

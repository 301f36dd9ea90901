"""Per-version summaries of the version journal for the listing walk.

The port of minio_tpu/storage/meta_scan.py over the port's JSON journal
(storage/meta.py). A listing needs a handful of fields of each version;
the walk stream (object/metacache.py) carries them as a trimmed summary
instead of a parsed journal, so a stream of a large bucket holds tuples,
not dict trees. Summary format: a tuple of per-version 8-tuples, latest
first, as stored in the journal:

    (flags, mod_time, size, version_id, data_dir, etag, content_type,
     tags)

flags: 1 = delete marker, 2 = inline, 4 = metadata past the summary
(the version's metadata holds keys beyond etag, content-type and
x-amz-tagging, so a listing must read the full journal for this key).
A journal of more than MTPU_META_SCAN_MAXV (default 8) versions is not
summarized: it takes the full parse.

The JAX package summarizes batches of journals in its native library and
falls back to its Python parser per blob; this module is that Python
path, field for field, and every blob goes through it. `counters` keeps
the blobs that came out as a sufficient summary ("summaries") apart
from those whose listing entry needs the full journal ("fallback": not
parseable, not summarizable, or metadata past the summary).
"""

from __future__ import annotations

import json
from typing import Optional

from minio_tpu_torch.storage.meta import MAGIC, MetaError
from minio_tpu_torch.utils.env import env_int

FLAG_DELETED = 1
FLAG_INLINE = 2
FLAG_EXTRA = 4

# The shallow walk's prefix marker (LocalStorage.walk_scan(shallow=True)
# yields it in place of a summary for a key prefix with keys below).
PREFIX_MARK = ("__prefix__",)

_CAPTURED_META = ("etag", "content-type", "x-amz-tagging")


MAXV = env_int("MTPU_META_SCAN_MAXV", 8)

# Blobs summarized sufficiently vs blobs whose listing entry needs the
# full journal (GIL-atomic enough for counters, as the JAX package's).
counters = {"summaries": 0, "fallback": 0}


def _summarize_versions(versions: list, maxv: int) -> Optional[tuple]:
    if len(versions) > maxv:
        return None
    out = []
    for v in versions:
        kind = v.get("kind")
        if kind not in (1, 2):
            return None
        vid, mt = v.get("vid"), v.get("mt")
        if not isinstance(vid, str) or not isinstance(mt, int):
            return None
        flags = FLAG_DELETED if kind == 2 else 0
        if v.get("inline"):
            flags |= FLAG_INLINE
        cap = {}
        for k, val in (v.get("meta") or {}).items():
            if k in _CAPTURED_META and isinstance(val, str):
                cap[k] = val
            else:
                flags |= FLAG_EXTRA
        out.append((flags, mt, v.get("size", 0) or 0, vid,
                    v.get("ddir", "") or "", cap.get("etag", ""),
                    cap.get("content-type", ""),
                    cap.get("x-amz-tagging", "")))
    return tuple(out)


def _versions_of(blob: bytes) -> list:
    """The journal's version maps, without decoding its inline shard
    data (which a summary never reads)."""
    if len(blob) < 4 or blob[:4] != MAGIC:
        raise MetaError("bad object metadata magic")
    try:
        doc = json.loads(blob[4:])
    except ValueError as e:
        raise MetaError(f"corrupt object metadata: {e}") from None
    versions = doc.get("versions", ()) if isinstance(doc, dict) else None
    if not isinstance(versions, list) or \
            not all(isinstance(v, dict) for v in versions):
        raise MetaError("corrupt object metadata: no version list")
    return versions


def scan_blob(blob: bytes, maxv: Optional[int] = None) -> Optional[tuple]:
    """One journal's summary, or None when it does not parse or is not
    summarizable; counted in `counters`."""
    try:
        vlist = _summarize_versions(_versions_of(blob),
                                    MAXV if maxv is None else maxv)
    except MetaError:
        vlist = None
    if vlist is None or not summary_sufficient(vlist):
        counters["fallback"] += 1
    else:
        counters["summaries"] += 1
    return vlist


def summary_sufficient(vlist: tuple) -> bool:
    """Whether the summary alone serves listings of this key (no version
    needs the full journal's metadata)."""
    return all(not (v[0] & FLAG_EXTRA) for v in vlist)


def scan_entry(blob: bytes, maxv: Optional[int] = None) -> tuple:
    """(vlist, blob or None) for one walked journal: the blob rides
    along when there is no summary or the summary does not suffice (the
    JAX package's BlobScanner policy)."""
    vlist = scan_blob(blob, maxv)
    if vlist is None or not summary_sufficient(vlist):
        return vlist, blob
    return vlist, None

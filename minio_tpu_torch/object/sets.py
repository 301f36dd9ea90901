"""One pool's erasure sets: every object key hashed to one set.

The port of minio_tpu/object/sets.py (reference erasureSets,
cmd/erasure-sets.go:51): a pool's drives form equal-width erasure sets,
and each object key routes to exactly one of them by SipHash-mod under
the deployment id (cmd/erasure-sets.go:663-701 sipHashMod/getHashedSet),
the JAX package's placement byte for byte. Bucket operations fan out to
every set; listings run one page a set concurrently, each on its set's
metacache walk stream, and merge.
"""

from __future__ import annotations

import threading
import time
import uuid as uuid_mod
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from minio_tpu_torch.object.erasure_object import versioning_state_of
from minio_tpu_torch.object.types import (BucketExists, BucketNotEmpty,
                                          BucketNotFound, ListObjectsInfo)
from minio_tpu_torch.utils.siphash import sip_hash_mod

FREE_SPACE_TTL = 1.0            # seconds a pool's free-space reading holds


def merge_list_pages(pages: Sequence[ListObjectsInfo], max_keys: int,
                     versioned: bool = False) -> ListObjectsInfo:
    """Per-set (or per-pool) listing pages -> one page
    (minio_tpu/object/sets.py `merge_list_pages`). Entries dedup by key
    (and version id when `versioned`): while a pool migration runs the
    same version is in the source and the destination pool, and the
    page given first (pool search order, destinations first) wins.

    A truncated page is complete only up to its next_marker, so nothing
    past the least such marker is listed yet: the merged page ends
    there at the latest (with a full page it ends sooner, as the JAX
    package's does), and the next page starts from it."""
    bound = min((p.next_marker for p in pages
                 if p.is_truncated and p.next_marker), default=None)
    items: list[tuple[str, str, object]] = []
    seen_prefixes: set[str] = set()
    seen: set[tuple] = set()
    for page in pages:
        for o in page.objects:
            vkey = (o.name, o.version_id) if versioned else (o.name,)
            if vkey in seen or (bound is not None and o.name > bound):
                continue
            seen.add(vkey)
            items.append((o.name, "o", o))
        for p in page.prefixes:
            if p not in seen_prefixes and (bound is None or p <= bound):
                seen_prefixes.add(p)
                items.append((p, "p", p))
    items.sort(key=lambda it: it[0])
    out = ListObjectsInfo()
    for name, kind, val in items[:max_keys]:
        (out.objects if kind == "o" else out.prefixes).append(val)
    if len(items) > max_keys:
        out.is_truncated = True
        out.next_marker = items[max_keys - 1][0]
    elif bound is not None:
        out.is_truncated = True
        out.next_marker = bound
    return out


class ErasureSets:
    """The object layer over one pool's erasure sets."""

    def __init__(self, sets: Sequence, deployment_id: str = ""):
        self.sets = list(sets)
        self.deployment_id = deployment_id or str(uuid_mod.uuid4())
        self._id_bytes = uuid_mod.UUID(self.deployment_id).bytes
        self._free = (float("-inf"), 0)      # (monotonic time, bytes)
        # The listing fan-out (lazy), shared by concurrent listings.
        self._list_pool: Optional[ThreadPoolExecutor] = None
        self._list_pool_mu = threading.Lock()

    # -- routing -------------------------------------------------------

    def set_index(self, object_: str) -> int:
        return sip_hash_mod(object_, len(self.sets), self._id_bytes)

    def set_for(self, object_: str):
        return self.sets[self.set_index(object_)]

    @property
    def disks(self) -> list:
        return [d for s in self.sets for d in s.disks]

    def free_space(self) -> int:
        """The pool's free bytes (drives that answer), read at most once
        a FREE_SPACE_TTL: placement asks on every new key, and a drive's
        disk info a call each would cost a small PUT more than its
        commit (the reference caches a drive's DiskInfo the same way,
        cmd/xl-storage.go diskInfoCache)."""
        now = time.monotonic()
        at, total = self._free
        if now - at < FREE_SPACE_TTL:
            return total
        total = 0
        for d in self.disks:
            try:
                total += d.disk_info().free
            except Exception:  # noqa: BLE001 - an offline drive
                pass
        self._free = (now, total)
        return total

    # -- buckets (every set) -------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        exists = 0
        for s in self.sets:
            try:
                s.make_bucket(bucket)
            except BucketExists:
                exists += 1
        if exists == len(self.sets):
            raise BucketExists(bucket)

    def bucket_exists(self, bucket: str) -> bool:
        return any(s.bucket_exists(bucket) for s in self.sets)

    def list_buckets(self) -> list:
        seen: dict[str, object] = {}
        for s in self.sets:
            for b in s.list_buckets():
                if b.name not in seen or b.created < seen[b.name].created:
                    seen[b.name] = b
        return [seen[k] for k in sorted(seen)]

    def bucket_empty(self, bucket: str) -> bool:
        """No set holds a version of any key of the bucket."""
        for s in self.sets:
            try:
                if s.list_objects(bucket, max_keys=1,
                                  include_versions=True).objects:
                    return False
            except BucketNotFound:
                continue
        return True

    def delete_bucket(self, bucket: str) -> None:
        """Refused (BucketNotEmpty) unless every set's share is empty,
        before any set drops the bucket."""
        if not self.bucket_empty(bucket):
            raise BucketNotEmpty(bucket)
        missing = 0
        for s in self.sets:
            try:
                s.delete_bucket(bucket)
            except BucketNotFound:
                missing += 1
        if missing == len(self.sets):
            raise BucketNotFound(bucket)

    # -- bucket metadata (each set holds its copy) ---------------------

    def get_bucket_meta(self, bucket: str) -> dict:
        for s in self.sets:
            meta = s.get_bucket_meta(bucket)
            if meta:
                return meta
        return {}

    def bucket_versioning(self, bucket: str) -> bool:
        return bool(self.get_bucket_meta(bucket).get("versioning"))

    def versioning_state(self, bucket: str) -> str:
        return versioning_state_of(self.get_bucket_meta(bucket))

    def set_bucket_versioning(self, bucket: str, status) -> None:
        for s in self.sets:
            s.set_bucket_versioning(bucket, status)

    def invalidate_bucket_meta(self, bucket: str = "") -> None:
        for s in self.sets:
            s.invalidate_bucket_meta(bucket)

    # -- objects (the key's set) ---------------------------------------

    def put_object(self, bucket, object_, *args, **kw):
        return self.set_for(object_).put_object(bucket, object_, *args, **kw)

    def get_object(self, bucket, object_, *args, **kw):
        return self.set_for(object_).get_object(bucket, object_, *args, **kw)

    def get_object_stream(self, bucket, object_, *args, **kw):
        return self.set_for(object_).get_object_stream(bucket, object_,
                                                       *args, **kw)

    def get_object_info(self, bucket, object_, *args, **kw):
        return self.set_for(object_).get_object_info(bucket, object_,
                                                     *args, **kw)

    def delete_object(self, bucket, object_, *args, **kw):
        return self.set_for(object_).delete_object(bucket, object_,
                                                   *args, **kw)

    def list_versions_all(self, bucket, object_):
        return self.set_for(object_).list_versions_all(bucket, object_)

    def heal_object(self, bucket, object_, *args, **kw):
        return self.set_for(object_).heal_object(bucket, object_,
                                                 *args, **kw)

    # -- multipart (the key's set) -------------------------------------

    def new_multipart_upload(self, bucket, object_, *args, **kw):
        return self.set_for(object_).new_multipart_upload(bucket, object_,
                                                          *args, **kw)

    def put_object_part(self, bucket, object_, *args, **kw):
        return self.set_for(object_).put_object_part(bucket, object_,
                                                     *args, **kw)

    def complete_multipart_upload(self, bucket, object_, *args, **kw):
        return self.set_for(object_).complete_multipart_upload(
            bucket, object_, *args, **kw)

    def abort_multipart_upload(self, bucket, object_, *args, **kw):
        return self.set_for(object_).abort_multipart_upload(
            bucket, object_, *args, **kw)

    def list_parts(self, bucket, object_, *args, **kw):
        return self.set_for(object_).list_parts(bucket, object_, *args, **kw)

    def list_multipart_uploads(self, bucket: str, prefix: str = "") -> list:
        out = []
        for s in self.sets:
            out.extend(s.list_multipart_uploads(bucket, prefix))
        out.sort(key=lambda r: (r.get("object", ""), r.get("initiated", 0)))
        return out

    # -- listing (one page a set, merged) ------------------------------

    def _listing_pool(self) -> ThreadPoolExecutor:
        with self._list_pool_mu:
            if self._list_pool is None:
                # Several concurrent listings' fan-outs, not one.
                self._list_pool = ThreadPoolExecutor(
                    max_workers=min(32, 4 * len(self.sets)),
                    thread_name_prefix="sets-list")
            return self._list_pool

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000,
                     include_versions: bool = False) -> ListObjectsInfo:
        def one(s):
            return s.list_objects(bucket, prefix=prefix, marker=marker,
                                  delimiter=delimiter, max_keys=max_keys,
                                  include_versions=include_versions)

        if len(self.sets) == 1:
            return one(self.sets[0])
        futs = [self._listing_pool().submit(one, s) for s in self.sets]
        pages = []
        for f in futs:
            try:
                pages.append(f.result())
            except BucketNotFound:
                continue
        if not pages:
            raise BucketNotFound(bucket)
        return merge_list_pages(pages, max(1, min(max_keys, 1000)),
                                versioned=include_versions)

    # -- healing and shutdown ------------------------------------------

    def heal_bucket(self, bucket: str) -> dict:
        out = {"bucket": bucket, "missing": 0, "healed": 0}
        for s in self.sets:
            try:
                r = s.heal_bucket(bucket)
            except Exception:  # noqa: BLE001 - a set without the bucket
                continue
            out["missing"] += r.get("missing", 0)
            out["healed"] += r.get("healed", 0)
        return out

    def close(self) -> None:
        with self._list_pool_mu:
            if self._list_pool is not None:
                self._list_pool.shutdown(wait=False)
                self._list_pool = None
        for s in self.sets:
            s.close()


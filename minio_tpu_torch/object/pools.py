"""Server pools: the object layer over one or more pools of erasure sets.

The port of minio_tpu/object/pools.py (reference erasureServerPools,
cmd/erasure-server-pool.go:52). Each pool is an object/sets.ErasureSets
over its own drives and set layout, the unit a deployment grows by. A
new key lands in the pool with the most free space unless some version
of it already lives in a pool (cmd/erasure-server-pool.go:1084
PutObject, :1095 getPoolIdx); reads and deletes search the pools in
order, draining pools last; listings merge the pools' pages.

The decommission and rebalance entry points drive object/decom.py and
object/rebalance.py. Their walks run in this process: the coordinator
lease and the fleet-sharded page dispatch of a distributed deployment,
and the elastic janitor that resumes an orphaned walk there, come with
the port's distributed plane.
"""

from __future__ import annotations

import json
import threading
from typing import Optional, Sequence

from minio_tpu_torch.object.multipart import _read_upload
from minio_tpu_torch.object.sets import merge_list_pages
from minio_tpu_torch.object.types import (BucketExists, BucketNotEmpty,
                                          BucketNotFound, DeleteOptions,
                                          ListObjectsInfo, MethodNotAllowed,
                                          ObjectNotFound, UploadNotFound,
                                          VersionNotFound)

_MISSES = (ObjectNotFound, VersionNotFound)


class DecomUnavailable(Exception):
    """Every pool is draining: no placement target exists."""


def layer_sets(layer) -> list:
    """Every erasure set of an object layer, pool by pool. The server
    boots a ServerPools; a front end built over a lone ErasureSet (the
    in-process tools) is its one set."""
    return list(layer.sets) if hasattr(layer, "sets") else [layer]


class ServerPools:
    """The top-level object layer over one or more pools."""

    def __init__(self, pools: Sequence):
        if not pools:
            raise ValueError("at least one pool required")
        self.pools = list(pools)
        # Pools being drained (object/decom.py): out of new placement,
        # searched last, so reads prefer the destination's copy.
        self.decommissioning: set[int] = set()
        self._decom = None
        self._rebalance = None
        self._rebal_mu = threading.Lock()
        # The foreground pressure probe a migration walk yields to
        # (decom.MigrationGovernor); the server wires admission's.
        self.migration_pressure = None
        # A pre-forked fleet (io/workers.py) wires a shared generation
        # here: a drain's start and end bump it, and a worker that sees
        # it move re-reads the drained pools from the persisted document
        # before it places or searches a key.
        self.decom_gen = None
        # Held across the generation's check and the re-read: a thread
        # that sees no change while another re-reads waits for that
        # re-read instead of placing with the drains it knew before.
        self._drain_sync_mu = threading.Lock()
        # Pools spanning nodes (server.boot): the migration walks need
        # the peer plane's coordinator lease, which is not ported.
        self.distributed = False

    @property
    def sets(self) -> list:
        """Every erasure set of every pool."""
        return [s for p in self.pools for s in p.sets]

    @property
    def disks(self) -> list:
        return [d for p in self.pools for d in p.disks]

    # -- placement -----------------------------------------------------

    def _sync_fleet_drains(self) -> None:
        gen = self.decom_gen
        if gen is None:
            return
        with self._drain_sync_mu:
            if gen.changed():
                self.sync_decommission_markers()

    def _pool_order(self) -> list[int]:
        """Search order: draining pools last, so during a decommission
        reads find the destination's (complete, maybe newer) version
        stack before the source's leftover."""
        self._sync_fleet_drains()
        if not self.decommissioning:
            return list(range(len(self.pools)))
        return [i for i in range(len(self.pools))
                if i not in self.decommissioning] + \
            sorted(self.decommissioning)

    def _pool_of_existing(self, bucket: str, object_: str) -> Optional[int]:
        """The pool already holding a version of the key, else None
        (MethodNotAllowed: its latest is a delete marker, named). Any
        other error propagates: taking a quorum loss for "not here"
        would write a second copy of the key into another pool."""
        if len(self.pools) == 1:
            return 0
        for i in self._pool_order():
            try:
                self.pools[i].get_object_info(bucket, object_)
                return i
            except MethodNotAllowed:
                return i
            except _MISSES + (BucketNotFound,):
                continue
        return None

    def _pool_for_new(self) -> int:
        self._sync_fleet_drains()
        candidates = [i for i in range(len(self.pools))
                      if i not in self.decommissioning]
        if not candidates:
            raise DecomUnavailable("every pool is decommissioning")
        if len(candidates) == 1:
            return candidates[0]
        return max(candidates, key=lambda i: self.pools[i].free_space())

    def _put_pool(self, bucket: str, object_: str) -> int:
        idx = self._pool_of_existing(bucket, object_)
        if idx is None or idx in self.decommissioning:
            # New versions go where a drain copies to; the old ones stay
            # readable in the draining pool until they move.
            return self._pool_for_new()
        return idx

    # -- buckets -------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        """Made in every pool (a pool added later gets it too);
        BucketExists only when every pool has it."""
        exists = 0
        for p in self.pools:
            try:
                p.make_bucket(bucket)
            except BucketExists:
                exists += 1
        if exists == len(self.pools):
            raise BucketExists(bucket)

    def bucket_exists(self, bucket: str) -> bool:
        return any(p.bucket_exists(bucket) for p in self.pools)

    def list_buckets(self) -> list:
        seen: dict[str, object] = {}
        for p in self.pools:
            for b in p.list_buckets():
                if b.name not in seen or b.created < seen[b.name].created:
                    seen[b.name] = b
        return [seen[k] for k in sorted(seen)]

    def delete_bucket(self, bucket: str) -> None:
        """Refused unless every pool's share is empty, before any pool
        drops the bucket."""
        if not all(p.bucket_empty(bucket) for p in self.pools):
            raise BucketNotEmpty(bucket)
        missing = 0
        for p in self.pools:
            try:
                p.delete_bucket(bucket)
            except BucketNotFound:
                missing += 1
        if missing == len(self.pools):
            raise BucketNotFound(bucket)

    def sync_buckets(self) -> int:
        """Make every bucket some pool has in each pool without it, with
        its metadata record (the versioning state): a pool added to a
        deployment starts with none, and a key placed or migrated there
        must find its bucket. Returns the buckets made."""
        made = 0
        for b in self.list_buckets():
            meta = self.get_bucket_meta(b.name)
            for p in self.pools:
                if not p.bucket_exists(b.name):
                    try:
                        p.make_bucket(b.name)
                        made += 1
                    except BucketExists:
                        pass
                for s in p.sets:
                    if meta and not s.get_bucket_meta(b.name):
                        s.set_bucket_meta(b.name, meta)
        return made

    def get_bucket_meta(self, bucket: str) -> dict:
        for p in self.pools:
            meta = p.get_bucket_meta(bucket)
            if meta:
                return meta
        return {}

    def bucket_versioning(self, bucket: str) -> bool:
        return self.pools[0].bucket_versioning(bucket)

    def versioning_state(self, bucket: str) -> str:
        return self.pools[0].versioning_state(bucket)

    def set_bucket_versioning(self, bucket: str, status) -> None:
        for p in self.pools:
            p.set_bucket_versioning(bucket, status)

    def invalidate_bucket_meta(self, bucket: str = "") -> None:
        for p in self.pools:
            p.invalidate_bucket_meta(bucket)

    # -- objects -------------------------------------------------------

    def put_object(self, bucket, object_, *args, **kw):
        return self.pools[self._put_pool(bucket, object_)].put_object(
            bucket, object_, *args, **kw)

    def _search(self, fn_name: str, bucket, object_, *args, **kw):
        last: Exception = ObjectNotFound(bucket, object_)
        for i in self._pool_order():
            try:
                return getattr(self.pools[i], fn_name)(bucket, object_,
                                                       *args, **kw)
            except _MISSES as e:
                last = e
        raise last

    def get_object(self, bucket, object_, *args, **kw):
        return self._search("get_object", bucket, object_, *args, **kw)

    def get_object_stream(self, bucket, object_, *args, **kw):
        return self._search("get_object_stream", bucket, object_,
                            *args, **kw)

    def get_object_info(self, bucket, object_, *args, **kw):
        return self._search("get_object_info", bucket, object_, *args, **kw)

    def list_versions_all(self, bucket, object_):
        return self._search("list_versions_all", bucket, object_)

    def heal_object(self, bucket, object_, *args, **kw):
        return self._search("heal_object", bucket, object_, *args, **kw)

    def delete_object(self, bucket, object_, opts=None):
        opts = opts or DeleteOptions()
        if self.decommissioning:
            if (opts.versioned or opts.null_marker) and not opts.version_id:
                # A marker stacks where a write would land: the key's
                # pool, or a survivor when that one drains (a marker
                # stamped into a draining pool would miss the walk).
                return self.pools[self._put_pool(bucket, object_)] \
                    .delete_object(bucket, object_, opts)
            # A version removal applies to every pool holding a copy:
            # mid-migration one version can be in both.
            deleted = None
            last: Exception = ObjectNotFound(bucket, object_)
            for i in self._pool_order():
                try:
                    deleted = self.pools[i].delete_object(bucket, object_,
                                                          opts)
                except _MISSES as e:
                    last = e
            if deleted is None:
                raise last
            return deleted
        # A marker lands in the pool that holds the key (reference
        # DeleteObject's pool lookup); a missing key answers from pool 0.
        idx = self._pool_of_existing(bucket, object_)
        return self.pools[idx or 0].delete_object(bucket, object_, opts)

    # -- multipart -----------------------------------------------------

    def new_multipart_upload(self, bucket, object_, *args, **kw):
        return self.pools[self._put_pool(bucket, object_)] \
            .new_multipart_upload(bucket, object_, *args, **kw)

    def _upload_pool(self, bucket, object_, upload_id):
        for p in self.pools:
            try:
                _read_upload(p.set_for(object_), bucket, object_, upload_id)
                return p
            except UploadNotFound:
                continue
        raise UploadNotFound(bucket, object_, upload_id)

    def put_object_part(self, bucket, object_, upload_id, *args, **kw):
        return self._upload_pool(bucket, object_, upload_id).put_object_part(
            bucket, object_, upload_id, *args, **kw)

    def complete_multipart_upload(self, bucket, object_, upload_id, parts):
        return self._upload_pool(bucket, object_, upload_id) \
            .complete_multipart_upload(bucket, object_, upload_id, parts)

    def abort_multipart_upload(self, bucket, object_, upload_id):
        return self._upload_pool(bucket, object_, upload_id) \
            .abort_multipart_upload(bucket, object_, upload_id)

    def list_parts(self, bucket, object_, upload_id, *args, **kw):
        return self._upload_pool(bucket, object_, upload_id).list_parts(
            bucket, object_, upload_id, *args, **kw)

    def list_multipart_uploads(self, bucket: str, prefix: str = "") -> list:
        out = []
        for p in self.pools:
            out.extend(p.list_multipart_uploads(bucket, prefix))
        out.sort(key=lambda r: (r.get("object", ""), r.get("initiated", 0)))
        return out

    # -- listing -------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000,
                     include_versions: bool = False) -> ListObjectsInfo:
        """Each pool's page in search order (draining pools last, so a
        version in both during a migration lists once, from the
        destination), merged."""
        if len(self.pools) == 1:
            return self.pools[0].list_objects(
                bucket, prefix=prefix, marker=marker, delimiter=delimiter,
                max_keys=max_keys, include_versions=include_versions)
        pages = []
        for i in self._pool_order():
            try:
                pages.append(self.pools[i].list_objects(
                    bucket, prefix=prefix, marker=marker,
                    delimiter=delimiter, max_keys=max_keys,
                    include_versions=include_versions))
            except BucketNotFound:
                continue
        if not pages:
            raise BucketNotFound(bucket)
        return merge_list_pages(pages, max(1, min(max_keys, 1000)),
                                versioned=include_versions)

    # -- decommission ----------------------------------------------------

    def start_decommission(self, pool_idx: int, checkpoint_every=None):
        """Drain pool `pool_idx` into the others (reference
        StartDecommission, cmd/erasure-server-pool-decom.go)."""
        from minio_tpu_torch.object import decom
        if self._decom is not None and \
                self._decom.state.get("status") == "draining" and \
                not self._decom.wait(timeout=0):
            raise decom.DecomError("a decommission is already running")
        kw = {} if checkpoint_every is None else \
            {"checkpoint_every": checkpoint_every}
        self._decom = decom.Decommission(self, pool_idx, **kw)
        self._decom.start()
        return self._decom

    def sync_decommission_markers(self) -> None:
        """The persisted decommission document's drained and draining
        pools leave placement here too."""
        from minio_tpu_torch.object import decom
        for sig, rec in decom.load_doc(self).get("records", {}).items():
            idx = decom.find_pool_by_signature(self, sig)
            if idx is not None and rec.get("status") in (
                    "draining", "failed", "complete"):
                self.decommissioning.add(idx)

    def resume_decommission(self):
        """At boot: pick an unfinished drain up (from the start when the
        run before recorded failures: the migrate is idempotent, and a
        failed key would be checkpointed past forever). Pools are found
        by their drives' signature, never by a stored index, which
        shifts once a drained pool leaves the command line. Returns the
        walk or None."""
        from minio_tpu_torch.object import decom
        self.sync_decommission_markers()
        for sig, rec in decom.load_doc(self).get("records", {}).items():
            idx = decom.find_pool_by_signature(self, sig)
            if idx is None or rec.get("status") not in ("draining",
                                                        "failed"):
                continue
            if rec.get("status") == "failed" or rec.get("failed"):
                rec.update(bucket="", marker="", failed=0)
            rec["status"] = "draining"
            rec["pool"] = idx
            self._decom = decom.Decommission(self, idx, state=rec)
            self._decom.start()
            return self._decom
        return None

    def decommission_status(self) -> Optional[dict]:
        """The live walk's state, else the persisted checkpoint (a
        worker that does not drive the walk reads this one)."""
        from minio_tpu_torch.object import decom
        d = self._decom
        if d is not None and not d.wait(timeout=0):
            return dict(d.state)
        state = decom.load_state(self)
        if state is None and d is not None:
            return dict(d.state)
        return dict(state) if state else None

    def cancel_decommission(self) -> None:
        """Pause the drain (checkpointed; a start or a boot resumes)."""
        if self._decom is not None:
            self._decom.stop()

    # -- rebalance -------------------------------------------------------

    def start_rebalance(self, checkpoint_every=None):
        """Move objects out of the pools above the average fill
        (reference rebalanceStart). Check and create under a lock: two
        admin starts must not race two walks onto one state file."""
        from minio_tpu_torch.object import rebalance
        kw = {} if checkpoint_every is None else \
            {"checkpoint_every": checkpoint_every}
        with self._rebal_mu:
            rb = self._rebalance
            if rb is not None and rb.state.get("status") in (
                    "planning", "rebalancing") and not rb.wait(timeout=0):
                raise rebalance.RebalanceError(
                    "a rebalance is already running")
            self._rebalance = rebalance.Rebalance(self, **kw)
            self._rebalance.start()
            return self._rebalance

    def resume_rebalance(self):
        """At boot: resume an interrupted rebalance from its checkpoint
        (a run killed while planning, or one whose pool count changed,
        plans again). Returns the walk or None."""
        from minio_tpu_torch.object import rebalance
        state = rebalance.load_state(self)
        if not state or state.get("status") not in ("planning",
                                                    "rebalancing"):
            return None
        if state.get("status") == "planning" or \
                len(state.get("pools", {})) != len(self.pools):
            state = None
        with self._rebal_mu:
            self._rebalance = rebalance.Rebalance(self, state=state)
            self._rebalance.start()
            return self._rebalance

    @staticmethod
    def _state_copy(rb) -> dict:
        # The walk mutates nested per-pool records meanwhile: a deep
        # copy through JSON, retried if a dict changed size under it.
        for _ in range(3):
            try:
                return json.loads(json.dumps(rb.state))
            except RuntimeError:
                continue
        return {"status": rb.state.get("status", "rebalancing")}

    def rebalance_status(self) -> Optional[dict]:
        """As decommission_status: the live walk, else the checkpoint."""
        from minio_tpu_torch.object import rebalance
        rb = self._rebalance
        if rb is not None and not rb.wait(timeout=0):
            return self._state_copy(rb)
        state = rebalance.load_state(self)
        if state is None and rb is not None:
            return self._state_copy(rb)
        return dict(state) if state else None

    def stop_rebalance(self) -> None:
        """Pause the rebalance (checkpointed; resumable)."""
        if self._rebalance is not None:
            self._rebalance.stop()

    # -- healing and shutdown --------------------------------------------

    def heal_bucket(self, bucket: str) -> dict:
        out = {"bucket": bucket, "missing": 0, "healed": 0}
        for p in self.pools:
            r = p.heal_bucket(bucket)
            out["missing"] += r["missing"]
            out["healed"] += r["healed"]
        return out

    def close(self) -> None:
        """Pause a walk in flight (checkpointed), then close the pools."""
        for walk in (self._decom, self._rebalance):
            if walk is not None:
                walk.stop()
        for p in self.pools:
            p.close()

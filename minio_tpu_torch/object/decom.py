"""Pool decommission: drain one pool's objects into the others.

The port of minio_tpu/object/decom.py (reference
cmd/erasure-server-pool-decom.go:1269 decommissionPool and its
checkpointed resume). An admin marks a pool; a background walk visits
every bucket of it and moves each key's whole version stack
(`migrate_key`: data versions re-encoded into the destination's
geometry, delete markers kept, metadata, ETags and part boundaries
verbatim through ErasureSet.restore_version) into the other pools, then
removes the source copy. Progress checkpoints go to the surviving
pools' drives (`config/decom.json` on the system volume, the JAX
package's document), so a stopped or crashed server resumes where it
left off, and either package can finish a drain the other started.

While a drain runs, new writes land in the other pools (ServerPools
leaves the pool out of placement) and reads keep succeeding: a stack is
restored at its destination before the source copy goes, and the pool
search visits destinations first. When the walk ends and a last
listing finds the pool empty, it is "complete" and the operator
restarts without its drives.

In a distributed deployment one node drives a walk: it holds the dsync
coordinator lease (`coordinator_lease`), shards each listing page's keys
over the nodes by a CRC-32 of the key (`PageDispatcher`: a peer migrates
its shard through its own object layer on a `mig.page` call and returns
counters only) and alone writes the checkpoint, so a coordinator's crash
costs at most one batch again. A peer that is down has its shard
migrated here.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Callable, Optional

from minio_tpu_torch.object.types import (DeleteOptions, GetOptions,
                                          MethodNotAllowed, ObjectNotFound,
                                          VersionNotFound)
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.utils.env import env_float, env_int

DECOM_PATH = "config/decom.json"
CHECKPOINT_EVERY = 16          # keys between checkpoint writes
# A version whose data lives in a warm tier carries this metadata key
# (minio_tpu/object/tier.py META_TIER): it migrates as its metadata.
META_TIER = "x-internal-tier-name"
YIELD_POLL_S = 0.05            # poll interval while a walk yields
RECHECK_WALKS = 3              # walks again while a drained pool holds keys


class DecomError(Exception):
    pass


class LeaseHeld(DecomError):
    """Another node holds the migration coordinator lease: it drives
    the drain (or rebalance)."""


class MigrationGovernor:
    """A migration walk is background work that yields to clients.

    gate() blocks while the front end queues (the server wires
    admission's pressure probe as layer.migration_pressure, the signal
    the bulk drive heal sheds on), counting each pause in
    state["yields"] and polling every YIELD_POLL_S. The walk runs
    MTPU_REBALANCE_WORKERS keys at once (default 1).
    """

    def __init__(self, layer, state: dict, stop: threading.Event):
        self.pressure: Optional[Callable[[], bool]] = \
            getattr(layer, "migration_pressure", None)
        self.workers = max(1, env_int("MTPU_REBALANCE_WORKERS", 1))
        self.state = state
        self._stop = stop
        self._mu = threading.Lock()

    def count(self, key: str, by: int = 1) -> None:
        self.add(self.state, key, by)

    def add(self, rec: dict, key: str, by: int = 1) -> None:
        """A counter of `rec` (a rebalance's per-pool record) bumped
        under the lock: parallel workers share it."""
        with self._mu:
            rec[key] = rec.get(key, 0) + by

    def gate(self) -> bool:
        """Pause while clients queue; False once stop() fired."""
        yielded = False
        while self.pressure is not None and self.pressure():
            if self._stop.is_set():
                return False
            if not yielded:
                yielded = True
                self.count("yields")
            time.sleep(YIELD_POLL_S)
        return not self._stop.is_set()


def pool_signature(pool) -> str:
    """A pool's identity: the hash of its sorted drive endpoints. Pool
    indices shift once a drained pool leaves the command line; a stored
    index would then name a live pool."""
    ids = [getattr(d, "endpoint", "") or getattr(d, "root", "")
           for d in pool.disks]
    return hashlib.sha256("\n".join(sorted(ids)).encode()).hexdigest()[:16]


def find_pool_by_signature(layer, sig: str) -> Optional[int]:
    """The current index of the pool with this signature, or None (it
    left the topology)."""
    for i, p in enumerate(layer.pools):
        if pool_signature(p) == sig:
            return i
    return None


def _state_disks(layer, skip_idx: int) -> list:
    """The drives of the first live surviving pool: the state must live
    neither on the pool being removed nor on one drained before."""
    for i, p in enumerate(layer.pools):
        if i != skip_idx and i not in layer.decommissioning:
            return p.disks
    for i, p in enumerate(layer.pools):
        if i != skip_idx:
            return p.disks
    raise DecomError("cannot decommission the only pool")


def load_doc(layer) -> dict:
    """The decommission document: every drain's record by pool
    signature, with a revision; the majority copy of each pool's drives,
    and of those the highest revision."""
    best: Optional[dict] = None
    for p in layer.pools:
        votes: dict[bytes, int] = {}
        for d in p.disks:
            try:
                blob = d.read_all(SYS_VOL, DECOM_PATH)
            except Exception:  # noqa: BLE001 - absent or offline
                continue
            votes[blob] = votes.get(blob, 0) + 1
        if not votes:
            continue
        try:
            doc = json.loads(max(votes.items(), key=lambda kv: kv[1])[0])
        except ValueError:
            continue
        if isinstance(doc, dict) and "records" in doc and \
                (best is None or doc.get("rev", 0) > best.get("rev", 0)):
            best = doc
    return best if best is not None else {"records": {}, "rev": 0}


def load_state(layer) -> Optional[dict]:
    """The latest drain's record, or None when none ever started."""
    records = load_doc(layer).get("records", {})
    if not records:
        return None
    return max(records.values(), key=lambda r: r.get("started_ns", 0))


def _write_doc(layer, doc: dict, skip_idx: int, scrub: bool = False) -> None:
    """The document to a majority of the first surviving pool's drives;
    `scrub` deletes the copies elsewhere (each copy holds every record,
    so nothing is lost)."""
    blob = json.dumps(doc, sort_keys=True).encode()
    disks = _state_disks(layer, skip_idx)
    ok = 0
    for d in disks:
        try:
            d.write_all(SYS_VOL, DECOM_PATH, blob)
            ok += 1
        except Exception:  # noqa: BLE001 - an offline drive
            continue
    if ok < len(disks) // 2 + 1:
        raise DecomError("could not persist decommission state to a quorum")
    if scrub:
        keep = {id(d) for d in disks}
        for d in layer.disks:
            if id(d) not in keep:
                try:
                    d.delete(SYS_VOL, DECOM_PATH)
                except Exception:  # noqa: BLE001 - absent or offline
                    pass


def coordinator_lease(layer, name: str):
    """The dsync write lease electing one fleet-wide coordinator of a
    migration ("decom" or "rebalance"), over the layer's lockers; None
    without lockers (one node needs no election). A held lease refreshes
    itself; a SIGKILLed holder's lapses after MTPU_GRID_LOCK_TTL, and a
    surviving node's elastic janitor then wins it."""
    if not layer.lockers:
        return None
    from minio_tpu_torch.grid.dsync import DRWMutex
    return DRWMutex(layer.lockers, f"{SYS_VOL}/elastic/{name}-coordinator")


def migrate_key(layer, src_idx: int, bucket: str, key: str,
                pick_dst: Callable[[], int]) -> int:
    """Move one key's whole version stack out of pool `src_idx`: the
    transfer primitive of a decommission and a rebalance. Returns the
    data bytes restored at the destination.

    Snapshot, then restore newest first (the destination's latest
    version is right at every step) with no lock held across sets (two
    sets' locks on one key share a lock stripe across the fleet:
    nesting them would deadlock), then under the source key's lock
    verify and clean up: a stack that changed meanwhile is copied again,
    a version deleted meanwhile goes from the destination too, so an
    acknowledged delete never comes back, and the source copies go only
    after everything landed. The destination
    is the pool that already holds the key, when another pool does
    (a newer write placed there), else pick_dst()."""
    src_set = layer.pools[src_idx].set_for(key)
    dst_idx = layer._pool_of_existing(bucket, key)
    if dst_idx is None or dst_idx == src_idx or \
            dst_idx in layer.decommissioning:
        dst_idx = pick_dst()
    dst_set = layer.pools[dst_idx].set_for(key)
    for _attempt in range(5):
        moved = 0
        try:
            versions = src_set.list_versions_all(bucket, key)
        except ObjectNotFound:
            return 0                # deleted mid-walk: nothing to do
        replaced = False
        for fi in sorted(versions, key=lambda f: -f.mod_time):
            data = None
            if not fi.deleted and not fi.metadata.get(META_TIER):
                try:
                    info, data = src_set.get_object(
                        bucket, key, GetOptions(version_id=fi.version_id))
                except (VersionNotFound, MethodNotAllowed, ObjectNotFound):
                    continue        # removed mid-walk
                if info.mod_time != fi.mod_time:
                    # The null version was overwritten since the
                    # snapshot: these bytes are not fi's.
                    replaced = True
                    break
            # A concurrent unversioned overwrite may have put a newer
            # null version at the destination: it wins, decided under
            # restore_version's key lock.
            dst_set.restore_version(bucket, key, fi, data,
                                    skip_if_newer_null=True)
            moved += len(data or b"")
        if replaced:
            continue
        # Caches across the fleet (fileinfo, hot objects, listing
        # walks) hold the source copy: the bump reaches them before the
        # copy goes. A refill meanwhile searches the destination first.
        src_set.metacache.bump(bucket)
        with src_set.ns.write(bucket, key):
            try:
                cur = src_set.list_versions_all(bucket, key)
            except ObjectNotFound:
                cur = []
            snap, now = _identities(versions), _identities(cur)
            if not now <= snap:
                # The stack changed mid-copy: a version was added, or an
                # unversioned overwrite replaced the null version under
                # the same id (the JAX package compares ids alone and
                # would then delete that acknowledged write): again.
                continue
            landed = set()
            if snap - now:
                try:
                    landed = _identities(dst_set.list_versions_all(bucket,
                                                                   key))
                except ObjectNotFound:
                    pass
            for ident in (snap - now) & landed:
                # Removed from the source while we copied: its restored
                # copy goes too (not a newer write under its id).
                try:
                    dst_set._delete_object_locked(
                        bucket, key, DeleteOptions(version_id=ident[0]))
                except (ObjectNotFound, VersionNotFound):
                    pass
            for fi in cur:
                try:
                    src_set._delete_object_locked(
                        bucket, key, DeleteOptions(version_id=fi.version_id))
                except (ObjectNotFound, VersionNotFound):
                    pass
            return moved
    raise DecomError(f"{bucket}/{key}: version stack kept changing")


def _identities(versions) -> set:
    """A stack's versions as (id, mod time, marker): a version replaced
    under its id (the null version) is another version."""
    return {(v.version_id, v.mod_time, v.deleted) for v in versions}


def free_space_dst(layer, exclude) -> int:
    """The pool with the most free space, leaving out `exclude` and
    every draining pool."""
    best, best_free = None, -1
    for i, p in enumerate(layer.pools):
        if i in exclude or i in layer.decommissioning:
            continue
        free = p.free_space()
        if free > best_free:
            best, best_free = i, free
    if best is None:
        raise DecomError("no destination pool available")
    return best


# mig.page batches and keys this process migrated for a coordinator on
# another node; a node's clean stop prints them.
PAGES_SERVED = {"batches": 0, "keys": 0}
_served_mu = threading.Lock()


def exec_page(layer, src_idx: int, bucket: str, keys: list,
              exclude=()) -> dict:
    """Migrate `keys` out of pool `src_idx` here, yielding to this node's
    clients between keys: the body of the `mig.page` verb and of the
    coordinator's own shard. Counters only ({migrated, failed, bytes,
    last_error}): the coordinator writes every checkpoint."""
    ex = {int(i) for i in exclude} | {int(src_idx)}
    pressure = layer.migration_pressure
    out = {"migrated": 0, "failed": 0, "bytes": 0, "last_error": None}
    for key in keys:
        while pressure is not None and pressure():
            time.sleep(YIELD_POLL_S)
        try:
            moved = migrate_key(layer, src_idx, bucket, key,
                                lambda: free_space_dst(layer, ex))
            out["migrated"] += 1
            out["bytes"] += moved
        except Exception as e:  # noqa: BLE001 - the page goes on
            out["failed"] += 1
            out["last_error"] = f"{bucket}/{key}: {e}"
    return out


def serve_page(layer, payload: dict) -> dict:
    """The `mig.page` grid verb: a coordinator's shard, counted."""
    keys = list(payload.get("keys") or ())
    out = exec_page(layer, int(payload["src"]), payload["b"], keys,
                    payload.get("ex") or ())
    with _served_mu:
        PAGES_SERVED["batches"] += 1
        PAGES_SERVED["keys"] += len(keys)
    return out


class PageDispatcher:
    """A migration walk sharded over the fleet (minio_tpu/object/decom.py):
    each batch's keys go to shard crc32(key) % (peers + 1); shard 0
    migrates here, each other one on its peer through `mig.page`, all at
    once, and the counters add up. A peer that is down, partitioned or
    without the verb gets its shard migrated here: the fleet's width
    buys speed, never correctness."""

    def __init__(self, layer, peers, timeout: Optional[float] = None):
        self.layer = layer
        self.peers = list(peers)
        self.timeout = timeout if timeout is not None else \
            env_float("MTPU_MIG_PAGE_TIMEOUT_S", 600.0)

    def run(self, src_idx: int, bucket: str, keys: list,
            exclude=()) -> dict:
        import zlib
        n = len(self.peers) + 1
        shards: list[list] = [[] for _ in range(n)]
        for k in keys:
            shards[zlib.crc32(k.encode()) % n].append(k)
        agg = {"migrated": 0, "failed": 0, "bytes": 0, "last_error": None}
        mu = threading.Lock()
        ex = sorted({int(i) for i in exclude} | {int(src_idx)})

        def merge(res: dict) -> None:
            with mu:
                for k in ("migrated", "failed", "bytes"):
                    agg[k] += int(res.get(k, 0))
                if res.get("last_error"):
                    agg["last_error"] = res["last_error"]

        def remote(i: int, shard: list) -> None:
            try:
                res = self.peers[i].call(
                    "mig.page", {"src": src_idx, "b": bucket,
                                 "keys": shard, "ex": ex},
                    timeout=self.timeout)
            except Exception:  # noqa: BLE001 - the peer is down: here
                res = exec_page(self.layer, src_idx, bucket, shard, ex)
            merge(res)

        threads = [threading.Thread(target=remote, args=(i, shard),
                                    daemon=True, name=f"mig-page-peer{i}")
                   for i, shard in enumerate(shards[1:]) if shard]
        for t in threads:
            t.start()
        if shards[0]:
            merge(exec_page(self.layer, src_idx, bucket, shards[0], ex))
        for t in threads:
            t.join()
        return agg

    def iter_batches(self, src_idx: int, bucket: str, keys: list,
                     exclude=(), gate=None, cut=None):
        """`keys` in ordered batches of MTPU_MIG_BATCH (default 8) a
        node, each dispatched over the fleet with a barrier, yielding
        (batch, counters): the caller moves its marker and checkpoints
        between batches. `gate` (the governor's) runs before each;
        `cut(batch)` may keep a leading part of it (a rebalance's byte
        target), and the next batch starts after that part."""
        width = max(1, env_int("MTPU_MIG_BATCH", 8)) * (len(self.peers) + 1)
        i = 0
        while i < len(keys):
            if gate is not None and not gate():
                return
            batch = keys[i:i + width]
            if cut is not None:
                batch = cut(batch)
                if not batch:
                    return
            i += len(batch)
            yield batch, self.run(src_idx, bucket, batch, exclude)


def page_dispatcher(layer) -> Optional[PageDispatcher]:
    """The fleet's dispatcher when the boot wired peer nodes, else None
    (one node walks alone)."""
    if not layer.migration_peers:
        return None
    return PageDispatcher(layer, layer.migration_peers)


class Decommission:
    """One pool drain, fresh or resumed from a checkpoint."""

    def __init__(self, layer, pool_idx: int, state: Optional[dict] = None,
                 checkpoint_every: int = CHECKPOINT_EVERY):
        if not 0 <= pool_idx < len(layer.pools):
            raise DecomError(f"no pool {pool_idx}")
        if not [i for i in range(len(layer.pools))
                if i != pool_idx and i not in layer.decommissioning]:
            # Draining the last placeable pool would leave every write
            # of the deployment nowhere to go.
            raise DecomError("no surviving pool to drain into")
        self.layer = layer
        self.pool_idx = pool_idx
        self.checkpoint_every = checkpoint_every
        self.state = state or {
            "pool": pool_idx, "status": "draining",
            "pool_sig": pool_signature(layer.pools[pool_idx]),
            "started_ns": time.time_ns(),
            "bucket": "", "marker": "",        # the resume checkpoint
            "migrated": 0, "failed": 0, "bytes_moved": 0, "yields": 0,
        }
        self.state.setdefault("bytes_moved", 0)
        self.state.setdefault("yields", 0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._gov = MigrationGovernor(layer, self.state, self._stop)
        # The document, loaded once: a checkpoint must not re-read every
        # drive of the deployment every few keys.
        self._doc: Optional[dict] = None
        self._lease = None

    def _persist(self, scrub: bool = False) -> None:
        if self._doc is None:
            self._doc = load_doc(self.layer)
        self.state["checkpoint_ns"] = time.time_ns()
        self._doc["records"][self.state["pool_sig"]] = self.state
        self._doc["rev"] = self._doc.get("rev", 0) + 1
        _write_doc(self.layer, self._doc, self.pool_idx, scrub=scrub)

    def _notify(self) -> None:
        """A status change reaches the fleet's other workers and, through
        on_decom_change, the other nodes, which take the pool out of
        their placement too."""
        gen = getattr(self.layer, "decom_gen", None)
        if gen is not None:
            gen.bump()
        cb = self.layer.on_decom_change
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 - must not fail the drain
                pass

    def _acquire_lease(self) -> None:
        """One node drives a drain: a lease lost mid-walk stops this one
        (checkpointed, still "draining") for the next winner to resume."""
        lease = coordinator_lease(self.layer, "decom")
        if lease is not None:
            lease.on_lost = self._stop.set
            if not lease.lock(write=True, timeout=5.0):
                raise LeaseHeld(
                    "decommission coordinator lease held by another node")
        self._lease = lease

    def _release_lease(self) -> None:
        lease, self._lease = self._lease, None
        if lease is not None:
            try:
                lease.unlock()
            except Exception:  # noqa: BLE001 - the lease may be lost
                pass

    def start(self, still_wanted=None) -> None:
        """Take the lease and walk. `still_wanted()`, asked once the
        lease is won, can still call it off (LeaseHeld): the janitor's
        check that the walk was not paused or ended while it waited."""
        self._acquire_lease()
        if still_wanted is not None and not still_wanted():
            self._release_lease()
            raise LeaseHeld("the walk was paused or ended meanwhile")
        self.state.pop("paused", None)
        # The record and the fleet's notice first, this process's
        # placement after: a key this process then places in another
        # pool is read by every worker in the same pool order (the JAX
        # package excludes the pool here first, and a sibling reading
        # before the notice finds the key's old copy in the drained
        # pool).
        try:
            self._persist(scrub=True)
        except DecomError:
            self._release_lease()
            raise
        self._notify()
        self.layer.decommissioning.add(self.pool_idx)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"decom-pool{self.pool_idx}")
        self._thread.start()

    def stop(self) -> None:
        """Pause: the status stays "draining", the progress so far is
        persisted and a resume walks on from it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self.state.get("status") == "draining":
            self.state["paused"] = True
            try:
                self._persist()
            except DecomError:
                pass
        # Only now: a janitor that won the lease before the pause was on
        # the drives would resume the walk an operator stopped.
        self._release_lease()

    def wait(self, timeout: float = 300) -> bool:
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    def _run(self) -> None:
        try:
            self._drain()
        except Exception as e:  # noqa: BLE001 - recorded, resumable
            self.state["status"] = "failed"
            self.state["error"] = str(e)
            try:
                self._persist()
            except DecomError:
                pass
        finally:
            if not self._stop.is_set():
                self._release_lease()   # stop() releases after the pause

    def _do_key(self, bucket: str, key: str) -> None:
        gov = self._gov
        if not gov.gate():
            return
        try:
            moved = migrate_key(self.layer, self.pool_idx, bucket, key,
                                lambda: free_space_dst(self.layer,
                                                       {self.pool_idx}))
            gov.count("migrated")
            gov.count("bytes_moved", moved)
        except Exception as e:  # noqa: BLE001 - the walk goes on
            gov.count("failed")
            self.state["last_error"] = f"{bucket}/{key}: {e}"

    def _drain(self) -> None:
        """Walk the pool, then check that it is empty (the reference's
        checkAfterDecom). A write that chose this pool before the
        drain's notice reached its worker can land behind the walk's
        marker: such a key is found by the check and the pool walked
        again from the start. A pool that still holds keys after
        RECHECK_WALKS more walks is "failed", never "complete"."""
        left: list = []
        for _ in range(1 + RECHECK_WALKS):
            if not self._walk():
                return                  # stopped: the checkpoint resumes
            left = self._leftover()
            if not left:
                break
            self.state["bucket"] = ""
            self.state["marker"] = ""
        if self.state["failed"] or left:
            self.state["status"] = "failed"
            if left:
                self.state["last_error"] = (
                    f"pool {self.pool_idx} still holds {len(left)} "
                    f"key(s) after the drain, first {left[0]}")
        else:
            self.state["status"] = "complete"
            self.state["finished_ns"] = time.time_ns()
        self._persist()
        self._notify()

    def _leftover(self) -> list[str]:
        """A few of the keys the pool still holds, as bucket/key."""
        src = self.layer.pools[self.pool_idx]
        left = []
        for b in src.list_buckets():
            page = src.list_objects(b.name, max_keys=4,
                                    include_versions=True)
            left += [f"{b.name}/{o.name}" for o in page.objects]
        return left

    def _walk(self) -> bool:
        """One walk from the checkpoint to the pool's end; False when
        stop() cut it."""
        from concurrent.futures import ThreadPoolExecutor
        src = self.layer.pools[self.pool_idx]
        since = 0
        gov = self._gov
        # With peer nodes each page's keys spread over the fleet; this
        # coordinator adds the counters up and writes every checkpoint.
        disp = page_dispatcher(self.layer)
        pool = ThreadPoolExecutor(
            max_workers=gov.workers,
            thread_name_prefix=f"decom{self.pool_idx}-mig") \
            if disp is None and gov.workers > 1 else None
        try:
            start_bucket = self.state.get("bucket", "")
            for bucket in sorted(b.name for b in src.list_buckets()):
                if bucket < start_bucket:
                    continue            # drained before the resume
                marker = self.state.get("marker", "") \
                    if bucket == start_bucket else ""
                while not self._stop.is_set():
                    page = src.list_objects(bucket, marker=marker,
                                            max_keys=256,
                                            include_versions=True)
                    keys = sorted({o.name for o in page.objects})
                    if disp is not None:
                        # The marker passes a batch once the whole fleet
                        # finished it: a crash walks one batch again.
                        for batch, agg in disp.iter_batches(
                                self.pool_idx, bucket, keys,
                                exclude={self.pool_idx}, gate=gov.gate):
                            gov.count("migrated", agg["migrated"])
                            gov.count("failed", agg["failed"])
                            gov.count("bytes_moved", agg["bytes"])
                            if agg["last_error"]:
                                self.state["last_error"] = agg["last_error"]
                            self.state["bucket"] = bucket
                            self.state["marker"] = batch[-1]
                            since += len(batch)
                            if since >= self.checkpoint_every:
                                since = 0
                                self._persist()
                    elif pool is not None:
                        # The marker passes only a fully done page: a
                        # crash walks at most one page again.
                        list(pool.map(lambda k: self._do_key(bucket, k),
                                      keys))
                        if keys and not self._stop.is_set():
                            self.state["bucket"] = bucket
                            self.state["marker"] = keys[-1]
                            since += len(keys)
                    else:
                        for key in keys:
                            if self._stop.is_set():
                                return False
                            self._do_key(bucket, key)
                            self.state["bucket"] = bucket
                            self.state["marker"] = key
                            since += 1
                            if since >= self.checkpoint_every:
                                since = 0
                                self._persist()
                    if self._stop.is_set():
                        return False
                    if since >= self.checkpoint_every:
                        since = 0
                        self._persist()
                    if not page.is_truncated:
                        break
                    marker = page.next_marker
                if self._stop.is_set():
                    return False
                self.state["bucket"] = bucket
                self.state["marker"] = ""
                self._persist()
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return True

"""Pool rebalance: move objects out of overfilled pools to the average.

The port of minio_tpu/object/rebalance.py (reference
cmd/erasure-server-pool-rebalance.go:100 rebalanceMeta, with the
rebalanceStart / rebalanceStatus / rebalanceStop admin verbs): the
operation an operator runs after adding an empty pool. Where a
decommission empties a pool and takes it out of placement, a rebalance
keeps every pool in service and moves just enough keys out of each pool
above the deployment's average fill into the emptier ones.

It shares object/decom.py's transfer primitive (`migrate_key`) and its
governor. Differences from a decommission, the reference's: the sources
stay in placement; each participating pool has its own walk and byte
target (it stops once at the average); destinations leave out the other
sources, so bytes never move back and forth between two full pools.
The state (`config/rebalance.json`, the JAX package's document) is
written to a majority of pool 0's drives every CHECKPOINT_EVERY keys,
and a restarted server resumes from it. In a distributed deployment the
walk takes decom's coordinator lease (named "rebalance") and shards its
pages over the nodes through decom.PageDispatcher.

Pools on one filesystem report the same free and total bytes a drive:
capacity is then drives x the filesystem's size, and placement by free
space prefers the pool with more drives.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from minio_tpu_torch.object.decom import (LeaseHeld, MigrationGovernor,
                                          coordinator_lease, free_space_dst,
                                          migrate_key, page_dispatcher)
from minio_tpu_torch.storage.local import SYS_VOL

REBAL_PATH = "config/rebalance.json"
CHECKPOINT_EVERY = 16
# A pool takes part when its used bytes exceed its capacity-weighted
# share of the data by this relative margin, so a balanced deployment
# is a no-op whatever its size.
THRESHOLD = 0.02


class RebalanceError(Exception):
    pass


def bucket_used_bytes(layer, bucket: str) -> int:
    """Every version's size in one bucket, by a paged walk."""
    used = 0
    marker = ""
    while True:
        page = layer.list_objects(bucket, marker=marker, max_keys=1000,
                                  include_versions=True)
        used += sum(o.size for o in page.objects)
        if not page.is_truncated:
            return used
        marker = page.next_marker


def pool_usage(pool) -> tuple[int, int]:
    """(used bytes, capacity bytes) of one pool: used from its namespace
    (version stacks included), capacity from its drives."""
    used = sum(bucket_used_bytes(pool, b.name) for b in pool.list_buckets())
    cap = 0
    for d in pool.disks:
        try:
            cap += d.disk_info().total
        except Exception:  # noqa: BLE001 - an offline drive
            pass
    return used, cap


def load_state(layer) -> Optional[dict]:
    """The highest-revision rebalance state on pool 0's drives, or None."""
    votes: set[bytes] = set()
    for d in layer.pools[0].disks:
        try:
            votes.add(d.read_all(SYS_VOL, REBAL_PATH))
        except Exception:  # noqa: BLE001 - absent or offline
            continue
    best: Optional[dict] = None
    for blob in votes:
        try:
            doc = json.loads(blob)
        except ValueError:
            continue
        if isinstance(doc, dict) and "pools" in doc and \
                (best is None or doc.get("rev", 0) > best.get("rev", 0)):
            best = doc
    return best


class Rebalance:
    """One rebalance run, fresh or resumed."""

    def __init__(self, layer, state: Optional[dict] = None,
                 checkpoint_every: int = CHECKPOINT_EVERY,
                 threshold: float = THRESHOLD):
        if len(layer.pools) < 2:
            raise RebalanceError("rebalance needs at least two pools")
        self.layer = layer
        self.checkpoint_every = checkpoint_every
        self.threshold = threshold
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Planning walks every pool's namespace: in the background
        # thread, so that the admin start answers at once.
        self.state = state or {"status": "planning",
                               "started_ns": time.time_ns(),
                               "pools": {}, "rev": 0, "yields": 0}
        self.state.setdefault("yields", 0)
        self._gov = MigrationGovernor(layer, self.state, self._stop)
        self._lease = None

    def _plan(self) -> dict:
        usages = [pool_usage(p) for p in self.layer.pools]
        avg = sum(u for u, _ in usages) / (sum(c for _, c in usages) or 1)
        pools = {}
        for i, (used, cap) in enumerate(usages):
            target_used = avg * (cap or 1)
            participating = used > target_used * (1 + self.threshold) \
                and used > 0 and i not in self.layer.decommissioning
            pools[str(i)] = {
                "participating": participating,
                "used": used, "capacity": cap or 1,
                "bytes_target": max(0, int(used - target_used))
                if participating else 0,
                "bytes_moved": 0, "bucket": "", "marker": "",
                "done": not participating, "migrated": 0, "failed": 0,
            }
        return {"status": "rebalancing", "pools": pools}

    def _persist(self) -> None:
        self.state["rev"] = self.state.get("rev", 0) + 1
        self.state["checkpoint_ns"] = time.time_ns()
        blob = json.dumps(self.state, sort_keys=True).encode()
        disks = self.layer.pools[0].disks
        ok = 0
        for d in disks:
            try:
                d.write_all(SYS_VOL, REBAL_PATH, blob)
                ok += 1
            except Exception:  # noqa: BLE001 - an offline drive
                continue
        if ok < len(disks) // 2 + 1:
            raise RebalanceError("could not persist rebalance state")

    def _acquire_lease(self) -> None:
        """One coordinator fleet-wide (decom.coordinator_lease); a lease
        lost mid-walk stops this one, checkpointed, for the next winner."""
        lease = coordinator_lease(self.layer, "rebalance")
        if lease is not None:
            lease.on_lost = self._stop.set
            if not lease.lock(write=True, timeout=5.0):
                raise LeaseHeld(
                    "rebalance coordinator lease held by another node")
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
        try:
            self._persist()
        except RebalanceError:
            self._release_lease()
            raise
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rebalance")
        self._thread.start()

    def stop(self) -> None:
        """Pause: the status stays, the progress is persisted, a resume
        walks on from it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self.state.get("status") in ("planning", "rebalancing"):
            self.state["paused"] = True
            try:
                self._persist()
            except RebalanceError:
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
            if self.state.get("status") == "planning":
                self.state.update(self._plan())
                self._persist()
            sources = {int(i) for i, rec in self.state["pools"].items()
                       if rec["participating"] and not rec["done"]}
            for src in sorted(sources):
                if self._stop.is_set():
                    return
                self._drain_pool(src, exclude=sources)
            if self._stop.is_set():
                return
            failed = sum(r["failed"] for r in self.state["pools"].values())
            self.state["status"] = "failed" if failed else "complete"
            self.state["finished_ns"] = time.time_ns()
            self._persist()
        except Exception as e:  # noqa: BLE001 - recorded, resumable
            self.state["status"] = "failed"
            self.state["error"] = str(e)
            try:
                self._persist()
            except RebalanceError:
                pass
        finally:
            if not self._stop.is_set():
                self._release_lease()   # stop() releases after the pause

    def _do_key(self, src: int, rec: dict, bucket: str, key: str,
                size: int, exclude: set) -> None:
        gov = self._gov
        # Parallel walkers check the byte target before each key: past
        # it a page's other keys stay (the serial walk stops after the
        # key that reaches it).
        if rec["bytes_moved"] >= rec["bytes_target"] or not gov.gate():
            return
        try:
            migrate_key(self.layer, src, bucket, key,
                        lambda: free_space_dst(self.layer, exclude))
            gov.add(rec, "migrated")
            gov.add(rec, "bytes_moved", size)
        except Exception as e:  # noqa: BLE001 - the walk goes on
            gov.add(rec, "failed")
            rec["last_error"] = f"{bucket}/{key}: {e}"

    def _drain_pool(self, src: int, exclude: set) -> None:
        from concurrent.futures import ThreadPoolExecutor
        rec = self.state["pools"][str(src)]
        pool = self.layer.pools[src]
        since = 0
        gov = self._gov
        # With peer nodes the pages spread over the fleet (decom's
        # PageDispatcher); this coordinator writes every checkpoint.
        disp = page_dispatcher(self.layer)
        workers = ThreadPoolExecutor(
            max_workers=gov.workers,
            thread_name_prefix=f"rebal{src}-mig") \
            if disp is None and gov.workers > 1 else None

        def reached_target() -> bool:
            return rec["bytes_moved"] >= rec["bytes_target"]

        def within_target(batch: list) -> list:
            # The byte target checked before each key, from the listing's
            # sizes: a batch ends with the key that reaches it, as the
            # serial walk does.
            left = rec["bytes_target"] - rec["bytes_moved"]
            for n, k in enumerate(batch):
                if left <= 0:
                    return batch[:n]
                left -= sizes[k]
            return batch

        def reached() -> bool:
            if reached_target():
                rec["done"] = True      # the pool is at the average
                self._persist()
                return True
            return False
        try:
            start_bucket = rec.get("bucket", "")
            for bucket in sorted(b.name for b in pool.list_buckets()):
                if bucket < start_bucket:
                    continue
                marker = rec.get("marker", "") \
                    if bucket == start_bucket else ""
                while not self._stop.is_set():
                    page = pool.list_objects(bucket, marker=marker,
                                             max_keys=256,
                                             include_versions=True)
                    sizes: dict[str, int] = {}
                    for o in page.objects:
                        sizes[o.name] = sizes.get(o.name, 0) + o.size
                    keys = sorted(sizes)
                    if disp is not None:
                        for batch, agg in disp.iter_batches(
                                src, bucket, keys, exclude=exclude | {src},
                                gate=lambda: not reached_target()
                                and gov.gate(), cut=within_target):
                            gov.add(rec, "migrated", agg["migrated"])
                            gov.add(rec, "failed", agg["failed"])
                            gov.add(rec, "bytes_moved", agg["bytes"])
                            if agg["last_error"]:
                                rec["last_error"] = agg["last_error"]
                            rec["bucket"] = bucket
                            rec["marker"] = batch[-1]
                            since += len(batch)
                            if since >= self.checkpoint_every:
                                since = 0
                                self._persist()
                        if self._stop.is_set():
                            return
                        if reached():
                            return
                    elif workers is not None:
                        # The marker passes only a fully done page.
                        list(workers.map(
                            lambda k: self._do_key(src, rec, bucket, k,
                                                   sizes[k], exclude),
                            keys))
                        if keys and not self._stop.is_set():
                            rec["bucket"] = bucket
                            rec["marker"] = keys[-1]
                            since += len(keys)
                        if since >= self.checkpoint_every:
                            since = 0
                            self._persist()
                        if reached():
                            return
                    else:
                        for key in keys:
                            if self._stop.is_set():
                                return
                            self._do_key(src, rec, bucket, key, sizes[key],
                                         exclude)
                            rec["bucket"] = bucket
                            rec["marker"] = key
                            since += 1
                            if since >= self.checkpoint_every:
                                since = 0
                                self._persist()
                            if reached():
                                return
                    if not page.is_truncated:
                        break
                    marker = page.next_marker
                if self._stop.is_set():
                    return
                rec["bucket"] = bucket
                rec["marker"] = ""
                self._persist()
        finally:
            if workers is not None:
                workers.shutdown(wait=True)
        # Walked everything (the targets were estimates): done.
        rec["done"] = True
        self._persist()

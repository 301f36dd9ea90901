"""Generation-validated cross-node cache coherence over the grid.

The port of minio_tpu/grid/coherence.py: the same protocol, verbs and
payloads (byte for byte through utils/mpack.py), so a port node and a
JAX node answer each other.

The contract that lets the quorum-fileinfo cache (object/fi_cache) and
the listing/bucket-meta caches stay ON across a distributed deployment
instead of being disabled on remote-drive sets. The old
PeerNotifier.broadcast was fire-and-forget: a dropped invalidation left
a peer serving stale metadata until a TTL — unacceptable for fileinfo,
which has no TTL. This protocol makes invalidation ACKED-OR-ESCALATED
and makes re-arming after any connectivity gap REQUIRE a generation
resync:

  * every node keeps a per-(bucket, class) GENERATION counter, bumped
    BEFORE the invalidation fan-out for each local mutation;
  * invalidations push {node, class, bucket, gen} to every peer and
    wait for acks; a peer that fails to ack is ESCALATED: counted in
    `escalations` (the clean-stop line prints it), and its missed
    invalidation applied by its own next resync;
  * each receiver records the highest generation it has APPLIED per
    (peer, bucket, class); a RESYNC pulls a peer's full generation map
    and invalidates every (bucket, class) whose generation advanced
    past the applied record — so invalidations lost while a peer was
    down, partitioned, or restarting are recovered exactly;
  * a peer starts DISARMED and re-arms only after a successful resync;
    any call failure or connection loss to it disarms it again. The
    cache gate `coherent()` is true only with EVERY peer armed —
    gated caches answer misses (never stale hits) the moment the node
    cannot prove it has seen every peer's latest mutation.

Liveness: a periodic sync thread (MTPU_GRID_SYNC_S, default 5 s)
resyncs disarmed peers and pulls armed ones, bounding the staleness
window of an ASYMMETRIC partition (pushes to us fail but our pulls
succeed) to one sync interval; symmetric partitions disarm immediately
via the connection-loss hook or the first failed call.

N x M worker topology (pre-forked workers on a distributed node):
exactly ONE PeerCoherence instance runs per node — in worker 0, the
process that owns the node's grid listener. Sibling workers relay
their outbound bumps to it over loopback (gen.relay) and gate their
caches on the state file it publishes (FileGate); inbound peer
invalidations propagate to siblings through the shared list.gen /
meta.gen bump files io/workers.py already maintains.

Wire surface (registered on the node's GridServer):
    gen.inv    {"n": node, "c": class, "b": bucket, "g": gen} -> "ok"
    gen.sync   {} -> {"n": node, "g": {class: {bucket: gen}}}
    gen.relay  {"b": bucket, "c": class} -> "ok"   (loopback siblings)
"""

from __future__ import annotations

import os
import threading
import time
import uuid as uuid_mod
from typing import Callable, Optional

from minio_tpu_torch.grid.wire import GridError
from minio_tpu_torch.utils import tracing
from minio_tpu_torch.utils.env import env_float as _env_float

# Shared push pool: invalidation fan-outs ride fixed daemon workers
# instead of a fresh thread per peer per mutation (the dsync fan-out
# lesson — thread churn per operation is pathological at production
# mutation rates).
_push_pool = None
_push_pool_mu = threading.Lock()


def _shared_push_pool():
    global _push_pool
    with _push_pool_mu:
        if _push_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _push_pool = ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="coherence-push")
        return _push_pool

INV_HANDLER = "gen.inv"
SYNC_HANDLER = "gen.sync"
RELAY_HANDLER = "gen.relay"

# Invalidation classes. LISTING covers the namespace caches that ride
# the metacache bump funnel (walk streams AND the fileinfo cache);
# BUCKET_META covers bucket configuration (versioning, policies, ...).
CLASS_LISTING = "listing"
CLASS_BUCKET_META = "bucket-meta"
CLASSES = (CLASS_LISTING, CLASS_BUCKET_META)


def make_set_invalidator(sets, layer=None) -> Callable[[str, str], None]:
    """Standard on_invalidate over erasure sets: LISTING drops walk
    streams + fileinfo entries through the bump funnel (bucket "" =
    every known bucket, plus an explicit fi_cache flush for buckets
    cached by GETs that never listed); BUCKET_META drops the TTL
    caches ("" = all). Shared by the server boot and the in-process
    two-node test stacks so the apply semantics cannot drift."""
    def apply_inv(bucket: str, cls: str) -> None:
        if cls == CLASS_BUCKET_META:
            if layer is not None:
                layer.invalidate_bucket_meta(bucket)
            else:
                for es in sets:
                    es.invalidate_bucket_meta(bucket)
            return
        for es in sets:
            mc = es.metacache
            if bucket:
                # broadcast=False: echoing a peer's invalidation back
                # would ping-pong bumps forever.
                mc.bump(bucket, broadcast=False)
                continue
            for b in {k[0] for k in list(mc._walks)} | set(mc._gen):
                mc.bump(b, broadcast=False)
            fc = getattr(es, "fi_cache", None)
            if fc is not None:
                fc.invalidate_all()
        if not bucket:
            # Wildcard invalidation: the hot-object tier caches buckets
            # the bump walk above may never have known (GET-only
            # traffic) — flush every cache in the process explicitly,
            # like the fi_cache flush above.
            from minio_tpu_torch.object import hotcache as _hot
            _hot.flush_process_caches()
    return apply_inv


class FileGate:
    """Sibling-worker view of worker 0's coherence gate (N x M worker
    topology): worker 0 publishes "1"/"0" (coherent or not) to a shared
    state file every sync tick; sibling workers' fi_cache/metacache
    remote gates read it instead of owning a PeerCoherence of their
    own. The rewrite-per-tick doubles as a heartbeat — a stale mtime
    (worker 0 dead or mid-respawn) reads as NOT coherent, so sibling
    caches answer misses during the gap exactly like worker 0's own
    caches do while its peers re-arm."""

    def __init__(self, path: str, ttl: Optional[float] = None,
                 poll: float = 0.05):
        self.path = path
        # Three missed heartbeats = dead publisher; floor keeps slow
        # CI boxes from flapping the gate on scheduler hiccups.
        self.ttl = ttl if ttl is not None else max(
            15.0, 3.0 * _env_float("MTPU_GRID_SYNC_S", 5.0))
        self._poll = poll
        self._at = 0.0
        self._last = False

    def __call__(self) -> bool:
        now = time.monotonic()
        if now - self._at < self._poll:
            return self._last
        self._at = now
        try:
            st = os.stat(self.path)
            with open(self.path, "rb") as f:
                ok = f.read(1) == b"1"
            ok = ok and (time.time() - st.st_mtime) <= self.ttl
        except OSError:
            ok = False
        self._last = ok
        return ok


class PeerCoherence:
    """One node's view of the cluster's cache-invalidation state."""

    def __init__(self, node_id: str, peers: dict,
                 on_invalidate: Optional[Callable[[str, str], None]] = None,
                 sync_interval: Optional[float] = None,
                 ack_timeout: float = 2.0):
        """`peers` maps peer id -> GridClient. `on_invalidate(bucket,
        class)` drops the local caches of that class for that bucket
        ("" = every bucket of the class)."""
        self.node_id = node_id
        self.peers = dict(peers)
        self.on_invalidate = on_invalidate
        self.sync_interval = sync_interval if sync_interval is not None \
            else _env_float("MTPU_GRID_SYNC_S", 5.0)
        self.ack_timeout = ack_timeout
        self._mu = threading.Lock()
        # Boot instance id: generation counters are in-memory and RESET
        # when a node restarts — a peer comparing new (small) gens
        # against pre-restart (large) applied records would see nothing
        # stale and re-arm over missed invalidations. Every inv/sync
        # carries this id; a changed id on a peer means "its counter
        # history is unknowable: flush everything of its classes and
        # start the applied records over" (see resync / handle_inv).
        self.instance_id = str(uuid_mod.uuid4())
        # (class, bucket) -> my generation (bumped per local mutation).
        self._local: dict[tuple, int] = {}
        # peer -> {"i": peer instance id, "gens": {(class, bucket) ->
        # highest generation APPLIED here under that instance}}.
        self._seen: dict[str, dict] = {p: {"i": None, "gens": {}}
                                       for p in peers}
        # peer -> armed. All False until the first resync proves we
        # hold every peer's current generation state.
        self._armed: dict[str, bool] = {p: False for p in peers}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        # N x M worker topology (wired by minio_tpu_torch.server in
        # worker mode): state_path publishes coherent() for sibling
        # FileGates; relay_flag_path is the siblings' dead-man
        # escalation — a sibling whose gen.relay loopback call failed
        # drops the flag, and the next sync tick converts it into a
        # wildcard broadcast.
        self.state_path: Optional[str] = None
        self.relay_flag_path: Optional[str] = None
        # Counters (a clean stop's coherence line).
        self.inv_sent = 0
        self.inv_failed = 0
        self.inv_applied = 0
        self.resyncs = 0
        self.escalations = 0
        # Connection-loss hook: a dying connection to a peer disarms it
        # NOW, not at the next sync tick.
        for pid, c in self.peers.items():
            hooks = getattr(c, "on_conn_lost", None)
            if hooks is not None:
                hooks.append(lambda pid=pid: self._disarm(pid))

    # -- gate ----------------------------------------------------------

    def coherent(self) -> bool:
        """True when every peer is armed: the caches this object gates
        may serve hits. One lock-free-ish dict scan — called per cache
        lookup."""
        armed = self._armed
        for v in armed.values():
            if not v:
                return False
        return True

    def armed_count(self) -> int:
        return sum(1 for v in self._armed.values() if v)

    def _disarm(self, peer: str) -> None:
        if self._armed.get(peer):
            self._armed[peer] = False
            self._wake.set()
            # Sibling workers must see the gate drop NOW, not at the
            # next heartbeat — their caches would serve through the gap.
            self._publish_state()

    # -- N x M worker topology (state file + sibling relay) ------------

    def _publish_state(self) -> None:
        path = self.state_path
        if not path:
            return
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write("1" if self.coherent() else "0")
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _check_relay_flag(self) -> None:
        path = self.relay_flag_path
        if not path:
            return
        try:
            os.stat(path)
        except OSError:
            return
        try:
            os.unlink(path)
        except OSError:
            pass
        # A sibling mutated the namespace but could not relay the bump
        # (we were restarting): WHICH bucket is lost with the failed
        # call, so broadcast a wildcard for both classes — peers flush
        # wholesale, exactly what a missed invalidation demands.
        for cls in CLASSES:
            try:
                self.broadcast("", cls)
            except Exception:  # noqa: BLE001 - escalation counted inside
                pass

    def handle_relay(self, payload) -> str:
        """Loopback verb for sibling workers (same node, no grid
        listener of their own): bump + fan out an invalidation on their
        behalf. Their SharedGen bump already covered the node's own
        processes; this covers the peers."""
        p = payload or {}
        self.broadcast(p.get("b", ""), p.get("c", CLASS_LISTING))
        return "ok"

    # -- local mutations -> push ---------------------------------------

    def local_bump(self, bucket: str, cls: str = CLASS_LISTING) -> int:
        with self._mu:
            g = self._local.get((cls, bucket), 0) + 1
            self._local[(cls, bucket)] = g
            return g

    def broadcast(self, bucket: str, cls: str = CLASS_LISTING) -> None:
        """Bump the local generation and push the invalidation to every
        peer, acked-or-escalated. Blocks up to ack_timeout per wave (all
        peers in parallel on the shared push pool) so a mutation's
        response implies reachable peers have already dropped their
        caches."""
        gen = self.local_bump(bucket, cls)
        if not self.peers:
            return
        payload = {"n": self.node_id, "i": self.instance_id,
                   "c": cls, "b": bucket, "g": gen}
        pool = _shared_push_pool()
        futs = [pool.submit(self._push_one, pid, c, payload)
                for pid, c in self.peers.items()]
        deadline = time.monotonic() + self.ack_timeout + 0.5
        for f in futs:
            try:
                f.result(timeout=max(0.0, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 - outcome counted in push
                pass

    def _push_one(self, pid: str, client, payload) -> None:
        try:
            client.call(INV_HANDLER, payload, timeout=self.ack_timeout)
            with self._mu:
                self.inv_sent += 1
        except Exception as e:  # noqa: BLE001 - escalated below
            self._escalate(pid, payload, e)

    def _escalate(self, pid: str, payload, err) -> None:
        """A peer did not ack an invalidation. We cannot force a remote
        cache to drop, but the failure is made loud (counted in
        `escalations`) and the local generation already advanced
        BEFORE the push — so the peer's own periodic resync pull
        applies the missed invalidation within one MTPU_GRID_SYNC_S
        interval, armed or not; that interval is the staleness bound
        for a peer that is up but unreachable from here. No connection
        reset here: the grid client already drops dead connections on
        send failure, and the remaining failure shapes (slow ack,
        remote handler error) have a provably-live transport — closing
        the SHARED client would fail every in-flight storage/lock call
        on it and feed their conn-lost errors to the peer's breaker,
        amplifying one slow ack into a node-level fault."""
        with self._mu:
            self.inv_failed += 1
            self.escalations += 1
        tracing.slow_event(
            "grid", "peer.invalidation-failed",
            tags={"peer": pid, "class": payload.get("c", ""),
                  "bucket": payload.get("b", ""),
                  "error": f"{type(err).__name__}: {err}"})

    # -- receiving side ------------------------------------------------

    def handle_inv(self, payload) -> str:
        p = payload or {}
        node = p.get("n", "")
        instance = p.get("i")
        cls = p.get("c", CLASS_LISTING)
        bucket = p.get("b", "")
        gen = int(p.get("g", 0))
        with self._mu:
            seen = self._seen.setdefault(node, {"i": None, "gens": {}})
            new_instance = instance is not None and seen["i"] != instance
        if new_instance:
            # The peer restarted (new counter history): whatever it
            # invalidated under its previous life is unknowable, and
            # recording the new instance WITHOUT flushing would erase
            # the evidence resync needs to flush later — so flush
            # everything of every class HERE, before the record moves.
            for flush_cls in CLASSES:
                if not self._apply("", flush_cls):
                    raise GridError("invalidation apply failed")
        if not self._apply(bucket, cls):
            # The local drop failed: do NOT record the generation (and
            # do not ack) — the sender escalates, and the next resync
            # retries the invalidation.
            raise GridError("invalidation apply failed")
        with self._mu:
            seen = self._seen.setdefault(node, {"i": None, "gens": {}})
            if instance is not None and seen["i"] != instance:
                seen["i"] = instance
                seen["gens"] = {}
            if gen > seen["gens"].get((cls, bucket), 0):
                seen["gens"][(cls, bucket)] = gen
        return "ok"

    def handle_sync(self, payload) -> dict:
        with self._mu:
            out: dict[str, dict[str, int]] = {}
            for (cls, bucket), gen in self._local.items():
                out.setdefault(cls, {})[bucket] = gen
        return {"n": self.node_id, "i": self.instance_id, "g": out}

    def _apply(self, bucket: str, cls: str) -> bool:
        """Drop the local caches for (bucket, class). Returns success —
        generation records advance only on applied invalidations."""
        cb = self.on_invalidate
        if cb is not None:
            try:
                cb(bucket, cls)
            except Exception:  # noqa: BLE001 - surfaced via return value
                return False
        with self._mu:
            self.inv_applied += 1
        return True

    # -- resync (pull) -------------------------------------------------

    def resync(self, pid: str) -> bool:
        """Pull one peer's generation map, invalidate every (bucket,
        class) whose generation advanced past what we applied, then arm
        the peer. Returns armed."""
        client = self.peers.get(pid)
        if client is None:
            return False
        try:
            remote = client.call(SYNC_HANDLER, {}, timeout=self.ack_timeout)
        except Exception:  # noqa: BLE001 - stays/goes disarmed
            self._armed[pid] = False
            return False
        gens = (remote or {}).get("g", {}) or {}
        instance = (remote or {}).get("i")
        # Key the applied-generation records by the peer's SELF-DECLARED
        # node id — the same key handle_inv records pushes under. Keying
        # by our local handle (pid, endpoint-derived) would split the
        # records whenever a node's bind address differs from the name
        # its peers know it by (e.g. --address 0.0.0.0), making every
        # resync re-apply every invalidation forever.
        declared = (remote or {}).get("n") or pid
        stale: list[tuple[str, str]] = []
        flush_all = False
        with self._mu:
            seen = self._seen.setdefault(declared, {"i": None, "gens": {}})
            if seen["i"] != instance:
                # The peer restarted since we last synced: whatever it
                # invalidated under its PREVIOUS life is unknowable
                # (counters reset, its map may even be empty). The only
                # safe move is a full flush of every class before
                # re-arming over the new instance's history.
                flush_all = True
            else:
                for cls, buckets in gens.items():
                    for bucket, gen in (buckets or {}).items():
                        if int(gen) > seen["gens"].get((cls, bucket), 0):
                            stale.append((bucket, cls))
        if flush_all:
            stale = [("", cls) for cls in CLASSES]
        # Invalidate BEFORE recording the generations and BEFORE
        # arming: a crash between steps re-invalidates (safe), never
        # arms with unapplied generations (unsafe).
        for bucket, cls in stale:
            if not self._apply(bucket, cls):
                self._armed[pid] = False
                return False
        with self._mu:
            seen = self._seen.setdefault(declared, {"i": None, "gens": {}})
            if flush_all:
                seen["i"] = instance
                seen["gens"] = {(cls, bucket): int(gen)
                                for cls, buckets in gens.items()
                                for bucket, gen in (buckets or {}).items()}
            else:
                for (bucket, cls) in stale:
                    g = int((gens.get(cls) or {}).get(bucket, 0))
                    if g > seen["gens"].get((cls, bucket), 0):
                        seen["gens"][(cls, bucket)] = g
            self.resyncs += 1
        self._armed[pid] = True
        return True

    def resync_all(self) -> bool:
        ok = True
        for pid in list(self.peers):
            if not self.resync(pid):
                ok = False
        return ok

    # -- lifecycle -----------------------------------------------------

    def register_into(self, srv) -> None:
        srv.register(INV_HANDLER, self.handle_inv)
        srv.register(SYNC_HANDLER, self.handle_sync)
        srv.register(RELAY_HANDLER, self.handle_relay)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="grid-coherence")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def _loop(self) -> None:
        # First pass immediately: the boot path starts disarmed and
        # should arm as soon as peers answer, not one interval later.
        while not self._stop.is_set():
            try:
                self.resync_all()
            except Exception:  # noqa: BLE001 - keep the daemon alive
                pass
            try:
                self._check_relay_flag()
                self._publish_state()
            except Exception:  # noqa: BLE001 - keep the daemon alive
                pass
            self._wake.wait(self.sync_interval)
            self._wake.clear()

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            return {
                "node": self.node_id,
                "peers": len(self.peers),
                "armed": self.armed_count(),
                "coherent": self.coherent(),
                "inv_sent": self.inv_sent,
                "inv_failed": self.inv_failed,
                "inv_applied": self.inv_applied,
                "resyncs": self.resyncs,
                "escalations": self.escalations,
                "peer_state": {p: bool(a) for p, a in self._armed.items()},
            }

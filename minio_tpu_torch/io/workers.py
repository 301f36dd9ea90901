"""Pre-forked SO_REUSEPORT front end: N worker processes, one port.

The port of minio_tpu/io/workers.py. One interpreter serves requests on
one core at a time; the reference's goroutines spread over every core.
So the server forks N workers, each binding the SAME (host, port) with
SO_REUSEPORT (the kernel spreads accepted connections across them, no
proxy hop), and each running the whole boot (minio_tpu_torch.server):
its own CUDA context, golden self-tests, erasure set, pinned pool,
batchers and kernel lane over the shared drives. The parent forks
before anything touches CUDA (a CUDA context does not survive a fork;
one made after it is the child's own) and then only supervises.

Cross-process coordination:
  * namespace locks: each worker's in-process NSLockMap is wrapped with
    striped flock() files under the first drive's system volume
    (FlockNSLock), so put/delete/heal of one key serialize across
    workers exactly as they do across threads; bucket-metadata
    read-modify-writes take one flock'd mutex (FlockMutex);
  * cache invalidation: namespace mutations append to a shared
    generation file (`list.gen`); workers pull-check it before serving a
    listing or a fileinfo or hot-object hit, and flush what they hold
    when any sibling mutated anything. Bucket-metadata writes append to
    `meta.gen`, checked at most every 0.25 s before a TTL-cached record
    is trusted. On a distributed node worker 0 owns the cross-node
    coherence (grid/coherence.py) and publishes its verdict to
    `coherence.state` on every sync tick; siblings gate their caches on
    it (FileGate: a stale heartbeat reads as incoherent), relay their
    bumps to worker 0 over loopback (`gen.relay`), and leave
    `coherence.relay-flag` when a relay fails, which worker 0's next
    tick turns into a wildcard broadcast (the wiring is
    minio_tpu_torch.server's);
  * admission: MTPU_API_REQUESTS_MAX budgets divide across workers
    (ceil), so the fleet-wide in-flight bound stays what the operator
    configured;
  * lifecycle: the parent forwards SIGTERM/SIGINT; each worker stops
    accepting, drains the requests in flight, stops its background work,
    stamps its drives clean and prints its kernel launches, then exits;
    the parent reaps and respawns workers that die otherwise (bounded).

Each worker serves through an event loop of its own (s3/eventloop.py)
on its SO_REUSEPORT socket: the epoll set, the executor threads and the
recv buffer pool are made in the worker, after the fork, as everything
else is. Its SIGTERM drain stops accepting, closes the parked
connections, and lets the dispatched requests and the response tails
the loop drains finish before the drives are stamped.

The control plane (minio_tpu/io/workers.py): each worker has two
socketpairs to the parent, made before the fork, carrying framed JSON
(a 4-byte length, then the object). On the query pipe the parent asks a
worker for its snapshot (`stat`: _worker_stat) or drains its trace
relay (`trace_drain`, `trace_stop`), answered by a thread of the worker
that never touches its event loop. On the hub pipe a worker asks the
parent for the fleet: `cluster_stats` (every worker's snapshot, which
any worker's metrics scrape and admin info merge) and the trace
subscription verbs (`trace_sub`, `trace_poll`, `trace_unsub`). While a
subscription lives, the parent's pump drains every worker's relay every
_TRACE_POLL_S seconds into each subscriber's bounded buffer, so one
worker's admin trace sees every sibling. Every exchange is tagged with
a request id, and a reply that comes after its request timed out is
discarded (`_drain_stale`), so one stall never desynchronises a pipe.

The parent stays one thread (it forks): its supervise loop serves the
hubs, runs the pump's ticks and reaps children in turn, each exchange
bounded by a timeout.

MTPU_HTTP_WORKERS: worker count (default = cores; 0/1 = one process,
as the tests run it).
"""

from __future__ import annotations

import collections
import errno
import fcntl
import itertools
import json
import os
import selectors
import signal
import socket
import struct
import sys
import threading
import time
import traceback
import zlib
from contextlib import contextmanager

from minio_tpu_torch.object.nslock import LockTimeout, NSLockMap
from minio_tpu_torch.object.pools import layer_sets

_NS_STRIPES = 128
_READY_TIMEOUT = 180.0          # worker 0's boot: self-tests on its card
_DRAIN_TIMEOUT = 15.0
_MAX_RESPAWNS = 10
_NEVER = float("-inf")          # a poll time no clock reading falls near
# The fleet trace pump: its drain period, and the entries a subscriber's
# buffer holds between two polls (the oldest go first).
_TRACE_POLL_S = 0.2
_TRACE_BUF = 4000
# A subscription not polled for this long (its handler died) expires, so
# the fleet disarms instead of pumping forever.
_TRACE_SUB_TTL = 30.0


def worker_count_from_env(env=os.environ) -> int:
    """Resolved MTPU_HTTP_WORKERS: default = cores; 0/1 = in-process."""
    raw = env.get("MTPU_HTTP_WORKERS", "")
    if raw.strip() == "":
        return max(1, os.cpu_count() or 1)
    try:
        return max(1, int(raw))
    except ValueError:
        return 1


def reserve_port(host: str, port: int) -> tuple[socket.socket, int]:
    """Bind (not listen) a SO_REUSEPORT socket to learn/hold the port:
    workers then bind+listen the same address; the non-listening
    reservation never receives connections but keeps the port ours
    between forks."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host, port))
    return s, s.getsockname()[1]


def _open_creating(path: str, flags: int) -> int:
    """os.open with O_CREAT, making the directory again if it went
    (a drive wiped under a serving fleet)."""
    try:
        return os.open(path, flags | os.O_CREAT, 0o644)
    except FileNotFoundError:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return os.open(path, flags | os.O_CREAT, 0o644)


# ---------------------------------------------------------------------------
# cross-process locks
# ---------------------------------------------------------------------------

class FlockMutex:
    """One exclusive cross-process lock (bucket-metadata RMW). Also
    excludes threads within a process: flock is per open file
    description and every acquire opens its own fd, kept in
    thread-local storage (on the shared instance, one thread's exit
    must not unlock another thread's acquisition)."""

    def __init__(self, path: str):
        self._path = path
        self._tls = threading.local()
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def __enter__(self):
        fd = _open_creating(self._path, os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
        except BaseException:
            os.close(fd)
            raise
        stack = getattr(self._tls, "fds", None)
        if stack is None:
            stack = self._tls.fds = []
        stack.append(fd)
        return self

    def __exit__(self, *exc):
        fd = self._tls.fds.pop()
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)
        return False


class FlockNSLock:
    """NSLockMap-compatible namespace locking that ALSO excludes other
    worker processes: the in-process RW lock runs first (full fidelity
    between threads), then a striped flock file is taken SH/EX for the
    cross-process edge. Stripes bound the lock-file population; two
    keys sharing a stripe only over-serialize, never under-serialize."""

    def __init__(self, lock_dir: str, inner: NSLockMap | None = None):
        self._dir = lock_dir
        os.makedirs(lock_dir, exist_ok=True)
        self._inner = inner if inner is not None else NSLockMap()

    def _stripe(self, volume: str, path: str) -> str:
        h = zlib.crc32(f"{volume}/{path}".encode()) % _NS_STRIPES
        return os.path.join(self._dir, f"ns-{h:03d}.lock")

    @contextmanager
    def _flocked(self, volume: str, path: str, op: int, timeout: float):
        fd = _open_creating(self._stripe(volume, path), os.O_RDWR)
        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    fcntl.flock(fd, op | fcntl.LOCK_NB)
                    break
                except OSError as e:
                    if e.errno not in (errno.EAGAIN, errno.EACCES):
                        raise
                    if time.monotonic() >= deadline:
                        raise LockTimeout(
                            f"cross-worker lock on {volume}/{path}") \
                            from None
                    time.sleep(0.005)
            try:
                yield
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)

    @contextmanager
    def write(self, volume: str, path: str,
              timeout: float = NSLockMap.DEFAULT_TIMEOUT):
        with self._inner.write(volume, path, timeout):
            with self._flocked(volume, path, fcntl.LOCK_EX, timeout):
                yield

    @contextmanager
    def read(self, volume: str, path: str,
             timeout: float = NSLockMap.DEFAULT_TIMEOUT):
        with self._inner.read(volume, path, timeout):
            with self._flocked(volume, path, fcntl.LOCK_SH, timeout):
                yield


# ---------------------------------------------------------------------------
# shared generation files (pull-model cache invalidation)
# ---------------------------------------------------------------------------

class SharedGen:
    """A monotonic cross-process generation: bump() appends one byte
    (O_APPEND, atomic), changed() compares the observed size against
    the last seen. Size inequality, not ordering, signals change, so
    even truncation or re-creation invalidates."""

    def __init__(self, path: str, poll_interval: float = 0.0):
        """poll_interval > 0 rate-limits the stat() behind changed():
        calls inside the window reuse the last verdict (False). Only for
        generations whose consumers tolerate that much staleness
        (bucket metadata), never the listing/fileinfo generation."""
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._last = -1
        self._poll_interval = poll_interval
        self._polled_at = _NEVER

    def bump(self) -> None:
        fd = _open_creating(self.path, os.O_WRONLY | os.O_APPEND)
        try:
            os.write(fd, b".")
        finally:
            os.close(fd)
        # Our own next changed() must see this bump whatever the clock
        # reads: the JAX package resets the window to 0.0, which a
        # monotonic clock younger than the window still falls inside.
        self._polled_at = _NEVER

    def changed(self) -> bool:
        if self._poll_interval > 0.0:
            now = time.monotonic()
            if now - self._polled_at < self._poll_interval:
                return False
            self._polled_at = now
        try:
            size = os.stat(self.path).st_size
        except OSError:
            size = 0
        if size != self._last:
            self._last = size
            return True
        return False


# ---------------------------------------------------------------------------
# one worker's wiring
# ---------------------------------------------------------------------------

def _wire_set(s, shared_dir: str, list_gen: SharedGen,
              meta_gen: SharedGen) -> None:
    """One erasure set's cross-worker wiring: flock namespace locks and
    bucket-metadata mutex, and pull-model invalidation of the listing
    metacache, the bucket-metadata TTL cache and the fileinfo cache."""
    s.ns = FlockNSLock(os.path.join(shared_dir, "nslocks"), inner=s.ns)
    s.bucket_meta_lock = FlockMutex(os.path.join(shared_dir,
                                                 "bucket-meta.lock"))
    # The fileinfo cache observes the generation file every worker's
    # bumps append to: its own SharedGen, since changed() is stateful
    # per observer and the metacache consumes list_gen.
    s.fi_cache.shared_gen = SharedGen(os.path.join(shared_dir, "list.gen"))

    mc = s.metacache
    orig_bump = mc.bump

    def bump(bucket: str, broadcast: bool = True) -> None:
        orig_bump(bucket, broadcast)
        list_gen.bump()
    mc.bump = bump
    if s.group_commit is not None:
        s.group_commit.bump = bump    # a batch's bump reaches the fleet
    orig_drop = mc.drop_bucket

    def drop_bucket(bucket: str) -> None:
        orig_drop(bucket)
        list_gen.bump()
    mc.drop_bucket = drop_bucket

    orig_walk = mc.walk_for

    def walk_for(es, bucket: str, prefix: str, start: str = "", **kw):
        if list_gen.changed():
            # Another worker mutated some namespace since we last
            # looked: orphan EVERY cached walk stream. The registry, not
            # only the generations, names the buckets: a worker that
            # never wrote has walks but no generation entries.
            buckets = {k[0] for k in list(mc._walks)} | set(mc._gen) \
                | {bucket}
            for b in buckets:
                orig_bump(b, False)     # a sibling's: it broadcast it
        return orig_walk(es, bucket, prefix, start=start, **kw)
    mc.walk_for = walk_for

    orig_set_meta = s.set_bucket_meta

    def set_bucket_meta(bucket: str, meta: dict) -> None:
        orig_set_meta(bucket, meta)
        meta_gen.bump()
    s.set_bucket_meta = set_bucket_meta

    orig_get_meta = s.get_bucket_meta

    def get_bucket_meta(bucket: str) -> dict:
        if meta_gen.changed():
            s.invalidate_bucket_meta()
        return orig_get_meta(bucket)
    s.get_bucket_meta = get_bucket_meta


# ---------------------------------------------------------------------------
# the control plane (parent <-> workers)
# ---------------------------------------------------------------------------

def _send_msg(sock: socket.socket, obj) -> None:
    blob = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            raise ConnectionError("control peer closed")
        buf += got
    return buf


def _recv_msg(sock: socket.socket, timeout: float = 5.0):
    sock.settimeout(timeout)
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n))


def _drain_stale(sock: socket.socket, grace: float = 0.25) -> None:
    """After a timed-out exchange: give the peer a short grace to finish
    writing its late (maybe partial) reply, then discard whatever came,
    so that the next exchange starts on a frame boundary."""
    deadline = time.monotonic() + grace
    try:
        while time.monotonic() < deadline:
            sock.settimeout(max(0.01, deadline - time.monotonic()))
            if not sock.recv(65536):
                return
    except (socket.timeout, OSError):
        pass


def _rpc(sock: socket.socket, rids, msg: dict, timeout: float) -> dict:
    """One rid-tagged request and its reply; replies to earlier requests
    that timed out are skipped, and a timeout drains the pipe."""
    rid = next(rids)
    msg = dict(msg, rid=rid)
    _send_msg(sock, msg)
    deadline = time.monotonic() + timeout
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise socket.timeout("control rpc timeout")
            reply = _recv_msg(sock, timeout=left)
            if reply.get("rid") == rid:
                reply.pop("rid", None)
                return reply
    except socket.timeout:
        _drain_stale(sock)
        raise


def _worker_stat(server, worker_id: int) -> dict:
    """One worker's control-plane snapshot (minio_tpu/io/workers.py
    `_worker_stat`): its metrics registry's state, admission, staging
    pools, per-drive engine rows, fileinfo and hot caches, group-commit
    lanes, event loop, grid breakers and drive heal. JSON-safe."""
    from minio_tpu_torch.grid import client as grid_client
    from minio_tpu_torch.io.bufpool import pools_stats
    from minio_tpu_torch.storage import group_commit
    engine, fileinfo = [], []
    for si, s in enumerate(layer_sets(server.objects)):
        io_eng = getattr(s, "io", None)
        if io_eng is not None:
            engine.extend({"set": si, "drive": di, **st}
                          for di, st in enumerate(io_eng.stats()))
        fileinfo.append(s.fi_cache.stats())
    stat = {"worker": worker_id, "pid": os.getpid(),
            "in_flight": server._inflight,
            "metrics": server.metrics.state(),
            "admission": server.admission.snapshot(),
            "bufpool": pools_stats(),
            "engine": engine,
            "fileinfo_cache": fileinfo,
            "hot_cache": server.hot_cache.stats(),
            "group_commit": group_commit.aggregate_stats()}
    loop_st = server.eventloop_stats()
    if loop_st is not None:
        stat["connections"] = loop_st
    gp = grid_client.peer_stats()
    if gp:
        stat["grid"] = gp
    dh = getattr(server, "drive_heal", None)
    if dh is not None:
        # The bulk heal runs on worker 0, but scrapes land on any worker.
        stat["drive_heal"] = dh.status()
    return stat


class WorkerContext:
    """Everything a forked worker wires into its S3Server."""

    def __init__(self, total: int, worker_id: int,
                 query_sock: socket.socket, hub_sock: socket.socket):
        self.total = total
        self.worker_id = worker_id
        self._query = query_sock       # the parent asks this worker
        self._hub = hub_sock           # this worker asks the parent
        self._hub_mu = threading.Lock()
        self._hub_rids = itertools.count(1)

    def _hub_rpc(self, msg: dict, timeout: float = 5.0) -> dict:
        with self._hub_mu:
            return _rpc(self._hub, self._hub_rids, msg, timeout)

    def cluster_stats(self) -> list[dict]:
        """Every worker's snapshot, this one's included, through the
        parent."""
        return self._hub_rpc({"op": "cluster_stats"},
                             timeout=10.0).get("stats", [])

    def trace_sub(self, types) -> int:
        # The parent arms every worker before it answers, so requests
        # made right after subscribing are seen.
        return self._hub_rpc({"op": "trace_sub", "types": list(types)},
                             timeout=15.0)["sub"]

    def trace_poll(self, sub_id: int) -> list[dict]:
        return self._hub_rpc({"op": "trace_poll", "sub": sub_id}) \
            .get("entries", [])

    def trace_unsub(self, sub_id: int) -> None:
        self._hub_rpc({"op": "trace_unsub", "sub": sub_id})

    def _serve_queries(self, server) -> None:
        """Answer the parent's queries, on a thread of its own: neither
        a snapshot nor a relay drain runs on the event loop."""
        while True:
            try:
                msg = _recv_msg(self._query, timeout=3600.0)
            except socket.timeout:
                continue
            except (ConnectionError, OSError, ValueError):
                return
            op = msg.get("op")
            try:
                if op == "stat":
                    reply = _worker_stat(server, self.worker_id)
                elif op == "trace_drain":
                    # Each drain re-arms, so a respawned worker relays
                    # from the pump's next tick on.
                    server.tracer.arm_remote(msg.get("types") or ["s3"])
                    reply = {"entries": server.tracer.drain_remote()}
                elif op == "trace_stop":
                    server.tracer.disarm_remote()
                    reply = {"ok": 1}
                else:
                    reply = {"error": f"unknown op {op!r}"}
            except Exception as e:  # noqa: BLE001 - answered, not fatal
                reply = {"error": f"{type(e).__name__}: {e}"}
            reply["rid"] = msg.get("rid")
            try:
                _send_msg(self._query, reply)
            except OSError:
                return

    def attach(self, server, finish) -> None:
        """Wire the worker's server: divided admission, cross-process
        locks and cache generations under the first drive's system
        volume, and the drain on SIGTERM/SIGINT: `finish()` (stop
        accepting, drain, stop the background work, stamp the drives,
        print the launches), then exit."""
        server.admission = server.admission.divided(self.total)
        # Any worker's scrape, admin info and admin trace see the fleet
        # through the parent.
        server.cluster_stats = self.cluster_stats
        server.cluster_trace = self
        threading.Thread(target=self._serve_queries, args=(server,),
                         daemon=True, name="worker-control").start()
        shared = os.path.join(server.drives[0].root, ".mtpu.sys", "workers")
        list_path = os.path.join(shared, "list.gen")
        # Every set of every pool, each with observers of its own:
        # changed() is stateful per observer, and one shared among sets
        # would let the first set's check hide a bump from the rest.
        for s in layer_sets(server.objects):
            _wire_set(s, shared, SharedGen(list_path),
                      SharedGen(os.path.join(shared, "meta.gen"),
                                poll_interval=0.25))
        server.hot_cache.shared_gen = SharedGen(list_path)
        # A drain started in one worker leaves placement in all.
        server.objects.decom_gen = SharedGen(
            os.path.join(shared, "decom.gen"))

        def drain(signum, frame):
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            code = 1
            try:
                finish()
                code = 0
            except BaseException:  # noqa: BLE001 - report, then exit
                traceback.print_exc(file=sys.stderr)
            finally:
                sys.stdout.flush()
                os._exit(code)
        signal.signal(signal.SIGTERM, drain)
        signal.signal(signal.SIGINT, drain)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class WorkerPool:
    """Fork + supervise N workers. `boot(address, ctx)` runs IN THE
    CHILD and must build, attach and serve an S3Server bound to
    `address` with SO_REUSEPORT; it never returns."""

    def __init__(self, address: str, n_workers: int, boot):
        host, _, port_s = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.n = max(2, n_workers)
        self.boot = boot
        self._reserve, self.port = reserve_port(self.host, int(port_s or 0))
        self.address = f"{self.host}:{self.port}"
        # The parent runs one thread until stop() (it forks, so it must
        # not run more): the signal handler runs on it between
        # bytecodes, and reads the live pids from a tuple replaced whole.
        self._children: dict[int, int] = {}       # pid -> worker id
        self._pids: tuple = ()
        self._stopping = False
        self._respawns = 0
        # The control plane: pid -> {worker, pid, query, hub} (the
        # parent's ends of the worker's two pipes), and the fleet trace
        # subscriptions: sub id -> {types, t (last poll), buf}.
        self._ctl: dict[int, dict] = {}
        self._sel = selectors.DefaultSelector()
        self._rids = itertools.count(1)
        self._trace_subs: dict[int, dict] = {}
        self._trace_seq = itertools.count(1)
        self._next_pump = 0.0

    def _run_child(self, worker_id: int, respawn: bool, query_sock,
                   hub_sock) -> None:
        os.environ["MTPU_HTTP_WORKERS"] = "1"
        os.environ["MTPU_WORKER_ID"] = str(worker_id)
        os.environ["MTPU_WORKER_TOTAL"] = str(self.n)
        if respawn:
            # A respawned worker boots while its siblings serve: the
            # boot's crash recovery must NOT run (it would sweep their
            # staged shards).
            os.environ["MTPU_WORKER_RESPAWN"] = "1"
        # The parent's handlers stop the fleet; a worker's attach()
        # installs its drain once it serves.
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)
        try:
            self.boot(self.address, WorkerContext(self.n, worker_id,
                                                  query_sock, hub_sock))
        except BaseException as e:  # noqa: BLE001 - child must not return
            print(f"worker {worker_id} boot failed: {e!r}", file=sys.stderr,
                  flush=True)
            os._exit(1)
        os._exit(0)

    def _spawn(self, worker_id: int, respawn: bool = False) -> int:
        sys.stdout.flush()
        sys.stderr.flush()
        query_parent, query_child = socket.socketpair()
        hub_parent, hub_child = socket.socketpair()
        pid = os.fork()
        if pid == 0:
            self._reserve.close()
            # The child keeps only its own pipes' ends.
            for sock in [query_parent, hub_parent] + [
                    r[k] for r in self._ctl.values() for k in ("query",
                                                               "hub")]:
                sock.close()
            self._children, self._pids, self._ctl = {}, (), {}
            try:
                self._run_child(worker_id, respawn, query_child, hub_child)
            finally:
                os._exit(1)
        query_child.close()
        hub_child.close()
        self._children[pid] = worker_id
        self._pids = tuple(self._children)
        rec = {"worker": worker_id, "pid": pid, "query": query_parent,
               "hub": hub_parent}
        self._ctl[pid] = rec
        self._sel.register(hub_parent, selectors.EVENT_READ, rec)
        return pid

    def _forget(self, pid: int) -> None:
        rec = self._ctl.pop(pid, None)
        if rec is None:
            return
        try:
            self._sel.unregister(rec["hub"])
        except (KeyError, ValueError):
            pass
        rec["hub"].close()
        rec["query"].close()

    # -- the parent's side of the control plane ---------------------------

    def _query(self, rec: dict, msg: dict, timeout: float) -> dict:
        return _rpc(rec["query"], self._rids, msg, timeout)

    def _serve_hub(self, rec: dict) -> None:
        """One request from a worker's hub pipe, answered; a worker
        whose pipe closed is forgotten."""
        try:
            msg = _recv_msg(rec["hub"], timeout=5.0)
        except (ConnectionError, OSError, ValueError):
            self._forget(rec["pid"])
            return
        op = msg.get("op")
        if op == "cluster_stats":
            reply = {"stats": self._collect_stats()}
        elif op == "trace_sub":
            reply = {"sub": self._trace_sub(msg.get("types") or ["s3"])}
        elif op == "trace_poll":
            reply = {"entries": self._trace_poll(msg.get("sub"))}
        elif op == "trace_unsub":
            self._trace_subs.pop(msg.get("sub"), None)
            reply = {"ok": 1}
        else:
            reply = {"error": f"unknown op {op!r}"}
        reply["rid"] = msg.get("rid")
        try:
            _send_msg(rec["hub"], reply)
        except OSError:
            self._forget(rec["pid"])

    def _collect_stats(self) -> list[dict]:
        out = []
        for rec in sorted(self._ctl.values(), key=lambda r: r["worker"]):
            try:
                out.append(self._query(rec, {"op": "stat"}, timeout=3.0))
            except (OSError, ConnectionError, ValueError):
                out.append({"worker": rec["worker"], "pid": rec["pid"],
                            "unreachable": True})
        return out

    def _trace_sub(self, types) -> int:
        sid = next(self._trace_seq)
        self._trace_subs[sid] = {
            "types": set(types), "t": time.monotonic(),
            "buf": collections.deque(maxlen=_TRACE_BUF)}
        # Arm the fleet before answering: a request made right after the
        # subscribe must not fall before the pump's first tick.
        self._trace_drain_once()
        return sid

    def _trace_poll(self, sid) -> list[dict]:
        sub = self._trace_subs.get(sid)
        if sub is None:
            return []
        sub["t"] = time.monotonic()
        out = list(sub["buf"])
        sub["buf"].clear()
        return out

    def _trace_drain_once(self) -> None:
        """One drain of every worker's relay, which also arms it with the
        wanted types; the entries go to each subscriber that wants them
        (a `broadcast` entry to every one)."""
        union = set()
        for sub in self._trace_subs.values():
            union |= sub["types"]
        if not union:
            return
        for rec in list(self._ctl.values()):
            try:
                reply = self._query(rec, {"op": "trace_drain",
                                          "types": sorted(union)},
                                    timeout=2.0)
            except (OSError, ConnectionError, ValueError):
                continue
            for e in reply.get("entries", []):
                et = e.get("trace_type", "s3")
                for sub in self._trace_subs.values():
                    if e.get("broadcast") or et in sub["types"]:
                        sub["buf"].append(e)

    def _trace_tick(self) -> None:
        """The pump: expire subscriptions nobody polls, drain while any
        lives, and stop every relay when the last one goes."""
        now = time.monotonic()
        if not self._trace_subs or now < self._next_pump:
            return
        self._next_pump = now + _TRACE_POLL_S
        self._trace_subs = {sid: sub for sid, sub in
                            self._trace_subs.items()
                            if now - sub["t"] <= _TRACE_SUB_TTL}
        if self._trace_subs:
            self._trace_drain_once()
            return
        for rec in list(self._ctl.values()):
            try:
                self._query(rec, {"op": "trace_stop"}, timeout=2.0)
            except (OSError, ConnectionError, ValueError):
                continue

    def _serve_control(self, wait: float) -> None:
        """Up to `wait` seconds of the control plane: the hub requests
        that came, then the pump's tick."""
        if self._trace_subs:
            wait = min(wait, max(0.0, self._next_pump - time.monotonic()))
        for key, _ in self._sel.select(timeout=wait):
            self._serve_hub(key.data)
        self._trace_tick()

    def start(self) -> None:
        """Fork worker 0, wait until it accepts (its boot initializes
        shared on-disk state, format.json and system volumes, exactly
        once and runs the crash recovery), then fork the rest."""
        signal.signal(signal.SIGTERM, lambda s, f: self.stop())
        signal.signal(signal.SIGINT, lambda s, f: self.stop())
        pid0 = self._spawn(0)
        self._wait_ready(pid0)
        for wid in range(1, self.n):
            if self._stopping:
                return
            self._spawn(wid)

    def _wait_ready(self, pid0: int) -> None:
        deadline = time.monotonic() + _READY_TIMEOUT
        while time.monotonic() < deadline and not self._stopping:
            done, status = os.waitpid(pid0, os.WNOHANG)
            if done:
                self._children.pop(pid0, None)
                self._pids = tuple(self._children)
                self._forget(pid0)
                raise RuntimeError(
                    f"worker 0 died during boot (status {status})")
            try:
                socket.create_connection((self.host, self.port),
                                         timeout=1.0).close()
                return
            except OSError:
                time.sleep(0.1)
        if not self._stopping:
            self.stop()
            raise RuntimeError("worker 0 never started accepting")

    def supervise(self) -> int:
        """Serve the control plane, reap children and respawn unexpected
        deaths (bounded); return once all children are gone after
        stop()."""
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return 0
            except InterruptedError:
                continue
            if pid == 0:
                self._serve_control(0.1)
                continue
            wid = self._children.pop(pid, None)
            self._pids = tuple(self._children)
            self._forget(pid)
            if wid is None:
                continue
            if self._stopping:
                if not self._children:
                    return 0
                continue
            self._respawns += 1
            if self._respawns > _MAX_RESPAWNS:
                print("too many worker deaths; shutting down",
                      file=sys.stderr, flush=True)
                self.stop()
                continue
            print(f"worker {wid} (pid {pid}) died (status {status}); "
                  "respawning", file=sys.stderr, flush=True)
            self._spawn(wid, respawn=True)

    def stop(self) -> None:
        """Graceful drain: SIGTERM every worker (they stop accepting,
        finish the requests in flight, exit); SIGKILL stragglers after
        _DRAIN_TIMEOUT. Signal-safe: touches only the lock-free _pids
        snapshot."""
        if self._stopping:
            return
        self._stopping = True
        for pid in self._pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + _DRAIN_TIMEOUT

        def reaper():
            while time.monotonic() < deadline:
                if not self._pids:
                    return
                time.sleep(0.1)
            for pid in self._pids:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        threading.Thread(target=reaper, daemon=True).start()


def serve_cli(argv, address: str, n_workers: int, main_fn) -> int:
    """CLI glue for `python -m minio_tpu_torch.server`: fork n_workers
    children that each re-enter main_fn with the concrete address and
    MTPU_HTTP_WORKERS=1 (the child's normal one-process boot), the
    parent supervising. main_fn picks its WorkerContext up through
    maybe_attach_worker once its server is ready."""

    def boot(concrete_addr: str, ctx: WorkerContext):
        global _PENDING_CTX
        _PENDING_CTX = ctx
        os.environ["MTPU_REUSE_PORT"] = "1"
        os._exit(main_fn(_swap_address(argv, address, concrete_addr)) or 0)

    pool = WorkerPool(address, n_workers, boot)
    print(f"minio_tpu_torch pre-forked front end: {pool.n} workers on "
          f"{pool.address} (SO_REUSEPORT), parent pid {os.getpid()}",
          flush=True)
    try:
        pool.start()
    except RuntimeError as e:
        print(f"FATAL: {e}", file=sys.stderr, flush=True)
        pool.supervise()
        return 1
    return pool.supervise()


def _swap_address(argv, old: str, new: str):
    out = list(argv)
    for i, a in enumerate(out):
        if a == old:
            out[i] = new
        elif a.startswith("--address=") and a[len("--address="):] == old:
            out[i] = f"--address={new}"
    if new not in out and not any(a.startswith("--address") for a in out):
        out = ["--address", new] + out
    return out


# Set by serve_cli's child boot before re-entering the server's main;
# consumed by maybe_attach_worker when the child's S3Server is ready.
_PENDING_CTX: WorkerContext | None = None


def maybe_attach_worker(server, finish) -> None:
    """Called by the server's main just before serving: if this process
    is a pre-forked worker, wire it up (see WorkerContext.attach)."""
    global _PENDING_CTX
    ctx, _PENDING_CTX = _PENDING_CTX, None
    if ctx is not None:
        ctx.attach(server, finish)

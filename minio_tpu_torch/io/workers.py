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

MTPU_HTTP_WORKERS: worker count (default = cores; 0/1 = one process,
as the tests run it). The fleet's control pipes (cluster stats, trace
relay) are not ported yet: they serve the port's metrics and tracing,
which come later.
"""

from __future__ import annotations

import errno
import fcntl
import os
import signal
import socket
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


class WorkerContext:
    """Everything a forked worker wires into its S3Server."""

    def __init__(self, total: int):
        self.total = total

    def attach(self, server, finish) -> None:
        """Wire the worker's server: divided admission, cross-process
        locks and cache generations under the first drive's system
        volume, and the drain on SIGTERM/SIGINT: `finish()` (stop
        accepting, drain, stop the background work, stamp the drives,
        print the launches), then exit."""
        server.admission = server.admission.divided(self.total)
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

    def _run_child(self, worker_id: int, respawn: bool) -> None:
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
            self.boot(self.address, WorkerContext(self.n))
        except BaseException as e:  # noqa: BLE001 - child must not return
            print(f"worker {worker_id} boot failed: {e!r}", file=sys.stderr,
                  flush=True)
            os._exit(1)
        os._exit(0)

    def _spawn(self, worker_id: int, respawn: bool = False) -> int:
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            self._reserve.close()
            self._children, self._pids = {}, ()
            try:
                self._run_child(worker_id, respawn)
            finally:
                os._exit(1)
        self._children[pid] = worker_id
        self._pids = tuple(self._children)
        return pid

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
        """Reap children; respawn unexpected deaths (bounded); return
        once all children are gone after stop()."""
        while True:
            try:
                pid, status = os.wait()
            except ChildProcessError:
                return 0
            except InterruptedError:
                continue
            wid = self._children.pop(pid, None)
            self._pids = tuple(self._children)
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

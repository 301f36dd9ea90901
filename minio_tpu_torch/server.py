"""Command line: serve S3 from pools of erasure sets on the card.

    python -m minio_tpu_torch.server --address HOST:PORT \
        [--device cuda|cpu] [--parity N] [--set-size N] \
        [--drive-timeout S] [--scanner-interval S] [--boot-timeout S] \
        DRIVES [DRIVES ...]

Distributed (the same command on every node; a drive endpoint
`http://HOST:PORT/PATH` belongs to the node serving S3 on HOST:PORT,
whose grid listens on PORT + 1000, as minio_tpu/server.py has it; a
node knows its own endpoints by its --address port and its host name):

    python -m minio_tpu_torch.server --address 0.0.0.0:9000 \
        http://minio{1...4}.example.net:9000/mnt/disk{1...4}/minio

The drive arguments are minio_tpu/server.py's (topology/ellipses.py):
each argument with a `{x...y}` range expands and is a server pool of its
own, the plain arguments together form one more, and each pool splits
into erasure sets of --set-size drives (default: the largest of 2-16
that divides the pool). `ROOT/p1/d{1...24} ROOT/p2/d{1...16}` is two
pools: 2 sets x 12 drives at EC 8+4, and 1 set x 16 at EC 12+4. A set
size that does not divide a pool, a pool that no size of 2-16 divides
(17 drives) and a --parity above half the set size are refused before
anything else runs, as minio_tpu/server.py refuses them.

Boot runs the golden gates first, as minio_tpu/server.py does, and
refuses to serve if any fails: the reference's erasure self-test on the
host codec and again through the card's GF kernel, the bitrot self-test,
and the HighwayHash golden checks through the card's hash kernel. Then
the drive plane boots pool by pool in minio_tpu/server.py's order.
format.json orders each pool's drives (topology/format.boot: all fresh,
a new layout is written, a second pool's under the first pool's
deployment id; otherwise the quorum layout's slots, a fresh drive
adopted into a missing slot and marked healing, a refused or missing
slot served by an OfflineDisk); a pool of another deployment is fatal.
Each drive in its slot gets its crash recovery: the group-commit WALs
replay, stale temporaries and uncommitted data dirs go, and objects
whose journals or data dirs were lost are queued on the MRF of the set
that owns them (storage/local.recovery_sweep); a drive whose previous
process stopped through main()'s shutdown path carries a clean-shutdown
stamp and gets the WAL replay and the temporaries' purge only. Every
drive is wrapped in a per-call deadline with a breaker
(storage/health.py) unless --drive-timeout is 0. The sets form
object/sets.ErasureSets (a key's set by SipHash under the deployment
id) and the pools object/pools.ServerPools. With more than one pool,
a bucket missing from a pool is made there with its metadata record
(a pool added to a deployment starts empty), the pools a persisted
decommission drains leave placement, and an interrupted decommission
or rebalance resumes. The periodic scanner (object/scanner.Scanner,
every --scanner-interval seconds, 0 = off) and the drive lifecycle
manager (object/drive_heal.DriveHealManager, polling at the scanner's
interval, 10 s when the scanner is off) start over the sets this
process owns. Credentials come from MINIO_ROOT_USER /
MINIO_ROOT_PASSWORD (default minioadmin/minioadmin).

It serves from a pre-forked fleet of MTPU_HTTP_WORKERS processes
(default: the host's cores; 1 serves from this process), as
minio_tpu/server.py does (io/workers.py). The parent validates the
arguments, builds the CUDA kernels (nvcc subprocesses only) and forks
before anything touches CUDA; each worker then runs the whole boot
above with its own CUDA context, on the SAME port through
SO_REUSEPORT, with admission control (s3/admission.py), the
fileinfo and hot-object caches kept coherent across workers, and
namespace locks that exclude the other workers. Only first-boot worker
0 runs the crash recovery (a respawned one does not: its siblings
serve) and the bucket sync; worker 0 resumes a migration; and the
background work is sharded by set: set i (numbered across pools) is
scanned and bulk-healed by worker i mod the fleet's width.

With endpoints of other nodes the boot is minio_tpu/server.py's
distributed one (reference serverMain, cmd/server-main.go:882-942). The
grid plane comes up first (start_grid): worker 0 listens on the grid
port with the storage RPCs of this node's drives, the node's dsync lock
server and `node.info`, and waits up to --boot-timeout (120 s) for every
peer's grid; a sibling worker binds nothing and votes through worker 0
over loopback. The drives of other nodes are remote drives
(storage/remote.py) behind the same health wrapper. The node owning a
pool's first endpoint writes a fresh layout; the others wait for it and
retry the format boot 5 times. Every set locks its keys through dsync
over all nodes' lock servers (grid/dsync.DistNSLock; in a fleet inside
the workers' flock locks). Worker 0 then asks every peer's `node.info`:
a peer of another deployment is fatal. Sets with remote drives run
without the cross-node cache protocol, which is not ported: their
caches answer misses, they have no group commit, and bucket metadata
is cached 2 s. The scanner and the bulk heals are sharded over nodes x
workers (set i by slot i mod the fleet's slots). A distributed
deployment resumes no migration, and the rebalance and decommission
admin verbs answer 501: without a coordinator lease two nodes could
walk at once.

A clean stop (SIGINT to one process; SIGTERM or SIGINT to a fleet's
parent, which forwards SIGTERM to its workers) stops accepting, lets
the requests in flight finish, stops the scanner, the bulk heals and a
migration walk (checkpointed), closes the sets, stamps the drives and
prints the card's kernel launches while it served (a worker's line
names the worker) and, distributed, the dsync locks it took.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.erasure.selftest import erasure_self_test
from minio_tpu_torch.grid import GridServer, client_for, dsync
from minio_tpu_torch.grid.client import peer_stats
from minio_tpu_torch.grid.dsync import (DistNSLock, LocalLocker, LockServer,
                                        RemoteLocker)
from minio_tpu_torch.io import workers as workers_mod
from minio_tpu_torch.object.drive_heal import (DriveHealManager,
                                               admission_pressure)
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.pools import ServerPools
from minio_tpu_torch.object.scanner import Scanner
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.ops import _build
from minio_tpu_torch.ops.rs_device import GpuBackend
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.storage import group_commit
from minio_tpu_torch.storage.health import wrap_disks
from minio_tpu_torch.storage.local import (LocalStorage, OfflineDisk,
                                           consume_clean_shutdown,
                                           mark_clean_shutdown,
                                           recovery_sweep, sweep_stale_tmp)
from minio_tpu_torch.storage.remote import RemoteStorage, StorageRPCService
from minio_tpu_torch.topology import ellipses
from minio_tpu_torch.topology import format as fmt_mod
from minio_tpu_torch.utils.latency import summarize

# A node's grid listens on its S3 port + this (minio_tpu/server.py's
# offset; the cluster harness relies on it).
GRID_PORT_OFFSET = 1000


def parse_args(argv=None) -> argparse.Namespace:
    """The arguments, with `pools` (lists of drive paths) and each
    pool's set size checked (minio_tpu/server.py `main`)."""
    p = argparse.ArgumentParser(prog="python -m minio_tpu_torch.server",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--address", default="127.0.0.1:9000", help="HOST:PORT")
    p.add_argument("--device", default=device_mod.DEFAULT_DEVICE,
                   choices=("cuda", "cpu"),
                   help="where the kernels run (cpu = plain PyTorch path)")
    p.add_argument("--parity", type=int, default=None,
                   help="parity shards (default: by set size, 4 for 8+ drives)")
    p.add_argument("--set-size", type=int, default=None,
                   help="drives per erasure set (default: auto 2-16)")
    p.add_argument("--drive-timeout", type=float, default=10.0,
                   help="per-call drive deadline in seconds, with a "
                        "breaker; 0 disables the health wrapper")
    p.add_argument("--scanner-interval", type=float, default=60.0,
                   help="seconds between scanner cycles; 0 disables it")
    p.add_argument("--boot-timeout", type=float, default=120.0,
                   help="seconds to wait for peer nodes at boot")
    p.add_argument("drives", nargs="+",
                   help="drive directories or http://host:port/path "
                        "endpoints; `{1...N}` ellipses expand, and each "
                        "ellipses argument forms its own server pool")
    args = p.parse_args(argv)
    try:
        args.pools = ellipses.parse_pools(args.drives)
        args.endpoints = [[ellipses.parse_endpoint(d) for d in spec]
                          for spec in args.pools]
    except ValueError as e:
        p.error(str(e))
    for spec in args.pools:
        try:
            size = args.set_size or ellipses.choose_set_size(len(spec))
        except ValueError as e:
            p.error(str(e))
        if len(spec) % size:
            p.error(f"{len(spec)} drives not divisible into sets of {size}")
        if args.parity is not None and not 0 <= args.parity <= size // 2:
            p.error(f"--parity must be in [0, {size // 2}] for "
                    f"{size}-drive sets")
    return args


_NO_RECOVERY = {"swept": 0, "wal_replayed": 0, "wal_repaired": 0,
                "wal_discarded": 0, "removed": 0, "dangling": 0}


def recover_drives(disks) -> dict:
    """Crash recovery of every drive before the set serves
    (minio_tpu/server.py runs the same at boot): the deep sweep after a
    crash, the WAL replay and temporaries' purge after a clean stop.
    Returns the drives' totals: drives swept deep, WAL frames replayed,
    journals repaired from them, torn tails discarded, entries removed,
    dangling data dirs, and the (bucket, path) list to heal."""
    out = dict(_NO_RECOVERY)
    heal: dict = {}                 # (bucket, path) in first-seen order
    for d in disks:
        if not consume_clean_shutdown(d):
            rep = recovery_sweep(d)
            out["swept"] += 1
            heal.update(dict.fromkeys(rep["heal"]))
        else:
            gc = group_commit.replay_wals(d)
            rep = {"removed": sweep_stale_tmp(d), "dangling": 0,
                   **{f"wal_{k}": v for k, v in gc.items()}}
        for k in ("wal_replayed", "wal_repaired", "wal_discarded",
                  "removed", "dangling"):
            out[k] += rep[k]
    out["heal"] = list(heal)
    return out


class Topology:
    """Which endpoints are this node's (minio_tpu/server.py `is_local`):
    a plain path, or a URL naming this node's host and S3 port. The
    other nodes are the (host, port) pairs of every other URL."""

    def __init__(self, address: str, endpoints: list):
        host, _, port = address.rpartition(":")
        self.port = int(port)
        self._hosts = {"127.0.0.1", "localhost", "0.0.0.0",
                       host or "127.0.0.1", socket.gethostname()}
        self.all = [ep for spec in endpoints for ep in spec]
        self.remote_nodes = sorted({(ep.host, ep.port) for ep in self.all
                                    if not self.is_local(ep)})
        self.distributed = bool(self.remote_nodes)

    def is_local(self, ep) -> bool:
        return ep.host is None or (ep.port == self.port
                                   and ep.host in self._hosts)

    def node_rank(self) -> tuple[int, int]:
        """(this node's rank, node count) in the sorted node list, the
        same on every node since every node runs the same command."""
        nodes = sorted({(ep.host, ep.port) for ep in self.all})
        remote = set(self.remote_nodes)
        return next((i for i, hp in enumerate(nodes)
                     if hp not in remote), 0), len(nodes)


def start_grid(topo: Topology, local: dict, owner: bool,
               boot_timeout: float):
    """The node's grid plane before the object layer (minio_tpu/server.py;
    reference initGlobalGrid, cmd/server-main.go:882). The owner (worker
    0, or the one process) listens on the S3 port + GRID_PORT_OFFSET
    with the storage RPCs of the local drives, the node's lock server
    and `node.info`, and waits up to `boot_timeout` for every peer's
    grid. A sibling worker binds nothing: the node's own lock vote is
    one more RemoteLocker, over loopback to worker 0. Returns (grid
    server or None, the node-info dict it answers, the lockers: this
    node's first, then one a peer)."""
    grid_port = topo.port + GRID_PORT_OFFSET
    peers = [RemoteLocker(client_for(h, p + GRID_PORT_OFFSET))
             for h, p in topo.remote_nodes]
    deadline = time.monotonic() + boot_timeout
    if not owner:
        self_client = client_for("127.0.0.1", grid_port)
        while not self_client.ping(timeout=2.0):
            if time.monotonic() > deadline:
                print("WARN: the node's grid plane (worker 0) is "
                      "unreachable; lock quorum degraded", file=sys.stderr)
                break
            time.sleep(0.2)
        return None, None, [RemoteLocker(self_client)] + peers
    srv = GridServer(grid_port)
    StorageRPCService(local).register_into(srv)
    lock_server = LockServer()
    lock_server.register_into(srv)
    node_info = {"deployment_id": ""}
    srv.register("node.info", lambda p: dict(node_info))
    srv.start()
    print(f"grid mesh on :{srv.port} ({len(local)} local drives)",
          flush=True)
    for host, port in topo.remote_nodes:
        c = client_for(host, port + GRID_PORT_OFFSET)
        while not c.ping(timeout=2.0):
            if time.monotonic() > deadline:
                print(f"WARN: peer {host}:{port} unreachable; its drives "
                      "boot offline", file=sys.stderr)
                break
            time.sleep(0.5)
    return srv, node_info, [LocalLocker(lock_server)] + peers


def boot_format(disks: list, size: int, deployment_id, leader: bool,
                distributed: bool, boot_timeout: float):
    """topology/format.boot of one pool. In a distributed deployment the
    node owning the pool's first endpoint writes a fresh layout; the
    others wait until formats appear and stop changing (the leader
    writes them one drive after another), then retry the boot 5 times
    2 s apart (minio_tpu/server.py)."""
    if distributed and not leader:
        deadline = time.monotonic() + boot_timeout
        seen = 0
        while time.monotonic() < deadline:
            now = sum(fmt_mod._safe_read(d) is not None for d in disks)
            if now == len(disks) or (now and now == seen):
                break
            seen = now
            time.sleep(0.5)
    attempts = 5 if distributed else 1
    for attempt in range(attempts):
        try:
            return fmt_mod.boot(disks, size, deployment_id)
        except fmt_mod.FormatError:
            if attempt == attempts - 1:
                raise
            time.sleep(2.0)


def check_peers(topo: Topology, node_info: dict, deployment_id: str) -> None:
    """The node.info handshake (reference verifyServerSystemConfig,
    cmd/server-main.go:928): a peer of another deployment is fatal. A
    peer still booting (no answer, or no id yet) passes."""
    node_info["deployment_id"] = deployment_id
    for host, port in topo.remote_nodes:
        try:
            info = client_for(host, port + GRID_PORT_OFFSET).call(
                "node.info", None, timeout=3.0)
        except Exception:  # noqa: BLE001 - peer still booting
            continue
        peer = (info or {}).get("deployment_id", "")
        if peer and peer != deployment_id:
            raise fmt_mod.FormatError(
                f"peer {host}:{port} deployment {peer} != {deployment_id}")


def boot(argv=None) -> S3Server:
    """Parse, run the boot gates, open the pools; a server ready to
    serve_forever(). In a pre-forked worker (MTPU_WORKER_ID), the crash
    recovery and the bucket sync run only in first-boot worker 0, a
    migration resumes only in worker 0, and the scanner and the bulk
    heals cover the sets whose index modulo the fleet's width is the
    worker's. With endpoints on other nodes, the grid plane comes up
    first (start_grid), the pools' drives on other nodes are remote
    drives, each set locks through dsync over every node's lock server,
    and the background work is sharded over nodes x workers."""
    args = parse_args(argv)
    worker = os.environ.get("MTPU_WORKER_ID", "")
    owner = worker in ("", "0")
    recovers = owner and not os.environ.get("MTPU_WORKER_RESPAWN")
    device = device_mod.resolve(args.device)
    erasure_self_test()
    erasure_self_test(GpuBackend(device))
    bitrot.bitrot_self_test()
    bitrot.device_self_test(device)
    topo = Topology(args.address, args.endpoints)
    local = {ep.path: LocalStorage(ep.path,
                                   endpoint=str(ep) if ep.is_url else "")
             for ep in topo.all if topo.is_local(ep)}
    grid_srv = node_info = None
    lockers: list = []
    if topo.distributed:
        grid_srv, node_info, lockers = start_grid(topo, local, owner,
                                                  args.boot_timeout)

    def make_disk(ep):
        if topo.is_local(ep):
            return local[ep.path]
        return RemoteStorage(ep.host, ep.port + GRID_PORT_OFFSET, ep.path)

    pools, formats, in_slots = [], [], []
    recovery = dict(_NO_RECOVERY, heal=[])
    pending = []                    # (pool, bucket, path) to heal
    adopted = offline = 0
    deployment_id = None
    for pi, spec in enumerate(args.endpoints):
        size = args.set_size or ellipses.choose_set_size(len(spec))
        ordered, fmt = boot_format([make_disk(ep) for ep in spec], size,
                                   deployment_id, topo.is_local(spec[0]),
                                   topo.distributed, args.boot_timeout)
        if deployment_id is not None and fmt.deployment_id != deployment_id:
            # Two deployments are never federated (reference: a mixed
            # deployment id is fatal at boot).
            raise fmt_mod.FormatError(
                f"pool {pi} belongs to deployment {fmt.deployment_id}, "
                f"expected {deployment_id}")
        deployment_id = fmt.deployment_id
        # Only this node's drives in their slots are recovered and, at a
        # clean stop, stamped: a refused drive is never written.
        slotted = [d for d in ordered if isinstance(d, LocalStorage)]
        if recovers:
            rep = recover_drives(slotted)
            for k, v in rep.items():
                recovery[k] += v
            pending += [(pi, vol, path) for vol, path in rep["heal"]]
        adopted += sum(1 for d in ordered
                       if d is not None and d.disk_info().healing)
        offline += sum(d is None for d in ordered)
        ordered = [d if d is not None else OfflineDisk(f"pos-{i}")
                   for i, d in enumerate(ordered)]
        if args.drive_timeout > 0:
            ordered = wrap_disks(ordered, op_timeout=args.drive_timeout)
        sets = [ErasureSet(ordered[i:i + size], parity=args.parity,
                           device=device)
                for i in range(0, len(ordered), size)]
        if topo.distributed:
            for s in sets:
                s.ns = DistNSLock(lockers)
        pools.append(ErasureSets(sets, fmt.deployment_id))
        formats.append(fmt)
        in_slots += slotted
    if node_info is not None:
        check_peers(topo, node_info, deployment_id)
    layer = ServerPools(pools)
    layer.distributed = topo.distributed
    for pi, vol, path in pending:
        pools[pi].set_for(path).mrf.enqueue(vol, path)
    if len(pools) > 1:
        if recovers:
            layer.sync_buckets()
        layer.sync_decommission_markers()
        # A distributed deployment resumes no migration: with no
        # coordinator lease, every node would run the walk.
        if owner and not topo.distributed:
            for what, resume in (("decommission", layer.resume_decommission),
                                 ("rebalance", layer.resume_rebalance)):
                if resume() is not None:
                    print(f"resuming an interrupted pool {what}", flush=True)
    # Every set is scanned and bulk-healed by one (node, worker) slot of
    # the fleet (minio_tpu/server.py).
    width = int(os.environ.get("MTPU_WORKER_TOTAL") or 1)
    rank, nodes = topo.node_rank() if topo.distributed else (0, 1)
    slot = rank * width + int(worker or 0)
    owned = [s for i, s in enumerate(layer.sets)
             if i % (nodes * width) == slot]
    scanner = Scanner(owned, interval=args.scanner_interval)
    if args.scanner_interval > 0 and owned:
        scanner.start()
    drive_heal = DriveHealManager(owned,
                                  total_hint=lambda: scanner.usage.objects)
    if owned:
        drive_heal.start(interval=args.scanner_interval
                         if args.scanner_interval > 0 else 10.0)
    host, _, port = args.address.rpartition(":")
    srv = S3Server(layer, (host or "127.0.0.1", int(port)),
                   {os.environ.get("MINIO_ROOT_USER", "minioadmin"):
                    os.environ.get("MINIO_ROOT_PASSWORD", "minioadmin")})
    # The bulk heal and a migration walk yield while clients queue
    # (minio_tpu/server.py).
    drive_heal.pressure = lambda: admission_pressure(srv.admission)
    layer.migration_pressure = drive_heal.pressure
    srv.recovery = recovery
    srv.format = formats[0]
    srv.drives = in_slots
    srv.scanner = scanner
    srv.drive_heal = drive_heal
    srv.grid_server = grid_srv
    srv.distributed = topo.distributed
    if recovers:
        print("recovery: " + ", ".join(
            f"{k} {len(v) if k == 'heal' else v}"
            for k, v in recovery.items()), flush=True)
    else:
        print(f"recovery: left to first-boot worker 0 (worker {worker})",
              flush=True)
    n = len(topo.all)
    print(f"format: deployment {deployment_id}, {n - offline} drives "
          f"in their slots, {adopted} healing, {offline} "
          f"offline; drive timeout {args.drive_timeout} s, scanner "
          f"interval {args.scanner_interval} s", flush=True)
    descs = []
    for pi, pool in enumerate(pools):
        sets, first = len(pool.sets), pool.sets[0]
        m = first.default_parity
        desc = f"EC {len(first.disks) - m}+{m}"
        if sets > 1:
            desc = f"{sets} sets x {len(first.disks)}, {desc}"
        descs.append(f"pool {pi}: {desc}" if len(pools) > 1 else desc)
    if topo.distributed:
        descs.append(f"distributed over {nodes} nodes, {len(local)} "
                     "drives here")
    fleet = f", worker {worker} of {os.environ.get('MTPU_WORKER_TOTAL')}" \
        f", pid {os.getpid()}, scanning {len(owned)} sets" if worker else ""
    print(f"serving S3 on http://{srv.address} ({n} drives, "
          f"{'; '.join(descs)}, device {device}{fleet})", flush=True)
    return srv


def launch_counts() -> dict:
    """The card's kernel launches so far in this process: gf_apply, in
    all, by its number of matrix rows and by its geometry "k,r", and
    highwayhash256."""
    from minio_tpu_torch.ops import hh_device, rs_device
    return {"gf_apply": rs_device.LAUNCHES,
            "gf_apply_by_r": dict(rs_device.LAUNCHES_BY_R),
            "gf_apply_by_kr": {f"{k},{r}": n for (k, r), n
                               in rs_device.LAUNCHES_BY_KR.items()},
            "highwayhash256": hh_device.LAUNCHES}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if not os.environ.get("MTPU_WORKER_ID"):
        n_workers = workers_mod.worker_count_from_env()
        if n_workers > 1:
            # The fleet forks before anything touches CUDA; nvcc runs
            # here once so that N workers do not each compile.
            if args.device == "cuda":
                try:
                    _build.build()
                except _build.KernelBuildError as e:
                    print(f"FATAL: {e}", file=sys.stderr)
                    return 1
            return workers_mod.serve_cli(argv, args.address, n_workers,
                                         main)
    try:
        srv = boot(argv)
    except fmt_mod.FormatError as e:
        print(f"FATAL: format verification failed: {e}", file=sys.stderr)
        return 1
    base = launch_counts()
    worker = os.environ.get("MTPU_WORKER_ID", "")

    def finish() -> None:
        # Stop accepting and drain; the scanner and the bulk heals stop
        # (checkpointed) before the set closes and the drives get their
        # clean-shutdown stamps.
        srv.stop()
        if srv.grid_server is not None:
            srv.grid_server.stop()
        for d in srv.drives:
            mark_clean_shutdown(d)
        now = launch_counts()

        def since(key: str) -> dict:
            return {str(g): n - base[key].get(g, 0)
                    for g, n in sorted(now[key].items())
                    if n > base[key].get(g, 0)}
        print(("worker " + worker + " " if worker else "")
              + "kernel launches while serving: " + json.dumps({
                  "gf_apply": now["gf_apply"] - base["gf_apply"],
                  "gf_apply_by_r": since("gf_apply_by_r"),
                  "gf_apply_by_kr": since("gf_apply_by_kr"),
                  "highwayhash256": now["highwayhash256"]
                  - base["highwayhash256"]}), flush=True)
        if srv.distributed:
            st = dsync.ACQUIRE.state()
            print(("worker " + worker + " " if worker else "")
                  + "dsync locks while serving: " + json.dumps({
                      "taken": st["count"], "refused": dsync.REFUSED,
                      "acquire_s": summarize(st),
                      "acquire_hist": st}), flush=True)
            print(("worker " + worker + " " if worker else "")
                  + "grid peers: " + json.dumps(peer_stats()), flush=True)

    # A pre-forked worker drains on SIGTERM/SIGINT through finish().
    workers_mod.maybe_attach_worker(srv, finish)
    srv.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())

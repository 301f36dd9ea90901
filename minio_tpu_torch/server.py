"""Command line: serve S3 from pools of erasure sets on the card.

    python -m minio_tpu_torch.server --address HOST:PORT \
        [--device cuda|cpu] [--parity N] [--set-size N] \
        [--drive-timeout S] [--scanner-interval S] DRIVES [DRIVES ...]

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

A clean stop (SIGINT to one process; SIGTERM or SIGINT to a fleet's
parent, which forwards SIGTERM to its workers) stops accepting, lets
the requests in flight finish, stops the scanner, the bulk heals and a
migration walk (checkpointed), closes the sets, stamps the drives and
prints the card's kernel launches while it served (a worker's line
names the worker).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.erasure.selftest import erasure_self_test
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
from minio_tpu_torch.topology import ellipses
from minio_tpu_torch.topology import format as fmt_mod


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
    p.add_argument("drives", nargs="+",
                   help="drive directories; `{1...N}` ellipses expand, and "
                        "each ellipses argument forms its own server pool")
    args = p.parse_args(argv)
    try:
        args.pools = ellipses.parse_pools(args.drives)
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


def boot(argv=None) -> S3Server:
    """Parse, run the boot gates, open the pools; a server ready to
    serve_forever(). In a pre-forked worker (MTPU_WORKER_ID), the crash
    recovery and the bucket sync run only in first-boot worker 0, a
    migration resumes only in worker 0, and the scanner and the bulk
    heals cover the sets whose index modulo the fleet's width is the
    worker's."""
    args = parse_args(argv)
    worker = os.environ.get("MTPU_WORKER_ID", "")
    owner = worker in ("", "0")
    recovers = owner and not os.environ.get("MTPU_WORKER_RESPAWN")
    device = device_mod.resolve(args.device)
    erasure_self_test()
    erasure_self_test(GpuBackend(device))
    bitrot.bitrot_self_test()
    bitrot.device_self_test(device)
    pools, formats, in_slots = [], [], []
    recovery = dict(_NO_RECOVERY, heal=[])
    pending = []                    # (pool, bucket, path) to heal
    adopted = offline = 0
    deployment_id = None
    for pi, spec in enumerate(args.pools):
        size = args.set_size or ellipses.choose_set_size(len(spec))
        ordered, fmt = fmt_mod.boot([LocalStorage(d) for d in spec], size,
                                    deployment_id)
        if deployment_id is not None and fmt.deployment_id != deployment_id:
            # Two deployments are never federated (reference: a mixed
            # deployment id is fatal at boot).
            raise fmt_mod.FormatError(
                f"pool {pi} belongs to deployment {fmt.deployment_id}, "
                f"expected {deployment_id}")
        deployment_id = fmt.deployment_id
        # Only the drives in their slots are recovered and, at a clean
        # stop, stamped: a refused drive is never written.
        slotted = [d for d in ordered if d is not None]
        if recovers:
            rep = recover_drives(slotted)
            for k, v in rep.items():
                recovery[k] += v
            pending += [(pi, vol, path) for vol, path in rep["heal"]]
        adopted += sum(1 for d in slotted if d.disk_info().healing)
        offline += len(ordered) - len(slotted)
        ordered = [d if d is not None else OfflineDisk(f"pos-{i}")
                   for i, d in enumerate(ordered)]
        if args.drive_timeout > 0:
            ordered = wrap_disks(ordered, op_timeout=args.drive_timeout)
        pools.append(ErasureSets(
            [ErasureSet(ordered[i:i + size], parity=args.parity,
                        device=device)
             for i in range(0, len(ordered), size)], fmt.deployment_id))
        formats.append(fmt)
        in_slots += slotted
    layer = ServerPools(pools)
    for pi, vol, path in pending:
        pools[pi].set_for(path).mrf.enqueue(vol, path)
    if len(pools) > 1:
        if recovers:
            layer.sync_buckets()
        layer.sync_decommission_markers()
        if owner:
            for what, resume in (("decommission", layer.resume_decommission),
                                 ("rebalance", layer.resume_rebalance)):
                if resume() is not None:
                    print(f"resuming an interrupted pool {what}", flush=True)
    fleet_slots = int(os.environ.get("MTPU_WORKER_TOTAL") or 1)
    owned = [s for i, s in enumerate(layer.sets)
             if i % fleet_slots == int(worker or 0)]
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
    if recovers:
        print("recovery: " + ", ".join(
            f"{k} {len(v) if k == 'heal' else v}"
            for k, v in recovery.items()), flush=True)
    else:
        print(f"recovery: left to first-boot worker 0 (worker {worker})",
              flush=True)
    n = sum(len(spec) for spec in args.pools)
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

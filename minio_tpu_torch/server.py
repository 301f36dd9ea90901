"""Command line: serve S3 from one erasure set on the card.

    python -m minio_tpu_torch.server --address HOST:PORT \
        [--device cuda|cpu] [--parity N] [--drive-timeout S] \
        [--scanner-interval S] DRIVE [DRIVE ...]

Boot runs the golden gates first, as minio_tpu/server.py does, and
refuses to serve if any fails: the reference's erasure self-test on the
host codec and again through the card's GF kernel, the bitrot self-test,
and the HighwayHash golden checks through the card's hash kernel. Then
the drive plane boots in minio_tpu/server.py's order. format.json
orders the drives (topology/format.boot: all fresh, a new one-set layout
is written; otherwise the quorum layout's slots, a fresh drive adopted
into a missing slot and marked healing, a refused or missing slot served
by an OfflineDisk). Each drive in its slot gets its crash recovery: the
group-commit WALs replay, stale temporaries and uncommitted data dirs
go, and objects whose journals or data dirs were lost are queued on the
set's MRF for heal (storage/local.recovery_sweep); a drive whose
previous process stopped through main()'s shutdown path carries a
clean-shutdown stamp and gets the WAL replay and the temporaries' purge
only. Every drive is wrapped in a per-call deadline with a breaker
(storage/health.py) unless --drive-timeout is 0; the set, its MRF
queue, the periodic scanner (object/scanner.Scanner, every
--scanner-interval seconds, 0 = off) and the drive lifecycle manager
(object/drive_heal.DriveHealManager, polling at the scanner's interval,
10 s when the scanner is off) start. Then it serves in one process
(CUDA does not survive a fork, so the pre-forked worker fleet of the
TPU package is not used). Credentials come from
MINIO_ROOT_USER / MINIO_ROOT_PASSWORD (default minioadmin/minioadmin).
A clean stop (SIGINT) stops the scanner and the bulk heals, closes the
set, stamps the drives and prints the card's kernel launches while it
served.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.erasure.selftest import erasure_self_test
from minio_tpu_torch.object.drive_heal import DriveHealManager
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.object.scanner import Scanner
from minio_tpu_torch.ops.rs_device import GpuBackend
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.storage import group_commit
from minio_tpu_torch.storage.health import wrap_disks
from minio_tpu_torch.storage.local import (LocalStorage, OfflineDisk,
                                           consume_clean_shutdown,
                                           mark_clean_shutdown,
                                           recovery_sweep, sweep_stale_tmp)
from minio_tpu_torch.topology import format as fmt_mod


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m minio_tpu_torch.server",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--address", default="127.0.0.1:9000", help="HOST:PORT")
    p.add_argument("--device", default=device_mod.DEFAULT_DEVICE,
                   choices=("cuda", "cpu"),
                   help="where the kernels run (cpu = plain PyTorch path)")
    p.add_argument("--parity", type=int, default=None,
                   help="parity shards (default: by set size, 4 for 8+ drives)")
    p.add_argument("--drive-timeout", type=float, default=10.0,
                   help="per-call drive deadline in seconds, with a "
                        "breaker; 0 disables the health wrapper")
    p.add_argument("--scanner-interval", type=float, default=60.0,
                   help="seconds between scanner cycles; 0 disables it")
    p.add_argument("drives", nargs="+", help="one directory per drive")
    return p.parse_args(argv)


def recover_drives(disks) -> dict:
    """Crash recovery of every drive before the set serves
    (minio_tpu/server.py runs the same at boot): the deep sweep after a
    crash, the WAL replay and temporaries' purge after a clean stop.
    Returns the drives' totals: drives swept deep, WAL frames replayed,
    journals repaired from them, torn tails discarded, entries removed,
    dangling data dirs, and the (bucket, path) list to heal."""
    out = {"swept": 0, "wal_replayed": 0, "wal_repaired": 0,
           "wal_discarded": 0, "removed": 0, "dangling": 0}
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
    """Parse, run the boot gates, open the drives; a server ready to
    serve_forever()."""
    args = parse_args(argv)
    device = device_mod.resolve(args.device)
    erasure_self_test()
    erasure_self_test(GpuBackend(device))
    bitrot.bitrot_self_test()
    bitrot.device_self_test(device)
    disks = [LocalStorage(d) for d in args.drives]
    n = len(disks)
    ordered, fmt = fmt_mod.boot(disks, n)
    # Only the drives in their slots are recovered and, at a clean stop,
    # stamped: a refused drive is never written.
    in_slots = [d for d in ordered if d is not None]
    recovery = recover_drives(in_slots)
    adopted = sum(1 for d in in_slots if d.disk_info().healing)
    ordered = [d if d is not None else OfflineDisk(f"pos-{i}")
               for i, d in enumerate(ordered)]
    if args.drive_timeout > 0:
        ordered = wrap_disks(ordered, op_timeout=args.drive_timeout)
    objects = ErasureSet(ordered, parity=args.parity, device=device)
    for vol, path in recovery["heal"]:
        objects.mrf.enqueue(vol, path)
    scanner = Scanner([objects], interval=args.scanner_interval)
    if args.scanner_interval > 0:
        scanner.start()
    drive_heal = DriveHealManager([objects],
                                  total_hint=lambda: scanner.usage.objects)
    drive_heal.start(interval=args.scanner_interval
                     if args.scanner_interval > 0 else 10.0)
    host, _, port = args.address.rpartition(":")
    srv = S3Server(objects, (host or "127.0.0.1", int(port)),
                   {os.environ.get("MINIO_ROOT_USER", "minioadmin"):
                    os.environ.get("MINIO_ROOT_PASSWORD", "minioadmin")})
    srv.recovery = recovery
    srv.format = fmt
    srv.drives = in_slots
    srv.scanner = scanner
    srv.drive_heal = drive_heal
    print("recovery: " + ", ".join(f"{k} {len(v) if k == 'heal' else v}"
                                   for k, v in recovery.items()), flush=True)
    offline = sum(isinstance(d, OfflineDisk) for d in ordered)
    print(f"format: deployment {fmt.deployment_id}, {n - offline} drives "
          f"in their slots, {adopted} healing, {offline} "
          f"offline; drive timeout {args.drive_timeout} s, scanner "
          f"interval {args.scanner_interval} s", flush=True)
    m = objects.default_parity
    print(f"serving S3 on http://{srv.address} ({n} drives, EC {n - m}+{m}, "
          f"device {device})", flush=True)
    return srv


def launch_counts() -> dict:
    """The card's kernel launches so far in this process: gf_apply, in
    all and by its number of matrix rows, and highwayhash256."""
    from minio_tpu_torch.ops import hh_device, rs_device
    return {"gf_apply": rs_device.LAUNCHES,
            "gf_apply_by_r": dict(rs_device.LAUNCHES_BY_R),
            "highwayhash256": hh_device.LAUNCHES}


def main(argv=None) -> int:
    try:
        srv = boot(argv)
    except fmt_mod.FormatError as e:
        print(f"FATAL: format verification failed: {e}", file=sys.stderr)
        return 1
    base = launch_counts()
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # The scanner and the bulk heals stop (checkpointed) before the
        # set closes and the drives get their clean-shutdown stamps.
        srv.close()
        for d in srv.drives:
            mark_clean_shutdown(d)
        now = launch_counts()
        by_r = {r: n - base["gf_apply_by_r"].get(r, 0)
                for r, n in now["gf_apply_by_r"].items()}
        print("kernel launches while serving: " + json.dumps({
            "gf_apply": now["gf_apply"] - base["gf_apply"],
            "gf_apply_by_r": {str(r): n for r, n in sorted(by_r.items())
                              if n},
            "highwayhash256": now["highwayhash256"]
            - base["highwayhash256"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

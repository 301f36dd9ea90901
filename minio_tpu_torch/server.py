"""Command line: serve S3 from one erasure set on the card.

    python -m minio_tpu_torch.server --address HOST:PORT \
        [--device cuda|cpu] [--parity N] DRIVE [DRIVE ...]

Boot runs the golden gates first, as minio_tpu/server.py does, and
refuses to serve if any fails: the reference's erasure self-test on the
host codec and again through the card's GF kernel, the bitrot self-test,
and the HighwayHash golden checks through the card's hash kernel. Before the
drives serve, each gets its crash recovery, as minio_tpu/server.py runs
it: the group-commit WALs replay, stale temporaries and uncommitted data
dirs go, and objects whose journals or data dirs were lost are queued on
the set's MRF for heal (storage/local.recovery_sweep). A drive whose
previous process stopped through main()'s shutdown path carries a
clean-shutdown stamp and gets the WAL replay and the temporaries' purge
only. Then it serves in one process (CUDA does not survive a fork, so the pre-forked
worker fleet of the TPU package is not used). Credentials come from
MINIO_ROOT_USER / MINIO_ROOT_PASSWORD (default minioadmin/minioadmin).
"""

from __future__ import annotations

import argparse
import os
import sys

from minio_tpu_torch import device as device_mod
from minio_tpu_torch.erasure.selftest import erasure_self_test
from minio_tpu_torch.object.erasure_object import ErasureSet
from minio_tpu_torch.ops.rs_device import GpuBackend
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage import bitrot
from minio_tpu_torch.storage import group_commit
from minio_tpu_torch.storage.local import (LocalStorage,
                                           consume_clean_shutdown,
                                           mark_clean_shutdown,
                                           recovery_sweep, sweep_stale_tmp)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m minio_tpu_torch.server",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--address", default="127.0.0.1:9000", help="HOST:PORT")
    p.add_argument("--device", default=device_mod.DEFAULT_DEVICE,
                   choices=("cuda", "cpu"),
                   help="where the kernels run (cpu = plain PyTorch path)")
    p.add_argument("--parity", type=int, default=None,
                   help="parity shards (default: by set size, 4 for 8+ drives)")
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
    recovery = recover_drives(disks)
    objects = ErasureSet(disks, parity=args.parity, device=device)
    for vol, path in recovery["heal"]:
        objects.mrf.enqueue(vol, path)
    host, _, port = args.address.rpartition(":")
    srv = S3Server(objects, (host or "127.0.0.1", int(port)),
                   {os.environ.get("MINIO_ROOT_USER", "minioadmin"):
                    os.environ.get("MINIO_ROOT_PASSWORD", "minioadmin")})
    srv.recovery = recovery
    print("recovery: " + ", ".join(f"{k} {len(v) if k == 'heal' else v}"
                                   for k, v in recovery.items()), flush=True)
    n, m = len(args.drives), objects.default_parity
    print(f"serving S3 on http://{srv.address} ({n} drives, EC {n - m}+{m}, "
          f"device {device})", flush=True)
    return srv


def main(argv=None) -> int:
    srv = boot(argv)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.httpd.server_close()
        srv.objects.close()
        for d in srv.objects.disks:
            mark_clean_shutdown(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())

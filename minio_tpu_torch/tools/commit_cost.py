"""What one solo commit costs: one-thread PUTs on a 12-drive EC 8+4 set.

    python -m minio_tpu_torch.tools.commit_cost --root DIR [--root DIR2 ...]
        [--device cuda] [--reps 200] [--seed 7]

For each --root (drives DIR/d0 .. DIR/d11, made fresh and removed after)
it times, on the host clock, PUTs from one thread, so that no other
request is in flight and each commit takes the solo path (the
group-commit lanes stay out):

  * `fresh_1k`: 1 KiB to a new key each time (inline in the journal),
  * `over_1k`: 1 KiB overwrites of one key (inline),
  * `over_1m`: 1 MiB overwrites of one key (shard files: staging, the
    data dir's move, the old data dir reclaimed),

--reps of each after 5 untimed ones, and prints one JSON line a root:
the filesystem type the root lies on (from /proc/mounts), and per row
the median, mean, p90 and min ms a PUT. It calls only ErasureSet's
public methods, so a copy of this file runs on an older tree of the
package for a comparison on one machine.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import time

DRIVES = 12


def fs_type(path: str) -> str:
    """The type of the filesystem `path` lies on (the longest mount
    point in /proc/mounts that holds it)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1]
                inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
                if inside and len(mnt) >= len(best):
                    best, kind = mnt, parts[2]
    except OSError:
        pass
    return kind


def time_root(root: str, device: str, reps: int, seed: int) -> dict:
    import numpy as np

    from minio_tpu_torch.object.erasure_object import ErasureSet
    from minio_tpu_torch.storage.local import LocalStorage

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    small = [rng.bytes(1024) for _ in range(8)]
    big = [rng.bytes(1 << 20) for _ in range(4)]
    es = ErasureSet([LocalStorage(os.path.join(root, f"d{i}"))
                     for i in range(DRIVES)], device=device)
    rows = {}
    try:
        es.make_bucket("cost")
        plans = {
            "fresh_1k": lambda i: es.put_object("cost", f"fresh/{i:06d}",
                                                small[i % len(small)]),
            "over_1k": lambda i: es.put_object("cost", "over-1k",
                                               small[i % len(small)]),
            "over_1m": lambda i: es.put_object("cost", "over-1m",
                                               big[i % len(big)]),
        }
        for name, put in plans.items():
            for i in range(5):
                put(reps + i)
            ms = []
            for i in range(reps):
                t0 = time.perf_counter()
                put(i)
                ms.append((time.perf_counter() - t0) * 1e3)
            ms.sort()
            rows[name] = {"median_ms": statistics.median(ms),
                          "mean_ms": statistics.fmean(ms),
                          "p90_ms": ms[int(0.9 * (len(ms) - 1))],
                          "min_ms": ms[0], "reps": reps}
    finally:
        es.close()
        shutil.rmtree(root, ignore_errors=True)
    return {"root": root, "fs": fs_type(os.path.dirname(root) or "."),
            "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", action="append", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("commit_cost: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 2
    for root in args.root:
        print(json.dumps(time_root(root, args.device, args.reps, args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

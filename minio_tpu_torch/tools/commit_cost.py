"""What one solo commit costs: one-thread PUTs on a 12-drive EC 8+4 set.

    python -m minio_tpu_torch.tools.commit_cost --root DIR [--root DIR2 ...]
        [--device cuda] [--reps 200] [--seed 7] [--profile OUT]

For each --root (drives DIR/d0 .. DIR/d11, made fresh and removed after)
it times, on the host clock, PUTs from one thread, so that no other
request is in flight and each commit takes the solo path (the
group-commit lanes stay out):

  * `fresh_1k`: 1 KiB to a new key each time (inline in the journal),
  * `over_1k`: 1 KiB overwrites of one key (inline),
  * `over_1m`: 1 MiB overwrites of one key (shard files: staging, the
    data dir's move, the old data dir reclaimed),

--reps of each after 5 untimed ones; and one row of concurrent commits,

  * `lane_1k`: LANE_THREADS threads, each overwriting a 1 KiB key of its
    own --reps / LANE_THREADS times, all started together, so that
    their commits coalesce in the group-commit lanes (each batch keeps
    the journals it replaces until write quorum is known, and settles
    them with one drive call a batch),

with its aggregate PUTs a second and the lanes' batches, members and
settle calls. With --profile the lane row runs a second time under one
cProfile capture (on Python 3.12 it sees every thread), and the 40
functions with the most own time are written to OUT (one section a
root); that run's times are not reported.
It prints one JSON line a root: the filesystem type the root lies on
(from /proc/mounts), and per row the median, mean, p90 and min ms a
PUT. It calls only ErasureSet's public methods (and reads the set's
`group_commit` stats where it has them), so a copy of this file runs on
an older tree of the package for a comparison on one machine.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import threading
import time

DRIVES = 12
LANE_THREADS = 16


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


def time_root(root: str, device: str, reps: int, seed: int,
              profile: str = "") -> dict:
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
            rows[name] = _row(ms, reps)
        rows["lane_1k"] = _lanes(es, small, reps)
        if profile:
            _profile_lanes(es, small, reps, root, profile)
    finally:
        es.close()
        shutil.rmtree(root, ignore_errors=True)
    return {"root": root, "fs": fs_type(os.path.dirname(root) or "."),
            "rows": rows}


def _row(ms: list, reps: int) -> dict:
    ms = sorted(ms)
    return {"median_ms": statistics.median(ms),
            "mean_ms": statistics.fmean(ms),
            "p90_ms": ms[int(0.9 * (len(ms) - 1))],
            "min_ms": ms[0], "reps": reps}


def _lanes(es, small: list, reps: int) -> dict:
    """The `lane_1k` row: LANE_THREADS threads of 1 KiB overwrites."""
    each = max(1, reps // LANE_THREADS)
    for t in range(LANE_THREADS):
        es.put_object("cost", f"lane/{t:02d}", small[t % len(small)])
    gc = getattr(es, "group_commit", None)
    before = dict(gc.stats()) if gc is not None else {}
    gate = threading.Barrier(LANE_THREADS)
    per: list = [[] for _ in range(LANE_THREADS)]

    def run(t: int) -> None:
        gate.wait()
        for i in range(each):
            t0 = time.perf_counter()
            es.put_object("cost", f"lane/{t:02d}", small[(t + i) % len(small)])
            per[t].append((time.perf_counter() - t0) * 1e3)
    threads = [threading.Thread(target=run, args=(t,))
               for t in range(LANE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    row = _row([x for ms in per for x in ms], each * LANE_THREADS)
    row["threads"] = LANE_THREADS
    row["puts_per_s"] = each * LANE_THREADS / wall
    if gc is not None:
        after = gc.stats()
        for k in ("batches", "members", "settle_calls"):
            if k in after:
                row[k] = after[k] - before.get(k, 0)
    return row


def _profile_lanes(es, small: list, reps: int, root: str, out: str) -> None:
    import cProfile
    import io
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    try:
        _lanes(es, small, reps)
    finally:
        prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(40)
    with open(out, "a") as f:
        f.write(f"== lane_1k under cProfile, root {root}\n{text.getvalue()}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", action="append", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--profile", default="",
                   help="append the lane row's profile to this file")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("commit_cost: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 2
    for root in args.root:
        print(json.dumps(time_root(root, args.device, args.reps, args.seed,
                                   args.profile)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

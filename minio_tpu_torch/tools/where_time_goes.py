"""Where a large PUT and GET spend their time on the card.

    python -m minio_tpu_torch.tools.where_time_goes [--size-mib 256] [--reps 3] [--seed 7]

One 12-drive EC 8+4 ErasureSet on the card (drives under /dev/shm where
it has room), no HTTP. For one object of --size-mib it times, on the
host clock and each --reps times (median and spread printed):

  * sha256 and md5 of the body in one pass each (the signed PUT's
    content hash and the ETag),
  * put_object through a Payload over a reader, as the S3 front end
    calls it: UNSIGNED-PAYLOAD (the reader alone) and signed (the
    SHA-256 runs as the body streams and is checked in the finish hook),
  * a GET that drains get_object_stream chunk by chunk, healthy and
    with 4 data-shard drives wiped (decode on the card), and get_object
    (the chunks copied into one bytes object) checked against the body,
  * the same body as a multipart upload of 8 MiB parts (the AWS CLI's
    part size), one part after another, and a drained GET of it,
  * heal_object (normal mode) of the object with one data-shard drive
    wiped and with two data and two parity drives wiped,
  * the bucket namespace: a server-side copy of the object (its GET
    stream fed to put_object, as CopyObject runs), a drained GET by
    version id of the oldest of three versions of --size-mib in a
    versioned bucket, healthy and with 4 data-shard drives wiped, and a
    listing of 10,000 keys of 1 KiB (written once, from 16 threads,
    after a tenth of them from one thread) in pages of 1000, deep and
    with delimiter "/" (keys/s); 100 of the one-thread PUTs again under
    torch.profiler and under cProfile (host time by function),

then runs one signed PUT and one GET (healthy, then degraded), the
multipart GET, the one-drive heal and the degraded GET of the oldest
version under torch.profiler and reports,
per operation, the device time by kernel and
by copy, each copy row marked with the host memory it read or wrote
(pinned or pageable), and the card's busy share of the wall time. The
last line is one JSON object with every number, the card's name and its
power limit. It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import cProfile
import hashlib
import io
import json
import os
import pstats
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from concurrent.futures import ThreadPoolExecutor

from minio_tpu_torch.object.erasure_object import ErasureSet, hash_order
from minio_tpu_torch.object.types import GetOptions, PutOptions
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils.streams import (ChunkReader, HashingReader,
                                           LimitedReader, Payload)

MIB = 1 << 20
BUCKET = "prof"
VBUCKET = "profv"
LBUCKET = "profl"
LIST_KEYS = [f"dir{d:02d}/obj{o:03d}" for d in range(100) for o in range(100)]


def _timed(fn, reps: int, setup=None) -> dict:
    """Host-clock seconds of fn() over `reps` runs, each after an untimed
    setup()."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(times), "min_s": min(times),
            "max_s": max(times), "runs": len(times)}


def _device_profile(fn, setup=None) -> dict:
    """Device time of one fn() call by kernel name and copy kind."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if setup is not None:
        setup()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for ev in prof.events():
        # Device-side records (kernels, memcpy, memset) only: the one
        # stream runs them one at a time, so their sum is busy time.
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.device_time_total / 1e6
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    # Copy rows are named by direction and host memory kind, e.g.
    # "Memcpy HtoD (Pinned -> Device)".
    copies = {name: {"s": t, "host_memory": "pageable"
                     if "Pageable" in name else "pinned"
                     if "Pinned" in name else "device"}
              for name, t in by_name.items() if "Memcpy" in name}
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall if wall else 0.0,
            "device_s_by_name": top, "copies": copies}


def _fs_type(path: str) -> str:
    """The file system type of the mount holding `path` (/proc/mounts)."""
    best, fstype = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            mnt, kind = line.split()[1:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                best, fstype = mnt, kind
    return fstype


def _host_profile(fn) -> list:
    """The host functions fn() spends the most own time in (cProfile,
    which slows every Python call it counts): [(seconds, calls, name)]."""
    prof = cProfile.Profile()
    prof.runcall(fn)
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, nc, f"{path.rsplit('/', 1)[-1]}:{line}({name})")
                   for (path, line, name), (_, nc, tt, _, _)
                   in stats.items()), reverse=True)
    return rows[:12]


def _payload(body: bytes, want: str | None) -> Payload:
    """The body as the S3 front end hands it to put_object: a Payload
    over a length-limited reader; hashed as it streams and checked
    against the signed SHA-256 `want` when there is one."""
    raw = LimitedReader(io.BytesIO(body), len(body))
    if want is None:
        return Payload(raw, len(body))
    hasher = HashingReader(raw)

    def fin():
        if hasher.hexdigest() != want:
            raise RuntimeError("SHA-256 mismatch")
    return Payload(hasher, len(body), finish=fin)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size-mib", type=int, default=256)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("where_time_goes: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)

    shm = "/dev/shm"
    root = tempfile.mkdtemp(prefix="where_time_goes-",
                            dir=shm if os.path.isdir(shm) and
                            shutil.disk_usage(shm).free > 8 << 30 else None)
    body = np.random.default_rng(args.seed).bytes(args.size_mib * MIB)
    result = {"card": smi, "size_mib": args.size_mib,
              "drives": f"{root} ({_fs_type(root)})"}
    print(f"drives under {result['drives']}", flush=True)
    try:
        drives = [os.path.join(root, f"d{i}") for i in range(12)]
        es = ErasureSet([LocalStorage(d) for d in drives], device="cuda")
        # Degraded reads must stay degraded: no background heals.
        es._mrf_closed = True
        try:
            es.make_bucket(BUCKET)
            es.put_object(BUCKET, "warm", body[:40 * MIB])   # build + warm
            es.get_object(BUCKET, "warm")

            signed = hashlib.sha256(body).hexdigest()

            def put(signed: str | None = signed):
                es.put_object(BUCKET, "obj", _payload(body, signed))

            def get():
                _, chunks = es.get_object_stream(BUCKET, "obj")
                for _ in chunks:
                    pass

            def get_bytes():
                if es.get_object(BUCKET, "obj")[1] != body:
                    raise RuntimeError("GET returned other bytes")

            _, got = es.get_object(BUCKET, "warm")
            if got != body[:40 * MIB]:
                raise RuntimeError("GET returned other bytes")
            result["sha256"] = _timed(lambda: hashlib.sha256(body), args.reps)
            result["md5"] = _timed(lambda: hashlib.md5(body), args.reps)
            result["put_unsigned"] = _timed(lambda: put(None), args.reps)
            result["put"] = _timed(put, args.reps)
            result["get"] = _timed(get, args.reps)
            result["get_bytes"] = _timed(get_bytes, args.reps)
            result["profile_put"] = _device_profile(put)
            result["profile_get"] = _device_profile(get)
            dist = hash_order(f"{BUCKET}/obj", 12)
            for i in [i for i in range(12) if dist[i] - 1 < 8][:4]:
                shutil.rmtree(os.path.join(drives[i], BUCKET, "obj"))
            if es.get_object(BUCKET, "obj")[1] != body:
                raise RuntimeError("degraded GET returned other bytes")
            result["get_degraded"] = _timed(get, args.reps)
            result["profile_get_degraded"] = _device_profile(get)
            if es.heal_object(BUCKET, "obj").healed != 4:
                raise RuntimeError("the wiped drives did not heal")

            # After the rows above, so that they run as on the parent.
            part = 8 * MIB

            def mp_put():
                uid = es.new_multipart_upload(BUCKET, "mp")
                done = [es.put_object_part(BUCKET, "mp", uid, n + 1,
                                           _payload(body[o:o + part], None))
                        for n, o in enumerate(range(0, len(body), part))]
                es.complete_multipart_upload(BUCKET, "mp", uid, [
                    (p.number, p.etag) for p in done])

            def mp_get():
                _, chunks = es.get_object_stream(BUCKET, "mp")
                for _ in chunks:
                    pass
            result["mp_put"] = _timed(mp_put, args.reps)
            if es.get_object(BUCKET, "mp")[1] != body:
                raise RuntimeError("multipart GET returned other bytes")
            result["mp_get"] = _timed(mp_get, args.reps)
            result["profile_mp_get"] = _device_profile(mp_get)

            def wipe(shards):
                def go():
                    for s in shards:
                        shutil.rmtree(os.path.join(
                            drives[dist.index(s + 1)], BUCKET, "obj"))
                return go

            def heal(wiped: int):
                r = es.heal_object(BUCKET, "obj")
                if r.healed != wiped:
                    raise RuntimeError(f"heal healed {r.healed} of {wiped}")
            result["heal_1"] = _timed(lambda: heal(1), args.reps,
                                      setup=wipe((0,)))
            result["heal_4"] = _timed(lambda: heal(4), args.reps,
                                      setup=wipe((0, 5, 8, 11)))
            result["profile_heal_1"] = _device_profile(lambda: heal(1),
                                                       setup=wipe((0,)))
            if es.get_object(BUCKET, "obj")[1] != body:
                raise RuntimeError("GET after heal returned other bytes")

            # The bucket namespace, after the rows the parent has.
            def copy():
                info, chunks = es.get_object_stream(BUCKET, "obj")
                reader = ChunkReader(chunks)
                try:
                    es.put_object(BUCKET, "copy", Payload(reader, info.size))
                finally:
                    reader.close()
            result["copy_256"] = _timed(copy, args.reps)
            if es.get_object(BUCKET, "copy")[1] != body:
                raise RuntimeError("the copy returned other bytes")

            es.make_bucket(VBUCKET)
            es.set_bucket_versioning(VBUCKET, "Enabled")
            oldest = es.put_object(VBUCKET, "obj", body,
                                   PutOptions(versioned=True)).version_id
            for shift in (1, 2):
                es.put_object(VBUCKET, "obj", body[shift:] + body[:shift],
                              PutOptions(versioned=True))

            def get_old():
                _, chunks = es.get_object_stream(
                    VBUCKET, "obj", opts=GetOptions(version_id=oldest))
                for _ in chunks:
                    pass
            if es.get_object(VBUCKET, "obj",
                             GetOptions(version_id=oldest))[1] != body:
                raise RuntimeError("GET by version id returned other bytes")
            result["get_version_old"] = _timed(get_old, args.reps)
            vdist = hash_order(f"{VBUCKET}/obj", 12)
            for i in [i for i in range(12) if vdist[i] - 1 < 8][:4]:
                shutil.rmtree(os.path.join(drives[i], VBUCKET, "obj"))
            if es.get_object(VBUCKET, "obj",
                             GetOptions(version_id=oldest))[1] != body:
                raise RuntimeError("degraded GET by version id returned "
                                   "other bytes")
            result["get_version_old_degraded"] = _timed(get_old, args.reps)
            result["profile_get_version_old_degraded"] = \
                _device_profile(get_old)

            es.make_bucket(LBUCKET)
            small = np.random.default_rng(args.seed + 1).bytes(
                len(LIST_KEYS) * 1024)
            seq = LIST_KEYS[:len(LIST_KEYS) // 10]
            t0 = time.perf_counter()
            for i, key in enumerate(seq):
                es.put_object(LBUCKET, key, small[i * 1024:(i + 1) * 1024])
            result["put_1k_one_thread_s"] = time.perf_counter() - t0

            def put_small(n: int):
                def go():
                    for j in range(n):
                        i = j % len(seq)
                        es.put_object(LBUCKET, seq[i],
                                      small[i * 1024:(i + 1) * 1024])
                return go
            result["profile_put_1k"] = _device_profile(put_small(100))
            result["host_put_1k"] = _host_profile(put_small(100))
            t0 = time.perf_counter()
            with ThreadPoolExecutor(16) as ex:
                list(ex.map(lambda i: es.put_object(
                    LBUCKET, LIST_KEYS[i], small[i * 1024:(i + 1) * 1024]),
                    range(len(LIST_KEYS))))
            result["list_10k_put_s"] = time.perf_counter() - t0

            def listing(delimiter: str, want: int):
                def go():
                    marker, got = "", 0
                    while True:
                        info = es.list_objects(LBUCKET, marker=marker,
                                               delimiter=delimiter)
                        got += len(info.objects) + len(info.prefixes)
                        if not info.is_truncated:
                            break
                        marker = info.next_marker
                    if got != want:
                        raise RuntimeError(f"listed {got} of {want}")
                return go
            result["list_10k"] = _timed(listing("", len(LIST_KEYS)),
                                        args.reps)
            result["list_10k_delimiter"] = _timed(listing(
                "/", len({k.split("/")[0] for k in LIST_KEYS})), args.reps)
        finally:
            es.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for op in ("sha256", "md5", "put_unsigned", "put", "get", "get_bytes",
               "get_degraded", "mp_put", "mp_get", "heal_1", "heal_4",
               "copy_256", "get_version_old", "get_version_old_degraded",
               "list_10k", "list_10k_delimiter"):
        r = result[op]
        rate = f"{len(LIST_KEYS) / r['median_s']:.1f} keys/s" \
            if op.startswith("list") else \
            f"{args.size_mib / r['median_s']:.1f} MiB/s"
        print(f"{op}: median {r['median_s']:.4f} s ({rate}), "
              f"min {r['min_s']:.4f} max {r['max_s']:.4f} over {r['runs']}")
    print(f"put_1k_one_thread: {result['put_1k_one_thread_s']:.4f} s "
          f"({len(LIST_KEYS) // 10 / result['put_1k_one_thread_s']:.1f} "
          "keys/s, one thread, once)")
    print(f"list_10k_put: {result['list_10k_put_s']:.4f} s "
          f"({len(LIST_KEYS) / result['list_10k_put_s']:.1f} keys/s, "
          "16 threads, once)")
    print("host_put_1k (100 one-thread PUTs of 1 KiB under cProfile), own "
          "time by function:")
    for tt, nc, name in result["host_put_1k"]:
        print(f"    {tt * 1e3:10.3f} ms  {nc:7d} calls  {name[:80]}")
    for op in ("profile_put", "profile_get", "profile_get_degraded",
               "profile_mp_get", "profile_heal_1",
               "profile_get_version_old_degraded", "profile_put_1k"):
        r = result[op]
        print(f"{op}: wall {r['wall_s']:.4f} s, device busy "
              f"{r['device_busy_s']:.4f} s ({100 * r['device_busy_share']:.2f}%)")
        for name, s in r["device_s_by_name"].items():
            print(f"    {s * 1e3:10.3f} ms  {name[:90]}")
        for name, c in r["copies"].items():
            print(f"    copy {c['s'] * 1e3:10.3f} ms  host memory "
                  f"{c['host_memory']:8s}  {name[:70]}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where a large PUT and GET spend their time on the card.

    python -m minio_tpu_torch.tools.where_time_goes [--size-mib 256] [--reps 3] [--seed 7]
        [--namespace-only | --drive-plane-only]

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
    with delimiter "/" (keys/s), each run a fresh walk of the drives
    (the bucket's metacache bumped before it), and the deep listing
    repeated with no write between (`list_10k_repeat`: served from the
    walk stream where the package has one); a small PUT's 12 journal
    writes through the set's fan-out pool against one thread writing
    them drive after drive, and a fan-out of 12 no-ops; 100 of the
    one-thread PUTs
    again under torch.profiler and under cProfile (host time by
    function), and the set's group-commit, metacache and journal-summary
    counters where the package has them,

then runs one signed PUT and one GET (healthy, then degraded), the
multipart GET, the one-drive heal and the degraded GET of the oldest
version under torch.profiler and reports,
per operation, the device time by kernel and
by copy, each copy row marked with the host memory it read or wrote
(pinned or pageable), and the card's busy share of the wall time. The
last line is one JSON object with every number, the card's name and its
power limit. It needs a CUDA card and fails without one. It runs with
the fileinfo cache off (MTPU_FILEINFO_CACHE=off), as before the cache.
The drive plane's rows follow (where the package has it): the bulk
heal of one wiped drive of 12 (`drive_heal_1`, phase 4e's data mix cut
to about 512 MiB, with its device profile), 1 KiB PUTs from one
thread over health-wrapped drives beside unwrapped ones
(`put_1k_wrapped`, `put_1k_unwrapped`), and on the same sets a drained
GET of --size-mib, healthy and with 4 data-shard drives wiped
(`get_wrapped`, `get_degraded_wrapped` and their unwrapped twins).
--namespace-only runs the listing and small-PUT rows alone,
--drive-plane-only the drive plane's. The script
uses only public calls of the package and reads its metadata-plane
counters with getattr, so a copy of it times an older tree of the
package as well, for a comparison within one call.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
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
from minio_tpu_torch.storage.meta import FileInfo
from minio_tpu_torch.utils.streams import (ChunkReader, HashingReader,
                                           LimitedReader, Payload)

MIB = 1 << 20
BUCKET = "prof"
VBUCKET = "profv"
LBUCKET = "profl"
JBUCKET = "profj"
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


def _journal_rows(es, drives: list, n: int = 100) -> dict:
    """Where a small PUT's journal writes go: ms per PUT's worth (one
    inline journal of 1 KiB on each of the 12 drives) written by the
    set's fan-out pool (as a PUT commits) and written by one thread,
    drive after drive; and ms per fan-out of 12 calls that do nothing
    (the pool's handoffs alone). Host clock, n runs each."""
    fi = FileInfo(volume=JBUCKET, name="", size=1024, mod_time=1,
                  metadata={"etag": "0" * 32}, inline_data=bytes(1056))
    es.make_bucket(JBUCKET)

    def write(d, key):
        d.write_metadata(JBUCKET, key, dataclasses.replace(fi, name=key))
    out = {}
    t0 = time.perf_counter()
    for j in range(n):
        es._fanout([lambda d=d, j=j: write(d, f"f{j}") for d in es.disks])
    out["journal_12_fanout_ms"] = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for j in range(n):
        for d in es.disks:
            write(d, f"s{j}")
    out["journal_12_serial_ms"] = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        es._fanout([lambda: None] * len(es.disks))
    out["fanout_noop_12_ms"] = (time.perf_counter() - t0) / n * 1e3
    for d in drives:
        shutil.rmtree(os.path.join(d, JBUCKET), ignore_errors=True)
    return out


def _tree_bytes(root: str) -> int:
    """Bytes of a drive's files outside its system volume."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root)
               if os.path.relpath(d, root).split(os.sep)[0] != ".mtpu.sys"
               for f in fs)


def _drive_plane_rows(root: str, seed: int, reps: int,
                      size_mib: int) -> dict:
    """The drive plane's rows, where the package has it ({} otherwise):
    `drive_heal_1`, the bulk heal of one wiped drive of 12 in process
    (phase 4e's data mix cut to about 512 MiB: 24 objects of 16 MiB,
    64 MiB + 1 B, a multipart of 8 x 8 MiB, 500 keys of 1 KiB, 50 keys of
    3 versions and 25 delete markers), each run after the drive is
    wiped again and its format restored; and `put_1k_wrapped`, 1 KiB
    PUTs from one thread on a set whose drives are health-wrapped
    (storage/health.wrap_disks, the server's default), beside the same
    PUTs on unwrapped drives (`put_1k_unwrapped`), runs interleaved; on
    the same two sets, a drained GET of one object of `size_mib`,
    healthy (`get_wrapped`, `get_unwrapped`) and with 4 data-shard
    drives wiped (`get_degraded_wrapped`, `get_degraded_unwrapped`), in
    MiB/s, each timed after one untimed GET of its kind."""
    try:
        from minio_tpu_torch.object.drive_heal import bulk_heal_drive
        from minio_tpu_torch.object.scanner import check_drive_formats
        from minio_tpu_torch.storage.health import wrap_disks
        from minio_tpu_torch.storage.local import read_healing
        from minio_tpu_torch.topology.format import init_formats
    except ImportError:
        return {}
    rng = np.random.default_rng(seed + 2)
    out: dict = {}
    drives = [os.path.join(root, "dp", f"d{i}") for i in range(12)]
    disks = [LocalStorage(d) for d in drives]
    init_formats(disks, 12)
    es = ErasureSet(disks, device="cuda")
    es._mrf_closed = True
    try:
        es.make_bucket("dp")
        es.make_bucket("dpv")
        es.set_bucket_versioning("dpv", "Enabled")
        for i in range(24):
            es.put_object("dp", f"big/{i:04d}", rng.bytes(16 * MIB))
        es.put_object("dp", "ragged", rng.bytes(64 * MIB + 1))
        uid = es.new_multipart_upload("dp", "mp")
        done = [es.put_object_part("dp", "mp", uid, n, rng.bytes(8 * MIB))
                for n in range(1, 9)]
        es.complete_multipart_upload("dp", "mp", uid,
                                     [(p.number, p.etag) for p in done])
        small = rng.bytes(500 * 1024)
        with ThreadPoolExecutor(16) as ex:
            list(ex.map(lambda i: es.put_object(
                "dp", f"small/{i:05d}", small[i * 1024:(i + 1) * 1024]),
                range(500)))
        for k in range(50):
            for _ in range(3):
                es.put_object("dpv", f"v{k:03d}", rng.bytes(4096),
                              PutOptions(versioned=True))
        from minio_tpu_torch.object.types import DeleteOptions
        for k in range(25):
            es.delete_object("dpv", f"v{k:03d}",
                             DeleteOptions(versioned=True))
        wiped = 5
        trackers: list = []

        def wipe():
            shutil.rmtree(drives[wiped])
            os.makedirs(drives[wiped])
            if check_drive_formats([es]) != 1:
                raise RuntimeError("the wiped drive's format not restored")
            trackers.append(read_healing(es.disks[wiped]))

        def heal():
            t = bulk_heal_drive(es, wiped, trackers[-1])
            if not t["finished"] or t["objects_failed"]:
                raise RuntimeError(f"bulk heal: {t}")
        out["drive_heal_1"] = _timed(heal, reps, setup=wipe)
        t = trackers[-1]
        out["drive_heal_1"].update(
            keys=t["objects_scanned"], healed=t["objects_healed"],
            bytes=_tree_bytes(drives[wiped]))
        out["profile_drive_heal_1"] = _device_profile(heal, setup=wipe)
    finally:
        es.close()
    rates: dict = {f"{op}_{kind}": [] for op in
                   ("put_1k", "get", "get_degraded")
                   for kind in ("unwrapped", "wrapped")}
    body = rng.bytes(1024)
    big = rng.bytes(size_mib * MIB)
    dist = hash_order(f"{LBUCKET}/big", 12)
    data_drives = [i for i in range(12) if dist[i] - 1 < 8][:4]

    def get_rate(s) -> float:
        _, chunks = s.get_object_stream(LBUCKET, "big")
        for _ in chunks:
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, chunks = s.get_object_stream(LBUCKET, "big")
        for _ in chunks:
            pass
        torch.cuda.synchronize()
        return size_mib / (time.perf_counter() - t0)
    for r in range(reps):
        for row in ("put_1k_unwrapped", "put_1k_wrapped"):
            sub = [os.path.join(root, f"{row}{r}", f"d{i}")
                   for i in range(12)]
            ws = [LocalStorage(d) for d in sub]
            ws = wrap_disks(ws) if row == "put_1k_wrapped" else ws
            s = ErasureSet(ws, device="cuda")
            s._mrf_closed = True
            try:
                s.make_bucket(LBUCKET)
                s.put_object(LBUCKET, "warm", body)
                t0 = time.perf_counter()
                for i in range(1000):
                    s.put_object(LBUCKET, f"k{i:04d}", body)
                rates[row].append(1000 / (time.perf_counter() - t0))
                kind = row.rpartition("_")[2]
                s.put_object(LBUCKET, "big", big)
                if s.get_object(LBUCKET, "big")[1] != big:
                    raise RuntimeError("GET returned other bytes")
                rates[f"get_{kind}"].append(get_rate(s))
                for i in data_drives:
                    shutil.rmtree(os.path.join(sub[i], LBUCKET, "big"))
                if s.get_object(LBUCKET, "big")[1] != big:
                    raise RuntimeError("degraded GET returned other bytes")
                rates[f"get_degraded_{kind}"].append(get_rate(s))
            finally:
                s.close()
                for d in ws:
                    if hasattr(d, "health_info"):
                        d.close()
                shutil.rmtree(os.path.join(root, f"{row}{r}"),
                              ignore_errors=True)
    out.update(rates)
    return out


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
    p.add_argument("--namespace-only", action="store_true",
                   help="only the listing and small-PUT rows")
    p.add_argument("--drive-plane-only", action="store_true",
                   help="only the drive plane's rows (drive_heal_1, "
                        "put_1k_wrapped)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("where_time_goes: needs a CUDA card")
    # The degraded rows wipe drives behind the sets' backs, and every
    # row times the drives' reads: no fileinfo cache answers for them.
    os.environ["MTPU_FILEINFO_CACHE"] = "off"
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
    if args.drive_plane_only:
        try:
            result.update(_drive_plane_rows(root, args.seed, args.reps,
                                            args.size_mib))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        _print_drive_plane(result)
        print(json.dumps(result))
        return 0
    try:
        drives = [os.path.join(root, f"d{i}") for i in range(12)]
        es = ErasureSet([LocalStorage(d) for d in drives], device="cuda")
        # Degraded reads must stay degraded: no background heals.
        es._mrf_closed = True
        try:
            if not args.namespace_only:
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

            else:
                es.make_bucket(BUCKET)
                es.put_object(BUCKET, "warm", body[:4096])   # build + warm
            es.make_bucket(LBUCKET)
            small = np.random.default_rng(args.seed + 1).bytes(
                len(LIST_KEYS) * 1024)
            seq = LIST_KEYS[:len(LIST_KEYS) // 10]
            t0 = time.perf_counter()
            for i, key in enumerate(seq):
                es.put_object(LBUCKET, key, small[i * 1024:(i + 1) * 1024])
            result["put_1k_one_thread_s"] = time.perf_counter() - t0
            result.update(_journal_rows(es, drives))

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
            mc = getattr(es, "metacache", None)

            def fresh_walk():
                if mc is not None:
                    mc.bump(LBUCKET)
            result["list_10k"] = _timed(listing("", len(LIST_KEYS)),
                                        args.reps, setup=fresh_walk)
            listing("", len(LIST_KEYS))()
            result["list_10k_repeat"] = _timed(
                listing("", len(LIST_KEYS)), args.reps)
            result["list_10k_delimiter"] = _timed(listing(
                "/", len({k.split("/")[0] for k in LIST_KEYS})), args.reps,
                setup=fresh_walk)
            gc = getattr(es, "group_commit", None)
            result["group_commit"] = None if gc is None else {
                k: v for k, v in gc.stats().items() if k != "wait_hist"}
            result["metacache"] = None if mc is None else mc.stats()
            try:
                from minio_tpu_torch.storage import meta_scan
                result["meta_scan"] = dict(meta_scan.counters)
            except ImportError:
                result["meta_scan"] = None
        finally:
            es.close()
        result.update(_drive_plane_rows(root, args.seed, args.reps,
                                        args.size_mib))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for op in ("sha256", "md5", "put_unsigned", "put", "get", "get_bytes",
               "get_degraded", "mp_put", "mp_get", "heal_1", "heal_4",
               "copy_256", "get_version_old", "get_version_old_degraded",
               "list_10k", "list_10k_repeat", "list_10k_delimiter"):
        r = result.get(op)
        if r is None:
            continue
        rate = f"{len(LIST_KEYS) / r['median_s']:.1f} keys/s" \
            if op.startswith("list") else \
            f"{args.size_mib / r['median_s']:.1f} MiB/s"
        print(f"{op}: median {r['median_s']:.4f} s ({rate}), "
              f"min {r['min_s']:.4f} max {r['max_s']:.4f} over {r['runs']}")
    print(f"put_1k_one_thread: {result['put_1k_one_thread_s']:.4f} s "
          f"({len(LIST_KEYS) // 10 / result['put_1k_one_thread_s']:.1f} "
          "keys/s, one thread, once)")
    print(f"journals of one small PUT (12 drives): through the fan-out "
          f"pool {result['journal_12_fanout_ms']:.3f} ms, one thread "
          f"{result['journal_12_serial_ms']:.3f} ms; a fan-out of 12 no-ops "
          f"{result['fanout_noop_12_ms']:.3f} ms")
    print(f"list_10k_put: {result['list_10k_put_s']:.4f} s "
          f"({len(LIST_KEYS) / result['list_10k_put_s']:.1f} keys/s, "
          "16 threads, once)")
    print("host_put_1k (100 one-thread PUTs of 1 KiB under cProfile), own "
          "time by function:")
    for tt, nc, name in result["host_put_1k"]:
        print(f"    {tt * 1e3:10.3f} ms  {nc:7d} calls  {name[:80]}")
    for key in ("group_commit", "metacache", "meta_scan"):
        print(f"{key}: {result[key]}")
    _print_drive_plane(result)
    for op in ("profile_put", "profile_get", "profile_get_degraded",
               "profile_mp_get", "profile_heal_1",
               "profile_get_version_old_degraded", "profile_put_1k"):
        _print_profile(op, result.get(op))
    print(json.dumps(result))
    return 0


def _print_profile(op: str, r) -> None:
    if r is None:
        return
    print(f"{op}: wall {r['wall_s']:.4f} s, device busy "
          f"{r['device_busy_s']:.4f} s ({100 * r['device_busy_share']:.2f}%)")
    for name, s in r["device_s_by_name"].items():
        print(f"    {s * 1e3:10.3f} ms  {name[:90]}")
    for name, c in r["copies"].items():
        print(f"    copy {c['s'] * 1e3:10.3f} ms  host memory "
              f"{c['host_memory']:8s}  {name[:70]}")


def _print_drive_plane(result: dict) -> None:
    r = result.get("drive_heal_1")
    if r is None:
        return
    print(f"drive_heal_1: median {r['median_s']:.4f} s, min "
          f"{r['min_s']:.4f} max {r['max_s']:.4f} over {r['runs']}; "
          f"{r['keys']} keys ({r['healed']} healed), {r['bytes']} B to the "
          f"drive: {r['bytes'] / MIB / r['median_s']:.1f} MiB/s, "
          f"{r['keys'] / r['median_s']:.1f} objects/s")
    _print_profile("profile_drive_heal_1", result.get("profile_drive_heal_1"))
    for row in ("put_1k_unwrapped", "put_1k_wrapped"):
        print(f"{row}: " + " / ".join(f"{x:.1f}" for x in result[row])
              + " keys/s (1000 PUTs of 1 KiB, one thread, turns "
              "interleaved)")
    for row in ("get_unwrapped", "get_wrapped", "get_degraded_unwrapped",
                "get_degraded_wrapped"):
        print(f"{row}: " + " / ".join(f"{x:.1f}" for x in result[row])
              + f" MiB/s (a drained GET of {result['size_mib']} MiB, turns "
              "interleaved)")


if __name__ == "__main__":
    raise SystemExit(main())

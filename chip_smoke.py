#!/usr/bin/env python3
"""Smoke run of minio_tpu_torch on one CUDA card.

    python3 chip_smoke.py            (from the repository root)

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. The card's name and power limit; build every CUDA kernel from
   minio_tpu_torch/ops/csrc/ (one nvcc per source, started together).
2. Every kernel against its plain PyTorch version on the card, exact
   byte equality, at the shapes the main path gives it: gf_apply at the
   EC 8+4 PUT window (32 x 8 x 128 KiB, byte and u32 contracts), at the
   4 x 8 decode rows, at ragged lengths and at the batcher's 256-block
   bucket (a sample of 8 batch rows); highwayhash256 at the window's 384
   streams x 128 KiB and at ragged lengths, and against the host numpy
   hash; rs_i8 at the 32-block window in words (parity and decode rows),
   at ragged word counts, and against gf_apply at 256 blocks; then the
   golden erasure and HighwayHash self-tests through the card.
3. The main path, one client: the S3 server (minio_tpu_torch.server) on
   12 drives, EC 8+4, device cuda, in this process. PUT a 256 MiB, a
   33 MiB + 777 B and a 200 KiB object over signed HTTP, GET each back;
   wipe the copies of 4 data-shard drives and GET again; flip one byte of
   a data-shard block and GET again. Byte identity every time.
4. The main path, concurrent: a fresh server as in 3, with the default
   MTPU_BATCH_FORCE. 16 client threads each PUT 6 objects (1 MiB,
   3 MiB + 5 B, 8 MiB, twice) whose keys share one `hash_order`; 16
   threads GET all 96; the copies on the 4 drives holding data shards 0-3
   are wiped and 16 threads GET all 96 again. Byte identity every time;
   on each of the put, get and reconstruct routes at least one device
   dispatch carried 2 or more requests' windows, no window went to the
   host, and no deadline culled a member. Each route's kernel-lane
   dispatches are read as round trip, queue wait and service apart. Then
   each route's device function alone, with no request threads, at every
   bucket that route used (host clock): the yardstick for the lane's
   service under load, weighted by the phase's own bucket counts.
5. B5's own entry point (python -m minio_tpu_torch.experiments.rs_i8_kernel):
   rs_i8 against make_encoder32, then both timed at 256 blocks.
   In phases 3, 4 and 5 every kernel's launch count is set to 0 just
   before the phase and read just after; each kernel of the phase's path
   must have launched.
6. Times: each kernel at the main path's shapes with CUDA events (inputs
   rotated over buffers larger than L2), its plain version's time and
   its bound; gf_apply and rs_i8 at 32 and 256 blocks.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT32_OPS_PER_S = 67e12        # H100 SXM 32-bit rate outside tensor cores
INT8_TC_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core rate
MIB = 1 << 20
K, M = 8, 4
SHARD = (1 << 20) // K         # EC 8+4 shard block of a 1 MiB erasure block


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(*parts) -> None:
    print(*parts, flush=True)


class Timer:
    """CUDA-event time of fn(i) in ms: warm-up, then the mean of `iters`."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(iters):
            fn(i)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters


def max_abs_err(torch, a, b) -> int:
    """Largest byte difference of two results compared as bytes (a u32
    word result is compared through its little-endian byte view)."""
    a, b = a.view(torch.uint8), b.view(torch.uint8)
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def decode_rows():
    from minio_tpu_torch.ops import gf256
    return np.ascontiguousarray(
        gf256.decode_matrix(K, M, tuple(range(4, 12)))[:4])


def phase_kernels(torch, dev, rng, errs):
    from minio_tpu_torch.erasure.selftest import erasure_self_test
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import gf256, hh_device, rs_device
    from minio_tpu_torch.storage import bitrot
    from minio_tpu_torch.utils.highwayhash import MAGIC_KEY, highwayhash256_many

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, 256, size=shape,
                                             dtype=np.uint8)).to(dev)

    def note(kern, what, err):
        log(f"{kern} {what} max_abs_err {err}")
        errs[kern] = max(errs[kern], err)

    pm = gf256.parity_matrix(K, M)
    dec = decode_rows()
    window = rand(32, K, SHARD)
    cases = [("parity u8", pm, window), ("decode rows", dec, window),
             ("parity ragged 98", pm, rand(1, K, 98)),
             ("parity ragged 1543", pm, rand(3, K, 1543)),
             ("decode ragged 3200", dec, rand(1, K, 3200))]
    for what, mat, data in cases:
        note("gf_apply", f"{what} {tuple(data.shape)}", max_abs_err(
            torch, rs_device.gf_apply(mat, data),
            rs_device.gf_apply_plain(mat, data)))
    out32 = rs_device.make_encoder32(pm)(window.view(torch.int32))
    note("gf_apply", f"parity u32 {tuple(out32.shape)}", max_abs_err(
        torch, out32, rs_device.gf_apply_plain(pm, window)))
    bucket = rand(256, K, SHARD)
    full = rs_device.gf_apply(pm, bucket)
    rows = torch.from_numpy(np.sort(rng.choice(256, size=8, replace=False))
                            ).to(dev)
    note("gf_apply", "256-block bucket, 8 sampled batch rows",
         max_abs_err(torch, full.index_select(0, rows),
                     rs_device.gf_apply_plain(pm, bucket.index_select(0,
                                                                    rows))))
    torch.cuda.synchronize()

    words = window.view(torch.int32)                       # [32, 8, 32768]
    for what, mat in (("parity", pm), ("decode rows", dec)):
        note("rs_i8", f"{what} words {tuple(words.shape)}", max_abs_err(
            torch, rs_i8_kernel.rs_apply8(mat, words),
            rs_i8_kernel.rs_apply8_plain(mat, words)))
    for l4 in (1, 25, 1000):
        w = rand(3, K, 4 * l4).view(torch.int32)
        note("rs_i8", f"ragged words {tuple(w.shape)}", max_abs_err(
            torch, rs_i8_kernel.rs_apply8(pm, w),
            rs_i8_kernel.rs_apply8_plain(pm, w)))
    bw = bucket.view(torch.int32)                          # [256, 8, 32768]
    note("rs_i8", f"vs gf_apply, words {tuple(bw.shape)}", max_abs_err(
        torch, rs_i8_kernel.make_encoder8(pm)(bw),
        rs_device.make_encoder32(pm)(bw)))
    del bucket, full, bw
    torch.cuda.synchronize()

    srows = rand(384, SHARD)
    got = hh_device.hash_rows(srows)
    t0 = time.perf_counter()
    plain = hh_device.hash_bytes_plain(srows)
    torch.cuda.synchronize()
    note("highwayhash256", f"(384, {SHARD}) (plain version "
         f"{time.perf_counter() - t0:.3f} s)", max_abs_err(torch, got, plain))
    words = hh_device.hash_words(srows.view(torch.int32).view(32, 12, -1))
    note("highwayhash256", "u32 words (32, 12, 32768)",
         max_abs_err(torch, words, plain))
    host = highwayhash256_many(MAGIC_KEY, srows[:4].cpu().numpy())
    check(np.array_equal(got[:4].cpu().numpy(), host),
          "highwayhash256 differs from the host numpy hash")
    for length in (1, 31, 33, 63, 98, 4097, SHARD + 5):
        r = rand(7, length)
        errs["highwayhash256"] = max(errs["highwayhash256"], max_abs_err(
            torch, hh_device.hash_rows(r), hh_device.hash_bytes_plain(r)))
    log(f"highwayhash256 ragged lengths max_abs_err {errs['highwayhash256']}")
    framed = rand(10, 32 + 1000)
    errs["highwayhash256"] = max(errs["highwayhash256"], max_abs_err(
        torch, hh_device.hash_rows(framed, skip=32),
        hh_device.hash_bytes_plain(framed[:, 32:])))
    check(all(v == 0 for v in errs.values()), f"kernels disagree: {errs}")

    erasure_self_test(rs_device.GpuBackend(dev))
    bitrot.device_self_test(dev)
    torch.cuda.synchronize()
    log("golden erasure and HighwayHash self-tests through the card: ok")


class Client:
    """Header-SigV4 S3 requests with the port's own signer."""

    def __init__(self, address: str, access: str = "minioadmin",
                 secret: str = "minioadmin"):
        from minio_tpu_torch.s3 import sigv4
        self.sigv4, self.address = sigv4, address
        self.access, self.secret = access, secret

    def __call__(self, method: str, path: str, body: bytes = b""):
        uri, headers = self.sigv4.sign_headers(
            method, self.address, path, self.access, self.secret,
            hashlib.sha256(body).hexdigest())
        host, _, port = self.address.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=600)
        try:
            conn.request(method, uri, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()


def drive_root() -> str:
    """Drives on /dev/shm where it has room, else under the temp dir."""
    if os.path.isdir("/dev/shm") and shutil.disk_usage("/dev/shm").free > 4 << 30:
        return tempfile.mkdtemp(prefix="chip_smoke-", dir="/dev/shm")
    return tempfile.mkdtemp(prefix="chip_smoke-")


class Server:
    """The port's S3 server on 12 fresh drives under `root`, serving from
    a thread of this process until stop()."""

    def __init__(self, root: str, name: str):
        from minio_tpu_torch import server
        self.drives = [os.path.join(root, name, f"d{i}") for i in range(12)]
        self.srv = server.boot(["--address", "127.0.0.1:0", "--device",
                                "cuda", *self.drives])
        self.es = self.srv.objects
        check(self.es.default_parity == M, "12 drives must give EC 8+4")
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.client = Client(self.srv.address)

    def stop(self) -> None:
        self.srv.shutdown()
        self.thread.join(timeout=60)


def reset_launches() -> None:
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import hh_device, rs_device
    rs_device.LAUNCHES = hh_device.LAUNCHES = rs_i8_kernel.LAUNCHES = 0


def read_launches() -> dict:
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import hh_device, rs_device
    return {"gf_apply": rs_device.LAUNCHES,
            "highwayhash256": hh_device.LAUNCHES,
            "rs_i8": rs_i8_kernel.LAUNCHES}


def data_holders(bucket: str, key: str, count: int, first_shard: int = 0):
    """Drives holding data shards first_shard.. of the key's distribution."""
    from minio_tpu_torch.object.erasure_object import hash_order
    dist = hash_order(f"{bucket}/{key}", 12)
    return [i for i in range(12) if first_shard <= dist[i] - 1 < K][:count]


def phase_main_path(torch, rng, root):
    s = Server(root, "seq")
    es, c = s.es, s.client
    try:
        objs = {"big": rng.bytes(256 * MIB),
                "mid": rng.bytes(33 * MIB + 777),
                "small": rng.bytes(200 * 1024)}
        reset_launches()
        es.device_windows = dict.fromkeys(es.device_windows, 0)

        check(c("PUT", "/smoke")[0] == 200, "make bucket")
        times = {}
        for name, body in objs.items():
            t0 = time.perf_counter()
            st, _ = c("PUT", f"/smoke/{name}", body)
            times[("put", name)] = time.perf_counter() - t0
            check(st == 200, f"PUT {name}: {st}")
        for name, body in objs.items():
            t0 = time.perf_counter()
            st, got = c("GET", f"/smoke/{name}")
            times[("get", name)] = time.perf_counter() - t0
            check(st == 200 and got == body, f"GET {name} not identical")
        log(f"main path: PUT+GET of {len(objs)} objects identical, windows "
            f"{es.device_windows}")

        before = es.device_windows["reconstruct"]
        moved = []
        for name in objs:
            for i in data_holders("smoke", name, 4):
                src = os.path.join(s.drives[i], "smoke", name)
                dst = os.path.join(s.drives[i], f"wiped-{name}")
                os.rename(src, dst)
                moved.append((dst, src))
        for name, body in objs.items():
            st, got = c("GET", f"/smoke/{name}")
            check(st == 200 and got == body,
                  f"degraded GET {name} (4 data drives wiped) not identical")
        check(es.device_windows["reconstruct"] > before,
              "degraded GET did not reconstruct on the card")
        for dst, src in moved:
            os.rename(dst, src)
        log("main path: GET with 4 data-shard drives wiped identical")

        before = es.device_windows["reconstruct"]
        for name in ("big", "mid"):
            d = os.path.join(s.drives[data_holders("smoke", name, 1)[0]],
                             "smoke", name)
            (ddir,) = [e for e in os.listdir(d) if e != "xl.meta"]
            with open(os.path.join(d, ddir, "part.1"), "r+b") as f:
                f.seek(32 + 100)
                b = f.read(1)
                f.seek(32 + 100)
                f.write(bytes([b[0] ^ 0x01]))
            st, got = c("GET", f"/smoke/{name}")
            check(st == 200 and got == objs[name],
                  f"GET {name} with a flipped byte not identical")
        check(es.device_windows["reconstruct"] > before,
              "bitrot-demoted GET did not reconstruct on the card")
        log("main path: GET with one flipped shard byte identical")

        bad = Client(s.srv.address, secret="wrong-secret")
        check(bad("GET", "/smoke/small")[0] == 403, "bad signature not 403")

        launches = read_launches()
        windows = dict(es.device_windows)
        log(f"main path launches {launches} set windows {windows} host "
            f"windows {es.host_windows}")
        check(launches["gf_apply"] and launches["highwayhash256"],
              f"a kernel of the path never launched: {launches}")
        check(all(windows.values()), f"a device route never ran: {windows}")
        check(not any(es.host_windows.values()),
              f"windows went to the host: {es.host_windows}")
        size = len(objs["big"]) / MIB
        log(f"256 MiB object: PUT {size / times[('put', 'big')]:.1f} MiB/s, "
            f"GET {size / times[('get', 'big')]:.1f} MiB/s (host clock over "
            "signed HTTP on localhost, one client)")
        return launches
    finally:
        s.stop()


CONC_THREADS = 16
CONC_SIZES = (MIB, 3 * MIB + 5, 8 * MIB, MIB, 3 * MIB + 5, 8 * MIB)


def conc_keys(bucket: str) -> list[list[str]]:
    """Per thread, one key per object; every key's hash_order over 12
    drives is the same, so one survivor set serves every degraded read."""
    want = zlib.crc32(f"{bucket}/t0-o0-0".encode()) % 12
    out = []
    for t in range(CONC_THREADS):
        keys = []
        for j in range(len(CONC_SIZES)):
            salt = 0
            while zlib.crc32(f"{bucket}/t{t}-o{j}-{salt}".encode()) % 12 \
                    != want:
                salt += 1
            keys.append(f"t{t}-o{j}-{salt}")
        out.append(keys)
    return out


def run_clients(fn, per_thread) -> float:
    """fn(thread_index, item) for each thread's items in turn, all threads
    started together; raises the first failure. Returns the wall time."""
    barrier = threading.Barrier(len(per_thread))
    errs = []

    def work(t, items):
        barrier.wait()
        try:
            for item in items:
                fn(t, item)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)
    threads = [threading.Thread(target=work, args=(t, items))
               for t, items in enumerate(per_thread)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "a client hung")
    if errs:
        raise errs[0]
    return wall


def summarize(hist: dict) -> str:
    from minio_tpu_torch.utils.latency import summarize as summ
    s = summ(hist)
    return f"p50 <= {s['p50'] * 1e3:g} ms, p99 <= {s['p99'] * 1e3:g} ms " \
        f"(n={s['count']}, mean {hist['sum'] / max(1, hist['count']) * 1e3:.3f} ms)"


def phase_concurrent(torch, rng, root):
    """16 clients at once through the stripe batchers; returns (launches,
    stats) of the phase."""
    os.environ.pop("MTPU_BATCH_FORCE", None)      # the default: device
    s = Server(root, "conc")
    es, c = s.es, s.client
    try:
        bucket = "conc"
        check(c("PUT", f"/{bucket}")[0] == 200, "make bucket")
        keys = conc_keys(bucket)
        bodies = {j: rng.bytes(n) for j, n in enumerate(CONC_SIZES)}
        # Every thread's j-th object gets its own bytes: a prefix that names
        # the key in front of the shared random body of that size.
        objs = {keys[t][j]: keys[t][j].encode().ljust(64, b".")
                + bodies[j][64:]
                for t in range(CONC_THREADS) for j in range(len(CONC_SIZES))}
        total = sum(len(b) for b in objs.values()) / MIB
        reset_launches()

        def put(t, j):
            st, _ = c("PUT", f"/{bucket}/{keys[t][j]}", objs[keys[t][j]])
            check(st == 200, f"PUT {keys[t][j]}: {st}")

        def get(t, j):
            st, got = c("GET", f"/{bucket}/{keys[t][j]}")
            check(st == 200 and got == objs[keys[t][j]],
                  f"GET {keys[t][j]} not identical")
        items = [list(range(len(CONC_SIZES)))] * CONC_THREADS
        walls = {"put": run_clients(put, items),
                 "get": run_clients(get, items)}
        wiped = data_holders(bucket, keys[0][0], 4)
        moved = []
        for i in wiped:
            for key in objs:
                src = os.path.join(s.drives[i], bucket, key)
                dst = os.path.join(s.drives[i], f"wiped-{key}")
                os.rename(src, dst)
                moved.append((dst, src))
        walls["degraded get"] = run_clients(get, items)
        for dst, src in moved:
            os.rename(dst, src)
        launches = read_launches()
        stats = es.batcher_stats()

        log(f"concurrent: {CONC_THREADS} clients, {len(objs)} objects, "
            f"{total:.1f} MiB each pass, identical every time; wiped drives "
            f"{wiped} (data shards 0-3 of every key)")
        for what, wall in walls.items():
            log(f"concurrent {what}: {wall:.3f} s, {total / wall:.1f} MiB/s "
                "aggregate (host clock over signed HTTP on localhost)")
        for route in ("put", "get", "reconstruct"):
            r = stats["routes"][route]
            dev_d = r["dispatches"]["device"]
            log(f"batcher {route}: device dispatches {dev_d}, host "
                f"dispatches {r['dispatches']['host']}, members "
                f"{r['requests']}, mean {r['requests']['device'] / max(1, dev_d):.2f} "
                f"max {r['max_members']} members a dispatch, "
                f"{r['multi_member_dispatches']} with 2+, buckets "
                f"{dict(sorted(r['buckets'].items()))}, fill ratio "
                f"{r['fill_ratio']:.4f}, deadline culls "
                f"{r['deadline_failures']}")
            log(f"batcher {route}: coalescing wait {summarize(r['wait_hist'])}")
            for part in ("round_trip", "wait", "service"):
                log(f"batcher {route}: lane {part.replace('_', ' ')} "
                    f"{summarize(r[f'lane_{part}_hist'])}")
        lane = stats["lane"]
        log(f"kernel lane: {lane['submitted_total']} dispatches, service "
            f"{summarize(lane['service_hist'])}, rejected "
            f"{lane['rejected_total']}")
        log(f"concurrent launches {launches} set windows {stats['windows']}")
        for route in ("put", "get", "reconstruct"):
            r = stats["routes"][route]
            check(r["multi_member_dispatches"] >= 1,
                  f"no {route} dispatch carried 2+ requests' windows")
            check(r["dispatches"]["host"] == 0
                  and r["requests"]["host"] == r["requests"]["bypass"] == 0,
                  f"{route} windows went to the host: {r}")
            check(r["deadline_failures"] == 0, f"{route} deadline culls")
            check(stats["windows"]["host"][route] == 0,
                  f"{route} host windows")
        check(launches["gf_apply"] and launches["highwayhash256"],
              f"a kernel of the path never launched: {launches}")
        return launches, stats
    finally:
        s.stop()


def mean_ms(hist: dict) -> float:
    return hist["sum"] / max(1, hist["count"]) * 1e3


def solo_dispatch_ms(torch, rng, stats: dict, runs: int = 5) -> dict:
    """Host-clock ms of each route's device function alone, with no
    request threads around, at every bucket the route used in the
    concurrent phase; then each route's lane service mean beside the solo
    time weighted by that route's own bucket counts."""
    from minio_tpu_torch.ops import gf256, hh_device, rs_device
    pm = gf256.parity_matrix(K, M)
    routes = stats["routes"]
    most = max(max(routes[r]["buckets"], default=8)
               for r in ("put", "get", "reconstruct"))
    win = rng.integers(0, 256, size=(most, K, SHARD), dtype=np.uint8)
    framed = rng.integers(0, 256, size=(most, K, 32 + SHARD),
                          dtype=np.uint8)
    fns = {"put": (hh_device.make_mesh_framer(pm, "cuda"), win),
           "get": (hh_device.make_mesh_deframer(K, "cuda"), framed),
           "reconstruct": (rs_device.make_mesh_matrix(decode_rows(), "cuda"),
                           win)}
    out = {}
    for route, (fn, x) in fns.items():
        used = routes[route]["buckets"]
        solo = {}
        for b in sorted(used):
            fn(x[:b])
            t0 = time.perf_counter()
            for _ in range(runs):
                fn(x[:b])
            solo[b] = (time.perf_counter() - t0) / runs * 1e3
        weighted = sum(solo[b] * n for b, n in used.items()) \
            / max(1, sum(used.values()))
        r = routes[route]
        rt, wait, service = (mean_ms(r[f"lane_{p}_hist"]) for p in
                             ("round_trip", "wait", "service"))
        log(f"solo {route} device function, no request threads: "
            + ", ".join(f"bucket {b} {ms:.3f} ms" for b, ms in solo.items())
            + f"; weighted by the phase's buckets {weighted:.3f} ms")
        log(f"lane {route} means: round trip {rt:.3f} ms = wait {wait:.3f} "
            f"+ service {service:.3f} + handoffs {rt - wait - service:.3f}; "
            f"service / solo at its buckets {service / weighted:.2f}x")
        out[route] = solo
    return out


def phase_b5_entry_point(torch):
    """python -m minio_tpu_torch.experiments.rs_i8_kernel, in process."""
    from minio_tpu_torch.experiments import rs_i8_kernel
    reset_launches()
    rc = rs_i8_kernel.main([])
    launches = read_launches()
    check(rc == 0, f"rs_i8_kernel entry point exited {rc}")
    check(launches["rs_i8"] > 0, "rs_i8 never launched from its entry point")
    log(f"rs_i8 entry point launches {launches}")
    return launches


def bound(nbytes: int, ops: int, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(torch, dev, rng):
    """{(kernel, blocks): (ms, plain_ms, bound_ms, bound_by)} at the main
    path's shapes."""
    from minio_tpu_torch.experiments import rs_i8_kernel
    from minio_tpu_torch.ops import gf256, hh_device, rs_device

    timer = Timer(torch)
    out = {}
    pm = gf256.parity_matrix(K, M)
    r, length = M, SHARD
    for b, nbuf in ((32, 4), (256, 2)):      # inputs > 50 MB of L2 together
        bufs = [torch.from_numpy(rng.integers(0, 256, size=(b, K, length),
                                              dtype=np.uint8)).to(dev)
                for _ in range(nbuf)]
        nbytes = b * K * length + b * r * length
        ms = timer(lambda i: rs_device.gf_apply(pm, bufs[i % nbuf]), iters=40)
        plain = timer(lambda i: rs_device.gf_apply_plain(pm, bufs[i % nbuf]),
                      iters=2, warmup=1)
        # One table lookup and one XOR per (output row, input shard, byte).
        out[("gf_apply", b)] = (ms, plain) + bound(
            nbytes + r * K * 256, 2 * b * r * K * length, INT32_OPS_PER_S)
        ms = timer(lambda i: rs_i8_kernel.rs_apply8(pm, bufs[i % nbuf]),
                   iters=40)
        plain = timer(lambda i: rs_i8_kernel.rs_apply8_plain(
            pm, bufs[i % nbuf]), iters=2, warmup=1)
        # The needed int8 product: [8r, 8k] bit matrix over every byte lane.
        out[("rs_i8", b)] = (ms, plain) + bound(
            nbytes, 2 * (8 * r) * (8 * K) * b * length, INT8_TC_OPS_PER_S)
        del bufs
        torch.cuda.empty_cache()

    s = 384
    rows = [torch.from_numpy(rng.integers(0, 256, size=(s, length),
                                          dtype=np.uint8)).to(dev)
            for _ in range(2)]          # 96 MiB
    ms = timer(lambda i: hh_device.hash_rows(rows[i % 2]), iters=10)
    plain = timer(lambda i: hh_device.hash_bytes_plain(rows[i % 2]),
                  iters=1, warmup=0)
    # ~104 32-bit integer operations per packet update (four lanes of
    # 64-bit adds, 32x32->64 products and XORs, four zipper merges): the
    # data's packets plus the 10 finalisation rounds.
    ops = 104 * s * (length // 32 + (1 if length % 32 else 0) + 10)
    out[("highwayhash256", 32)] = (ms, plain) + bound(
        s * length + s * 32, ops, INT32_OPS_PER_S)
    for (name, b), (ms, plain, bms, by) in out.items():
        log(f"time {name} at {b} blocks: {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), {bms / ms * 100:.2f}% of bound")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from minio_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    t_start = t0 = time.perf_counter()
    _build.build()
    log(f"kernel build {time.perf_counter() - t0:.2f} s")
    for kern in _build.KERNELS:
        for line in _build.ptxas_report(kern).splitlines():
            if "Used" in line:
                log(f"ptxas {kern}: {line.split(':', 1)[1].strip()}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    errs = {"gf_apply": 0, "highwayhash256": 0, "rs_i8": 0}
    phase_kernels(torch, dev, rng, errs)
    root = drive_root()
    try:
        seq = phase_main_path(torch, rng, root)
        conc, conc_stats = phase_concurrent(torch, rng, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    solo_dispatch_ms(torch, rng, conc_stats)
    b5 = phase_b5_entry_point(torch)
    times = phase_times(torch, dev, rng)

    launches = {"gf_apply": seq["gf_apply"] + conc["gf_apply"],
                "highwayhash256": seq["highwayhash256"]
                + conc["highwayhash256"],
                "rs_i8": b5["rs_i8"]}
    meta = {
        "gf_apply": ("minio_tpu_torch/ops/csrc/gf_apply.cu",
                     "minio_tpu/ops/rs_device.py:321", 32),
        "highwayhash256": ("minio_tpu_torch/ops/csrc/highwayhash.cu",
                           "minio_tpu/ops/hh_device.py:525", 32),
        "rs_i8": ("minio_tpu_torch/ops/csrc/rs_i8.cu",
                  "experiments/rs_i8_kernel.py:78", 256),
    }
    kernels = []
    for kern, (src, replaces, blocks) in meta.items():
        ms, plain, bms, by = times[(kern, blocks)]
        kernels.append({"name": kern, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kern],
                        "max_abs_err": errs[kern], "ms": ms,
                        "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                        "library_ms": None})
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

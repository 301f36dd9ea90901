"""How the pre-forked fleet's aggregate grows with its workers.

    python -m minio_tpu_torch.tools.fleet_scaling [--workers 1,2,4]
        [--clients 16] [--keys 32] [--turns 2]

For each worker count it boots `python -m minio_tpu_torch.server
--device cuda` with MTPU_HTTP_WORKERS=N on 12 fresh drives (EC 8+4,
under /dev/shm where it has room), in a session of its own, and times
from --clients client threads of this process, each request on a fresh
connection (so SO_REUSEPORT spreads them), --keys requests a client:

  * 1 KiB PUTs (keys/s): the object layer, the drives and one gf_apply
    and one highwayhash256 launch each on the card;
  * signed GETs of one 1 KiB key, hits of each worker's hot-object tier
    after its first (requests/s): the front end and the handler with
    no object-layer, drive or card work;
  * the HTTP floor, GET /minio/health/live (requests/s): what this
    process's clients and the front end's parsing allow.

The worker counts run in turns, the order reversed every other turn,
so that a drift of the host lands on every count. A line per run, then
one JSON object with every number, the card's name, its power limit and
the host's cores. It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

from minio_tpu_torch.s3 import sigv4

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def request(address: str, method: str, path: str,
            body: bytes = b"") -> int:
    """One signed request on a fresh connection; its status."""
    uri, headers = sigv4.sign_headers(
        method, address, path, "minioadmin", "minioadmin",
        hashlib.sha256(body).hexdigest())
    host, _, port = address.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request(method, uri, body=body, headers=headers)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def run_clients(clients: int, fn) -> float:
    """fn(client) on `clients` threads started together; the wall."""
    barrier = threading.Barrier(clients)
    errs: list = []

    def work(t: int) -> None:
        barrier.wait()
        try:
            fn(t)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)
    threads = [threading.Thread(target=work, args=(t,))
               for t in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    if errs or any(th.is_alive() for th in threads):
        raise RuntimeError(f"a client failed or hung: {errs[:1]}")
    return wall


def one_run(root: str, workers: int, clients: int, keys: int,
            device: str = "cuda") -> dict:
    drives = [os.path.join(root, f"d{i}") for i in range(12)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch.server", "--device", device,
         "--address", address, "--scanner-interval", "0", *drives],
        cwd=REPO, env={**os.environ, "MTPU_HTTP_WORKERS": str(workers)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    lines: list[str] = []

    def read() -> None:
        for line in proc.stdout:
            lines.append(line)
    threading.Thread(target=read, daemon=True).start()
    try:
        t0 = time.perf_counter()
        while sum("serving S3 on" in ln for ln in lines) < workers:
            if proc.poll() is not None or time.perf_counter() - t0 > 240:
                raise RuntimeError(f"the server did not boot: {lines[-10:]}")
            time.sleep(0.05)
        boot_s = time.perf_counter() - t0
        if request(address, "PUT", "/scale") != 200:
            raise RuntimeError("make bucket")
        body = os.urandom(1024)

        def puts(t: int) -> None:
            for i in range(keys):
                if request(address, "PUT", f"/scale/c{t:02d}/{i:04d}",
                           body) != 200:
                    raise RuntimeError("1 KiB PUT refused")

        def gets(path: str):
            def client(_t: int) -> None:
                for _ in range(keys):
                    if request(address, "GET", path) != 200:
                        raise RuntimeError(f"GET {path} refused")
            return client
        put_s = clients * keys / run_clients(clients, puts)
        hot = clients * keys / run_clients(clients,
                                           gets("/scale/c00/0000"))
        floor = clients * keys / run_clients(clients,
                                             gets("/minio/health/live"))
        proc.send_signal(signal.SIGINT)      # the clean stop, 1 or N
        if proc.wait(timeout=60) != 0:
            raise RuntimeError(f"the server's stop: {lines[-10:]}")
        return {"workers": workers, "boot_s": boot_s,
                "put_1k_keys_s": put_s, "hot_get_1k_req_s": hot,
                "http_floor_req_s": floor}
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "minio_tpu_torch.tools.fleet_scaling")
    p.add_argument("--workers", default="1,2,4")
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--keys", type=int, default=32)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fleet_scaling: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    counts = [int(w) for w in args.workers.split(",")]
    base = "/dev/shm" if os.path.isdir("/dev/shm") and \
        shutil.disk_usage("/dev/shm").free > 2 << 30 else None
    rows = []
    for turn in range(args.turns):
        for workers in (counts if turn % 2 == 0 else counts[::-1]):
            row = one_run(tempfile.mkdtemp(prefix="fleet-scaling-",
                                           dir=base),
                          workers, args.clients, args.keys)
            rows.append({"turn": turn, **row})
            print(f"turn {turn}: {workers} worker(s) up in "
                  f"{row['boot_s']:.2f} s; {args.clients} clients: 1 KiB "
                  f"PUTs {row['put_1k_keys_s']:.1f} keys/s, hot 1 KiB GETs "
                  f"{row['hot_get_1k_req_s']:.1f} requests/s, HTTP floor "
                  f"{row['http_floor_req_s']:.1f} requests/s ({card})",
                  flush=True)
    print(json.dumps({"card": card, "nproc": os.cpu_count(),
                      "clients": args.clients, "keys": args.keys,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

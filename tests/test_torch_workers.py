"""The port's pre-forked worker fleet (minio_tpu_torch/io/workers.py)
against the JAX package's (minio_tpu/io/workers.py), exact.

Units: SharedGen (with the own-bump case under a young monotonic clock,
which the JAX package's window reset misses), FlockNSLock across two
processes, worker_count_from_env against the JAX function; forked
processes printing into one pipe keep their lines whole.

Fleets, in subprocesses started in their own session (killed by process
group): the port's two workers (`--device cpu`, its parent guarded so
that any torch.cuda call there raises) and the JAX package's two
workers (JAX_PLATFORMS=cpu) on 4 fresh drives each. The same request
scripts run against both, each request on a fresh connection so that
SO_REUSEPORT spreads them over the workers; statuses, object bytes,
error codes and listed keys compared step by step: the ports of
test_workers_conformance_subset, test_workers_fileinfo_cache_cross_
invalidation, test_fleet_overwrite_flushes_sibling_caches and
test_workers_coalesced_bump_coherence. A port fleet of its own for the
lifecycle: admission divided and shedding (503 SlowDown, Retry-After),
a SIGKILLed worker respawned, and SIGTERM draining every worker to exit
0 with its launch line and the drives' clean-shutdown stamps.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from minio_tpu.io import workers as jax_workers
from minio_tpu_torch.io import workers
from minio_tpu_torch.object.nslock import LockTimeout
from minio_tpu_torch.storage.local import CLEAN_SHUTDOWN_FILE
from tests.s3client import S3Client

REPO = Path(__file__).resolve().parents[1]

# The fleet parent's guard: any torch.cuda call in the parent's pid
# raises, so a parent that touched CUDA before forking cannot boot.
PORT_MAIN = """
import os, sys, torch
parent = os.getpid()
def guard(name, orig):
    def call(*a, **k):
        if os.getpid() == parent:
            raise RuntimeError(f"torch.cuda.{name} called in the fleet parent")
        return orig(*a, **k)
    return call
for name in ("is_available", "init", "_lazy_init", "device_count",
             "current_device", "set_device"):
    setattr(torch.cuda, name, guard(name, getattr(torch.cuda, name)))
from minio_tpu_torch import server
sys.exit(server.main(sys.argv[1:]))
"""


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_shared_gen_poll_interval(tmp_path):
    """The JAX package's case, on the port: calls inside the window
    reuse the last verdict, a sibling's bump shows once the window
    expires, our own bump shows at once."""
    path = str(tmp_path / "meta.gen")
    writer = workers.SharedGen(path)
    observer = workers.SharedGen(path, poll_interval=3600.0)
    assert observer.changed() is True        # first look always syncs
    writer.bump()
    assert observer.changed() is False       # inside the window
    observer._polled_at = workers._NEVER     # window expiry
    assert observer.changed() is True
    assert observer.changed() is False       # re-armed, no new bump
    observer.bump()                          # own bump resets the window
    assert observer.changed() is True
    observer.bump()
    assert writer.changed() is True


@pytest.mark.parametrize("clock", [1.0, 742.0, 3599.0])
def test_shared_gen_own_bump_on_a_young_clock(tmp_path, monkeypatch, clock):
    """time.monotonic() below the window: the port's first look and its
    own bump are seen (the JAX package resets the window to 0.0, which
    such a clock still falls inside, and hides both)."""
    monkeypatch.setattr(workers.time, "monotonic", lambda: clock)
    path = str(tmp_path / "meta.gen")
    observer = workers.SharedGen(path, poll_interval=3600.0)
    assert observer.changed() is True
    observer.bump()
    assert observer.changed() is True
    assert observer.changed() is False


def test_shared_gen_matches_jax_on_an_old_clock(tmp_path, monkeypatch):
    """Where the JAX package's window reset is sound (a clock older than
    the window), both give the same verdicts on the same sequence."""
    clock = [10_000.0]
    monkeypatch.setattr(workers.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(jax_workers.time, "monotonic", lambda: clock[0])
    verdicts = []
    for mod, sub in ((workers, "p"), (jax_workers, "j")):
        path = str(tmp_path / sub / "list.gen")
        w, o = mod.SharedGen(path), mod.SharedGen(path, poll_interval=5.0)
        seq = []
        clock[0] = 10_000.0
        for step in ("o", "wb", "o", "t", "o", "o", "ob", "o", "t", "wb",
                     "o", "t", "o"):
            if step == "o":
                seq.append(o.changed())
            elif step == "wb":
                w.bump()
            elif step == "ob":
                o.bump()
            else:
                clock[0] += 6.0
        verdicts.append(seq)
    assert verdicts[0] == verdicts[1]


HOLDER = """
import sys, time
from minio_tpu_torch.io.workers import FlockNSLock
lk = FlockNSLock(sys.argv[1])
with getattr(lk, sys.argv[2])("bkt", "key"):
    print("held", flush=True)
    time.sleep(float(sys.argv[3]))
"""


@pytest.mark.parametrize("mode", ["write", "read"])
def test_flock_nslock_serializes_one_key_across_processes(tmp_path, mode):
    """A key locked in another process: a write lock here times out,
    a read lock only against a writer; another key is free; the key is
    ours once the holder is gone."""
    lock_dir = str(tmp_path / "nslocks")
    proc = subprocess.Popen(
        [sys.executable, "-c", HOLDER, lock_dir, mode, "2.0"],
        cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        assert proc.stdout.readline().strip() == "held"
        lk = workers.FlockNSLock(lock_dir)
        with pytest.raises(LockTimeout):
            with lk.write("bkt", "key", timeout=0.3):
                pass
        if mode == "write":
            with pytest.raises(LockTimeout):
                with lk.read("bkt", "key", timeout=0.3):
                    pass
        else:
            with lk.read("bkt", "key", timeout=0.3):
                pass
        other = next(f"k{i}" for i in range(1000)
                     if lk._stripe("bkt", f"k{i}") != lk._stripe("bkt",
                                                                  "key"))
        with lk.write("bkt", other, timeout=0.3):
            pass
        assert proc.wait(timeout=30) == 0
        with lk.write("bkt", "key", timeout=0.3):
            pass
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)


@pytest.mark.parametrize("raw", ["", " ", "0", "1", "2", "4", "17", "-3",
                                 "x", "2.5", " 3 "])
def test_worker_count_from_env_matches_jax(raw):
    env = {"MTPU_HTTP_WORKERS": raw}
    assert workers.worker_count_from_env(env) == \
        jax_workers.worker_count_from_env(env)
    assert workers.worker_count_from_env({}) == \
        jax_workers.worker_count_from_env({})


def test_swap_address_matches_jax():
    for argv in (["--address", "h:0", "d1"], ["--address=h:0", "d1"],
                 ["d1", "d2"]):
        assert workers._swap_address(argv, "h:0", "h:9") == \
            jax_workers._swap_address(argv, "h:0", "h:9")


# Eight forked processes print JSON lines at once into one pipe, as a
# fleet's workers do at their clean stop, after the server's stream setup.
_FORKED_LINES = """
import json, os
from minio_tpu_torch.server import whole_lines
whole_lines()
go_r, go_w = os.pipe()
pids = []
for w in range(8):
    pid = os.fork()
    if pid == 0:
        os.read(go_r, 1)            # every process forked: print at once
        for i in range(300):
            print(f"worker {w} line: " + json.dumps({"i": i, "pad": "x" * 80}),
                  flush=True)
        os._exit(0)
    pids.append(pid)
os.write(go_w, b"g" * 8)
for pid in pids:
    os.waitpid(pid, 0)
"""


def test_forked_workers_print_whole_lines():
    """Under PYTHONUNBUFFERED a print writes its text and its newline
    apart; after whole_lines() every line arrives whole."""
    out = subprocess.run(
        [sys.executable, "-c", _FORKED_LINES], capture_output=True,
        text=True, timeout=120, cwd=str(Path(__file__).parent.parent),
        env={**os.environ, "PYTHONUNBUFFERED": "1"}, check=True).stdout
    lines = out.splitlines()
    assert len(lines) == 8 * 300
    got = sorted((int(ln.split()[1]), json.loads(ln.split(": ", 1)[1])["i"])
                 for ln in lines)
    assert got == [(w, i) for w in range(8) for i in range(300)]


# ---------------------------------------------------------------------------
# fleets
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """A server subprocess in its own session, its output collected."""

    def __init__(self, argv: list, env: dict, port: int):
        self.address = f"127.0.0.1:{port}"
        self.proc = subprocess.Popen(
            argv, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self.lines: list[str] = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())

    def serving(self) -> dict:
        """worker id -> pid of each worker's latest serving line."""
        out = {}
        for ln in list(self.lines):
            m = re.search(r"serving S3 on .*worker (\d+) of \d+, pid (\d+)",
                          ln)
            if m:
                out[int(m.group(1))] = int(m.group(2))
        return out

    def wait_for(self, cond, what: str, timeout: float = 120) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            if self.proc.poll() is not None or time.monotonic() > deadline:
                pytest.fail(f"{what}: {self.lines[-30:]}")
            time.sleep(0.1)

    def wait_live(self) -> None:
        """The port answers a health probe."""
        def live():
            try:
                return S3Client(self.address).request(
                    "GET", "/minio/health/live", sign=False)[0] == 200
            except OSError:
                return False
        self.wait_for(live, "the fleet did not come up")

    def kill(self) -> None:
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.proc.wait(timeout=30)


def port_fleet(root: Path, port: int, n: int = 2, **env) -> Fleet:
    drives = [str(root / f"d{i}") for i in range(4)]
    fl = Fleet([sys.executable, "-c", PORT_MAIN, "--device", "cpu",
                "--address", f"127.0.0.1:{port}", "--scanner-interval", "0",
                *drives],
               dict(os.environ, PYTHONPATH=str(REPO),
                    MTPU_HTTP_WORKERS=str(n), **env), port)
    fl.drives = drives
    fl.wait_for(lambda: len(fl.serving()) == n, "the port's fleet did "
                "not boot every worker")
    fl.wait_live()
    return fl


def jax_fleet(root: Path, port: int, **env) -> Fleet:
    fl = Fleet([sys.executable, "-m", "minio_tpu.server", "--address",
                f"127.0.0.1:{port}", "--scanner-interval", "0",
                f"{root}/d{{1...4}}"],
               dict(os.environ, JAX_PLATFORMS="cpu", MTPU_HTTP_WORKERS="2",
                    **env), port)
    fl.wait_for(lambda: sum("serving S3" in ln for ln in fl.lines) >= 2,
                "the JAX package's fleet did not boot both workers", 180)
    fl.wait_live()
    return fl


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """(port fleet, JAX fleet), two workers each, group commit on."""
    root = tmp_path_factory.mktemp("fleets")
    made = []
    try:
        made.append(port_fleet(root / "port", _free_port(),
                               MTPU_GROUP_COMMIT="on"))
        made.append(jax_fleet(root / "jax", _free_port(),
                              MTPU_GROUP_COMMIT="on"))
        yield made
    finally:
        for fl in made:
            fl.kill()


def _header(hdrs: dict, name: str) -> str:
    return {k.lower(): v for k, v in hdrs.items()}.get(name, "")


def _norm(method: str, st: int, body: bytes):
    """What two servers must agree on: the status, an object's bytes,
    an error's code, a listing's keys, an upload id's presence."""
    if method != "GET" or not body.startswith(b"<?xml"):
        return st, body if method == "GET" else b""
    code = re.findall(rb"<Code>([^<]*)</Code>", body)
    if code:
        return st, code
    return st, sorted(re.findall(rb"<Key>([^<]*)</Key>", body))


def _run(addr: str, steps) -> list:
    """Each step on a fresh connection; a step is (method, path, kw) or
    a callable taking the results so far and returning one."""
    out = []
    for step in steps:
        method, path, kw = step(out) if callable(step) else step
        st, hdrs, body = S3Client(addr).request(method, path, **kw)
        out.append((method, st, hdrs, body))
    return out


def _compare(fleets, steps) -> list:
    port, jx = fleets
    got = [_run(fl.address, steps) for fl in (port, jx)]
    for i, (p, j) in enumerate(zip(*got)):
        assert _norm(p[0], p[1], p[3]) == _norm(j[0], j[1], j[3]), \
            f"step {i}: {p[0]} port {p[1]} {p[3][:200]!r} / JAX {j[1]} " \
            f"{j[3][:200]!r}"
    return got[0]


def test_workers_conformance_subset(fleets):
    """Bucket and object CRUD, a ranged GET, listings fresh after
    writes through either worker, multipart, deletes."""
    body = os.urandom(30_000)
    # Part 1 at the S3 minimum of 5 MiB, part 2 the short last one.
    part1, part2 = os.urandom(5 << 20), os.urandom(1000)

    def upload_id(out):
        return out[-1][3].decode().split("<UploadId>")[1].split("<")[0]

    def part(num, data, back):
        def step(out):
            return ("PUT", "/confb/mp", {"query": {
                "partNumber": str(num), "uploadId": upload_id(
                    out[:len(out) - back])}, "body": data})
        return step

    def complete(out):
        uid = upload_id(out[:-2])
        etags = [_header(out[-2][2], "etag"), _header(out[-1][2], "etag")]
        xml = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
            for n, e in zip((1, 2), etags)) + "</CompleteMultipartUpload>"
        return ("POST", "/confb/mp", {"query": {"uploadId": uid},
                                      "body": xml.encode()})

    steps = [("PUT", "/confb", {}),
             ("PUT", "/confb/obj1", {"body": body}),
             ("GET", "/confb/obj1", {}),
             ("GET", "/confb/obj1", {"headers": {"Range": "bytes=100-299"}}),
             *[("GET", "/confb", {})] * 6,
             ("POST", "/confb/mp", {"query": {"uploads": ""}}),
             part(1, part1, 0), part(2, part2, 1), complete,
             ("GET", "/confb/mp", {}),
             ("DELETE", "/confb/mp", {}),
             ("DELETE", "/confb/obj1", {}),
             *[("GET", "/confb", {})] * 4,
             ("GET", "/confb/obj1", {})]
    out = _compare(fleets, steps)
    assert out[2][3] == body and out[3][3] == body[100:300]
    assert out[14][1] == 200 and out[14][3] == part1 + part2
    assert all(b"obj1" in out[i][3] for i in range(4, 10))
    assert all(b"obj1" not in out[i][3] for i in range(17, 21))
    assert out[21][1] == 404


def test_workers_fileinfo_cache_cross_invalidation(fleets):
    """Overwrites and deletes through either worker invalidate every
    sibling's fileinfo cache: both workers primed, then no connection
    serves stale bytes."""
    body1, body2 = b"one" * 12_345, b"two" * 15_001
    steps = [("PUT", "/fib", {}), ("PUT", "/fib/k", {"body": body1}),
             *[("GET", "/fib/k", {})] * 8,
             ("PUT", "/fib/k", {"body": body2}),
             *[("GET", "/fib/k", {})] * 8,
             ("DELETE", "/fib/k", {}),
             *[("GET", "/fib/k", {})] * 6]
    out = _compare(fleets, steps)
    assert all(o[3] == body1 for o in out[2:10])
    assert all(o[1] == 200 and o[3] == body2 for o in out[11:19])
    assert all(o[1] == 404 for o in out[20:])


def test_fleet_overwrite_flushes_sibling_caches(fleets):
    """Both workers' hot caches warm, an overwrite through one: every
    later GET, whichever worker lands it, serves the new bytes."""
    v1, v2 = os.urandom(4_800), os.urandom(4_800)
    steps = [("PUT", "/flh", {}), ("PUT", "/flh/obj", {"body": v1}),
             *[("GET", "/flh/obj", {})] * 8,
             ("PUT", "/flh/obj", {"body": v2}),
             *[("GET", "/flh/obj", {})] * 8,
             ("DELETE", "/flh/obj", {}),
             *[("GET", "/flh/obj", {})] * 4]
    out = _compare(fleets, steps)
    assert all(o[3] == v1 for o in out[2:10])
    assert all(o[3] == v2 for o in out[11:19])
    assert all(o[1] == 404 for o in out[20:])


def test_workers_coalesced_bump_coherence(fleets):
    """Concurrent small PUT storms through both workers (group-commit
    lanes engaged), then overwrites: no connection serves stale bytes,
    and the listing converges on the full keyspace."""
    body1, body2 = b"one" * 1000, b"two" * 1100
    port, jx = fleets
    results = []
    for fl in (port, jx):
        addr = fl.address
        assert S3Client(addr).request("PUT", "/gcb")[0] == 200

        def storm(body):
            def put(t):
                cli = S3Client(addr)
                sts = [cli.request("PUT", f"/gcb/k{t}-{i}", body=body)[0]
                       for i in range(6)]
                sts.append(cli.request("PUT", "/gcb/hot", body=body)[0])
                return sts
            with ThreadPoolExecutor(max_workers=8) as ex:
                return [st for sts in ex.map(put, range(8)) for st in sts]

        def gets():
            return [(st, got) for st, _, got in
                    (S3Client(addr).request("GET", "/gcb/hot")
                     for _ in range(8))]

        got = [storm(body1), gets(), storm(body2), gets()]
        st, _, page = S3Client(addr).request(
            "GET", "/gcb", query={"prefix": "k", "max-keys": "1000"})
        got.append((st, sorted(re.findall(rb"<Key>([^<]*)</Key>", page))))
        results.append(got)
    p, j = results
    assert p == j
    assert p[0] == [200] * 56 and p[2] == [200] * 56
    assert p[1] == [(200, body1)] * 8 and p[3] == [(200, body2)] * 8
    assert len(p[4][1]) == 48


def test_hot_and_fileinfo_kill_switches_in_a_fleet(tmp_path):
    """MTPU_FILEINFO_CACHE=off MTPU_HOT_CACHE=off: a fleet that caches
    nothing answers as one that does."""
    fl = port_fleet(tmp_path, _free_port(), MTPU_FILEINFO_CACHE="off",
                    MTPU_HOT_CACHE="off")
    try:
        body = os.urandom(2000)
        c = S3Client(fl.address)
        assert c.request("PUT", "/kil")[0] == 200
        assert c.request("PUT", "/kil/o", body=body)[0] == 200
        for _ in range(4):
            assert S3Client(fl.address).request("GET", "/kil/o")[2] == body
    finally:
        fl.kill()


def test_fleet_lifecycle_admission_respawn_drain(tmp_path):
    """MTPU_API_REQUESTS_MAX=4 over 2 workers: a burst of 16 PUTs sheds
    with 503 SlowDown and Retry-After while at least 4 succeed. A
    SIGKILLed worker is respawned (a new pid serving as the same worker)
    and the fleet serves throughout. SIGTERM to the parent: each worker
    drains, prints its launch line and exits; the parent exits 0, and
    every drive carries the clean-shutdown stamp."""
    fl = port_fleet(tmp_path, _free_port(), MTPU_API_REQUESTS_MAX="4",
                    MTPU_API_REQUESTS_DEADLINE="100ms")
    try:
        addr = fl.address
        assert S3Client(addr).request("PUT", "/admb")[0] == 200
        body = os.urandom(40_000)

        def put_one(i):
            return S3Client(addr).request("PUT", f"/admb/o{i}", body=body)

        with ThreadPoolExecutor(max_workers=16) as ex:
            results = list(ex.map(put_one, range(16)))
        statuses = [st for st, _, _ in results]
        assert statuses.count(200) >= 4, statuses
        assert set(statuses) <= {200, 503}, statuses
        for st, hdrs, err in results:
            if st == 503:
                assert b"<Code>SlowDown</Code>" in err
                assert _header(hdrs, "retry-after") == "1"
        ok = statuses.index(200)

        before = fl.serving()
        os.kill(before[1], signal.SIGKILL)
        fl.wait_for(lambda: fl.serving().get(1) not in (None, before[1]),
                    "worker 1 was not respawned")
        for _ in range(6):
            st, _, got = S3Client(addr).request("GET", f"/admb/o{ok}")
            assert st == 200 and got == body
        after = fl.serving()
        assert after[0] == before[0] and after[1] != before[1]

        fl.proc.send_signal(signal.SIGTERM)
        assert fl.proc.wait(timeout=30) == 0
        fl.reader.join(10)              # every line the fleet printed
        done = [ln for ln in fl.lines
                if re.match(r"worker \d kernel launches while serving: ", ln)]
        assert sorted(ln.split()[1] for ln in done) == ["0", "1"], fl.lines
        for d in fl.drives:
            assert os.path.exists(os.path.join(d, ".mtpu.sys",
                                               CLEAN_SHUTDOWN_FILE)), d
    finally:
        fl.kill()


def test_fleet_pools_background_by_set_and_migration_coherence(tmp_path):
    """Two workers over three sets (pool 0: 8 drives in sets of 4, pool
    1: 4 drives): worker 0 scans sets 0 and 2, worker 1 set 1. A key
    both workers have read (and cached) is decommissioned out of pool 0
    by whichever worker takes the admin call: every later read on fresh
    connections returns its bytes, an overwrite lands in pool 1 and is
    what every worker then serves, and a delete is seen by both."""
    port = _free_port()
    fl = Fleet([sys.executable, "-c", PORT_MAIN, "--device", "cpu",
                "--address", f"127.0.0.1:{port}", "--scanner-interval", "0",
                "--set-size", "4", str(tmp_path / "d{1...8}"),
                str(tmp_path / "e{1...4}")],
               dict(os.environ, PYTHONPATH=str(REPO), MTPU_HTTP_WORKERS="2"),
               port)
    try:
        fl.wait_for(lambda: len(fl.serving()) == 2, "the fleet did not boot")
        fl.wait_live()
        scanning = {int(m.group(1)): int(m.group(2)) for ln in fl.lines
                    for m in [re.search(r"worker (\d+) of 2, pid \d+, "
                                        r"scanning (\d+) sets", ln)] if m}
        assert scanning == {0: 2, 1: 1}, fl.lines
        addr = fl.address

        def get(key: str) -> list:
            return [S3Client(addr).request("GET", f"/mig/{key}")[::2]
                    for _ in range(8)]
        assert S3Client(addr).request("PUT", "/mig")[0] == 200
        old, new = os.urandom(2000), os.urandom(3000)
        assert S3Client(addr).request("PUT", "/mig/k", body=old)[0] == 200
        assert get("k") == [(200, old)] * 8
        pool0 = [tmp_path / f"d{i}" for i in range(1, 9)]
        assert any((d / "mig" / "k").exists() for d in pool0)

        assert S3Client(addr).request(
            "POST", "/minio/admin/v3/decommission",
            query={"pool": "0"})[0] == 200
        deadline = time.monotonic() + 60
        while True:
            st, _, body = S3Client(addr).request(
                "GET", "/minio/admin/v3/decommission-status")
            doc = json.loads(body) if body else {}
            if st == 200 and doc.get("status") == "complete":
                break
            assert time.monotonic() < deadline, (st, body)
            time.sleep(0.1)
        assert doc["migrated"] == 1 and doc["failed"] == 0
        assert not any((d / "mig" / "k").exists() for d in pool0)
        assert get("k") == [(200, old)] * 8
        assert S3Client(addr).request("PUT", "/mig/k", body=new)[0] == 200
        assert get("k") == [(200, new)] * 8
        assert not any((d / "mig" / "k").exists() for d in pool0)
        assert S3Client(addr).request("DELETE", "/mig/k")[0] == 204
        assert [st for st, _ in get("k")] == [404] * 8
    finally:
        fl.kill()


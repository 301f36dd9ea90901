"""The port's grid mesh (minio_tpu_torch/grid) against the JAX package's.

The control frames are the JAX grid's frames byte for byte; a port
client and a JAX server (and the other way round) answer each other's
ping, unary, stream and error frames; and the port's own counterparts
of the JAX package's grid tests (tests/test_distributed.py,
tests/test_grid_native.py, tests/test_cluster.py): raw bulk frames,
credit windows, chaos modes and the per-peer breaker. The JAX side of a
cross-package test runs in a subprocess: a JAX grid started in the
pytest worker would start the JAX package's process-wide poller, which
its own tests expect not to exist.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from minio_tpu.grid import wire as ref_wire
from minio_tpu_torch.grid import GridClient, GridError, GridServer
from minio_tpu_torch.grid import RemoteCallError, chaos as chaos_mod
from minio_tpu_torch.grid import loop, wire
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.storage.meta import FileNotFoundErr
from minio_tpu_torch.storage.remote import RemoteStorage, StorageRPCService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every frame type, nested maps, bin, big and negative ints, floats,
# non-ASCII and long strings.
FRAMES = [
    {"t": wire.T_REQ, "m": 1, "h": "st.read_all", "p": {"d": "/x/d0",
                                                        "a": ["b", "k"]}},
    {"t": wire.T_RESP, "m": 2, "p": b"\x00\x01" * 300},
    {"t": wire.T_ERR, "m": 3, "e": "FileNotFound", "msg": "b/k"},
    {"t": wire.T_SREQ, "m": 4, "h": "st.walk_scan", "p": {"a": ["b", "", "",
                                                                False]},
     "w": 32},
    {"t": wire.T_CHUNK, "m": 5, "p": [["k", 0, [[0, 1 << 40, 70000, "v",
                                                  "dd", "e", "", ""]]]]},
    {"t": wire.T_EOF, "m": 6},
    {"t": wire.T_PING},
    {"t": wire.T_PONG},
    {"t": wire.T_WIN, "m": 7, "n": 16},
    {"t": wire.T_REQ, "m": 2**32 - 1, "h": "lock.try",
     "p": {"r": "bkt/obj", "u": "uuid", "w": True}},
    {"t": wire.T_RESP, "m": 9, "p": {"neg": [-1, -33, -200, -70000,
                                             -2**40], "big": 2**64 - 1,
                                     "f": 1.25, "none": None,
                                     "s": "é" * 40 + "x" * 300,
                                     "nest": {"a": {"b": {"c": [b""]}}},
                                     "many": {str(i): i for i in range(20)},
                                     "arr": list(range(20))}},
]


@pytest.mark.parametrize("msg", FRAMES, ids=lambda m: f"t{m.get('t')}")
def test_control_frames_equal_jax(msg):
    ours = wire.pack_frame(msg)
    assert ours == ref_wire.pack_frame(msg)
    a, b = socket.socketpair()
    try:
        a.sendall(ours)
        got = wire.read_frame(b)
        a.sendall(ours)
        assert got == ref_wire.read_frame(b) == msg
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("mux,n", [(1, 0), (7, 87382), (2**32 - 1, 1 << 20)])
def test_raw_frames_equal_jax(mux, n):
    assert wire.pack_raw_header(mux, n) == ref_wire.pack_raw_header(mux, n)
    payload = bytes(range(256)) * (n // 256) + b"\x05" * (n % 256)
    a, b = socket.socketpair()
    try:
        threading.Thread(target=a.sendall, args=(
            wire.pack_raw_header(mux, n) + payload,), daemon=True).start()
        got = wire.read_frame(b)
        assert got == {"t": wire.T_CHUNK, "m": mux, "p": payload,
                       "raw": True}
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the two packages answer each other
# ---------------------------------------------------------------------------

_JAX_SERVER = textwrap.dedent("""
    import sys
    from minio_tpu.grid import GridServer, wire
    from minio_tpu.storage.meta import FileNotFoundErr
    import minio_tpu.storage.remote  # registers the storage error codes
    srv = GridServer(0, host="127.0.0.1")
    srv.register("echo", lambda p: p)
    def boom(p):
        raise FileNotFoundErr("nope")
    srv.register("boom", boom)
    def gen(p):
        for i in range(p):
            yield {"i": i}
        yield wire.RawBytes(b"R" * 3000)
    srv.register_stream("gen", gen)
    srv.start()
    print(srv.port, flush=True)
    sys.stdin.read()
    srv.stop()
""")

_JAX_CLIENT = textwrap.dedent("""
    import json, sys
    from minio_tpu.grid import GridClient, RemoteCallError
    c = GridClient("127.0.0.1", int(sys.argv[1]))
    out = {"ping": c.ping(), "echo": c.call("echo", {"a": [1, -2], "s": "x"}),
           "stream": [x if isinstance(x, dict) else len(x)
                      for x in c.stream("gen", 3)]}
    try:
        c.call("boom")
    except RemoteCallError as e:
        out["boom"] = e.code
    try:
        c.call("no-such")
    except RemoteCallError as e:
        out["none"] = e.code
    c.close()
    print(json.dumps(out))
""")


def _jax_env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def test_port_client_against_jax_server():
    p = subprocess.Popen([sys.executable, "-c", _JAX_SERVER],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         env=_jax_env(), cwd=REPO, text=True)
    try:
        port = int(p.stdout.readline())
        c = GridClient("127.0.0.1", port)
        try:
            assert c.ping()
            assert c.call("echo", {"a": [1, -2], "b": b"raw"}) == \
                {"a": [1, -2], "b": b"raw"}
            assert list(c.stream("gen", 3)) == \
                [{"i": 0}, {"i": 1}, {"i": 2}, b"R" * 3000]
            with pytest.raises(RemoteCallError) as ei:
                c.call("boom")
            assert ei.value.code == "FileNotFound"
            with pytest.raises(RemoteCallError) as ei:
                c.call("no-such")
            assert ei.value.code == "NoSuchHandler"
        finally:
            c.close()
    finally:
        p.stdin.close()
        p.wait(timeout=30)


def test_jax_client_against_port_server():
    srv = GridServer(0, host="127.0.0.1")
    srv.register("echo", lambda p: p)

    def boom(p):
        raise FileNotFoundErr("nope")
    srv.register("boom", boom)

    def gen(p):
        for i in range(p):
            yield {"i": i}
        yield wire.RawBytes(b"R" * 3000)
    srv.register_stream("gen", gen)
    srv.start()
    try:
        r = subprocess.run([sys.executable, "-c", _JAX_CLIENT,
                            str(srv.port)], env=_jax_env(), cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out == {"ping": True, "echo": {"a": [1, -2], "s": "x"},
                       "stream": [{"i": 0}, {"i": 1}, {"i": 2}, 3000],
                       "boom": "FileNotFound", "none": "NoSuchHandler"}
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# grid core (tests/test_distributed.py's)
# ---------------------------------------------------------------------------

@pytest.fixture
def grid_pair():
    srv = GridServer(0, host="127.0.0.1")
    srv.start()
    client = GridClient("127.0.0.1", srv.port)
    yield srv, client
    client.close()
    srv.stop()


def test_grid_unary_and_concurrent(grid_pair):
    srv, client = grid_pair
    srv.register("echo", lambda p: p)
    srv.register("double", lambda p: p * 2)
    assert client.call("echo", {"a": [1, 2], "b": b"raw"}) == \
        {"a": [1, 2], "b": b"raw"}
    results = []

    def worker(i):
        results.append(client.call("double", i))
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(20)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(results) == [i * 2 for i in range(20)]


def test_grid_stream(grid_pair):
    srv, client = grid_pair
    srv.register_stream("gen", lambda p: (i for i in range(p)))
    assert list(client.stream("gen", 5)) == [0, 1, 2, 3, 4]


def test_grid_error_mapping(grid_pair):
    srv, client = grid_pair

    def boom(p):
        raise FileNotFoundErr("nope")
    srv.register("boom", boom)
    with pytest.raises(RemoteCallError) as ei:
        client.call("boom")
    assert ei.value.code == "FileNotFound"
    with pytest.raises(RemoteCallError) as ei:
        client.call("no-such-handler")
    assert ei.value.code == "NoSuchHandler"


def test_grid_reconnect_after_server_restart():
    srv = GridServer(0, host="127.0.0.1")
    srv.start()
    port = srv.port
    srv.register("echo", lambda p: p)
    client = GridClient("127.0.0.1", port)
    assert client.call("echo", 1) == 1
    srv.stop()
    time.sleep(0.1)
    with pytest.raises(GridError):
        client.call("echo", 2, timeout=2.0)
    srv2 = GridServer(port, host="127.0.0.1")
    srv2.register("echo", lambda p: p)
    srv2.start()
    try:
        deadline = time.time() + 5
        while True:
            try:
                assert client.call("echo", 3) == 3
                break
            except GridError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
    finally:
        client.close()
        srv2.stop()


# ---------------------------------------------------------------------------
# raw bulk frames and credit windows (tests/test_grid_native.py's)
# ---------------------------------------------------------------------------

@pytest.fixture
def grid_env(tmp_path):
    roots = [str(tmp_path / f"d{i}") for i in range(2)]
    locals_ = [LocalStorage(r) for r in roots]
    srv = GridServer(0, host="127.0.0.1")
    StorageRPCService({r: d for r, d in zip(roots, locals_)}) \
        .register_into(srv)
    srv.start()
    yield srv, roots, locals_
    srv.stop()


def _blob(n: int, seed: int = 7) -> bytes:
    one = bytes((i * 31 + seed) & 0xFF for i in range(4096))
    return (one * (n // len(one) + 1))[:n]


def test_raw_read_byte_identity_and_sendfile_counter(grid_env):
    srv, roots, locals_ = grid_env
    data = _blob(5 * (1 << 20) + 12345)
    locals_[0].make_vol("vol")
    locals_[0].create_file("vol", "shard.bin", [data])
    remote = RemoteStorage("127.0.0.1", srv.port, roots[0])
    before = loop.stats()
    assert remote.read_file("vol", "shard.bin") == data
    for off, ln in [(0, 17), (1 << 20, 1 << 20), ((1 << 20) - 3, 10),
                    (len(data) - 5, -1), (4321, 3 * (1 << 20) + 7),
                    ((1 << 20) - 3, (1 << 20) + 7)]:
        want = data[off:] if ln < 0 else data[off:off + ln]
        assert remote.read_file("vol", "shard.bin", off, ln) == want, \
            (off, ln)
    after = loop.stats()
    assert after["sendfile_transfers"] > before["sendfile_transfers"]
    assert after["sendfile_bytes"] - before["sendfile_bytes"] >= len(data)
    assert after["raw_rx_bytes"] - before["raw_rx_bytes"] >= len(data)


def test_raw_read_empty_file(grid_env):
    srv, roots, locals_ = grid_env
    locals_[0].make_vol("vol")
    locals_[0].create_file("vol", "empty.bin", [])
    remote = RemoteStorage("127.0.0.1", srv.port, roots[0])
    assert remote.read_file("vol", "empty.bin") == b""
    buf = bytearray(8)
    assert remote.read_file_into("vol", "empty.bin", 0, [buf]) == 0


def test_raw_write_sink_byte_identity(grid_env):
    """create_file pushes raw frames; the file is the chunks' bytes,
    also when it appends (heal's windowed rewrite)."""
    srv, roots, locals_ = grid_env
    data = _blob(4 * (1 << 20) + 999, seed=11)
    remote = RemoteStorage("127.0.0.1", srv.port, roots[1])
    remote.make_vol_if_missing("wvol")
    before = loop.stats()
    pieces = [data[i:i + 87382] for i in range(0, len(data), 87382)]
    remote.create_file("wvol", "pushed.bin", iter(pieces))
    after = loop.stats()
    assert locals_[1].read_file("wvol", "pushed.bin") == data
    assert after["raw_tx_bytes"] - before["raw_tx_bytes"] >= len(data)
    remote.create_file("wvol", "pushed.bin", [b"tail"], append=True)
    assert locals_[1].read_file("wvol", "pushed.bin") == data + b"tail"


def test_mux_fairness_under_undrained_bulk_stream(grid_env):
    """A bulk raw stream nobody drains stalls the sender at its credit
    window; unary calls on the same connection keep answering fast."""
    srv, roots, _ = grid_env
    chunk = _blob(256 << 10, seed=9)
    total = 64

    def bulk_stream(payload):
        for _ in range(total):
            yield wire.RawBytes(chunk)

    srv.register_stream("test.bulk", bulk_stream)
    c = GridClient("127.0.0.1", srv.port)
    try:
        it = c.stream("test.bulk", raw=True, timeout=60.0)
        got = next(it)
        got[1].release()
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            assert c.ping(timeout=5.0)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        assert lat[len(lat) // 2] < 0.05, f"median ping {lat[-1]:.3f}s"
        n = len(chunk)
        for view, lease in it:
            n += len(view)
            lease.release()
        assert n == total * len(chunk)
    finally:
        c.close()


def test_stream_timeout_on_live_connection_is_not_breaker_fuel(grid_env):
    """A hung stream handler times out its caller while pings keep the
    connection provably alive: never breaker fuel."""
    srv, roots, _ = grid_env
    release = threading.Event()

    def hung_stream(payload):
        yield b"first"
        release.wait(30.0)
        yield b"second"

    srv.register_stream("test.hung", hung_stream)
    c = GridClient("127.0.0.1", srv.port, trip_after=2)
    stop = threading.Event()

    def pinger():
        while not stop.is_set():
            c.ping(timeout=2.0)
            stop.wait(0.2)

    t = threading.Thread(target=pinger, daemon=True)
    t.start()
    try:
        for _ in range(3):                 # > trip_after
            it = c.stream("test.hung", timeout=1.0)
            assert next(it) == b"first"
            with pytest.raises(GridError) as ei:
                next(it)
            assert "connection live" in str(ei.value)
            it.close()
        assert c.breaker_state() == "closed"
        assert c._consecutive == 0
        assert c.ping(timeout=2.0)
    finally:
        release.set()
        stop.set()
        t.join(timeout=5)
        c.close()


# ---------------------------------------------------------------------------
# chaos and the per-peer breaker (tests/test_cluster.py's)
# ---------------------------------------------------------------------------

@pytest.fixture
def chaos_file(tmp_path):
    path = tmp_path / "chaos.json"
    old = os.environ.get(chaos_mod.ENV)
    os.environ[chaos_mod.ENV] = str(path)
    chaos_mod._reset_for_tests()
    try:
        yield path
    finally:
        if old is None:
            os.environ.pop(chaos_mod.ENV, None)
        else:
            os.environ[chaos_mod.ENV] = old
        chaos_mod._reset_for_tests()


def _wait_chaos():
    time.sleep(chaos_mod._POLL_S + 0.02)


def test_grid_chaos_modes(chaos_file):
    srv = GridServer(0, host="127.0.0.1")
    srv.register("echo", lambda p: p)
    srv.start()
    c = GridClient("127.0.0.1", srv.port, send_retries=0, trip_after=1000)
    try:
        assert c.call("echo", 1) == 1
        chaos_file.write_text('{"mode": "blackhole"}')
        _wait_chaos()
        with pytest.raises(GridError):
            c.call("echo", 2, timeout=1.0)
        chaos_file.write_text('{"mode": "drop"}')
        _wait_chaos()
        t0 = time.monotonic()
        with pytest.raises(GridError):
            c.call("echo", 3, timeout=0.5)
        assert time.monotonic() - t0 >= 0.4   # timed out, not refused
        chaos_file.write_text('{"mode": "delay", "seconds": 0.15}')
        _wait_chaos()
        t0 = time.monotonic()
        assert c.call("echo", 4, timeout=5.0) == 4
        assert time.monotonic() - t0 >= 0.15
        chaos_file.write_text("{}")
        _wait_chaos()
        assert c.call("echo", 5) == 5
    finally:
        c.close()
        srv.stop()


def test_chaos_drive_delay_hangs_remote_rpc(chaos_file, tmp_path):
    root = str(tmp_path / "drv")
    local = LocalStorage(root)
    srv = GridServer(0, host="127.0.0.1")
    StorageRPCService({root: local}).register_into(srv)
    srv.start()
    rem = RemoteStorage("127.0.0.1", srv.port, root)
    try:
        rem.make_vol("v")
        chaos_file.write_text('{"drive_delay": 0.3}')
        _wait_chaos()
        t0 = time.monotonic()
        rem.write_all("v", "k", b"x")
        assert time.monotonic() - t0 >= 0.3
    finally:
        srv.stop()


def test_grid_breaker_opens_and_fails_fast():
    probe = GridServer(0, host="127.0.0.1")
    probe.start()
    port = probe.port
    probe.stop()
    time.sleep(0.05)
    c = GridClient("127.0.0.1", port, send_retries=2,
                   trip_after=3, cooldown=0.2, cooldown_max=1.0)
    t_call = time.time()
    with pytest.raises(GridError):
        c.call("echo", 1, timeout=1.0)      # 3 attempts = 3 faults
    assert c.breaker_state() == "open"
    t0 = time.monotonic()
    with pytest.raises(GridError) as ei:
        c.call("echo", 2, timeout=1.0)
    assert time.monotonic() - t0 < 0.05     # no connect attempt at all
    assert "circuit open" in str(ei.value)
    st = c.stats()
    assert st["state"] == "open" and st["rpc_errors"] >= 3
    assert st["breaker_opens"] == 1
    assert st["fast_fails"] == 1
    assert len(st["opened_at"]) == 1
    assert t_call <= st["opened_at"][0] <= time.time()
    srv = GridServer(port, host="127.0.0.1")
    srv.register("echo", lambda p: p)
    srv.start()
    try:
        deadline = time.monotonic() + 10
        while True:
            try:
                assert c.call("echo", 3, timeout=2.0) == 3
                break
            except GridError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert c.breaker_state() == "closed"
        assert c.stats()["reconnects"] >= 1
    finally:
        c.close()
        srv.stop()


def test_remote_handler_errors_never_trip_breaker():
    srv = GridServer(0, host="127.0.0.1")

    def boom(p):
        raise FileNotFoundErr("nope")
    srv.register("boom", boom)
    srv.start()
    c = GridClient("127.0.0.1", srv.port, trip_after=2)
    try:
        for _ in range(6):
            with pytest.raises(RemoteCallError):
                c.call("boom")
        assert c.breaker_state() == "closed"
    finally:
        c.close()
        srv.stop()

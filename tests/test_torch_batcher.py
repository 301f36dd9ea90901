"""The port's StripeBatcher against the TPU package's, scenario by scenario.

Both batchers get the same numpy device_fn/host_fn and the same
min_device_blocks; each scenario must give the same dispatched buckets,
the same member rows and the same routes in both. Coalescing is made
deterministic with a gated device function: the dispatcher's first
dispatch blocks in the kernel lane until the test has queued the other
members in a known order, then every later dispatch sees exactly them.
The scenarios are those of tests/test_stripe_batcher.py (coalescing, solo
bypass, host verdict, failure delivered to every waiter, oversized split,
solo device-sized dispatch) plus deadline culls, mixed member shapes,
a split_fn route and the per-route MTPU_BATCH_FORCE pins.
"""

import contextlib
import hashlib
import threading
import time

import numpy as np
import pytest

from minio_tpu.ops import batcher as ref_batcher
from minio_tpu.utils import deadline as ref_deadline

from minio_tpu_torch.ops import batcher as port_batcher
from minio_tpu_torch.utils import deadline as port_deadline

K, M, SHARD = 4, 2, 256
MODS = {"ref": (ref_batcher, ref_deadline), "port": (port_batcher,
                                                     port_deadline)}


def _window(b, seed, shard=SHARD):
    return np.random.default_rng(seed).integers(0, 256, size=(b, K, shard),
                                                dtype=np.uint8)


def _rows(stacked):
    """A framer-shaped result: per drive, (digest, block) per block; data
    blocks are views of the input, parity blocks fresh arrays."""
    b = stacked.shape[0]
    out = []
    for i in range(K + M):
        pieces = []
        for bi in range(b):
            blk = stacked[bi, i] if i < K \
                else stacked[bi, i - K] ^ np.uint8(0x5A + i)
            dig = np.frombuffer(hashlib.blake2b(
                blk.tobytes(), digest_size=32).digest(), dtype=np.uint8)
            pieces.append((dig, blk))
        out.append(pieces)
    return out


def _canon(rows):
    return [[(bytes(d), bytes(b)) for d, b in drive] for drive in rows]


class GatedDevice:
    """Device function that records each batch's shape; its first call
    blocks until release(), and with fail=True every call raises."""

    def __init__(self, fn=_rows, fail=False, gated=True):
        self.fn, self.fail = fn, fail
        self.shapes = []
        self.gate = threading.Event()
        if not gated:
            self.gate.set()

    def __call__(self, stacked):
        self.shapes.append(tuple(stacked.shape))
        self.gate.wait(30)
        if self.fail:
            raise RuntimeError("device fell over")
        return self.fn(stacked)

    def release(self):
        self.gate.set()


class Runner:
    """Members submitted from threads, in a fixed order."""

    def __init__(self, sb):
        self.sb = sb
        self.results, self.errors, self.routes, self.threads = {}, {}, {}, []

    def submit(self, name, window, dl_s=None, wait_pending=None,
               wait_dispatch=None, dlmod=None):
        def work():
            ctx = dlmod.bind(dlmod.Deadline(dl_s)) if dl_s is not None \
                else contextlib.nullcontext()
            with ctx:
                try:
                    self.results[name] = self.sb.frame(window)
                except Exception as e:  # noqa: BLE001 - compared below
                    self.errors[name] = type(e).__name__
                self.routes[name] = self.sb.last_route()
        t = threading.Thread(target=work)
        t.start()
        self.threads.append(t)
        deadline = time.monotonic() + 10
        while wait_pending is not None and \
                len(self.sb._pending) != wait_pending:
            assert time.monotonic() < deadline, "member never queued"
            time.sleep(0.002)
        while wait_dispatch is not None and \
                len(wait_dispatch.shapes) < 1:
            assert time.monotonic() < deadline, "dispatch never started"
            time.sleep(0.002)

    def join(self):
        for t in self.threads:
            t.join(30)
            assert not t.is_alive(), "a member hung"


def _stats(sb):
    st = sb.stats()
    return {k: st[k] for k in ("dispatches", "requests", "buckets",
                               "batched_blocks", "capacity_blocks",
                               "deadline_failures")}


def _busy(sb):
    """Pretend another request is in flight, so no member goes solo."""
    with sb._mu:
        sb._inflight += 1


def _gated_burst(mod, dlmod, members, device=None, settle=0.15, **kw):
    """First a 32-block member that the dispatcher sends at once (it fills
    the target) and that blocks in the lane; then `members` (name, window,
    deadline seconds or None) queued in order; then, `settle` seconds
    later, release. Returns (runner, device, batcher)."""
    dev = device or GatedDevice()
    sb = mod.StripeBatcher(dev, _rows, min_device_blocks=8,
                           max_wait_s=0.05, **kw)
    sb.force(True)
    _busy(sb)
    run = Runner(sb)
    run.submit("first", _window(32, 0, members[0][1].shape[2]
                                if members else SHARD),
               wait_dispatch=dev)
    for i, (name, win, dl_s) in enumerate(members):
        run.submit(name, win, dl_s=dl_s, dlmod=dlmod, wait_pending=i + 1)
    time.sleep(settle)      # past the window (and deadlines) of the queue
    dev.release()
    run.join()
    with sb._mu:
        sb._inflight -= 1
    return run, dev, sb


def scenario_coalesce(mod, dlmod):
    wins = [(f"m{i}", _window(4, i + 1), None) for i in range(6)]
    run, dev, sb = _gated_burst(mod, dlmod, wins)
    for name, win, _ in wins:
        assert _canon(run.results[name]) == _canon(_rows(win))
        for i in range(K):      # data rows re-pointed to the member's window
            assert all(np.shares_memory(blk, win)
                       for _, blk in run.results[name][i])
    return {"shapes": dev.shapes, "routes": run.routes, "stats": _stats(sb),
            "rows": {n: _canon(r) for n, r in run.results.items()}}


def scenario_mixed_shapes(mod, dlmod):
    wins = [("a1", _window(4, 11), None), ("b1", _window(4, 12, 128), None),
            ("a2", _window(4, 13), None), ("b2", _window(4, 14, 128), None)]
    run, dev, sb = _gated_burst(mod, dlmod, wins)
    for name, win, _ in wins:
        assert _canon(run.results[name]) == _canon(_rows(win))
    return {"shapes": dev.shapes, "routes": run.routes, "stats": _stats(sb),
            "rows": {n: _canon(r) for n, r in run.results.items()}}


def scenario_deadline_cull(mod, dlmod):
    wins = [("late", _window(4, 21), 1.0), ("ok", _window(8, 22), None)]
    run, dev, sb = _gated_burst(mod, dlmod, wins, settle=1.3)
    errors = dict(run.errors)
    with dlmod.bind(dlmod.Deadline(-1.0)):
        with pytest.raises(dlmod.DeadlineExceeded):
            sb.frame(_window(4, 23))
    assert _canon(run.results["ok"]) == _canon(_rows(wins[1][1]))
    return {"shapes": dev.shapes, "errors": errors, "stats": _stats(sb),
            "routes": {n: r for n, r in run.routes.items() if n != "late"}}


def scenario_oversized_burst(mod, dlmod):
    wins = [(f"m{i}", _window(32, 30 + i), None) for i in range(9)]
    run, dev, sb = _gated_burst(mod, dlmod, wins)
    for name, win, _ in wins:
        assert _canon(run.results[name]) == _canon(_rows(win))
    return {"shapes": dev.shapes, "routes": run.routes, "stats": _stats(sb)}


def scenario_failure_to_all(mod, dlmod):
    wins = [(f"m{i}", _window(4, 40 + i), None) for i in range(3)]
    run, dev, sb = _gated_burst(mod, dlmod, wins,
                                device=GatedDevice(fail=True))
    assert not run.results
    return {"shapes": dev.shapes, "errors": run.errors, "routes": run.routes,
            "stats": _stats(sb)}


def scenario_split_route(mod, dlmod):
    """A reconstruct-shaped route: split_fn slices each member's rows."""
    def rebuild(stacked):
        return np.ascontiguousarray(stacked[:, :2] ^ np.uint8(7))
    dev = GatedDevice(fn=rebuild)
    wins = [(f"m{i}", _window(4, 50 + i), None) for i in range(3)]
    run, dev, sb = _gated_burst(
        mod, dlmod, wins, device=dev, route="reconstruct",
        split_fn=lambda out, off, c, _m: out[off:off + c],
        concat_fn=lambda a, b: np.concatenate([a, b]))
    for name, win, _ in wins:
        assert np.array_equal(run.results[name], rebuild(win))
    return {"shapes": dev.shapes, "routes": run.routes, "stats": _stats(sb),
            "rows": {n: r.tobytes() for n, r in run.results.items()}}


def scenario_oversized_window(mod, dlmod):
    dev = GatedDevice(gated=False)
    sb = mod.StripeBatcher(dev, _rows, min_device_blocks=8)
    sb.force(True)
    win = _window(300, 60)
    rows = sb.frame(win)
    assert _canon(rows) == _canon(_rows(win))
    return {"shapes": dev.shapes, "route": sb.last_route(),
            "stats": _stats(sb)}


def scenario_solo_bypass(mod, dlmod):
    dev = GatedDevice(gated=False)
    sb = mod.StripeBatcher(dev, _rows, min_device_blocks=8)
    sb.force(True)
    win = _window(2, 61)
    t0 = time.perf_counter()
    rows = sb.frame(win)
    assert time.perf_counter() - t0 < 0.2
    assert _canon(rows) == _canon(_rows(win))
    return {"shapes": dev.shapes, "route": sb.last_route(),
            "stats": _stats(sb)}


def scenario_solo_device_sized(mod, dlmod):
    dev = GatedDevice(gated=False)
    sb = mod.StripeBatcher(dev, _rows, min_device_blocks=8)
    sb.force(True)
    win = _window(32, 62)
    rows = sb.frame(win)
    assert _canon(rows) == _canon(_rows(win))
    return {"shapes": dev.shapes, "route": sb.last_route(),
            "stats": _stats(sb)}


def scenario_host_verdict(mod, dlmod):
    dev = GatedDevice(gated=False)
    sb = mod.StripeBatcher(dev, _rows, min_device_blocks=8)
    sb.force(False)
    _busy(sb)
    win = _window(4, 63)
    rows = sb.frame(win)
    assert _canon(rows) == _canon(_rows(win))
    return {"shapes": dev.shapes, "route": sb.last_route(),
            "stats": _stats(sb)}


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_coalesce, scenario_mixed_shapes, scenario_deadline_cull,
    scenario_oversized_burst, scenario_failure_to_all, scenario_split_route,
    scenario_oversized_window, scenario_solo_bypass,
    scenario_solo_device_sized, scenario_host_verdict)}

EXPECT = {
    "coalesce": {"shapes": [(32, K, SHARD), (32, K, SHARD)]},
    "mixed_shapes": {"shapes": [(32, K, SHARD), (8, K, SHARD),
                                (8, K, 128)]},
    "deadline_cull": {"shapes": [(32, K, SHARD), (8, K, SHARD)],
                      "errors": {"late": "DeadlineExceeded"}},
    "oversized_burst": {"shapes": [(32, K, SHARD), (256, K, SHARD),
                                   (32, K, SHARD)]},
    "failure_to_all": {"shapes": [(32, K, SHARD), (16, K, SHARD)]},
    "split_route": {"shapes": [(32, K, SHARD), (16, K, SHARD)]},
    "oversized_window": {"shapes": [(256, K, SHARD), (64, K, SHARD)],
                         "route": "device"},
    "solo_bypass": {"shapes": [], "route": "bypass"},
    "solo_device_sized": {"shapes": [(32, K, SHARD)], "route": "device"},
    "host_verdict": {"shapes": [], "route": "bypass"},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name, monkeypatch):
    monkeypatch.delenv("MTPU_BATCH_FORCE", raising=False)
    out = {tag: SCENARIOS[name](mod, dlmod)
           for tag, (mod, dlmod) in MODS.items()}
    assert out["port"] == out["ref"]
    for key, want in EXPECT[name].items():
        assert out["port"][key] == want, key
    if name == "failure_to_all":
        assert out["port"]["errors"] == dict.fromkeys(
            ("first", "m0", "m1", "m2"), "RuntimeError")
    if name == "deadline_cull":
        assert out["port"]["stats"]["deadline_failures"] == 2


@pytest.mark.parametrize("env,want", [
    ("put=host,get=device", {"put": "host", "get": "device"}),
    ("get=host,reconstruct=device", {"get": "host",
                                     "reconstruct": "device"}),
    ("host", {"put": "host", "get": "host", "reconstruct": "host"}),
    ("device", {"put": "device", "get": "device", "reconstruct": "device"}),
    ("auto", {"put": "auto", "get": "auto", "reconstruct": "auto"}),
])
def test_per_route_force_pins(monkeypatch, env, want):
    """Named pins agree with the reference; a route the list leaves out
    keeps each package's default: auto in the TPU package, device in the
    port (no probe unless asked)."""
    monkeypatch.setenv("MTPU_BATCH_FORCE", env)
    for route in ("put", "get", "reconstruct"):
        ref, port = (ref_batcher.batch_force_mode(route),
                     port_batcher.batch_force_mode(route))
        if route in want:
            assert port == ref == want[route]
        else:
            assert (ref, port) == ("auto", "device")
        verdict = {"device": True, "host": False}
        sb = port_batcher.StripeBatcher(_rows, _rows, route=route)
        assert sb._device_ok is verdict.get(port)


@pytest.mark.parametrize("verdict,busy,blocks", [
    (True, False, 2), (True, False, 8), (True, True, 2), (False, True, 8)])
def test_worth_batching_matches_reference(verdict, busy, blocks):
    got = []
    for mod, _ in MODS.values():
        sb = mod.StripeBatcher(_rows, _rows, min_device_blocks=8)
        sb.force(verdict)
        if busy:
            _busy(sb)
        got.append(sb.worth_batching(blocks))
    assert got[0] == got[1] == (verdict and (busy or blocks >= 8))


def test_default_is_device_without_probe(monkeypatch):
    monkeypatch.delenv("MTPU_BATCH_FORCE", raising=False)
    sb = port_batcher.StripeBatcher(
        _rows, _rows, probe_fn=lambda: pytest.fail("probe ran"))
    assert sb._device_ok is True and sb._probe_started
    assert port_batcher.aggregate_stats()["forced"]["put"] == "device"


def test_auto_probe_device_error_propagates(monkeypatch):
    """Under auto the JAX probe turns a device exception into a host
    verdict; the port's keeps it and raises it to later callers."""
    monkeypatch.setenv("MTPU_BATCH_FORCE", "auto")

    def boom(stacked):
        raise RuntimeError("no card")
    sb = port_batcher.StripeBatcher(boom, _rows, min_device_blocks=1)
    sb.frame(_window(1, 70))          # unprobed: served by the host rival
    sb._probe_thread.join(10)
    assert sb._device_ok is None
    with pytest.raises(RuntimeError, match="calibration probe") as e:
        sb.frame(_window(1, 71))
    assert "no card" in str(e.value.__cause__)
    sb.close()


def test_close_drains_and_joins():
    dev = GatedDevice(gated=False)
    sb = port_batcher.StripeBatcher(dev, _rows, min_device_blocks=1,
                                    max_wait_s=5.0)
    sb.force(True)
    _busy(sb)
    run = Runner(sb)
    run.submit("m", _window(2, 80), wait_pending=1)
    sb.close()                 # dispatches the pending member at once
    run.join()
    assert sb._dispatcher is None or not sb._dispatcher.is_alive()
    assert _canon(run.results["m"]) == _canon(_rows(_window(2, 80)))
    st = sb.stats()
    assert st["dispatches"]["device"] == 1 and st["max_members"] == 1


def test_lane_wait_and_service_kept_apart():
    """A dispatch queued behind another on the kernel lane: its wait is
    the other's service, its own service is its device function, and the
    round trip covers both."""
    from minio_tpu_torch.io.engine import kernel_lane
    gate = threading.Event()
    blocker = kernel_lane().submit(lambda: gate.wait(30))

    def slow(stacked):
        time.sleep(0.03)
        return _rows(stacked)
    sb = port_batcher.StripeBatcher(slow, _rows, min_device_blocks=8)
    sb.force(True)
    run = Runner(sb)
    run.submit("m", _window(8, 90))
    time.sleep(0.1)
    gate.set()
    run.join()
    blocker.result(10)
    assert blocker.wait_s >= 0 and blocker.service_s >= 0.09
    assert _canon(run.results["m"]) == _canon(_rows(_window(8, 90)))
    st = sb.stats()
    wait, service, rt = (st[k] for k in (
        "lane_wait_hist", "lane_service_hist", "lane_round_trip_hist"))
    assert wait["count"] == service["count"] == rt["count"] == 1
    assert wait["sum"] >= 0.05
    assert 0.03 <= service["sum"] < wait["sum"]
    assert rt["sum"] >= wait["sum"] + service["sum"] - 1e-6
    merged = port_batcher.merge_route_stats([st])["put"]
    assert merged["lane_wait_hist"] == wait


def test_staging_fault_fails_the_dispatch():
    """A pool that cannot allocate fails the members' dispatch: the batch
    is never staged into unpooled pageable memory behind the caller's
    back."""
    class BrokenPool:
        def lease(self, size):
            raise RuntimeError("cudaHostAlloc failed")
    dev = GatedDevice(gated=False)
    sb = port_batcher.StripeBatcher(dev, _rows, min_device_blocks=8,
                                    pool=BrokenPool())
    sb.force(True)
    with pytest.raises(RuntimeError, match="cudaHostAlloc"):
        sb.frame(_window(9, 91))          # a 16-block bucket: staged
    assert dev.shapes == []
    assert sb.stats()["dispatches"]["device"] == 0

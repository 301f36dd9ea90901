"""The port's request span trees (minio_tpu_torch/utils/tracing.py and
its call sites) held against the JAX package's on the same inputs.

* The linkage of a PUT's and a GET's span tree on a set of 4 health-
  wrapped drives, as the set of (type, name, parent name): equal between
  the JAX `ErasureSet` and the port's (`device="cpu"`) once the
  documented differences of the two data planes are mapped (below).
* The slow-op log: the record of a slow drive names its ancestry.
* The disarmed path builds no span, context or trace field.
* The grid: an armed call's frames encode to the JAX frames' bytes; a
  peer's subtree is stitched under a `wire` span on both packages alike
  (unary, stream, a remote error); a disarmed call carries no trace
  bytes; a call cut by a dead peer is annotated as a fault.
* The kernel span: one `batcher.dispatch` a batched launch, fanned into
  each member's tree with its route, and no `lane_ms` on the CPU.

Tolerance: none; trees, records and bytes compare exactly.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

import minio_tpu.native as ref_native
from minio_tpu.grid import wire as ref_wire
from minio_tpu.grid.client import GridClient as RefClient
from minio_tpu.grid.server import GridServer as RefGridServer
from minio_tpu.object.erasure_object import ErasureSet as RefSet
from minio_tpu.storage.health import wrap_disks as ref_wrap
from minio_tpu.storage.local import LocalStorage as RefLocal
from minio_tpu.utils import tracing as ref_tracing

from minio_tpu_torch.grid import wire as port_wire
from minio_tpu_torch.grid.client import GridClient as PortClient
from minio_tpu_torch.grid.server import GridServer as PortGridServer
from minio_tpu_torch.object.erasure_object import ErasureSet as PortSet
from minio_tpu_torch.storage.health import wrap_disks as port_wrap
from minio_tpu_torch.storage.local import LocalStorage as PortLocal
from minio_tpu_torch.utils import tracing as port_tracing

BKT = "trc"
RNG = np.random.default_rng(19)
# One whole 1 MiB block: no ragged tail, so every launch of the port's
# PUT and GET is batched.
BODY = RNG.bytes(1 << 20)

PKG = {
    "jax": dict(tracing=ref_tracing, wire=ref_wire, client=RefClient,
                server=RefGridServer, local=RefLocal, wrap=ref_wrap,
                mkset=lambda disks: RefSet(disks)),
    "port": dict(tracing=port_tracing, wire=port_wire, client=PortClient,
                 server=PortGridServer, local=PortLocal, wrap=port_wrap,
                 mkset=lambda disks: PortSet(disks, device="cpu")),
}

# The two data planes differ in names, never in shape:
# * the JAX package runs its whole blocks through native host kernels
#   (`mtpu_put_frame`, `mtpu_get_frame`); the port through the stripe
#   batcher (`batcher.dispatch`), each one kernel span under the root;
# * the port reads shard windows into pooled buffers (`read_file_into`
#   where the JAX package calls `read_file`);
# * the port keeps the journal a commit replaces until write quorum is
#   known and then settles it (`settle_prev`), and clears the commit's
#   staging directory with its own call (`delete`).
KERNEL_NAMES = {"mtpu_put_frame": "batcher.dispatch",
                "mtpu_get_frame": "batcher.dispatch"}
PORT_NAMES = {"disk.read_file_into": "disk.read_file"}
PORT_ONLY = {"disk.settle_prev", "disk.delete"}


class _Armed:
    """Arm one package's span collection and bind a fresh context."""

    def __init__(self, tracing):
        self.tracing = tracing

    def __enter__(self):
        self.tok = object()
        self.tracing.arm(self.tok)
        self.ctx = self.tracing.TraceContext()
        self.bind = self.tracing.bind(self.ctx, 0)
        self.bind.__enter__()
        return self.ctx

    def __exit__(self, *exc):
        self.bind.__exit__(*exc)
        self.tracing.disarm(self.tok)


def _linkage(ctx, names=None) -> set:
    names = names or {}
    by_id = {s["span"]: s for s in ctx.spans}
    out = set()
    for s in ctx.spans:
        p = by_id.get(s["parent"])
        name = names.get(s["name"], s["name"])
        pname = names.get(p["name"], p["name"]) if p else "<root>"
        out.add((s["type"], name, pname))
    return out


def _by_name(ctx, name):
    return [s for s in ctx.spans if s["name"] == name]


# -- the erasure set's trees ---------------------------------------------------

@pytest.fixture
def both_sets(tmp_path, monkeypatch):
    # The JAX native host library would skip its own batched kernels'
    # spans only by name: keep it, and map the names (KERNEL_NAMES).
    sets = {}
    for pkg in PKG:
        disks = [PKG[pkg]["local"](str(tmp_path / pkg / f"d{i}"))
                 for i in range(4)]
        es = PKG[pkg]["mkset"](PKG[pkg]["wrap"](disks))
        es.make_bucket(BKT)
        sets[pkg] = es
    yield sets
    for es in sets.values():
        es.close()


def _tree(pkg, fn):
    with _Armed(PKG[pkg]["tracing"]) as ctx:
        fn()
    return ctx


def test_span_tree_linkage_put_get(both_sets):
    """The set of (type, name, parent name) of a PUT's and a GET's tree,
    equal between the packages under the documented name mapping."""
    if ref_native.load() is None:
        pytest.skip("the JAX native host library is not built here")
    trees = {}
    for pkg, es in both_sets.items():
        put = _tree(pkg, lambda: es.put_object(BKT, "k", BODY))
        get = _tree(pkg, lambda: es.get_object(BKT, "k"))
        trees[pkg] = (put, get)
    for i, what in enumerate(("put", "get")):
        ref = _linkage(trees["jax"][i], KERNEL_NAMES)
        port = {link for link in _linkage(trees["port"][i], PORT_NAMES)
                if link[1] not in PORT_ONLY}
        assert port == ref, (what, port ^ ref)
        # Every span hangs under the root or a span of its own tree.
        ctx = trees["port"][i]
        ids = {s["span"] for s in ctx.spans}
        assert all(s["parent"] in ids or s["parent"] == 0
                   for s in ctx.spans)
        kern = _by_name(ctx, "batcher.dispatch")
        assert kern and all(s["parent"] == 0 for s in kern)
        assert {s["tags"]["op"] for s in kern} == {what}
        # The CPU has no lane stream to time; the lane's service is
        # on the host clock, inside the span.
        assert all("lane_ms" not in s["tags"] for s in kern)
        assert all(0 <= s["tags"]["service_ms"] <= s["duration_ms"]
                   for s in kern if s["tags"]["route"] == "device")


def test_degraded_get_kernel_span_names_the_decode(both_sets):
    """A GET with the drive of data shard 1 gone rebuilds through the
    reconstruct batcher: its kernel span's tags say so."""
    from minio_tpu_torch.object.erasure_object import hash_order
    es = both_sets["port"]
    es._mrf_closed = True           # no background heal refills a drive
    es.put_object(BKT, "deg", BODY)
    first = hash_order(f"{BKT}/deg", len(es.disks)).index(1)
    vol = os.path.join(es.disks[first]._disk.root, BKT)
    os.rename(vol, vol + ".gone")
    try:
        es.fi_cache.invalidate_all()
        ctx = _tree("port", lambda: es.get_object(BKT, "deg"))
    finally:
        os.rename(vol + ".gone", vol)
    ops = {s["tags"]["op"] for s in _by_name(ctx, "batcher.dispatch")}
    assert ops == {"reconstruct"}, ops
    # The survivors' verify outside the get batcher is a kernel span of
    # its own.
    assert _by_name(ctx, "device.verify")


@pytest.mark.parametrize("pkg", list(PKG))
def test_slow_op_record_names_the_slow_drive(tmp_path, pkg):
    """A drive whose rename_data sleeps past MTPU_SLOW_OP_MS: its slow
    record is the `disk.rename_data` span of that drive, with the same
    ancestry on both packages."""
    tracing = PKG[pkg]["tracing"]
    disks = [PKG[pkg]["local"](str(tmp_path / f"d{i}")) for i in range(4)]
    slow = disks[2]
    real = slow.rename_data

    def sleepy(*a, **kw):
        time.sleep(0.12)
        return real(*a, **kw)
    slow.rename_data = sleepy
    es = PKG[pkg]["mkset"](PKG[pkg]["wrap"](disks))
    try:
        es.make_bucket(BKT)
        tracing.set_slow_ms(60)
        try:
            with _Armed(tracing) as ctx:
                es.put_object(BKT, "slow", RNG.bytes(600_000))
            recs = [r for r in tracing.slow_ops()
                    if r.get("trace") == ctx.trace_id]
        finally:
            tracing.set_slow_ms(0)
    finally:
        es.close()
    disk_recs = [r for r in recs if r["name"] == "disk.rename_data"]
    assert len(disk_recs) == 1, recs
    rec = disk_recs[0]
    assert rec["ancestry"] == ["<root>", "engine.op"]
    assert rec["tags"]["drive"] == str(tmp_path / "d2")
    assert rec["slow"] is True and rec["duration_ms"] >= 60
    # The drive's engine.op, which contains it, is slow too.
    assert {r["name"] for r in recs} >= {"disk.rename_data", "engine.op"}


def test_disarmed_put_get_build_no_span(tmp_path, monkeypatch):
    """Disarmed, a PUT and a GET through the port's server build no
    context, span, record, trace field or timing event (the body holds
    a whole block, so both go through the batcher): each of those
    raises here."""
    from minio_tpu_torch import device as device_mod
    from minio_tpu_torch import server
    from minio_tpu_torch.s3 import server as s3server
    from tests.s3client import S3Client

    def boom(*a, **kw):
        raise AssertionError("the disarmed path touched span machinery")
    assert not port_tracing.ACTIVE
    srv = server.boot(["--device", "cpu", "--address", "127.0.0.1:0",
                       "--scanner-interval", "0",
                       *[str(tmp_path / f"d{i}") for i in range(4)]])
    srv.objects.sets[0]._mrf_closed = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        for name in ("TraceContext", "_Span", "_OpSpan", "record_span",
                     "capture", "export_spans", "entries_from"):
            monkeypatch.setattr(port_tracing, name, boom)
        monkeypatch.setattr(s3server, "make_entry", boom)
        monkeypatch.setattr(device_mod, "lane_timed", boom)
        cli = S3Client(srv.address)
        body = RNG.bytes((1 << 20) + 4096)
        assert cli.request("PUT", "/quiet")[0] == 200
        assert cli.request("PUT", "/quiet/k", body=body)[0] == 200
        st, _, got = cli.request("GET", "/quiet/k")
        assert st == 200 and got == body
    finally:
        srv.shutdown()
        t.join(timeout=30)


def test_lane_members_share_one_kernel_span(tmp_path):
    """Concurrent PUTs coalesced into one batcher dispatch: the ONE
    kernel span is fanned into each member's own tree, with the batch's
    member count."""
    es = PortSet([PortLocal(str(tmp_path / f"d{i}")) for i in range(4)],
                 device="cpu")
    try:
        es.make_bucket(BKT)
        ctxs = [port_tracing.TraceContext() for _ in range(3)]
        gate = threading.Barrier(3)
        tok = object()
        port_tracing.arm(tok)
        try:
            def put(i):
                gate.wait()
                with port_tracing.bind(ctxs[i], 0):
                    es.put_object(BKT, f"m{i}", BODY)
            ts = [threading.Thread(target=put, args=(i,)) for i in range(3)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(120)
        finally:
            port_tracing.disarm(tok)
        for ctx in ctxs:
            kern = _by_name(ctx, "batcher.dispatch")
            assert len(kern) == 1 and kern[0]["parent"] == 0, ctx.spans
            tags = kern[0]["tags"]
            assert tags["op"] == "put" and tags["blocks"] == 1
            assert 1 <= tags["members"] <= 3
            assert tags["batch_blocks"] == tags["members"]
    finally:
        es.close()


# -- the grid ------------------------------------------------------------------

def _handlers(tracing, hold):
    def spanny(p):
        with tracing.span("storage", "disk.read_file", {"vol": "v"}) \
                if tracing.ACTIVE else tracing.NOOP:
            time.sleep(0.002)
        return "ok"

    def boom(p):
        with tracing.span("storage", "disk.delete_file", {}) \
                if tracing.ACTIVE else tracing.NOOP:
            pass
        raise ValueError("nope")

    def slow(p):
        hold.wait(timeout=10)
        return "done"

    def walk(p):
        for i in range(3):
            with tracing.span("storage", "disk.walk", {"page": i}) \
                    if tracing.ACTIVE else tracing.NOOP:
                pass
            yield i
    return {"spanny": spanny, "boom": boom, "slow": slow,
            "echo": lambda p: p}, {"walk": walk}


@pytest.fixture(params=list(PKG))
def grid_pair(request):
    """A real GridServer and GridClient of one package, on loopback."""
    pkg = PKG[request.param]
    srv = pkg["server"](0, host="127.0.0.1")
    hold = threading.Event()
    unary, streams = _handlers(pkg["tracing"], hold)
    for name, fn in unary.items():
        srv.register(name, fn)
    for name, fn in streams.items():
        srv.register_stream(name, fn)
    srv.start()
    cli = pkg["client"]("127.0.0.1", srv.port, connect_timeout=2.0)
    yield request.param, srv, cli, hold
    hold.set()
    try:
        srv.stop()
    except Exception:  # noqa: BLE001 - some cases stop it themselves
        pass


def _shape(ctx) -> list:
    """A tree's linkage by names, in span order: (name, parent name)."""
    by_id = {s["span"]: s["name"] for s in ctx.spans}
    return sorted((s["name"], by_id.get(s["parent"], "<root>"))
                  for s in ctx.spans)


_SHAPES = {
    "spanny": [("disk.read_file", "wire"), ("grid.spanny", "<root>"),
               ("wire", "grid.spanny")],
    "walk": [("disk.walk", "wire")] * 3 + [("grid.walk", "<root>"),
                                          ("wire", "grid.walk")],
    "boom": [("disk.delete_file", "wire"), ("grid.boom", "<root>"),
             ("wire", "grid.boom")],
}


def test_armed_unary_stitches_remote_subtree(grid_pair):
    pkg, _, cli, _ = grid_pair
    with _Armed(PKG[pkg]["tracing"]) as ctx:
        assert cli.call("spanny", {"x": 1}, timeout=5.0) == "ok"
    assert _shape(ctx) == _SHAPES["spanny"]
    ids = [s["span"] for s in ctx.spans]
    assert len(set(ids)) == len(ids)
    tags = _by_name(ctx, "wire")[0]["tags"]
    assert set(tags) == {"peer", "serialize_ms", "peer_queue_ms",
                         "peer_service_ms", "transit_ms"}
    assert tags["peer_service_ms"] >= 2.0   # the handler slept 2 ms


def test_armed_stream_stitches_remote_subtree(grid_pair):
    pkg, _, cli, _ = grid_pair
    with _Armed(PKG[pkg]["tracing"]) as ctx:
        assert list(cli.stream("walk", {}, timeout=5.0)) == [0, 1, 2]
    assert _shape(ctx) == _SHAPES["walk"]
    assert _by_name(ctx, "grid.walk")[0]["tags"]["chunks"] == 3
    assert "peer_service_ms" in _by_name(ctx, "wire")[0]["tags"]


def test_remote_error_still_ships_its_subtree(grid_pair):
    """A handler that raised still answered: its spans come back on the
    error frame, and the wire span has no fault."""
    pkg, _, cli, _ = grid_pair
    with _Armed(PKG[pkg]["tracing"]) as ctx:
        with pytest.raises(Exception) as info:
            cli.call("boom", {}, timeout=5.0)
    assert type(info.value).__name__ == "RemoteCallError"
    assert _shape(ctx) == _SHAPES["boom"]
    assert "fault" not in _by_name(ctx, "wire")[0]["tags"]


def test_disarmed_grid_call_carries_zero_trace_bytes(grid_pair,
                                                      monkeypatch):
    pkg, _, cli, _ = grid_pair
    wire = PKG[pkg]["wire"]
    assert not PKG[pkg]["tracing"].ACTIVE
    frames = []
    real_pack = wire.pack_frame

    def spy(msg):
        frames.append(dict(msg))
        return real_pack(msg)
    monkeypatch.setattr(wire, "pack_frame", spy)
    assert cli.call("echo", {"a": 1}, timeout=5.0) == {"a": 1}
    assert list(cli.stream("walk", {}, timeout=5.0)) == [0, 1, 2]
    reqs = [f for f in frames if f["t"] in (wire.T_REQ, wire.T_SREQ)]
    resps = [f for f in frames if f["t"] in (wire.T_RESP, wire.T_ERR,
                                             wire.T_EOF)]
    assert reqs and resps
    assert all("tc" not in f and "_rx" not in f for f in reqs), reqs
    assert all("ts" not in f for f in resps), resps


def test_peer_killed_mid_armed_call_annotates_a_fault(grid_pair):
    """A peer that dies during an armed call: the wire span carries the
    fault and nothing is stitched; the next call fails fast with the
    same annotation; no arm token is left behind."""
    pkg, srv, cli, hold = grid_pair
    tracing = PKG[pkg]["tracing"]
    with _Armed(tracing) as ctx:
        killer = threading.Timer(0.3, srv.stop)
        killer.start()
        with pytest.raises(Exception):
            cli.call("slow", {}, timeout=5.0)
        killer.join()
        hold.set()
        wires = _by_name(ctx, "wire")
        assert len(wires) == 1
        assert wires[0]["tags"]["fault"] in ("conn_lost", "GridError",
                                             "DeadlineExceeded")
        assert {s["name"] for s in ctx.spans} == {"grid.slow", "wire"}
        before = len(ctx.spans)
        with pytest.raises(Exception) as info:
            cli.call("echo", {}, timeout=1.0)
        assert "GridError" in [c.__name__ for c in type(info.value).__mro__]
        wires = _by_name(ctx, "wire")
        assert len(wires) == 2 and "fault" in wires[1]["tags"]
        assert len(ctx.spans) == before + 2
    assert not tracing.ACTIVE
    with tracing._arm_mu:
        assert not tracing._arm_sources


def test_armed_frames_encode_to_the_jax_bytes():
    """The trace fields on the wire: a traced request, a reply carrying
    a shipped subtree, an error and a stream's end, each packed by both
    packages to the same bytes."""
    tc = {"i": "0123456789abcdef", "s": 7, "a": 1, "n": "node-a:9000"}
    spans = [{"type": "storage", "name": "disk.read_file", "span": 1,
              "parent": 0, "start": 1760832000.123456,
              "duration_ms": 2.345, "tags": {"drive": "/d/1", "n": 3}},
             {"type": "storage", "name": "disk.walk", "span": 2,
              "parent": 1, "start": 1760832000.5, "duration_ms": 0.0,
              "error": "ValueError", "slow": True, "threshold_ms": 1.5}]
    ts = {"spans": spans, "dropped": 2, "q": 0.125, "v": 4.5,
          "node": "node-b:9000"}
    frames = [
        {"t": port_wire.T_REQ, "m": 1, "h": "st.read_version",
         "p": {"d": "/d/1", "a": ["b", "k"]}, "tc": tc},
        {"t": port_wire.T_SREQ, "m": 2, "h": "st.walk_scan", "p": {},
         "w": 16, "tc": tc},
        {"t": port_wire.T_RESP, "m": 1, "p": {"ok": True}, "ts": ts},
        {"t": port_wire.T_ERR, "m": 3, "e": "FileNotFound",
         "msg": "no such key", "ts": ts},
        {"t": port_wire.T_EOF, "m": 2, "ts": ts},
    ]
    for msg in frames:
        assert port_wire.pack_frame(msg) == ref_wire.pack_frame(msg), msg
    assert port_wire.T_REQ == ref_wire.T_REQ
    assert port_wire.T_EOF == ref_wire.T_EOF

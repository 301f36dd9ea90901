"""The port's drive health wrapper (storage/health.py) with its own
NaughtyDisk (storage/naughty.py): the eight cases of the JAX package's
tests/test_health_naughty.py, and two of the port's own.

The breaker trips on faults of the drive only (I/O errors, op
timeouts), never on domain answers (missing files or volumes: the drive
working correctly), never on the request's own deadline running out,
and readmits a recovered drive through the half-open probe after its
cooldown. The port's own: a read_file_into that outlives its deadline
keeps the pooled region it fills out of the pool until it ends;
create_file's deadline runs only while the drive holds a chunk, so a
streamed PUT whose body arrives slower than the deadline still lands
on every drive; and more concurrent calls than the pool's 8 workers all
run at once (a streamed PUT holds a create_file a drive for its whole
body).
"""

import threading
import time

import numpy as np
import pytest

from minio_tpu_torch.storage.health import DiskHealthWrapper, wrap_disks
from minio_tpu_torch.storage.local import (FaultyDisk, LocalStorage,
                                           OfflineDisk, VolumeNotFound)
from minio_tpu_torch.storage.meta import FileNotFoundErr
from minio_tpu_torch.storage.naughty import NaughtyDisk
from minio_tpu_torch.utils import deadline as deadline_mod

MIB = 1 << 20


def _wrapped(tmp_path, naughty_kwargs=None, **health_kwargs):
    disk = LocalStorage(str(tmp_path / "d"))
    naughty = NaughtyDisk(disk, **(naughty_kwargs or {}))
    kwargs = dict(op_timeout=0.3, trip_after=3, cooldown=60.0)
    kwargs.update(health_kwargs)
    return naughty, DiskHealthWrapper(naughty, **kwargs)


def test_infra_errors_trip_breaker_and_fail_fast(tmp_path):
    naughty, hd = _wrapped(tmp_path,
                           {"default_err": OSError("injected io")})
    for _ in range(3):
        with pytest.raises(OSError):
            hd.list_vols()
    assert not hd.is_online()
    # Breaker open: calls fail fast WITHOUT reaching the drive.
    before = naughty.call_count
    t0 = time.monotonic()
    with pytest.raises(FaultyDisk):
        hd.list_vols()
    assert time.monotonic() - t0 < 0.1
    assert naughty.call_count == before


def test_domain_errors_are_never_fuel(tmp_path):
    """Missing files/volumes are the storage layer working CORRECTLY;
    even trip_after consecutive ones leave the breaker closed."""
    naughty, hd = _wrapped(
        tmp_path,
        {"fail_ops": {"read_version": FileNotFoundErr("gone"),
                      "stat_vol": VolumeNotFound("nope")}},
        trip_after=2)
    for _ in range(5):
        with pytest.raises(FileNotFoundErr):
            hd.read_version("b", "o")
        with pytest.raises(VolumeNotFound):
            hd.stat_vol("b")
    assert hd.is_online()
    assert hd._consecutive == 0


def test_domain_error_resets_consecutive_infra_count(tmp_path):
    """fault, domain-answer, fault must NOT trip a trip_after=2
    breaker: the domain answer proves the drive is alive in between."""
    naughty, hd = _wrapped(tmp_path, trip_after=2)
    naughty.fail_ops["list_vols"] = OSError("io")
    with pytest.raises(OSError):
        hd.list_vols()
    with pytest.raises(VolumeNotFound):
        hd.stat_vol("missing-vol")       # real answer from the drive
    with pytest.raises(OSError):
        hd.list_vols()
    assert hd.is_online()


def test_half_open_probe_readmits_after_cooldown(tmp_path):
    naughty, hd = _wrapped(tmp_path,
                           {"default_err": OSError("injected io")},
                           trip_after=2, cooldown=0.1)
    for _ in range(2):
        with pytest.raises(OSError):
            hd.list_vols()
    assert not hd.is_online()
    # Drive recovers; before cooldown the breaker still fails fast.
    naughty.default_err = None
    with pytest.raises(FaultyDisk):
        hd.list_vols()
    time.sleep(0.15)
    # Half-open probe passes through and closes the breaker.
    assert hd.list_vols() == []
    assert hd.is_online()
    assert hd.list_vols() == []


def test_failed_probe_restarts_cooldown(tmp_path):
    naughty, hd = _wrapped(tmp_path,
                           {"default_err": OSError("injected io")},
                           trip_after=2, cooldown=0.15)
    for _ in range(2):
        with pytest.raises(OSError):
            hd.list_vols()
    time.sleep(0.2)
    with pytest.raises(OSError):     # the probe itself fails
        hd.list_vols()
    # Immediately after the failed probe: open again, fail fast.
    with pytest.raises(FaultyDisk):
        hd.list_vols()
    # After another full cooldown a fresh probe succeeds.
    naughty.default_err = None
    time.sleep(0.2)
    assert hd.list_vols() == []
    assert hd.is_online()


def test_deadline_cut_probe_does_not_wedge_half_open():
    """A half-open probe cut short by the REQUEST deadline proves
    nothing: the probe slot must be released so a later (budgeted)
    caller can still re-admit the recovered drive. Also: an already-
    expired budget must fail BEFORE consuming the probe slot."""
    class Flaky:
        endpoint = "flaky"
        mode = "fail"

        def list_vols(self):
            if self.mode == "fail":
                raise OSError("io")
            if self.mode == "slow":
                time.sleep(0.3)
            return []

    disk = Flaky()
    hd = DiskHealthWrapper(disk, op_timeout=5.0, trip_after=2,
                           cooldown=0.1)
    for _ in range(2):
        with pytest.raises(OSError):
            hd.list_vols()
    assert not hd.is_online()
    disk.mode = "slow"               # recovered, but not instant
    time.sleep(0.15)
    # Expired budget: rejected before the probe slot is consumed.
    with deadline_mod.bind(deadline_mod.Deadline(0.0)):
        with pytest.raises(deadline_mod.DeadlineExceeded):
            hd.list_vols()
    # Probe cut mid-op by a short budget: aborted, inconclusive.
    with deadline_mod.bind(deadline_mod.Deadline(0.05)):
        with pytest.raises(deadline_mod.DeadlineExceeded):
            hd.list_vols()
    assert not hd.is_online()        # still open, but not wedged:
    disk.mode = "ok"
    assert hd.list_vols() == []      # a healthy caller's probe closes it
    assert hd.is_online()


def test_clamped_expiry_streak_still_trips_dead_drive(monkeypatch):
    """A request budget permanently shorter than the op timeout must
    not starve the breaker: repeated GENEROUS-window clamped expiries
    (the suspicion window, 1 s, cut to 0.2 s here) on the same drive are
    evidence enough to trip, while tiny-window expiries never count."""
    monkeypatch.setattr(DiskHealthWrapper, "_SUSPICION_WINDOW", 0.2)

    class Dead:
        endpoint = "dead"

        def list_vols(self):
            time.sleep(30)

    hd = DiskHealthWrapper(Dead(), op_timeout=10.0, trip_after=2,
                           cooldown=300.0)
    # Tiny windows prove nothing, however many.
    for _ in range(4):
        with deadline_mod.bind(deadline_mod.Deadline(0.05)):
            with pytest.raises(deadline_mod.DeadlineExceeded):
                hd.list_vols()
    assert hd.is_online()
    # Windows of silence past the suspicion window, trip_after in a
    # row: trip.
    for _ in range(2):
        with deadline_mod.bind(deadline_mod.Deadline(0.25)):
            with pytest.raises(deadline_mod.DeadlineExceeded):
                hd.list_vols()
    assert not hd.is_online()
    # And the open breaker now fails fast, budget or no budget.
    t0 = time.monotonic()
    with pytest.raises(FaultyDisk):
        hd.list_vols()
    assert time.monotonic() - t0 < 0.5


def test_request_deadline_exhaustion_is_not_fuel(tmp_path):
    """An op cut short by the REQUEST's deadline budget (clamped below
    the drive's own op timeout) raises DeadlineExceeded and never
    counts against the drive."""
    class Slow:
        endpoint = "slow"

        def list_vols(self):
            time.sleep(0.3)
            return []

    hd = DiskHealthWrapper(Slow(), op_timeout=5.0, trip_after=1,
                           cooldown=60.0)
    with deadline_mod.bind(deadline_mod.Deadline(0.05)):
        with pytest.raises(deadline_mod.DeadlineExceeded):
            hd.list_vols()
    assert hd.is_online()            # trip_after=1, yet still closed
    with deadline_mod.bind(deadline_mod.Deadline(0.0)):
        with pytest.raises(deadline_mod.DeadlineExceeded):
            hd.list_vols()
    assert hd.is_online()
    # Without a deadline the same op completes and records success.
    assert hd.list_vols() == []
    assert hd.health_info()["ops"]["list_vols"]["count"] >= 1


class _HangingReads:
    """A drive whose read_file_into waits for `gate` while `hang` is set."""

    def __init__(self, disk):
        self._disk = disk
        self.hang = False
        self.gate = threading.Event()

    @property
    def endpoint(self):
        return self._disk.endpoint

    @property
    def root(self):
        return self._disk.root

    def read_file_into(self, *a):
        if self.hang:
            self.gate.wait(10)
        return self._disk.read_file_into(*a)

    def __getattr__(self, name):
        return getattr(self._disk, name)


def _set(tmp_path, disks, **health_kwargs):
    from minio_tpu_torch.object.erasure_object import ErasureSet
    es = ErasureSet(wrap_disks(disks, **health_kwargs), device="cpu")
    es._mrf_closed = True
    es.make_bucket("b")
    return es


def test_late_read_keeps_its_lease_from_the_pool(tmp_path):
    """A GET whose shard read on one drive outlives its deadline is
    rebuilt around that drive, and the pooled region the late read
    fills stays out of the pool until the drive answers: then it goes
    back, once."""
    from minio_tpu_torch.io.bufpool import global_pool
    from minio_tpu_torch.object.erasure_object import hash_order
    disks = [_HangingReads(LocalStorage(str(tmp_path / f"d{i}")))
             for i in range(12)]
    es = _set(tmp_path, disks, op_timeout=0.3, bulk_timeout=0.3,
              trip_after=5)
    body = np.random.default_rng(3).bytes(2 * MIB + 3)
    try:
        es.put_object("b", "k", body)
        dist = hash_order("b/k", 12)
        h = next(i for i in range(12) if dist[i] == 1)
        pool = global_pool("cpu")
        base = pool.stats()
        disks[h].hang = True
        assert es.get_object("b", "k")[1] == body
        # The region the hung read fills is still leased.
        assert pool.stats()["outstanding"] == base["outstanding"] + 1
        disks[h].hang = False
        disks[h].gate.set()
        t0 = time.monotonic()
        while pool.stats()["outstanding"] != base["outstanding"] \
                and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        after = pool.stats()
        assert after["outstanding"] == base["outstanding"]
        assert after["double_releases"] == base["double_releases"]
        assert after["leaks"] == base["leaks"]
    finally:
        es.close()
    # At the wrapper, the expired call travels with its error.
    gate = threading.Event()

    class Hung:
        endpoint = "hung"

        def read_file_into(self, *a):
            gate.wait(10)
            return 7

    hd = DiskHealthWrapper(Hung(), bulk_timeout=0.2, trip_after=5)
    with pytest.raises(FaultyDisk) as ei:
        hd.read_file_into("b", "f", 0, [bytearray(8)])
    assert not ei.value.pending.done()
    gate.set()
    assert ei.value.pending.result(10) == 7


def test_create_file_deadline_runs_while_the_drive_holds_a_chunk(tmp_path):
    """create_file's bulk deadline bounds the drive, not the body: chunks
    that arrive slower than it in all still land, while a drive that
    holds one chunk past it is cut off and handed no further chunk."""
    disk = LocalStorage(str(tmp_path / "d"))
    disk.make_vol("v")
    hd = DiskHealthWrapper(disk, bulk_timeout=0.2, trip_after=5)

    def slow(n):
        for i in range(n):
            time.sleep(0.1)
            yield bytes([i]) * 10
    t0 = time.monotonic()
    hd.create_file("v", "slow", slow(6))
    assert time.monotonic() - t0 > 0.5
    assert disk.read_file("v", "slow") == b"".join(
        bytes([i]) * 10 for i in range(6))
    assert hd.health_info()["consecutive_faults"] == 0

    pulled = []

    class Stuck:
        endpoint = "stuck"

        def create_file(self, volume, path, chunks):
            for c in chunks:
                time.sleep(0.5)

    def counted():
        for i in range(4):
            pulled.append(i)
            yield b"x"
    hd = DiskHealthWrapper(Stuck(), bulk_timeout=0.2, trip_after=5)
    with pytest.raises(FaultyDisk) as ei:
        hd.create_file("v", "p", counted())
    with pytest.raises(FaultyDisk):
        ei.value.pending.result(10)
    assert pulled == [0]
    assert hd.health_info()["consecutive_faults"] == 1


def test_streamed_put_slower_than_bulk_deadline(tmp_path, monkeypatch):
    """A streamed PUT whose body takes longer to arrive than the drives'
    bulk deadline: every drive stays online, no fault is counted, and
    the object reads back."""
    from minio_tpu_torch.object import erasure_object
    from minio_tpu_torch.utils.streams import Payload
    monkeypatch.setattr(erasure_object, "STREAM_WINDOW_BLOCKS", 1)
    body = np.random.default_rng(4).bytes(4 * MIB + 7)

    class Slow:
        pos = 0

        def read(self, n):
            time.sleep(0.05)
            out = body[self.pos:self.pos + min(n, 256 << 10)]
            self.pos += len(out)
            return out
    disks = [LocalStorage(str(tmp_path / f"d{i}")) for i in range(12)]
    es = _set(tmp_path, disks, op_timeout=0.3, bulk_timeout=0.3)
    try:
        t0 = time.monotonic()
        es.put_object("b", "slow", Payload(Slow(), len(body)))
        assert time.monotonic() - t0 > 0.6
        assert all(d.is_online() and
                   d.health_info()["consecutive_faults"] == 0
                   for d in es.disks)
        assert es.get_object("b", "slow")[1] == body
    finally:
        es.close()


def test_pool_grows_past_eight_concurrent_calls(tmp_path):
    """Twelve calls that each wait for all twelve to have started: a
    fixed pool of 8 workers would hold the last four back forever."""
    started = threading.Barrier(12, timeout=5)

    class Slow:
        endpoint = "slow"

        def create_file(self, *a):
            started.wait()
            return True

    hd = DiskHealthWrapper(Slow(), bulk_timeout=5.0)
    results = []
    ths = [threading.Thread(target=lambda: results.append(
        hd.create_file("v", "p", [])))
        for _ in range(12)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(10)
    assert results == [True] * 12
    # OfflineDisk slots and wrapped drives pass through wrap_disks.
    off = OfflineDisk("pos-0")
    wrapped = wrap_disks([off, hd, LocalStorage(str(tmp_path / "e"))])
    assert wrapped[0] is off and wrapped[1] is hd
    assert isinstance(wrapped[2], DiskHealthWrapper)

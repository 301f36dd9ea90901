"""Request tracing and audit logging.

The port's copy of minio_tpu/s3/trace.py, the reference's observability
pair:
  * trace: a live pub/sub of per-request records, streamed to admin
    clients over HTTP (reference cmd/admin-handlers.go TraceHandler and
    its pubsub, the `mc admin trace` counterpart);
  * audit: one structured record a completed request, delivered to a
    webhook best-effort with a bounded retry queue (reference
    internal/logger audit targets).
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
import urllib.error
import urllib.request


def make_entry(api: str, method: str, path: str, bucket: str, key: str,
               status: int, duration_s: float, remote: str,
               access_key: str, rx: int = 0, tx: int = 0) -> dict:
    """One trace/audit record (the reference's madmin.TraceInfo /
    audit.Entry shape, trimmed). Timestamps carry millisecond
    precision — whole-second stamps made entries from one burst
    unsortable — in the same format span entries use."""
    from minio_tpu_torch.utils.tracing import _iso_ms
    return {
        "version": "1",
        "time": _iso_ms(time.time()),
        "api": api,
        "method": method,
        "path": path,
        "bucket": bucket,
        "object": key,
        "statusCode": status,
        "durationMs": round(duration_s * 1000, 3),
        "remoteHost": remote,
        "accessKey": access_key,
        "rx": rx,
        "tx": tx,
    }


class TraceBroadcaster:
    """Bounded pub/sub with per-subscriber TYPE filters: subscribers
    receive every published entry of the types they asked for
    (`s3|storage|grid|kernel|scanner|heal`; default just the top-level
    s3 records) while subscribed; slow subscribers drop oldest entries
    rather than backpressuring the request path (counted in `dropped`,
    every subscriber's summed; unlocked, so a count under races).

    Deep (non-s3) span collection is armed only while somebody watches:
    any subscription or remote relay wanting internal types holds an
    utils/tracing arm() token, so the request path's span machinery is
    a single attribute check when nobody does. The remote relay is the
    pre-forked worker side of cross-process streaming (io/workers.py):
    armed workers buffer matching entries in a bounded ring the parent
    drains over the control pipe."""

    _DEPTH = 1000
    _RELAY_DEPTH = 2000
    # The remote relay self-disarms when no drain has refreshed it for
    # this long (drains normally arrive every ~0.2 s): a parent whose
    # trace_stop never reached this worker (timeout, respawn, parent
    # death) must not leave span collection armed forever.
    _REMOTE_TTL = 10.0

    def __init__(self):
        self._mu = threading.Lock()
        self._subs: list[tuple[queue.Queue, frozenset]] = []
        self._remote_types: frozenset = frozenset()
        self._remote_deadline = 0.0
        self._relay: collections.deque = \
            collections.deque(maxlen=self._RELAY_DEPTH)
        # Plain bool refreshed under _mu, read WITHOUT it: every
        # request completion checks `active` — a mutex there would tax
        # the disarmed fast path the whole design protects.
        self._active = False
        self.dropped = 0

    @property
    def active(self) -> bool:
        return self._active

    def _rearm_locked(self) -> None:
        from minio_tpu_torch.utils import tracing
        self._active = bool(self._subs) or bool(self._remote_types)
        wanted = set(self._remote_types)
        for _, types in self._subs:
            wanted |= types
        if wanted - {"s3"}:
            tracing.arm(self)
        else:
            tracing.disarm(self)

    def wants_internal(self) -> bool:
        """True when any subscriber (local or remote relay) asked for
        non-s3 span types — the server only renders span entries then."""
        with self._mu:
            if self._remote_types - {"s3"}:
                return True
            return any(types - {"s3"} for _, types in self._subs)

    def subscribe(self, types=None) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=self._DEPTH)
        with self._mu:
            self._subs.append((q, frozenset(types or ("s3",))))
            self._rearm_locked()
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._mu:
            self._subs = [(sq, t) for sq, t in self._subs if sq is not q]
            self._rearm_locked()

    # -- cross-worker relay (io/workers.py control pipes) ---------------

    def arm_remote(self, types) -> None:
        """Buffer matching entries for the parent's drain poll
        (idempotent; each drain re-arms and refreshes the TTL, so
        respawned workers heal and missed trace_stops age out)."""
        with self._mu:
            self._remote_types = frozenset(types or ("s3",))
            self._remote_deadline = time.monotonic() + self._REMOTE_TTL
            self._rearm_locked()

    def disarm_remote(self) -> None:
        with self._mu:
            self._remote_types = frozenset()
            self._relay.clear()
            self._rearm_locked()

    def drain_remote(self) -> list[dict]:
        with self._mu:
            out = list(self._relay)
            self._relay.clear()
        return out

    def _remote_expired_locked(self) -> bool:
        """Lazy TTL: a relay nobody drains (missed trace_stop, dead
        parent) self-disarms rather than taxing every request forever."""
        if self._remote_types \
                and time.monotonic() > self._remote_deadline:
            self._remote_types = frozenset()
            self._relay.clear()
            self._rearm_locked()
            return True
        return False

    def publish(self, entry: dict) -> None:
        etype = entry.get("trace_type", "s3")
        wild = entry.get("broadcast", False)
        with self._mu:
            if self._remote_types:
                self._remote_expired_locked()
            subs = [q for q, types in self._subs
                    if wild or etype in types]
            if self._remote_types and (wild or etype in self._remote_types):
                self._relay.append(entry)
        for q in subs:
            try:
                q.put_nowait(entry)
            except queue.Full:
                self.dropped += 1
                try:
                    q.get_nowait()      # drop oldest
                    q.put_nowait(entry)
                except (queue.Empty, queue.Full):
                    pass


def make_trace_stream(server):
    """Grid stream verb (`trace.stream`) backing ?cluster=true admin
    trace: a peer node pulls THIS node's live trace entries as a
    stream of batches (lists of entry dicts). Subscribes exactly like
    the local admin handler — fleet-wide through the worker control
    pipe when the hub is up, else the local broadcaster — and yields
    an empty batch at least once per second so the grid client's
    per-frame liveness window never lapses on an idle node. Ends when
    the consumer stops draining (credit stall unwinds the generator)
    or the connection drops."""

    def _stream(payload):
        spec = payload if isinstance(payload, dict) else {}
        types = sorted({str(t) for t in spec.get("types") or ["s3"]})
        hub = getattr(server, "cluster_trace", None)
        sub = sub_id = None
        if hub is not None:
            try:
                sub_id = hub.trace_sub(types)
            except Exception:  # noqa: BLE001 - control plane down
                hub = None
        if hub is None:
            sub = server.tracer.subscribe(set(types))
        try:
            last_yield = time.monotonic()
            while True:
                if hub is not None:
                    entries = hub.trace_poll(sub_id)
                    if not entries:
                        if time.monotonic() - last_yield < 1.0:
                            time.sleep(0.2)
                            continue
                else:
                    try:
                        entries = [sub.get(timeout=1.0)]
                    except queue.Empty:
                        entries = []
                yield entries       # empty batch = heartbeat
                last_yield = time.monotonic()
        finally:
            if hub is not None:
                try:
                    hub.trace_unsub(sub_id)
                except Exception:  # noqa: BLE001 - best effort
                    pass
            else:
                server.tracer.unsubscribe(sub)

    return _stream


class AuditLogger:
    """Webhook audit target with a bounded in-memory retry deque.

    Audit is best-effort telemetry: a down target never blocks requests;
    entries beyond the buffer (or failing more than _MAX_ATTEMPTS
    deliveries: one poison entry must not dam the whole stream) count
    as dropped. Each record is POSTed bare as JSON (_post)."""

    _BUFFER = 10_000
    _MAX_ATTEMPTS = 5

    def __init__(self, endpoint: str, timeout: float = 3.0):
        self.timeout = timeout
        self.endpoint = endpoint
        self.sent = 0
        self.dropped = 0
        self._q: collections.deque = collections.deque(maxlen=self._BUFFER)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, entry: dict) -> None:
        if len(self._q) == self._q.maxlen:
            # Overflow evicts the OLDEST queued record; it must be
            # counted (and is exported — minio_tpu_audit_dropped_total),
            # never silently vanish.
            self.dropped += 1
        self._q.append((entry, 0))
        self._wake.set()

    def stats(self) -> dict:
        """Delivery counters for metrics/admin info: drops are real
        audit loss and must be VISIBLE (alertable), not silent."""
        return {"endpoint": self.endpoint, "sent": self.sent,
                "dropped": self.dropped, "pending": len(self._q)}

    def _run(self) -> None:
        backoff = 0.5
        while not self._stop.is_set():
            if not self._q:
                self._wake.wait(timeout=1.0)
                self._wake.clear()
                continue
            entry, attempts = self._q[0]
            try:
                self._post(entry)
            except Exception:  # noqa: BLE001 - retry with backoff
                try:
                    self._q.popleft()
                except IndexError:
                    continue
                if attempts + 1 >= self._MAX_ATTEMPTS:
                    self.dropped += 1
                else:
                    self._q.appendleft((entry, attempts + 1))
                self._stop.wait(timeout=backoff)
                backoff = min(backoff * 2, 30.0)
                continue
            try:
                self._q.popleft()
            except IndexError:
                pass
            self.sent += 1
            backoff = 0.5

    def _post(self, entry: dict) -> None:
        """POST one record bare (the JAX package's WebhookTarget.send
        with wrap=False); a non-2xx status raises."""
        req = urllib.request.Request(
            self.endpoint, data=json.dumps(entry).encode(),
            headers={"Content-Type": "application/json",
                     "User-Agent": "minio-tpu-notify"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except urllib.error.HTTPError as e:
            raise OSError(f"audit webhook {self.endpoint}: {e.code}") \
                from None

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._worker.join(timeout=2)

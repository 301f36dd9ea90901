"""Peer control plane: change-notification fan-out.

The port of minio_tpu/grid/peers.py (reference NotificationSys and the
peer REST client, cmd/notification.go:49, cmd/peer-rest-client.go:304):
a node that changes shared state (a drain's status, a bucket's listing,
its metadata) broadcasts a reload to every peer, so their caches drop at
once instead of serving the old state for up to a cache TTL. The TTL
stays the fallback for a peer that is down or unreachable at broadcast
time: it re-reads the persisted truth within one TTL of coming back.

The kinds `iam` and `config` are understood and answered, and do
nothing until the port has IAM and a server configuration to reload
(the JAX handler does the same when it is built without them).
"""

from __future__ import annotations

import threading

from minio_tpu_torch.utils import tracing

RELOAD_HANDLER = "peer.reload"

# Reload kinds a peer understands.
KIND_IAM = "iam"
KIND_BUCKET_META = "bucket-meta"
KIND_CONFIG = "config"
KIND_DECOM = "decom"
# A bucket's namespace changed on the sending node: its listing walks
# (object/metacache.py) go, so the peer's next listing walks afresh.
KIND_LISTING = "listing"

# Fan-out outcomes, process-wide (every notifier of the process adds to
# them): a best-effort path that fails every time must not fail unseen.
_stats_mu = threading.Lock()
_counts = {"sent": 0, "failed": 0}


def notify_stats() -> dict:
    with _stats_mu:
        return dict(_counts)


class PeerNotifier:
    """Best-effort synchronous fan-out to every peer.

    A broadcast calls every peer in parallel and waits up to `timeout`
    for each, so a change has reached every reachable node when the call
    that made it returns. Failures are counted, not raised:
    the state is already persisted to a quorum, and the peer's cache TTL
    bounds its staleness.
    """

    def __init__(self, clients, timeout: float = 2.0):
        self._clients = list(clients)
        self._timeout = timeout

    def broadcast(self, kind: str, bucket: str = "") -> None:
        if not self._clients:
            return
        payload = {"kind": kind, "bucket": bucket}
        threads = [threading.Thread(target=self._one, args=(c, payload),
                                    daemon=True)
                   for c in self._clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self._timeout)

    def _one(self, client, payload: dict) -> None:
        try:
            client.call(RELOAD_HANDLER, payload, timeout=self._timeout)
        except Exception as e:  # noqa: BLE001 - peer down: TTL fallback
            with _stats_mu:
                _counts["failed"] += 1
            # Counted and named: a best-effort path that always fails
            # is an outage.
            tracing.slow_event(
                "grid", "peer.notify-failed",
                tags={"peer": f"{getattr(client, 'host', '?')}:"
                              f"{getattr(client, 'port', '?')}",
                      "kind": payload.get("kind", ""),
                      "error": f"{type(e).__name__}: {e}"})
            return
        with _stats_mu:
            _counts["sent"] += 1


def make_reload_handler(object_layer=None):
    """The receiving side: a grid handler that drops the local cache the
    payload names (reference cmd/peer-rest-server.go's
    LoadBucketMetadataHandler family, as one keyed verb)."""

    def handler(payload):
        p = payload or {}
        kind = p.get("kind", "")
        if object_layer is None:
            return "ok"
        if kind == KIND_BUCKET_META:
            object_layer.invalidate_bucket_meta(p.get("bucket", ""))
        elif kind == KIND_LISTING:
            # Not broadcast again: the sending node already fanned out,
            # and an echo would bounce between the nodes for ever.
            from minio_tpu_torch.object.pools import layer_sets
            for es in layer_sets(object_layer):
                es.metacache.bump(p.get("bucket", ""), broadcast=False)
        elif kind == KIND_DECOM:
            # A drain started or ended on another node: the pools it
            # drains leave the placement of this node's workers too.
            sync = getattr(object_layer, "peer_decom_notice", None)
            if sync is not None:
                try:
                    sync()
                except Exception:  # noqa: BLE001 - the next boot syncs
                    pass
        return "ok"

    return handler

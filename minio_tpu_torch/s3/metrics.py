"""Prometheus-style metrics registry for the S3 server.

The port of minio_tpu/s3/metrics.py (the reference's metrics subsystem,
cmd/metrics-v3.go): per-API request counts, latencies and bytes, the
connection plane, object and capacity gauges fed by the scanner, drive
state, heal and migration counters, the caches, the stripe batcher and
the kernel lane, the group-commit lanes, the grid, the SLO engine and
the cluster federation, rendered in Prometheus text exposition format
at /minio/v2/metrics/cluster (cmd/metrics-router.go).

Every series keeps the JAX package's name, label set and HELP/TYPE
lines. Series of subsystems the port does not have yet are not
rendered: replication and site replication, batch jobs, the transform
plane, the per-drive engine queues and the GET kernel split.
"""

from __future__ import annotations

import os
import threading
import time

from minio_tpu_torch.utils import tracing as _tracing
from minio_tpu_torch.utils.latency import Histogram, LastMinute, summarize


class Metrics:
    def __init__(self):
        self._mu = threading.Lock()
        self._requests: dict[tuple[str, str], int] = {}
        self._latency_sum: dict[str, float] = {}
        self._latency_count: dict[str, int] = {}
        # Bucketed + rolling latency per API: the sum/count pair above
        # answers "average since boot"; the histogram answers
        # percentiles-over-all-time and the last-minute ring answers
        # "is THIS api slow right now" (reference: metrics-v3
        # histograms + cmd/last-minute.gen.go windows).
        self._latency_hist: dict[str, Histogram] = {}
        self._last_minute: dict[str, LastMinute] = {}
        self._bytes_rx = 0
        self._bytes_tx = 0
        # Connection plane (serve hot loop, s3/hotloop.py): open
        # connections, keep-alive reuse, and native-framer fallbacks to
        # the Python parser.
        self._conn_active = 0
        self._keepalive_reuses = 0
        self._parse_fallbacks = 0
        # Response-path split (event-loop connection plane): sendfile
        # short-circuit / pooled gathered sendmsg / legacy wfile.
        self._response_path = {"sendfile": 0, "pooled": 0, "legacy": 0}
        self._start = time.time()

    def record(self, api: str, status: int, seconds: float,
               rx: int = 0, tx: int = 0) -> None:
        klass = f"{status // 100}xx"
        with self._mu:
            key = (api, klass)
            self._requests[key] = self._requests.get(key, 0) + 1
            self._latency_sum[api] = self._latency_sum.get(api, 0.0) + seconds
            self._latency_count[api] = self._latency_count.get(api, 0) + 1
            self._bytes_rx += rx
            self._bytes_tx += tx
            hist = self._latency_hist.get(api)
            if hist is None:
                hist = self._latency_hist[api] = Histogram()
                self._last_minute[api] = LastMinute()
            minute = self._last_minute[api]
        hist.observe(seconds)
        minute.observe(seconds)

    def conn_open(self) -> None:
        with self._mu:
            self._conn_active += 1

    def conn_close(self) -> None:
        with self._mu:
            self._conn_active -= 1

    def keepalive_reuse(self) -> None:
        with self._mu:
            self._keepalive_reuses += 1

    def parse_fallback(self) -> None:
        with self._mu:
            self._parse_fallbacks += 1

    def response_path(self, kind: str) -> None:
        """One response served via `kind` (sendfile|pooled|legacy) —
        stamped exactly once per response at its final write."""
        with self._mu:
            self._response_path[kind] = \
                self._response_path.get(kind, 0) + 1

    def http_conn_stats(self) -> dict:
        with self._mu:
            return {"connections_active": self._conn_active,
                    "keepalive_reuses": self._keepalive_reuses,
                    "parse_fallbacks": self._parse_fallbacks,
                    "response_path": dict(self._response_path)}

    def last_minute(self) -> dict:
        """Per-API last-minute summaries {api: {count,p50,p99,max}} —
        the admin-info view."""
        with self._mu:
            minutes = dict(self._last_minute)
        return {api: summarize(lm.window()) for api, lm in minutes.items()}

    def state(self) -> dict:
        """JSON-safe counter snapshot for cross-worker aggregation
        (io/workers.py control pipe)."""
        with self._mu:
            hists = dict(self._latency_hist)
            minutes = dict(self._last_minute)
            out = {
                "requests": [[a, s, v]
                             for (a, s), v in self._requests.items()],
                "latency_sum": dict(self._latency_sum),
                "latency_count": dict(self._latency_count),
                "rx": self._bytes_rx,
                "tx": self._bytes_tx,
                "conn_active": self._conn_active,
                "keepalive_reuses": self._keepalive_reuses,
                "parse_fallbacks": self._parse_fallbacks,
                "response_path": dict(self._response_path),
            }
        out["latency_hist"] = {a: h.state() for a, h in hists.items()}
        out["last_minute"] = {a: lm.window() for a, lm in minutes.items()}
        out["slow_ops_total"] = _tracing.slow_total
        return out

    # -- rendering -------------------------------------------------------

    def render(self, object_layer=None, scanner=None, server=None,
               peer_states=None, node_states=None) -> str:
        """Prometheus text. With `peer_states` (every worker's control
        snapshot, this worker included), request counters render as
        the FLEET totals and per-worker gauges are appended — one
        scrape of any worker sees the whole front-end.

        With `node_states` (every cluster node's peer.metrics snapshot,
        the local node flagged "local": True), the merge goes one level
        further the same way: remote workers' states join the fleet
        totals and per-node families (requests, slow ops, last-minute
        latency, replication lag) are appended with `node` identity
        labels — one scrape of ANY node answers for the cluster."""
        lines: list[str] = []

        def metric(name, help_, type_, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {type_}")
            for labels, value in samples:
                if labels:
                    lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
                    lines.append(f"{name}{{{lab}}} {value}")
                else:
                    lines.append(f"{name} {value}")

        def hist_metric(name, help_, samples):
            """Prometheus histogram family: per-label-set cumulative
            `_bucket{le=}` lines plus `_sum`/`_count`. `samples` is
            [(labels, hist_state)]."""
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
            for labels, st in samples:
                base = ",".join(f'{k}="{v}"' for k, v in labels.items())
                for le, cum in Histogram.cumulative(st):
                    lab = f'{base},le="{le}"' if base else f'le="{le}"'
                    lines.append(f"{name}_bucket{{{lab}}} {cum}")
                suffix = f"{{{base}}}" if base else ""
                lines.append(f"{name}_sum{suffix} {st.get('sum', 0.0)}")
                lines.append(f"{name}_count{suffix} {st.get('count', 0)}")

        with self._mu:
            reqs = dict(self._requests)
            lat_sum = dict(self._latency_sum)
            lat_count = dict(self._latency_count)
            rx, tx = self._bytes_rx, self._bytes_tx
            conn_active = self._conn_active
            keepalive_reuses = self._keepalive_reuses
            parse_fallbacks = self._parse_fallbacks
            resp_path = dict(self._response_path)
            hists = {a: h.state() for a, h in self._latency_hist.items()}
            minutes = {a: lm.window()
                       for a, lm in self._last_minute.items()}
        slow_total = _tracing.slow_total
        peer_metrics = [p["metrics"] for p in (peer_states or [])
                        if isinstance(p.get("metrics"), dict)]
        # Cluster federation: remote nodes' worker states join the
        # fleet totals (the local node's own states already sit in
        # peer_metrics — or, single-process, in this instance — so its
        # node_states entry is flagged "local" and skipped here).
        remote_states = []
        for ns in (node_states or []):
            if not isinstance(ns, dict) or ns.get("local"):
                continue
            remote_states.extend(s for s in ns.get("states") or []
                                 if isinstance(s, dict))
        if remote_states:
            if not peer_metrics:
                peer_metrics = [self.state()]
            peer_metrics = peer_metrics + remote_states
        if peer_metrics:
            reqs, lat_sum, lat_count = {}, {}, {}
            rx = tx = 0
            conn_active = keepalive_reuses = parse_fallbacks = 0
            resp_path = {}
            slow_total = 0
            hist_states: dict[str, list] = {}
            minute_states: dict[str, list] = {}
            for st in peer_metrics:
                for a, s, v in st.get("requests", []):
                    reqs[(a, s)] = reqs.get((a, s), 0) + v
                for a, v in st.get("latency_sum", {}).items():
                    lat_sum[a] = lat_sum.get(a, 0.0) + v
                for a, v in st.get("latency_count", {}).items():
                    lat_count[a] = lat_count.get(a, 0) + v
                for a, hs in st.get("latency_hist", {}).items():
                    hist_states.setdefault(a, []).append(hs)
                for a, w in st.get("last_minute", {}).items():
                    minute_states.setdefault(a, []).append(w)
                rx += st.get("rx", 0)
                tx += st.get("tx", 0)
                conn_active += st.get("conn_active", 0)
                keepalive_reuses += st.get("keepalive_reuses", 0)
                parse_fallbacks += st.get("parse_fallbacks", 0)
                for k, v in st.get("response_path", {}).items():
                    resp_path[k] = resp_path.get(k, 0) + v
                slow_total += st.get("slow_ops_total", 0)
            hists = {a: Histogram.merge(sts)
                     for a, sts in hist_states.items()}
            minutes = {a: LastMinute.merge(ws)
                       for a, ws in minute_states.items()}

        metric("minio_tpu_http_requests_total",
               "HTTP requests by API and status class", "counter",
               [({"api": a, "status": s}, v)
                for (a, s), v in sorted(reqs.items())])
        metric("minio_tpu_http_request_seconds_sum",
               "Cumulative request latency per API", "counter",
               [({"api": a}, round(v, 6)) for a, v in sorted(lat_sum.items())])
        metric("minio_tpu_http_request_seconds_count",
               "Request count per API (latency sample count)", "counter",
               [({"api": a}, v) for a, v in sorted(lat_count.items())])
        metric("minio_tpu_http_rx_bytes_total",
               "Bytes received in request bodies", "counter", [({}, rx)])
        metric("minio_tpu_http_tx_bytes_total",
               "Bytes sent in response bodies", "counter", [({}, tx)])
        metric("minio_tpu_http_connections_active",
               "Open front-end HTTP connections", "gauge",
               [({}, conn_active)])
        metric("minio_tpu_http_keepalive_reuses_total",
               "Requests served on an already-open keep-alive connection",
               "counter", [({}, keepalive_reuses)])
        metric("minio_tpu_http_parse_fallbacks_total",
               "Requests the native head framer declined to the Python "
               "parser", "counter", [({}, parse_fallbacks)])
        metric("minio_tpu_http_response_path_total",
               "Responses by final-write mechanism (hotcache RAM hit / "
               "sendfile short-circuit / pooled gathered sendmsg / "
               "legacy buffered writes)", "counter",
               [({"path": k}, v) for k, v in sorted(resp_path.items())])
        # Event-loop connection plane (s3/eventloop.py): parked vs
        # active fds, fresh accepts vs keep-alive re-parks, shed and
        # reaped connections, and the loop-lag histogram. Fleet-merged
        # from every worker's control snapshot when available.
        loop_stats = None
        if peer_states:
            peer_loops = [p.get("connections") for p in peer_states
                          if isinstance(p.get("connections"), dict)]
            if peer_loops:
                loop_stats = merge_loop_stats(peer_loops)
        if loop_stats is None and server is not None:
            es = getattr(server, "eventloop_stats", None)
            loop_stats = es() if es is not None else None
        ls = loop_stats or {}
        metric("minio_tpu_http_eventloop_enabled",
               "1 when the epoll event-loop front end serves this "
               "fleet, 0 under thread-per-connection", "gauge",
               [({}, 1 if ls.get("enabled") else 0)])
        metric("minio_tpu_http_parked_connections",
               "Keep-alive connections parked in the epoll set "
               "(no thread, hibernated recv buffer)", "gauge",
               [({}, ls.get("parked", 0))])
        metric("minio_tpu_http_dispatched_connections",
               "Connections currently owned by an executor thread or "
               "a loop-owned response-tail drain", "gauge",
               [({}, ls.get("active", 0))])
        metric("minio_tpu_http_conns_accepted_total",
               "Fresh connections accepted by the event loop",
               "counter", [({}, ls.get("accepted_total", 0))])
        metric("minio_tpu_http_conns_shed_total",
               "Connections shed at accept (connection-level "
               "backpressure past MTPU_MAX_CONNS)", "counter",
               [({}, ls.get("shed_total", 0))])
        metric("minio_tpu_http_conn_reparks_total",
               "Keep-alive turnarounds re-parked into the epoll set "
               "instead of pinning a thread", "counter",
               [({}, ls.get("reparks_total", 0))])
        metric("minio_tpu_http_idle_reaped_total",
               "Connections reaped by the idle deadline (includes "
               "slowloris partial heads)", "counter",
               [({}, ls.get("reaped_idle_total", 0))])
        if ls.get("loop_lag"):
            hist_metric("minio_tpu_http_loop_lag_seconds",
                        "Event-loop tick service lag (ready events to "
                        "handled)", [({}, ls["loop_lag"])])
        hist_metric("minio_tpu_api_request_duration_seconds",
                    "Bucketed request latency per API",
                    [({"api": a}, st) for a, st in sorted(hists.items())])
        lm_samples, lm_counts = [], []
        for a, w in sorted(minutes.items()):
            s = summarize(w)
            lm_counts.append(({"api": a}, s["count"]))
            for q in ("p50", "p99", "max"):
                lm_samples.append(({"api": a, "q": q}, s[q]))
        metric("minio_tpu_api_last_minute_seconds",
               "Rolling last-minute request latency per API "
               "(p50/p99/max over 60 one-second slots)", "gauge",
               lm_samples)
        metric("minio_tpu_api_last_minute_requests",
               "Requests observed in the trailing minute per API",
               "gauge", lm_counts)
        metric("minio_tpu_slow_ops_total",
               "Spans that crossed the MTPU_SLOW_OP_MS threshold "
               "(slow-op log records emitted)", "counter",
               [({}, slow_total)])
        metric("minio_tpu_process_uptime_seconds",
               "Seconds since server start", "gauge",
               [({}, round(time.time() - self._start, 1))])

        if scanner is not None:
            u = scanner.usage
            metric("minio_tpu_cluster_objects_total",
                   "Objects at last scanner cycle", "gauge",
                   [({}, u.objects)])
            metric("minio_tpu_cluster_versions_total",
                   "Object versions at last scanner cycle", "gauge",
                   [({}, u.versions)])
            metric("minio_tpu_cluster_usage_bytes",
                   "Logical bytes stored at last scanner cycle", "gauge",
                   [({}, u.total_size)])
            metric("minio_tpu_bucket_usage_bytes",
                   "Logical bytes per bucket", "gauge",
                   [({"bucket": b}, bu.size)
                    for b, bu in sorted(u.buckets.items())])
            metric("minio_tpu_heal_objects_healed_total",
                   "Objects healed by the scanner", "counter",
                   [({}, u.healed)])
            metric("minio_tpu_heal_failures_total",
                   "Scanner heal failures", "counter",
                   [({}, u.heal_failures)])
            metric("minio_tpu_scanner_cycles_total",
                   "Completed scanner cycles", "counter", [({}, u.cycles)])

        if object_layer is not None:
            online, offline = 0, 0
            total_cap = free_cap = 0
            for _, _, di in probe_disks(object_layer):
                if di is None:
                    offline += 1
                else:
                    online += 1
                    total_cap += di.total
                    free_cap += di.free
            metric("minio_tpu_drives_online", "Drives responding", "gauge",
                   [({}, online)])
            metric("minio_tpu_drives_offline", "Drives not responding",
                   "gauge", [({}, offline)])
            metric("minio_tpu_capacity_raw_total_bytes",
                   "Raw capacity across online drives", "gauge",
                   [({}, total_cap)])
            metric("minio_tpu_capacity_raw_free_bytes",
                   "Raw free capacity across online drives", "gauge",
                   [({}, free_cap)])
            # Metacache effectiveness across the layer's sets.
            mcs = {"hits": 0, "misses": 0, "walks_active": 0,
                   "walks_started": 0, "persisted_loads": 0,
                   "compactions": 0}
            for s in layer_sets(object_layer):
                mc = getattr(s, "metacache", None)
                if mc is not None:
                    st = mc.stats()
                    for key in mcs:
                        mcs[key] += st[key]
            metric("minio_tpu_metacache_hits_total",
                   "Listing pages served from cache", "counter",
                   [({}, mcs["hits"])])
            metric("minio_tpu_metacache_misses_total",
                   "Listing pages that required a drive walk", "counter",
                   [({}, mcs["misses"])])
            metric("minio_tpu_metacache_walks_active",
                   "Background listing walks currently producing",
                   "gauge", [({}, mcs["walks_active"])])
            metric("minio_tpu_metacache_walks_started_total",
                   "Background listing walks started", "counter",
                   [({}, mcs["walks_started"])])
            metric("minio_tpu_metacache_persisted_loads_total",
                   "Listings warm-started from persisted walk segments",
                   "counter", [({}, mcs["persisted_loads"])])
            metric("minio_tpu_metacache_compactions_total",
                   "Continuation walks compacted onto persisted base "
                   "runs", "counter", [({}, mcs["compactions"])])
            # Native journal-scan split: fallbacks are blobs the native
            # scanner handed back to the Python parser.
            from minio_tpu_torch.storage import meta_scan as _ms
            metric("minio_tpu_meta_scan_blobs_total",
                   "xl.meta journals decoded by the listing walk, by "
                   "path", "counter",
                   [({"path": p}, _ms.counters[p])
                    for p in ("summaries", "fallback")])
            # MRF queue health: drops must be VISIBLE — a heal that
            # silently vanishes is a future quorum loss (s._mrf, not
            # s.mrf: rendering metrics must not start a worker).
            mrf = {"healed": 0, "spilled": 0, "dropped": 0, "pending": 0}
            for s in layer_sets(object_layer):
                q = getattr(s, "_mrf", None)
                if q is not None:
                    st = q.stats()
                    for key in mrf:
                        mrf[key] += st[key]
            metric("minio_tpu_mrf_healed_total",
                   "Objects healed off the MRF retry queue", "counter",
                   [({}, mrf["healed"])])
            metric("minio_tpu_mrf_spilled_total",
                   "MRF entries that overflowed the bounded queue into "
                   "the persisted pending set (replayed, not lost)",
                   "counter", [({}, mrf["spilled"])])
            metric("minio_tpu_mrf_dropped_total",
                   "MRF heals abandoned after exhausting retries "
                   "(real loss — alert on this)", "counter",
                   [({}, mrf["dropped"])])
            metric("minio_tpu_mrf_pending",
                   "Heal entries awaiting MRF repair", "gauge",
                   [({}, mrf["pending"])])

        if server is not None:
            adm = getattr(server, "admission", None)
            if adm is not None:
                snap = adm.snapshot()
                classes = sorted(k for k, v in snap.items()
                                 if isinstance(v, dict))
                metric("minio_tpu_api_requests_max",
                       "Configured in-flight request limit per class "
                       "(0 = unlimited)", "gauge",
                       [({"class": c}, snap[c]["limit"]) for c in classes])
                metric("minio_tpu_api_requests_in_flight",
                       "Requests currently admitted per class", "gauge",
                       [({"class": c}, snap[c]["in_flight"])
                        for c in classes])
                metric("minio_tpu_api_requests_waiting",
                       "Requests queued for an admission slot", "gauge",
                       [({"class": c}, snap[c]["waiting"])
                        for c in classes])
                metric("minio_tpu_api_requests_admitted_total",
                       "Requests admitted per class", "counter",
                       [({"class": c}, snap[c]["admitted_total"])
                        for c in classes])
                metric("minio_tpu_api_requests_shed_total",
                       "Requests shed with 503 by admission control",
                       "counter",
                       [({"class": c, "reason": r},
                         snap[c][f"shed_{r}_total"])
                        for c in classes
                        for r in ("queue_full", "deadline")])
                metric("minio_tpu_api_request_deadline_exceeded_total",
                       "Requests that exhausted their deadline budget "
                       "mid-flight (408)", "counter",
                       [({}, snap["deadline_exceeded_total"])])
            aud = getattr(server, "audit", None)
            if aud is not None:
                # Audit delivery health: a full retry queue used to
                # evict records with no visible trace — dropped MUST be
                # exported (it is real audit loss, alert on it).
                ast = aud.stats()
                metric("minio_tpu_audit_sent_total",
                       "Audit records delivered to the webhook target",
                       "counter", [({}, ast["sent"])])
                metric("minio_tpu_audit_dropped_total",
                       "Audit records lost to retry-queue overflow or "
                       "exhausted delivery attempts (alert on this)",
                       "counter", [({}, ast["dropped"])])
                metric("minio_tpu_audit_pending",
                       "Audit records waiting in the retry queue",
                       "gauge", [({}, ast["pending"])])
            dh = getattr(server, "drive_heal", None)
            st = None
            if peer_states:
                # Pre-forked mode: bulk heals run on worker 0 only,
                # but scrapes land on any worker — render the FLEET's
                # drive-heal state so every scrape sees the heal.
                merged = {"formats_restored": 0, "drives": []}
                found = False
                for p in peer_states:
                    pst = p.get("drive_heal")
                    if isinstance(pst, dict):
                        found = True
                        merged["formats_restored"] += \
                            pst.get("formats_restored", 0)
                        merged["drives"].extend(pst.get("drives", []))
                if found:
                    st = merged
            if st is None and dh is not None:
                st = dh.status()
            if st is not None:
                # Drive replacement bulk-heal progress: one sample per
                # healing (or recently finished) drive, so operators
                # can watch a swap converge from any dashboard.
                samples = {"scanned": [], "healed": [], "failed": [],
                           "bytes": [], "eta": []}
                healing_now = 0
                for entry in st.get("drives", []):
                    lab = {"set": entry.get("set", 0),
                           "drive": entry.get("drive", 0)}
                    if entry.get("state") != "done":
                        healing_now += 1
                    samples["scanned"].append(
                        (lab, entry.get("objects_scanned", 0)))
                    samples["healed"].append(
                        (lab, entry.get("objects_healed", 0)))
                    samples["failed"].append(
                        (lab, entry.get("objects_failed", 0)))
                    samples["bytes"].append(
                        (lab, entry.get("bytes_healed", 0)))
                    if "eta_seconds" in entry:
                        samples["eta"].append(
                            (lab, entry["eta_seconds"]))
                metric("minio_tpu_drives_healing",
                       "Drives currently under bulk heal", "gauge",
                       [({}, healing_now)])
                metric("minio_tpu_drive_heal_objects_scanned",
                       "Objects scanned by each drive's bulk heal",
                       "gauge", samples["scanned"])
                metric("minio_tpu_drive_heal_objects_healed",
                       "Objects repaired onto each replaced drive",
                       "gauge", samples["healed"])
                metric("minio_tpu_drive_heal_objects_failed",
                       "Objects the bulk heal failed to repair "
                       "(MRF/scanner retry later)", "gauge",
                       samples["failed"])
                metric("minio_tpu_drive_heal_bytes_healed",
                       "Logical bytes repaired onto each replaced "
                       "drive", "gauge", samples["bytes"])
                metric("minio_tpu_drive_heal_eta_seconds",
                       "Estimated seconds to bulk-heal completion "
                       "(rate-based; needs a scanner object count)",
                       "gauge", samples["eta"])
                metric("minio_tpu_drive_formats_restored_total",
                       "Fresh drives re-formatted into their slot at "
                       "runtime", "counter",
                       [({}, st.get("formats_restored", 0))])
            decom_status = getattr(server.object_layer,
                                   "decommission_status", None) \
                if getattr(server, "object_layer", None) is not None \
                else None
            if decom_status is not None:
                st = decom_status()
                if st:
                    metric("minio_tpu_decommission_migrated_total",
                           "Objects migrated by the active/last drain",
                           "counter", [({}, st.get("migrated", 0))])
                    metric("minio_tpu_decommission_failed_total",
                           "Objects the drain failed to migrate",
                           "counter", [({}, st.get("failed", 0))])
                    metric("minio_tpu_decom_bytes_moved_total",
                           "Data bytes restored into surviving pools "
                           "by the active/last drain", "counter",
                           [({}, st.get("bytes_moved", 0))])
                    metric("minio_tpu_decom_yields_total",
                           "Drain pauses taken to yield to queueing "
                           "foreground requests", "counter",
                           [({}, st.get("yields", 0))])
                    if st.get("checkpoint_ns"):
                        age = max(0.0, time.time() -
                                  st["checkpoint_ns"] / 1e9)
                        metric("minio_tpu_decom_checkpoint_age_seconds",
                               "Seconds since the drain checkpoint "
                               "last persisted (resume staleness "
                               "bound)", "gauge", [({}, age)])
            rb_status = getattr(server.object_layer,
                                "rebalance_status", None) \
                if getattr(server, "object_layer", None) is not None \
                else None
            if rb_status is not None:
                st = rb_status()
                if st:
                    recs = sorted((st.get("pools") or {}).items())
                    metric("minio_tpu_rebalance_active",
                           "1 while a rebalance walk is in progress",
                           "gauge",
                           [({}, 1 if st.get("status") in
                             ("planning", "rebalancing") else 0)])
                    metric("minio_tpu_rebalance_migrated_total",
                           "Objects each participating pool shed in "
                           "the active/last rebalance", "counter",
                           [({"pool": p}, r.get("migrated", 0))
                            for p, r in recs])
                    metric("minio_tpu_rebalance_bytes_moved_total",
                           "Bytes each participating pool shed",
                           "counter",
                           [({"pool": p}, r.get("bytes_moved", 0))
                            for p, r in recs])
                    metric("minio_tpu_rebalance_failed_total",
                           "Objects the rebalance failed to migrate",
                           "counter",
                           [({"pool": p}, r.get("failed", 0))
                            for p, r in recs])
                    metric("minio_tpu_rebalance_pool_fill_fraction",
                           "Used/capacity per pool as of rebalance "
                           "planning", "gauge",
                           [({"pool": p},
                             r.get("used", 0) / (r.get("capacity") or 1))
                            for p, r in recs])
                    metric("minio_tpu_rebalance_yields_total",
                           "Rebalance pauses taken to yield to "
                           "queueing foreground requests", "counter",
                           [({}, st.get("yields", 0))])
                    if st.get("checkpoint_ns"):
                        age = max(0.0, time.time() -
                                  st["checkpoint_ns"] / 1e9)
                        metric(
                            "minio_tpu_rebalance_checkpoint_age_seconds",
                            "Seconds since the rebalance checkpoint "
                            "last persisted", "gauge", [({}, age)])

        # -- I/O engine observability (io/bufpool + io/engine) ----------
        # Saturation diagnosis: pool hit rate says whether hot paths
        # recycle window buffers; outstanding/leaks say whether leases
        # return; per-drive queue depth says which drive is the wall.
        from minio_tpu_torch.io.bufpool import pools_stats
        bp = pools_stats()
        for name, help_, type_, key in (
                ("minio_tpu_bufpool_hits_total",
                 "Buffer leases served from the pool", "counter", "hits"),
                ("minio_tpu_bufpool_misses_total",
                 "Buffer leases that allocated fresh memory", "counter",
                 "misses"),
                ("minio_tpu_bufpool_oversized_total",
                 "Leases larger than every size class (unpooled)",
                 "counter", "oversized"),
                ("minio_tpu_bufpool_outstanding",
                 "Leases currently held", "gauge", "outstanding"),
                ("minio_tpu_bufpool_leaks_total",
                 "Dropped leases returned by the leak net", "counter",
                 "leaks"),
                ("minio_tpu_bufpool_idle_bytes",
                 "Bytes parked on pool free lists", "gauge",
                 "idle_bytes")):
            metric(name, help_, type_, [({}, bp[key])])

        # -- cross-request stripe batcher (ops/batcher) -----------------
        # Occupancy diagnosis: route counters say whether PUTs actually
        # ride the device; bucket counters + fill ratio say whether
        # coalescing fills the mesh-wide batches it compiles for; the
        # wait histogram bounds the latency the accumulation window
        # adds; deadline failures count members culled before dispatch.
        from minio_tpu_torch.ops import batcher as _batcher_mod
        bst = _batcher_mod.aggregate_stats()
        routes = sorted(bst["routes"].items())
        metric("minio_tpu_batcher_dispatches_total",
               "Coalesced stripe-batch dispatches by route "
               "(put|get|reconstruct) and resolved path", "counter",
               [({"route": r, "path": p}, v) for r, st in routes
                for p, v in sorted(st["dispatches"].items())])
        metric("minio_tpu_batcher_requests_total",
               "Stripe windows routed through the batcher by route "
               "(bypass = calibrated host pass-through)", "counter",
               [({"route": r, "path": p}, v) for r, st in routes
                for p, v in sorted(st["requests"].items())])
        metric("minio_tpu_batcher_bucket_dispatches_total",
               "Device dispatches per batch padding bucket", "counter",
               [({"route": r, "bucket": b}, v) for r, st in routes
                for b, v in sorted(st["buckets"].items())])
        metric("minio_tpu_batcher_batched_blocks_total",
               "Stripe blocks carried by device dispatches", "counter",
               [({"route": r}, st["batched_blocks"])
                for r, st in routes])
        metric("minio_tpu_batcher_capacity_blocks_total",
               "Padded bucket capacity of those dispatches "
               "(batched/capacity = fill ratio)", "counter",
               [({"route": r}, st["capacity_blocks"])
                for r, st in routes])
        metric("minio_tpu_batcher_fill_ratio",
               "Mean batch fill ratio (blocks dispatched / bucket "
               "capacity) since boot", "gauge",
               [({"route": r}, round(st["fill_ratio"], 4))
                for r, st in routes])
        metric("minio_tpu_batcher_deadline_failures_total",
               "Batch members failed for exhausted deadlines before "
               "dispatch (batch-mates unaffected)", "counter",
               [({"route": r}, st["deadline_failures"])
                for r, st in routes])
        metric("minio_tpu_batcher_mesh_devices",
               "Chips the batched dispatch shards over", "gauge",
               [({}, bst["mesh_devices"])])
        hist_metric("minio_tpu_batcher_wait_seconds",
                    "Coalescing wait per batched stripe window "
                    "(enqueue to dispatch start)",
                    [({"route": r}, st["wait_hist"])
                     for r, st in routes])
        hist_metric("minio_tpu_kernel_lane_decode_service_seconds",
                    "Kernel-lane service time of decode-route "
                    "(get/reconstruct) device dispatches",
                    [({}, bst["decode_lane_hist"])])
        # -- group-commit write plane (storage/group_commit) ------------
        # Occupancy diagnosis for the small-object commit lanes: batch
        # size distribution + mean fill say whether concurrent PUTs
        # actually coalesce; fsyncs_saved is the durability-cost
        # amortization; culls/demotions are the isolation escape
        # hatches firing.
        from minio_tpu_torch.storage import group_commit as _gc_mod
        gst = _gc_mod.aggregate_stats()
        peers_gc = [p.get("group_commit") for p in (peer_states or [])
                    if isinstance(p.get("group_commit"), dict)]
        if peers_gc:
            # Pre-forked mode: each worker runs its own lanes and a
            # scrape lands on an arbitrary one — merge the fleet.
            gst = _gc_mod.merge_stats(peers_gc)
        metric("minio_tpu_group_commit_batches_total",
               "Coalesced per-drive commit batches dispatched",
               "counter", [({}, gst["batches"])])
        metric("minio_tpu_group_commit_members_total",
               "Commit members carried by those batches", "counter",
               [({}, gst["members"])])
        metric("minio_tpu_group_commit_solo_total",
               "Group-eligible commits that took the solo fan-out "
               "(no coalescing company)", "counter",
               [({}, gst["solo_bypass"])])
        metric("minio_tpu_group_commit_batch_size_dispatches_total",
               "Batches per power-of-two member-count bucket",
               "counter",
               [({"size": str(b)}, v) for b, v in
                sorted(gst["size_buckets"].items())])
        metric("minio_tpu_group_commit_fill_mean",
               "Mean members per batch since boot", "gauge",
               [({}, round(gst["fill_mean"], 3))])
        metric("minio_tpu_group_commit_merged_members_total",
               "Same-object members merged into one journal rewrite",
               "counter", [({}, gst["merged_members"])])
        metric("minio_tpu_group_commit_noop_skips_total",
               "Byte-identical version re-adds short-circuited "
               "without a journal rewrite", "counter",
               [({}, gst["noop_skips"])])
        metric("minio_tpu_group_commit_fsyncs_saved_total",
               "Per-journal fdatasyncs replaced by batch WAL syncs",
               "counter", [({}, gst["fsyncs_saved"])])
        metric("minio_tpu_group_commit_deadline_culls_total",
               "Members culled for exhausted deadlines before their "
               "batch dispatched (batch-mates unaffected)", "counter",
               [({}, gst["deadline_culls"])])
        metric("minio_tpu_group_commit_solo_demotions_total",
               "Members demoted to the solo commit path after a batch "
               "fault", "counter", [({}, gst["solo_demotions"])])
        metric("minio_tpu_group_commit_checkpoints_total",
               "Background WAL checkpoints (one os.sync each)",
               "counter", [({}, gst["checkpoints"])])
        metric("minio_tpu_group_commit_wals_retired_total",
               "WAL frames retired by checkpoints", "counter",
               [({}, gst["wals_retired"])])
        hist_metric("minio_tpu_group_commit_wait_seconds",
                    "Coalescing wait per commit member (enqueue to "
                    "batch dispatch)", [({}, gst["wait_hist"])])
        # Report the lane without CREATING it: kernel_lane() lazily
        # spawns a worker thread, and a scrape on a host-codec-only
        # process should not pay a permanent thread to export zeros.
        from minio_tpu_torch.io import engine as _engine
        if _engine._kernel_lane is not None:
            kst = _engine._kernel_lane.stats()
        else:
            kst = {"queued": 0, "submitted_total": 0,
                   "service_hist": Histogram().state()}
        metric("minio_tpu_kernel_lane_queued",
               "Device dispatches waiting in the shared kernel lane",
               "gauge", [({}, kst["queued"])])
        metric("minio_tpu_kernel_lane_dispatches_total",
               "Device dispatches submitted to the kernel lane",
               "counter", [({}, kst["submitted_total"])])
        hist_metric("minio_tpu_kernel_lane_op_duration_seconds",
                    "Bucketed service time of kernel-lane device "
                    "dispatches", [({}, kst["service_hist"])])
        # -- read path: the quorum-fileinfo cache -----------------------
        # Hit rate says whether repeat GETs skip the k-drive metadata
        # fan-out; invalidations say writes are being observed.
        if object_layer is not None:
            fic = {"hits": 0, "misses": 0, "evictions": 0,
                   "invalidations": 0, "entries": 0, "bytes": 0,
                   "stat_hits": 0, "stat_misses": 0, "stat_entries": 0,
                   "stat_evictions": 0}
            for s in layer_sets(object_layer):
                cache = getattr(s, "fi_cache", None)
                if cache is not None:
                    st = cache.stats()
                    for key in fic:
                        fic[key] += st[key]
            for name, help_, type_, key in (
                    ("minio_tpu_fileinfo_cache_hits_total",
                     "GET/HEAD metadata served from the fileinfo cache",
                     "counter", "hits"),
                    ("minio_tpu_fileinfo_cache_misses_total",
                     "Fileinfo lookups that paid the drive fan-out",
                     "counter", "misses"),
                    ("minio_tpu_fileinfo_cache_evictions_total",
                     "Entries LRU-evicted from the fileinfo cache",
                     "counter", "evictions"),
                    ("minio_tpu_fileinfo_cache_invalidations_total",
                     "Write/heal invalidations of cached fileinfo",
                     "counter", "invalidations"),
                    ("minio_tpu_fileinfo_cache_entries",
                     "Keys currently cached", "gauge", "entries"),
                    ("minio_tpu_fileinfo_cache_bytes",
                     "Resident inline bytes held by cached fileinfo",
                     "gauge", "bytes"),
                    ("minio_tpu_fileinfo_cache_stat_hits_total",
                     "HEADs served from the stat class (or a data "
                     "entry)", "counter", "stat_hits"),
                    ("minio_tpu_fileinfo_cache_stat_misses_total",
                     "HEADs that paid the drive fan-out", "counter",
                     "stat_misses"),
                    ("minio_tpu_fileinfo_cache_stat_entries",
                     "Stat-class keys currently cached", "gauge",
                     "stat_entries"),
                    ("minio_tpu_fileinfo_cache_stat_evictions_total",
                     "Stat-class entries LRU-trimmed (healthy under "
                     "HEAD storms — distinct from data-class thrash)",
                     "counter", "stat_evictions")):
                metric(name, help_, type_, [({}, fic[key])])

        # -- hot-object read tier (object/hotcache.py) ------------------
        # Hits are GETs that never touched the object layer (served
        # from a pinned RAM buffer, most straight off the epoll loop);
        # admits vs rejects say whether tinyLFU is filtering scans;
        # invalidations say mutations are being observed. Per-worker
        # caches merge into the fleet view like the loop stats above.
        hot_states = [p.get("hot_cache") for p in (peer_states or [])
                      if isinstance(p.get("hot_cache"), dict)]
        if not hot_states and server is not None:
            hc = getattr(server, "hot_cache", None)
            if hc is not None:
                hot_states = [hc.stats()]
        if hot_states:
            hot = {"hits": 0, "misses": 0, "admits": 0, "rejects": 0,
                   "evictions": 0, "invalidations": 0, "entries": 0,
                   "bytes": 0}
            hot_enabled = 0
            for st in hot_states:
                if st.get("enabled"):
                    hot_enabled = 1
                for key in hot:
                    hot[key] += st.get(key, 0)
            metric("minio_tpu_hot_cache_enabled",
                   "1 when the hot-object read tier is admitting "
                   "(MTPU_HOT_CACHE kill switch)", "gauge",
                   [({}, hot_enabled)])
            for name, help_, type_, key in (
                    ("minio_tpu_hot_cache_hits_total",
                     "GETs served from the hot-object RAM tier (no "
                     "object-layer work)", "counter", "hits"),
                    ("minio_tpu_hot_cache_misses_total",
                     "Hot-tier lookups that fell through to the "
                     "object layer", "counter", "misses"),
                    ("minio_tpu_hot_cache_admits_total",
                     "Objects admitted into the hot tier", "counter",
                     "admits"),
                    ("minio_tpu_hot_cache_admission_rejects_total",
                     "Candidates the tinyLFU filter kept out (scan "
                     "resistance at work)", "counter", "rejects"),
                    ("minio_tpu_hot_cache_evictions_total",
                     "Entries evicted by the byte/entry caps",
                     "counter", "evictions"),
                    ("minio_tpu_hot_cache_invalidations_total",
                     "Mutation/coherence flushes of hot entries",
                     "counter", "invalidations"),
                    ("minio_tpu_hot_cache_entries",
                     "Objects currently pinned in the hot tier",
                     "gauge", "entries"),
                    ("minio_tpu_hot_cache_bytes",
                     "Resident bytes pinned in the hot tier", "gauge",
                     "bytes")):
                metric(name, help_, type_, [({}, hot[key])])
        # -- distributed plane: grid peer breakers, notify fan-out,
        #    cross-node coherence -----------------------------------------
        from minio_tpu_torch.grid import client as _grid_client
        from minio_tpu_torch.grid import peers as _grid_peers
        gstats = _grid_client.peer_stats()
        _STATE_NUM = {"closed": 0, "half-open": 1, "open": 2}
        metric("minio_tpu_grid_peer_state",
               "Per-peer grid circuit breaker state "
               "(0 closed, 1 half-open, 2 open)", "gauge",
               [({"peer": g["peer"]}, _STATE_NUM.get(g["state"], 2))
                for g in gstats])
        metric("minio_tpu_grid_peer_reconnects_total",
               "Grid connections re-established per peer", "counter",
               [({"peer": g["peer"]}, g["reconnects"]) for g in gstats])
        metric("minio_tpu_grid_peer_rpc_errors_total",
               "Grid transport failures per peer (timeouts, resets, "
               "refused connects; remote handler errors excluded)",
               "counter",
               [({"peer": g["peer"]}, g["rpc_errors"]) for g in gstats])
        # Native data plane (grid/loop.py epoll poller): multiplexed
        # stream frames, raw bulk transfer, zero-copy sendfile.
        # The port's grid data plane is always its epoll poller.
        from minio_tpu_torch.grid import loop as _grid_loop
        lst_ = _grid_loop.stats()
        metric("minio_tpu_grid_native_enabled",
               "1 when the native grid data plane is active "
               "(MTPU_GRID_NATIVE kill switch + epoll availability)",
               "gauge", [({}, 1)])
        metric("minio_tpu_grid_stream_raw_tx_frames_total",
               "Raw bulk frames sent on the native plane", "counter",
               [({}, lst_["raw_tx_frames"])])
        metric("minio_tpu_grid_stream_raw_tx_bytes_total",
               "Raw bulk payload bytes sent on the native plane",
               "counter", [({}, lst_["raw_tx_bytes"])])
        metric("minio_tpu_grid_stream_raw_rx_frames_total",
               "Raw bulk frames received into pooled leases",
               "counter", [({}, lst_["raw_rx_frames"])])
        metric("minio_tpu_grid_stream_raw_rx_bytes_total",
               "Raw bulk payload bytes received into pooled leases",
               "counter", [({}, lst_["raw_rx_bytes"])])
        metric("minio_tpu_grid_stream_credit_stalls_total",
               "Times a bulk sender parked on an exhausted credit "
               "window (receiver not draining)", "counter",
               [({}, lst_["credit_stalls"])])
        metric("minio_tpu_grid_sendfile_transfers_total",
               "Shard transfers shipped via os.sendfile (zero "
               "Python-level copies send-side)", "counter",
               [({}, lst_["sendfile_transfers"])])
        metric("minio_tpu_grid_sendfile_bytes_total",
               "Bytes shipped via os.sendfile", "counter",
               [({}, lst_["sendfile_bytes"])])
        nst = _grid_peers.notify_stats()
        metric("minio_tpu_peer_notify_sent_total",
               "Peer reload notifications acknowledged", "counter",
               [({}, nst["sent"])])
        metric("minio_tpu_peer_notify_failed_total",
               "Peer reload notifications that failed (best-effort "
               "path; the receiver's TTL/resync is the fallback)",
               "counter", [({}, nst["failed"])])
        coh = getattr(server, "coherence", None) if server is not None \
            else None
        if coh is not None:
            cst = coh.stats()
            metric("minio_tpu_cluster_peers_armed",
                   "Peers whose generation state is synced (caches "
                   "serve hits only with every peer armed)", "gauge",
                   [({}, cst["armed"])])
            metric("minio_tpu_cluster_gen_resyncs_total",
                   "Generation resync rounds completed against peers",
                   "counter", [({}, cst["resyncs"])])
            metric("minio_tpu_cluster_invalidations_applied_total",
                   "Cross-node cache invalidations applied locally "
                   "(pushed + recovered by resync)", "counter",
                   [({}, cst["inv_applied"])])
            metric("minio_tpu_cluster_invalidations_failed_total",
                   "Invalidation pushes a peer failed to ack "
                   "(escalated: logged, connection reset, covered by "
                   "the peer's next resync)", "counter",
                   [({}, cst["inv_failed"])])
        if peer_states:
            metric("minio_tpu_worker_in_flight",
                   "In-flight requests per pre-forked worker", "gauge",
                   [({"worker": p.get("worker", "?")},
                     p.get("in_flight", 0))
                    for p in peer_states if not p.get("unreachable")])
            metric("minio_tpu_worker_up",
                   "Pre-forked worker control-plane reachability",
                   "gauge",
                   [({"worker": p.get("worker", "?")},
                     0 if p.get("unreachable") else 1)
                    for p in peer_states])
            metric("minio_tpu_workers_total",
                   "Configured pre-forked worker count", "gauge",
                   [({}, len(peer_states))])

        # -- SLO engine (utils/slo.py): burn-rate / budget gauges ------
        slo = getattr(server, "slo", None) if server is not None else None
        if slo is not None:
            snap = slo.snapshot(metrics=self)
            objs = snap.get("objectives", [])
            verdict_code = {"pass": 0, "warn": 1, "burn": 2}
            metric("minio_tpu_slo_objectives",
                   "Declared SLO objectives under continuous "
                   "evaluation", "gauge", [({}, len(objs))])
            metric("minio_tpu_slo_burn_rate",
                   "Error-budget burn rate per objective (1.0 = "
                   "burning exactly the declared budget)", "gauge",
                   [({"objective": o["name"]}, o["burn_rate"])
                    for o in objs])
            metric("minio_tpu_slo_error_budget_remaining",
                   "Fraction of the declared error budget left in the "
                   "rolling window", "gauge",
                   [({"objective": o["name"]}, o["budget_remaining"])
                    for o in objs])
            metric("minio_tpu_slo_p99_seconds",
                   "Observed p99 latency of the objective's API class "
                   "over the last minute", "gauge",
                   [({"objective": o["name"]}, o["p99_s"])
                    for o in objs])
            metric("minio_tpu_slo_shed_rate",
                   "Fraction of the objective's requests shed (503) in "
                   "the rolling window", "gauge",
                   [({"objective": o["name"]}, o["shed_rate"])
                    for o in objs])
            metric("minio_tpu_slo_verdict",
                   "Objective verdict: 0 pass, 1 warn, 2 burn",
                   "gauge",
                   [({"objective": o["name"]},
                     verdict_code.get(o["verdict"], 2)) for o in objs])

        # -- cluster federation: per-node identity families ------------
        if node_states:
            node_rows = []
            for ns in node_states:
                if isinstance(ns, dict):
                    node_rows.append((ns.get("node", "?") or "?", ns))
            metric("minio_tpu_cluster_node_up",
                   "Per-node reachability of the cluster telemetry "
                   "verb (peer.metrics)", "gauge",
                   [({"node": n}, 0 if ns.get("unreachable") else 1)
                    for n, ns in node_rows])
            req_rows, slow_rows, lm_rows = [], [], []
            for n, ns in node_rows:
                if ns.get("unreachable"):
                    continue
                total = 0
                wins = []
                for st in ns.get("states") or []:
                    if not isinstance(st, dict):
                        continue
                    total += sum(v for _, _, v in
                                 st.get("requests", []))
                    wins.extend(w for w in
                                st.get("last_minute", {}).values())
                req_rows.append(({"node": n}, total))
                slow_rows.append(({"node": n}, ns.get("slow_ops", 0)))
                if wins:
                    summ = summarize(LastMinute.merge(wins))
                    for q in ("p50", "p99"):
                        lm_rows.append(({"node": n, "q": q},
                                        round(summ.get(q, 0.0), 6)))
            metric("minio_tpu_cluster_node_requests_total",
                   "HTTP requests served per cluster node (all APIs)",
                   "counter", req_rows)
            metric("minio_tpu_cluster_node_slow_ops_total",
                   "Slow-op records per cluster node", "counter",
                   slow_rows)
            metric("minio_tpu_cluster_node_last_minute_seconds",
                   "Last-minute request latency quantiles per node "
                   "(all APIs merged)", "gauge", lm_rows)

        return "\n".join(lines) + "\n"


def layer_sets(object_layer) -> list:
    """Erasure sets behind any object-layer shape (set / sets / pools)."""
    pools = getattr(object_layer, "pools", None)
    if pools is not None:
        return [s for p in pools for s in p.sets]
    sets = getattr(object_layer, "sets", None)
    if sets is not None:
        return list(sets)
    return [object_layer] if hasattr(object_layer, "disks") else []


def probe_disks(object_layer) -> list:
    """(set_idx, disk, DiskInfo-or-None) for every drive, probed in
    PARALLEL per set — one hung remote drive must not stack its timeout
    onto every other drive's (health probes have deadlines)."""
    out = []
    for si, s in enumerate(layer_sets(object_layer)):
        fanout = getattr(s, "_fanout", None)
        if fanout is not None:
            results, _ = fanout([lambda d=d: d.disk_info()
                                 for d in s.disks])
        else:  # pragma: no cover - every set has _fanout
            results = []
            for d in s.disks:
                try:
                    results.append(d.disk_info())
                except Exception:  # noqa: BLE001
                    results.append(None)
        for d, di in zip(s.disks, results):
            out.append((si, d, di))
    return out


def _lag_summary(state: dict) -> dict:
    """Approximate p50/p99 in milliseconds from a bucketed histogram
    state (latency.percentile: upper bound of the quantile's bucket)."""
    from minio_tpu_torch.utils.latency import percentile
    counts = state.get("counts", [])
    total = state.get("count", 0)
    return {
        "count": total,
        "mean_ms": round(1000.0 * state.get("sum", 0.0) / total, 3)
        if total else 0.0,
        "p50_ms": round(percentile(counts, total, 0.5) * 1000.0, 3),
        "p99_ms": round(percentile(counts, total, 0.99) * 1000.0, 3),
    }


def merge_loop_stats(stats_list) -> dict:
    """Fleet merge of per-worker EventLoopServer.stats() snapshots:
    counters and gauges sum, max_conns sums (fleet capacity), the
    loop-lag histograms merge."""
    out = {"enabled": False, "parked": 0, "active": 0, "writing": 0,
           "max_conns": 0, "accepted_total": 0, "shed_total": 0,
           "reparks_total": 0, "reaped_idle_total": 0,
           "dispatch_total": 0, "hot_hits_total": 0,
           "executor_threads": 0, "executor_queue": 0}
    lags = []
    for st in stats_list:
        if not isinstance(st, dict):
            continue
        out["enabled"] = out["enabled"] or bool(st.get("enabled"))
        for k in list(out):
            if k != "enabled":
                out[k] += st.get(k, 0)
        if st.get("loop_lag"):
            lags.append(st["loop_lag"])
    if lags:
        out["loop_lag"] = Histogram.merge(lags)
    return out


def peer_metrics_state(server) -> dict:
    """One node's telemetry snapshot for the cluster-federation verb
    (grid `peer.metrics`): every local worker's Metrics.state() —
    fleet-merged through the pre-forked hub exactly the way a local
    scrape merges them, one topology level down — plus the node's
    slow-op total and replication lag summary, all under the node's
    self-declared identity. JSON/mpack-safe by construction."""
    states = []
    cs = getattr(server, "cluster_stats", None)
    if cs is not None:
        try:
            states = [w["metrics"] for w in cs()
                      if isinstance(w.get("metrics"), dict)]
        except Exception:  # noqa: BLE001 - serve own snapshot
            states = []
    if not states:
        states = [server.metrics.state()]
    return {"node": getattr(server, "node_id", "") or "",
            "states": states,
            "slow_ops": _tracing.slow_total}


def node_info(server) -> dict:
    """One node's admin-info summary (drives, usage, heal state) —
    served locally by the admin handler and remotely over the grid's
    peer.info endpoint so cluster info covers every node (reference:
    cmd/notification.go ServerInfo fan-out)."""
    scanner = getattr(server, "scanner", None)
    sets = layer_sets(server.object_layer)
    drives = []
    for si, d, di in probe_disks(server.object_layer):
        entry = {"set": si,
                 "endpoint": getattr(d, "endpoint", "")
                 or getattr(d, "root", "")}
        if di is not None:
            entry.update(state="ok", total=di.total,
                         used=di.used, free=di.free)
        else:
            entry.update(state="offline")
        drives.append(entry)
    usage = {}
    total_objects = 0
    if scanner is not None:
        u = scanner.usage
        total_objects = u.objects
        usage = {"objects": u.objects, "versions": u.versions,
                 "total_size": u.total_size,
                 "buckets": len(u.buckets),
                 "last_update": u.last_update}
    info = {
        "mode": "online",
        "node": getattr(server, "node_id", "") or "",
        "sets": len(sets),
        "drives": drives,
        "drives_online": sum(1 for d in drives if d["state"] == "ok"),
        "drives_offline": sum(1 for d in drives if d["state"] != "ok"),
        "objects": total_objects,
        "usage": usage,
        "heal": server.heal_status,
    }
    if getattr(server, "drive_heal", None) is not None:
        try:
            info["drive_heal"] = server.drive_heal.status()
        except Exception:  # noqa: BLE001 - status best effort
            pass
    # Elastic-fleet migrations (object/decom.py + object/rebalance.py):
    # the any-node status docs — a live local driver's counters when
    # this node coordinates, else the persisted rev-voted checkpoint.
    for sec, attr in (("decommission", "decommission_status"),
                      ("rebalance", "rebalance_status")):
        fn = getattr(server.object_layer, attr, None)
        if fn is not None:
            try:
                st = fn()
                if st:
                    info[sec] = st
            except Exception:  # noqa: BLE001 - status best effort
                pass
    adm = getattr(server, "admission", None)
    if adm is not None:
        # Shed/queue/deadline counters per request class: the operator-
        # facing view of admission control (reference: madmin info's
        # requests fields).
        info["admission"] = adm.snapshot()
    aud = getattr(server, "audit", None)
    if aud is not None:
        info["audit"] = aud.stats()
    # Rolling last-minute latency per API + the recent slow-op records
    # (deep tracing's operator surface: a slow GET names its slow
    # span ancestry here without any trace subscriber attached).
    m = getattr(server, "metrics", None)
    if m is not None:
        info["last_minute"] = m.last_minute()
        # Connection plane (serve hot loop): open connections,
        # keep-alive reuse, native-parse fallbacks. Fleet-merged below
        # when the pre-forked control plane is up.
        info["http"] = m.http_conn_stats()
    # Event-loop connection plane (s3/eventloop.py): parked/active fd
    # gauges, accept/shed/re-park counters, loop-lag summary. Replaced
    # by the fleet merge below in worker mode.
    es = getattr(server, "eventloop_stats", None)
    loop_st = es() if es is not None else None
    if loop_st is not None:
        lag = loop_st.pop("loop_lag", None)
        if lag:
            loop_st["loop_lag_ms"] = _lag_summary(lag)
        info["connections"] = loop_st
    info["slow_ops"] = {"total": _tracing.slow_total,
                        "threshold_ms": _tracing.slow_ms(),
                        "recent": _tracing.slow_ops()[-20:]}
    # Continuous SLO engine (utils/slo.py): per-objective burn-rate /
    # remaining-budget with pass/warn/burn verdicts.
    slo = getattr(server, "slo", None)
    if slo is not None:
        try:
            info["slo"] = slo.snapshot(metrics=m)
        except Exception:  # noqa: BLE001 - verdicts are advisory
            pass
    # The staging pools (and, in worker mode, the whole fleet's
    # per-worker snapshots via the control pipe, below).
    from minio_tpu_torch.io.bufpool import pools_stats
    info["bufpool"] = pools_stats()
    fileinfo = []
    metacache = []
    for si, s in enumerate(sets):
        cache = getattr(s, "fi_cache", None)
        if cache is not None:
            fileinfo.append({"set": si, **cache.stats()})
        mc = getattr(s, "metacache", None)
        if mc is not None:
            metacache.append({"set": si, **mc.stats()})
    # Group-commit write plane: per-set lane occupancy + the process's
    # WAL checkpoint counters (storage/group_commit).
    from minio_tpu_torch.storage import group_commit as _gc_mod
    gst = _gc_mod.aggregate_stats()
    gst.pop("wait_hist", None)
    info["group_commit"] = gst
    info["fileinfo_cache"] = fileinfo
    # Hot-object read tier (object/hotcache.py): this process's cache;
    # replaced by the fleet merge below in worker mode.
    hc = getattr(server, "hot_cache", None)
    if hc is not None:
        info["hot_cache"] = hc.stats()
    from minio_tpu_torch.storage import meta_scan as _ms
    info["metacache"] = {"sets": metacache, "scan": dict(_ms.counters)}
    # Distributed plane: per-peer breaker states, notify fan-out
    # outcomes, and the coherence protocol's arm/generation state.
    from minio_tpu_torch.grid import client as _grid_client
    from minio_tpu_torch.grid import peers as _grid_peers
    gstats = _grid_client.peer_stats()
    if gstats:
        info["grid"] = {"peers": gstats,
                        "notify": _grid_peers.notify_stats()}
    coh = getattr(server, "coherence", None)
    if coh is not None:
        info["coherence"] = coh.stats()
    cluster = getattr(server, "cluster_stats", None)
    if cluster is not None:
        try:
            peers = cluster()
            info["workers"] = [
                {k: p.get(k) for k in ("worker", "pid", "in_flight",
                                       "unreachable", "bufpool",
                                       "fileinfo_cache", "hot_cache",
                                       "drive_heal", "connections")
                 if k in p}
                for p in peers]
            peer_hot = [p.get("hot_cache") for p in peers
                        if isinstance(p.get("hot_cache"), dict)]
            if peer_hot:
                hot_agg: dict = {}
                for pst in peer_hot:
                    for k, v in pst.items():
                        if isinstance(v, bool):
                            hot_agg[k] = bool(hot_agg.get(k)) or v
                        elif isinstance(v, (int, float)):
                            hot_agg[k] = hot_agg.get(k, 0) + v
                info["hot_cache"] = hot_agg
            http_tot = {"connections_active": 0, "keepalive_reuses": 0,
                        "parse_fallbacks": 0,
                        "response_path": {"sendfile": 0, "pooled": 0,
                                          "legacy": 0}}
            merged = False
            for p in peers:
                st = p.get("metrics")
                if isinstance(st, dict):
                    merged = True
                    http_tot["connections_active"] += \
                        st.get("conn_active", 0)
                    http_tot["keepalive_reuses"] += \
                        st.get("keepalive_reuses", 0)
                    http_tot["parse_fallbacks"] += \
                        st.get("parse_fallbacks", 0)
                    for k, v in st.get("response_path", {}).items():
                        http_tot["response_path"][k] = \
                            http_tot["response_path"].get(k, 0) + v
            if merged:
                info["http"] = http_tot
            peer_loops = [p.get("connections") for p in peers
                          if isinstance(p.get("connections"), dict)]
            if peer_loops:
                fleet = merge_loop_stats(peer_loops)
                lag = fleet.pop("loop_lag", None)
                if lag:
                    fleet["loop_lag_ms"] = _lag_summary(lag)
                info["connections"] = fleet
        except Exception:  # noqa: BLE001 - control plane down; own view
            info["workers"] = [{"worker": getattr(server, "worker_id", 0),
                                "pid": os.getpid(),
                                "in_flight": server._inflight}]
    return info

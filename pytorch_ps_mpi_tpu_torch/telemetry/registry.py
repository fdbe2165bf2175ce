"""MetricsRegistry: counters, gauges, bucketed histograms, Prometheus text
(the JAX package's ``telemetry/registry.py``, which imports no framework).

One canonical metric schema for every PS server (shm and TCP emit
*identical* keys — enforced by ``tests/test_telemetry.py``), rendered in
the Prometheus text exposition format so a stock scraper reads the TCP
server's ``/metrics`` endpoint (:class:`.http_server.MetricsHTTPServer`)
and the shm server's :meth:`PSServerTelemetry.prometheus_text` scrape
method without translation.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_INF = float("inf")


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without the trailing .0,
    +Inf spelled the Prometheus way."""
    if v == _INF:
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_text(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        with self._lock:
            self.value += n

    def set(self, v: float) -> None:
        """Mirror an externally-tracked monotonic count (the scrape-time
        collector path: servers keep their own counters, the registry
        reflects them)."""
        with self._lock:
            self.value = float(v)

    def render(self) -> List[str]:
        return [f"{self.name}{_labels_text(self.labels)} {_fmt(self.value)}"]


class Gauge:
    """Point-in-time value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def render(self) -> List[str]:
        return [f"{self.name}{_labels_text(self.labels)} {_fmt(self.value)}"]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf is implicit)."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float], help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            i = 0
            while i < len(self.bounds) and v > self.bounds[i]:
                i += 1
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def load(self, value_counts: Dict[Any, int]) -> None:
        """Mirror an externally-kept ``{value: count}`` histogram (e.g. a
        server's ``staleness_seen``) — replaces current contents. Built
        locally and swapped under ONE lock acquisition so concurrent
        scrapes (ThreadingHTTPServer runs collectors per request) can
        never interleave a reset with another scrape's adds. The source
        dict is snapshotted atomically first — it is typically the live
        ``staleness_seen`` the serve thread is inserting into."""
        counts = [0] * (len(self.bounds) + 1)
        total_sum, total_n = 0.0, 0
        for v, n in list(value_counts.items()):
            v, n = float(v), int(n)
            i = 0
            while i < len(self.bounds) and v > self.bounds[i]:
                i += 1
            counts[i] += n
            total_sum += v * n
            total_n += n
        with self._lock:
            self.counts = counts
            self.sum = total_sum
            self.count = total_n

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-quantile observation falls in) — good enough for the report
        table; exact values live in the flight recorder."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                return self.bounds[i] if i < len(self.bounds) else _INF
        return _INF

    def approx_quantile(self, q: float) -> float:
        """Interpolated quantile (Prometheus ``histogram_quantile``
        semantics): observations are assumed uniform within each bucket
        and the q-quantile position is linearly interpolated between the
        bucket's edges — so p95 of a histogram is a value, not just
        "somewhere ≤ bound". Observations in the +Inf overflow bucket
        degrade to the highest finite bound (same clamp Prometheus
        applies). NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts, total = list(self.counts), self.count
        if total == 0:
            return math.nan
        target = q * total
        cum = 0
        # the first bucket's lower edge: 0 for the nonneg histograms this
        # registry holds (latencies, staleness), else the bound itself
        lo = 0.0 if self.bounds[0] > 0 else float(self.bounds[0])
        for i, c in enumerate(counts):
            if i >= len(self.bounds):
                return float(self.bounds[-1])  # overflow bucket: clamp
            hi = float(self.bounds[i])
            if cum + c >= target and c:
                frac = (target - cum) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            cum += c
            lo = hi
        return float(self.bounds[-1])

    def render(self) -> List[str]:
        out = []
        cum = 0
        for b, c in zip(self.bounds + [_INF], self.counts):
            cum += c
            labels = dict(self.labels)
            labels["le"] = _fmt(b)
            out.append(f"{self.name}_bucket{_labels_text(labels)} {cum}")
        lt = _labels_text(self.labels)
        out.append(f"{self.name}_sum{lt} {_fmt(self.sum)}")
        out.append(f"{self.name}_count{lt} {self.count}")
        return out


class MetricsRegistry:
    """Named instruments + scrape-time collectors, rendered as Prometheus
    text. ``counter``/``gauge``/``histogram`` are get-or-create (same
    name returns the same instrument; a kind clash raises)."""

    def __init__(self) -> None:
        self._metrics: "Dict[str, Any]" = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, *args, **kw):
        # labeled instruments are distinct series under one metric name
        # (the Prometheus model: ``name{worker="1"}``); the registry key
        # carries the label set so per-worker counters coexist with the
        # unlabeled total
        key = name + _labels_text(kw.get("labels"))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, *args, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "", **kw) -> Counter:
        return self._get_or_create(Counter, name, help, **kw)

    def gauge(self, name: str, help: str = "", **kw) -> Gauge:
        return self._get_or_create(Gauge, name, help, **kw)

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "", **kw) -> Histogram:
        return self._get_or_create(Histogram, name, buckets, help, **kw)

    def get(self, name: str):
        return self._metrics.get(name)

    def add_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        """Register a scrape-time callback that refreshes instruments
        from external state (server counters) before each render."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in list(self._collectors):
            fn(self)

    def to_dict(self) -> Dict[str, float]:
        """Flat snapshot for tests/JSON: counters+gauges by name,
        histograms as ``name_sum``/``name_count``."""
        self.collect()
        out: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lt = _labels_text(m.labels)
            if isinstance(m, Histogram):
                out[f"{m.name}{lt}_sum"] = m.sum
                out[f"{m.name}{lt}_count"] = float(m.count)
            else:
                out[f"{m.name}{lt}"] = m.value
        return out

    def prometheus_text(self) -> str:
        self.collect()
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: (m.name, _labels_text(m.labels)))
        last_name = None
        for m in metrics:
            if m.name != last_name:  # HELP/TYPE once per metric name,
                # however many labeled series it has
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                last_name = m.name
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Canonical PS-server schema (shm + TCP emit IDENTICAL keys/types)
# ---------------------------------------------------------------------------

#: The canonical ``metrics()`` dict keys every PS server emits, all float
#: (the reference's msg/packaged-bytes accounting, ``ps.py:135-136``,
#: plus the async protocol's staleness drop counter).
PS_SERVER_METRIC_KEYS: Tuple[str, ...] = (
    # sample ordering/aging for the fleet poller (telemetry.fleet): ts
    # is the wall clock at metrics() time, uptime_s the monotonic age of
    # this server PROCESS GENERATION (a supervisor restart resets it —
    # how the poller tells a respawned generation from a stale scrape)
    "ts",
    "uptime_s",
    "grads_received",
    "bytes_received",
    "raw_bytes_per_grad",
    "wire_bytes_per_grad",
    "compression_ratio",
    "stale_drops",
    # flat-bucket wire accounting (bucketing.BucketPlan on the CodecWire):
    # bucket_count == 0 means the per-leaf wire; wire_units_per_push is
    # the number of contiguous payload buffers one gradient push ships
    # (buckets when bucketing, leaves otherwise)
    "bucket_count",
    "wire_units_per_push",
    # self-verifying wire frames (resilience.frames): pushes whose frame
    # failed validation (corruption, config drift, size) — always 0 when
    # frame checking is off
    "frames_rejected",
    # staleness distribution summary (exact weighted quantiles over
    # ``staleness_seen``; the scrape registry mirrors them as the
    # ps_staleness_p* gauges via Histogram.approx_quantile) — the
    # headline numbers of the staleness/convergence tradeoff, 0.0 before
    # any gradient arrives
    "staleness_p50",
    "staleness_p95",
    "staleness_p99",
    # numerics observability (telemetry.numerics.NumericsMonitor): all
    # 0.0 when numerics is unarmed. nonfinite_total counts NaN/Inf
    # PUSHES (frames, not elements); grad_norm is the last healthy
    # consumed gradient's finite L2 norm; update_ratio is ||dp||/||p||
    # at the last probe; codec_rel_error / ef_residual_norm mirror the
    # latest worker-side codec-fidelity probe
    "nonfinite_total",
    "grad_norm",
    "update_ratio",
    "codec_rel_error",
    "ef_residual_norm",
    # gradient lineage (telemetry.lineage.LineageTracker): all 0.0 when
    # lineage is unarmed. lineage_pushes counts pushes billed to a
    # published version; push_e2e_p*_ms are EXACT per-push end-to-end
    # latencies (worker encode -> version published) measured from the
    # v2 frame headers' trace IDs — the measured numbers the health
    # interarrival EWMAs only estimate
    "lineage_pushes",
    "push_e2e_p50_ms",
    "push_e2e_p95_ms",
    # round anatomy (telemetry.anatomy.RoundAnatomy): all 0.0 when
    # anatomy is unarmed. anatomy_rounds counts published versions
    # decomposed into exact stage-level critical paths;
    # anatomy_wire_share is the fraction of those rounds gated by the
    # wire stage (the controller's regime signal, measured not
    # estimated); anatomy_top_saving_frac is the advisor's best
    # projected round-time saving at a 20% Coz-style virtual speedup
    "anatomy_rounds",
    "anatomy_wire_share",
    "anatomy_top_saving_frac",
    # homomorphic aggregation (Codec.aggregate + the CodecWire
    # aggregator): agg_mode is 1.0 while the serve loop folds pushes
    # into a compressed accumulator (0.0 unarmed); decodes_per_publish
    # is decodes over gradient-composed publishes (== 1.0 in aggregation
    # mode, ~world-size on the sync decode-sum path, ALSO 1.0 on the
    # async path where every push publishes — read it WITH agg_mode,
    # 0.0 before any publish); agg_fallbacks counts pushes that took
    # the decode-sum
    # path while cfg["agg"] == "on" explicitly requested aggregation
    "agg_mode",
    "decodes_per_publish",
    "agg_fallbacks",
    # hierarchical aggregation (parallel.tree): worker pushes composed
    # through lineage trailers on every VALID tree-wire frame this
    # server validated (stale-dropped frames included — tree drivers
    # stop on this exact count); 0.0 on a non-tree server
    "tree_composed",
    # parameter-serving read tier (serving.ServingCore): all 0.0 when the
    # read tier is unarmed. reads_total counts read-tier requests served
    # (plus, on TCP, the transport's own native GET_PARAMS worker reads);
    # read_p50/p95_ms are read-tier service times; delta_bytes_saved is
    # payload bytes delta replies avoided vs full snapshots; reads_shed
    # counts admission-control rejections (explicit retry-after replies);
    # coalesce_hits counts delta reads served from an existing encode;
    # reads_not_modified counts version-conditional reads answered with
    # no payload (read tier + the native conditional GET_PARAMS path)
    "reads_total",
    "read_p50_ms",
    "read_p95_ms",
    "delta_bytes_saved",
    "reads_shed",
    "coalesce_hits",
    "reads_not_modified",
    # native read plane + follower tier (serving.native_read /
    # serving.follower): native_read_conns is the reader connections
    # currently open on the C++ epoll tier (0.0 on the Python loop);
    # replica_lag_versions is how many versions this replica trailed its
    # upstream at the last pull (0.0 standalone/current);
    # follower_bytes_relayed counts bytes pulled from upstream and
    # re-served by this follower (0.0 when not following)
    "native_read_conns",
    "replica_lag_versions",
    "follower_bytes_relayed",
    # self-driving control plane (control.Controller): all 0.0 when the
    # controller is unarmed. control_actions counts executed controller
    # actions (codec renegotiations, LR re-weights, evict/readmit,
    # read-tier tuning); control_epoch is the current wire epoch (codec
    # renegotiations since boot — the frame-fingerprint handshake's
    # generation counter); control_evicted is the number of workers
    # currently backoff-evicted from the sync barrier;
    # control_lr_scale_min is the smallest per-worker staleness LR
    # weight in force (1.0 = nobody de-weighted; 0.0 only when unarmed)
    "control_actions",
    "control_epoch",
    "control_evicted",
    "control_lr_scale_min",
    # structural control (the controller's topo rule): all 0.0 when
    # topo_actions is unarmed. topo_actions counts structural actions
    # (group replans/merges, replica scale, shard plans); replicas_live
    # is the read replicas the elastic tier currently runs;
    # group_replans is the tree splits currently in force (a merge
    # decrements — 0.0 means the boot topology)
    "topo_actions",
    "replicas_live",
    "group_replans",
    # read-path freshness plane (telemetry.freshness / serving.core):
    # all 0.0 until a publish stamps an FRS1 birth record.
    # read_fresh_p50_ms / read_fresh_p95_ms are publish→visible-here
    # latency quantiles over the last window of stamped versions (root
    # clock, skew-corrected per hop); serving_age_ms is the wall age of
    # the OLDEST tenant's currently-served version (the age-of-
    # information gauge — grows between publishes, snaps down on each);
    # fresh_hop_count is the deepest hop chain a served trailer carries
    # (0.0 at the root, N at an N-hop edge replica)
    "read_fresh_p50_ms",
    "read_fresh_p95_ms",
    "serving_age_ms",
    "fresh_hop_count",
    # leader hop anatomy (telemetry.hop_anatomy): the leader-pipeline
    # occupancy plane. All neutral (0.0; headroom 1.0) until hop rounds
    # land. hop_busy_frac is the median share of the hop window spent
    # WORKING (validate/fold/finalize/encode/push vs waiting);
    # hop_ingest_wait_ms the median per-round wait for group pushes;
    # hop_stream_headroom_ratio the median serial/overlapped projection
    # (≫1 = a streaming leader hop would pay, ≈1 = pipeline already
    # busy — split instead); hop_ring_drops counts native interval-ring
    # entries surrendered to overflow (bounded rings never block)
    "hop_rounds",
    "hop_busy_frac",
    "hop_ingest_wait_ms",
    "hop_stream_headroom_ratio",
    "hop_serial_ms",
    "hop_ring_drops",
)

#: The canonical-key subset the ``/health`` fleet rollup republishes
#: (``diagnosis.HealthMonitor.snapshot`` imports THIS — the rollup used
#: to hand-list keys inline, the drift class psanalyze's
#: metrics-surface rule now lints against). Must stay a subset of the
#: canonical schema; checked here so a bad edit fails at import, and
#: statically by ``tools/psanalyze``.
HEALTH_FLEET_ROLLUP_KEYS: Tuple[str, ...] = (
    "grads_received",
    "stale_drops",
    "staleness_p50",
    "staleness_p95",
    "staleness_p99",
    "agg_mode",
    "decodes_per_publish",
    "agg_fallbacks",
    "control_actions",
    "control_epoch",
    "native_read_conns",
    "replica_lag_versions",
    "follower_bytes_relayed",
    "hop_busy_frac",
    "hop_stream_headroom_ratio",
)
assert set(HEALTH_FLEET_ROLLUP_KEYS) <= set(PS_SERVER_METRIC_KEYS)


def staleness_quantile(seen: Dict[Any, int], q: float) -> float:
    """Exact weighted q-quantile of a ``{staleness_value: count}`` dict
    (the server's ``staleness_seen``); 0.0 when empty. Snapshots the
    dict in ONE C-level call first — scrapes run on the HTTP thread
    while the serve loop inserts, and a Python-level iteration over the
    live dict would intermittently raise 'changed size during
    iteration' into a 500."""
    items = sorted(seen.items())  # atomic under the GIL (no bytecode)
    total = sum(int(n) for _, n in items)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    for v, n in items:
        cum += int(n)
        if cum >= target:
            return float(v)
    return float(items[-1][0])


def _native_read_stats(server) -> Tuple[int, int]:
    """The transport's own worker reads (TCP ``GET_PARAMS``): total and
    not-modified replies (``parallel/tcp.py`` keeps them as
    ``_reads_total``/``_reads_not_modified``)."""
    return (int(getattr(server, "_reads_total", 0)),
            int(getattr(server, "_reads_not_modified", 0)))


def ps_server_metrics(server) -> Dict[str, float]:
    """The ONE implementation of the canonical server ``metrics()`` dict
    (both transports call this — the schema cannot fork again)."""
    if server.wire is not None:
        raw = float(server.wire.raw_bytes)
        wire = float(server.wire.wire_bytes)
        plan = getattr(server.wire, "plan", None)
        buckets = float(plan.num_buckets) if plan is not None else 0.0
        units = float(
            plan.num_buckets if plan is not None
            else len(server.wire.shapes)
        )
    else:
        # the no-codec wire ships ONE concatenated f32 buffer per push
        n = int(getattr(server, "_flat_params", 0))
        raw = wire = float(n * 4)
        buckets = 0.0
        units = 1.0 if n else 0.0
    nm = getattr(server, "numerics_monitor", None)
    lt = getattr(server, "lineage_tracker", None)
    an = getattr(server, "anatomy", None)
    ha = getattr(server, "hop_anatomy", None)
    sc = getattr(server, "serving_core", None)
    cl = getattr(server, "controller", None)
    rm = sc.read_metrics() if (sc is not None and sc.armed) else {}
    # the transport's own worker-read path (TCP GET_PARAMS) counts too:
    # totals and cheap not-modified replies ride the same canonical keys
    nat_total, nat_nm = _native_read_stats(server)
    t0_mono = getattr(server, "_t0_mono", None)
    if t0_mono is None:  # fake/test servers: anchor at first metrics()
        t0_mono = server.__dict__.setdefault("_t0_mono", time.monotonic())
    return {
        "ts": time.time(),
        "uptime_s": max(0.0, time.monotonic() - t0_mono),
        "grads_received": float(server.grads_received),
        "bytes_received": float(server.bytes_received),
        "raw_bytes_per_grad": raw,
        "wire_bytes_per_grad": wire,
        "compression_ratio": raw / wire,
        "stale_drops": float(server.stale_drops),
        "bucket_count": buckets,
        "wire_units_per_push": units,
        "frames_rejected": float(getattr(server, "frames_rejected_total", 0)),
        "staleness_p50": staleness_quantile(server.staleness_seen, 0.50),
        "staleness_p95": staleness_quantile(server.staleness_seen, 0.95),
        "staleness_p99": staleness_quantile(server.staleness_seen, 0.99),
        "nonfinite_total": float(
            nm.nonfinite_frames_total if nm is not None else 0.0),
        "grad_norm": float(nm.last_grad_norm if nm is not None else 0.0),
        "update_ratio": float(
            (nm.update_ratio or 0.0) if nm is not None else 0.0),
        "codec_rel_error": float(
            nm.codec_rel_error if nm is not None else 0.0),
        "ef_residual_norm": float(
            nm.ef_residual_norm if nm is not None else 0.0),
        "agg_mode": float(getattr(server, "agg_mode", 0.0)),
        "decodes_per_publish": (
            float(getattr(server, "decodes_done", 0))
            / max(1.0, float(getattr(server, "grad_publishes", 0)))
            if getattr(server, "grad_publishes", 0) else 0.0),
        "agg_fallbacks": float(getattr(server, "agg_fallbacks", 0)),
        "tree_composed": float(getattr(server, "tree_composed", 0)),
        "lineage_pushes": float(lt.composed if lt is not None else 0.0),
        "push_e2e_p50_ms": float(
            lt.e2e_ms_quantile(0.50) if lt is not None else 0.0),
        "push_e2e_p95_ms": float(
            lt.e2e_ms_quantile(0.95) if lt is not None else 0.0),
        "anatomy_rounds": float(an.rounds if an is not None else 0.0),
        "anatomy_wire_share": float(
            an.wire_share() if an is not None else 0.0),
        "anatomy_top_saving_frac": float(
            an.top_saving_frac() if an is not None else 0.0),
        "reads_total": rm.get("reads_total", 0.0) + float(nat_total),
        "read_p50_ms": rm.get("read_p50_ms", 0.0),
        "read_p95_ms": rm.get("read_p95_ms", 0.0),
        "delta_bytes_saved": rm.get("delta_bytes_saved", 0.0),
        "reads_shed": rm.get("reads_shed", 0.0),
        "coalesce_hits": rm.get("coalesce_hits", 0.0),
        "reads_not_modified": (rm.get("reads_not_modified", 0.0)
                               + float(nat_nm)),
        "native_read_conns": rm.get("native_read_conns", 0.0),
        "replica_lag_versions": rm.get("replica_lag_versions", 0.0),
        "follower_bytes_relayed": rm.get("follower_bytes_relayed", 0.0),
        "control_actions": float(
            cl.actions_total if cl is not None else 0.0),
        "control_epoch": float(cl.epoch if cl is not None else 0.0),
        "control_evicted": float(
            len(cl.evicted) if cl is not None else 0.0),
        "control_lr_scale_min": float(
            cl.lr_scale_min() if cl is not None else 0.0),
        "topo_actions": float(
            cl.topo_actions_total if cl is not None else 0.0),
        "replicas_live": float(
            cl.replicas_live if cl is not None else 0.0),
        "group_replans": float(
            cl.group_replans if cl is not None else 0.0),
        "read_fresh_p50_ms": rm.get("read_fresh_p50_ms", 0.0),
        "read_fresh_p95_ms": rm.get("read_fresh_p95_ms", 0.0),
        "serving_age_ms": rm.get("serving_age_ms", 0.0),
        "fresh_hop_count": rm.get("fresh_hop_count", 0.0),
        "hop_rounds": float(ha.rounds if ha is not None else 0.0),
        "hop_busy_frac": float(
            ha.busy_frac() if ha is not None else 0.0),
        "hop_ingest_wait_ms": float(
            ha.ingest_wait_ms() if ha is not None else 0.0),
        "hop_stream_headroom_ratio": float(
            ha.headroom_ratio() if ha is not None else 1.0),
        "hop_serial_ms": float(
            ha.serial_ms() if ha is not None else 0.0),
        "hop_ring_drops": float(
            ha.ring_drops if ha is not None else 0.0),
    }


def ps_server_registry(
    server, registry: Optional[MetricsRegistry] = None
) -> MetricsRegistry:
    """Attach a scrape-time collector mirroring ``server``'s state into
    Prometheus instruments (counters, gauges, and the staleness
    histogram). Scraping reads live server attributes — no hot-path
    bookkeeping is added to the serve loop."""
    reg = registry if registry is not None else MetricsRegistry()
    # per-unit buckets up to the bound, CAPPED: max_staleness can be huge
    # (tests use 10**9 to disable dropping) and bucket count must not
    # scale with it — beyond 32 the bound itself is the one extra edge
    ms = int(server.max_staleness)
    stale_buckets = sorted(set(list(range(min(ms, 32) + 2)) + [ms]))

    def collect(r: MetricsRegistry) -> None:
        m = ps_server_metrics(server)
        # sample ordering/aging for the fleet poller: every scrape is
        # stamped with its wall time + the server generation's uptime
        r.gauge("ps_scrape_ts_seconds",
                "wall-clock timestamp of this scrape").set(m["ts"])
        r.gauge("ps_uptime_seconds",
                "monotonic age of this server generation").set(
                    m["uptime_s"])
        r.counter("ps_grads_received_total",
                  "gradients consumed by the server").set(m["grads_received"])
        r.counter("ps_wire_bytes_received_total",
                  "payload bytes consumed").set(m["bytes_received"])
        r.counter("ps_stale_drops_total",
                  "gradients dropped for exceeding max_staleness").set(
                      m["stale_drops"])
        # per-worker labeled series ONLY (zero-filled for every
        # configured worker): an additional unlabeled total under the
        # same name would double PromQL aggregations like sum(...)
        rej_help = ("self-verifying frames rejected "
                    "(corruption / config drift / size mismatch)")
        rejected = getattr(server, "frames_rejected", {})
        for w in range(int(server.num_workers)):
            r.counter("ps_frames_rejected_total", rej_help,
                      labels={"worker": str(w)}).set(
                          float(rejected.get(w, 0)))
        r.gauge("ps_raw_bytes_per_grad",
                "dense f32 bytes of one gradient").set(m["raw_bytes_per_grad"])
        r.gauge("ps_wire_bytes_per_grad",
                "encoded payload bytes of one gradient").set(
                    m["wire_bytes_per_grad"])
        r.gauge("ps_compression_ratio",
                "raw/wire bytes").set(m["compression_ratio"])
        r.gauge("ps_bucket_count",
                "flat dtype-grouped buckets per gradient push "
                "(0 = per-leaf wire)").set(m["bucket_count"])
        r.gauge("ps_wire_units_per_push",
                "contiguous payload buffers one push ships "
                "(buckets when bucketing, leaves otherwise)").set(
                    m["wire_units_per_push"])
        r.gauge("ps_agg_mode",
                "1 while the serve loop aggregates pushes in the "
                "compressed domain (Codec.aggregate)").set(m["agg_mode"])
        r.gauge("ps_decodes_per_publish",
                "payload decodes per gradient-composed publish (~world "
                "on the sync decode-sum path; 1 under aggregation AND "
                "on the per-push async path — aggregation is armed only "
                "when ps_agg_mode is 1)").set(m["decodes_per_publish"])
        r.counter("ps_agg_fallbacks_total",
                  "pushes consumed via decode-sum while aggregation was "
                  "explicitly requested").set(m["agg_fallbacks"])
        r.counter("ps_tree_composed_total",
                  "worker pushes composed through hierarchical-tree "
                  "lineage trailers on valid frames").set(
                      m["tree_composed"])
        nat_total, nat_nm = _native_read_stats(server)
        r.counter("ps_native_reads_total",
                  "transport-level worker snapshot reads (GET_PARAMS)"
                  ).set(float(nat_total))
        r.counter("ps_native_reads_not_modified_total",
                  "transport-level reads answered with the cheap "
                  "not-modified reply").set(float(nat_nm))
        r.gauge("ps_publish_version",
                "latest published snapshot version").set(float(server.version))
        r.gauge("ps_num_workers", "configured worker count").set(
            float(server.num_workers))
        hist = r.histogram("ps_staleness", stale_buckets,
                           "observed gradient staleness (versions)")
        hist.load(server.staleness_seen)
        # quantile GAUGES beside the bucketed histogram: alert rules and
        # the /health snapshot read a number, not a bucket dict
        # (Histogram.approx_quantile — NaN-free: 0.0 before any gradient)
        for q, name in ((0.50, "ps_staleness_p50"),
                        (0.95, "ps_staleness_p95"),
                        (0.99, "ps_staleness_p99")):
            v = hist.approx_quantile(q)
            r.gauge(name,
                    f"observed gradient staleness p{int(q * 100)} "
                    "(interpolated, versions)").set(
                        0.0 if math.isnan(v) else v)

    reg.add_collector(collect)
    return reg


class PSServerTelemetry:
    """Mixin giving a PS server the canonical telemetry surface:
    ``metrics()`` (the canonical dict), ``scrape_registry()`` (a
    :class:`MetricsRegistry` that reads live server state at scrape
    time), ``prometheus_text()`` (the scrape method), and
    :meth:`start_metrics_http` (the ``/metrics`` + ``/health`` HTTP
    endpoint — transport-independent: it renders live Python state on a
    daemon thread and never touches a native transport handle, so the
    shm server serves it as readily as the TCP one). Also the home of
    the frame-rejection accounting both transports share: one
    misconfigured or corrupting worker becomes a counted, per-worker
    rejection stream instead of a server crash."""

    _telemetry_registry: Optional[MetricsRegistry] = None
    #: total self-verifying frames rejected (all workers)
    frames_rejected_total: int = 0
    #: payload decodes performed (per consumed push on the decode-sum
    #: path, ONE per round under homomorphic aggregation) — incremented
    #: by the transports' ``_decode_payload`` and by the serve loop's
    #: round finalize; numerator of ``decodes_per_publish``
    decodes_done: int = 0
    #: gradient-composed publishes (the serve loop's ``_post_update``
    #: site; the initial parameter publish is excluded) — denominator of
    #: ``decodes_per_publish``
    grad_publishes: int = 0
    #: 1.0 while the serve loop's compressed-domain aggregation is armed
    agg_mode: float = 0.0
    #: pushes consumed via decode-sum while ``cfg["agg"] == "on"``
    #: explicitly requested aggregation (auto-fallback visibility)
    agg_fallbacks: int = 0
    #: the attached online-diagnosis monitor (``/health``'s source),
    #: set by ``serve()`` when health is armed — see :mod:`.diagnosis`
    health_monitor: Optional[Any] = None
    #: the attached numerics monitor (grad-norm/NaN/codec-fidelity
    #: source for the canonical schema and ``/health``'s ``numerics``
    #: section), set by ``serve()`` when numerics is armed — see
    #: :mod:`.numerics`
    numerics_monitor: Optional[Any] = None
    #: the attached gradient-lineage tracker (trace-ID consumer — the
    #: exact e2e-latency/staleness source for the canonical schema, fed
    #: by ``resilience.frames.framed_poll``), set by ``serve()`` when
    #: lineage is armed — see :mod:`.lineage`
    lineage_tracker: Optional[Any] = None
    #: the last consumed push's frame-carried lineage meta (worker,
    #: step, seq, staleness, send/recv walls, decode_s), refreshed by
    #: ``framed_poll`` on every successful pop
    last_push_meta: Optional[Dict[str, Any]] = None
    #: the attached round-anatomy engine (exact per-round critical
    #: paths + what-if advisor — the ``anatomy_*`` canonical keys'
    #: source), set by :class:`~pytorch_ps_mpi_tpu_torch.telemetry.anatomy.
    #: RoundAnatomy` when lineage is armed — see :mod:`.anatomy`
    anatomy: Optional[Any] = None
    #: the attached parameter-serving core (snapshot ring + read tier +
    #: the canonical ``reads_*`` metrics source), set by
    #: :class:`~pytorch_ps_mpi_tpu_torch.serving.ServingCore` on construction
    serving_core: Optional[Any] = None
    #: the attached self-driving controller (the ``control_*`` canonical
    #: keys' source and ``/health``'s ``control`` section), set by
    #: :class:`~pytorch_ps_mpi_tpu_torch.control.Controller`
    controller: Optional[Any] = None
    #: old-epoch frames consumed during codec-renegotiation transitions
    #: (``renegotiate_wire`` keeps the retiring wire accepted: these
    #: frames would have been ``"config"`` rejections without it)
    epoch_old_frames: int = 0
    #: the retained metrics history (``/history``'s source), set by
    #: :meth:`arm_observability` — see :mod:`.timeseries`
    timeseries_db: Optional[Any] = None
    #: the SLO burn-rate watchdog (``/health``'s ``slo`` section and the
    #: ``ps_slo_*`` instruments), set by :meth:`arm_observability`
    slo_watchdog: Optional[Any] = None
    #: the fleet poller (``/fleet``'s source), set by
    #: :meth:`arm_observability` — see :mod:`.fleet`
    fleet_monitor: Optional[Any] = None
    #: the continuous sampling profiler, set (and started) by
    #: :meth:`arm_observability` — see :mod:`.profiler`
    profiler: Optional[Any] = None
    #: the read-path freshness tracker (publish→edge propagation rows +
    #: the age-of-information plane), set by :meth:`arm_observability`
    #: — see :mod:`.freshness`
    freshness_tracker: Optional[Any] = None
    #: the attached leader-hop occupancy profiler (the ``hop_*``
    #: canonical keys' source: per-round sub-stage intervals + the
    #: streaming-headroom projection), set by :meth:`arm_observability`
    #: when ``cfg["hop_anatomy"]`` is armed — see :mod:`.hop_anatomy`
    hop_anatomy: Optional[Any] = None

    @property
    def frames_rejected(self) -> Dict[int, int]:
        """Per-worker rejected-frame counts (lazily created)."""
        return self.__dict__.setdefault("_frames_rejected", {})

    def _reject_frame(self, worker: int, reason: str) -> None:
        d = self.frames_rejected
        d[worker] = d.get(worker, 0) + 1
        self.frames_rejected_total += 1
        reasons = self.__dict__.setdefault("reject_reasons", {})
        reasons[reason] = reasons.get(reason, 0) + 1
        from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

        record_event("ps.frame_rejected", worker=worker, reason=reason)

    def metrics(self) -> Dict[str, float]:
        """Canonical wire-observability schema, identical across
        transports (see :data:`PS_SERVER_METRIC_KEYS`)."""
        return ps_server_metrics(self)

    def scrape_registry(self) -> MetricsRegistry:
        if self._telemetry_registry is None:
            self._telemetry_registry = ps_server_registry(self)
        return self._telemetry_registry

    def prometheus_text(self) -> str:
        return self.scrape_registry().prometheus_text()

    def health_json(self) -> str:
        """The ``/health`` body: the attached monitor's verdict snapshot,
        or an explicit not-armed marker — a scraper can always tell
        "diagnosis off" from "fleet empty"."""
        import json

        mon = self.health_monitor
        if mon is None:
            m = ps_server_metrics(self)
            # ts/uptime_s on the monitor-less document too: the fleet
            # poller orders and ages every member's samples uniformly
            doc: Dict[str, Any] = {"armed": False, "workers": [],
                                   "ts": m["ts"],
                                   "uptime_s": round(m["uptime_s"], 3)}
            sc = self.serving_core
            if sc is not None and sc.armed:
                # a read-only / monitor-less server still reports its
                # serving tier: ring occupancy, queue depth, read counts
                doc["serving"] = sc.serving_snapshot()
            if self.anatomy is not None:
                # the monitor-less route still reports the round
                # anatomy: critical-path shares + the what-if advisor
                doc["anatomy"] = self.anatomy.snapshot()
            if self.slo_watchdog is not None:
                doc["slo"] = self.slo_watchdog.snapshot()
            if self.controller is not None:
                # the monitor-less route still reports the controller:
                # action counts, eviction state, epoch
                doc["control"] = self.controller.snapshot()
            if self.hop_anatomy is not None:
                # the monitor-less route still reports the hop anatomy:
                # sub-stage occupancy + the streaming-headroom board
                doc["hop"] = self.hop_anatomy.snapshot()
            if self.timeseries_db is not None:
                doc["history"] = self.timeseries_db.snapshot()
            return json.dumps(doc)
        return mon.render_json()

    def history_json(self, query: Optional[Dict[str, Any]] = None
                     ) -> "tuple[str, str]":
        """The ``/history`` body: the TSDB's query reply, or an explicit
        not-armed marker (as the unarmed ``/health``)."""
        import json

        db = self.timeseries_db
        if db is None:
            return (json.dumps({"armed": False, "key_names": []}),
                    "application/json")
        return db.render_http(query)

    def fleet_json(self, query: Optional[Dict[str, Any]] = None
                   ) -> "tuple[str, str]":
        """The ``/fleet`` body: the fleet poller's merged snapshot, or an
        explicit not-armed marker."""
        import json

        fm = self.fleet_monitor
        if fm is None:
            return (json.dumps({"armed": False, "members": {}}),
                    "application/json")
        return fm.render_http(query)

    def start_metrics_http(self, port: int = 0,
                           host: str = "0.0.0.0") -> int:
        """Serve ``prometheus_text()`` at ``http://host:port/metrics``
        and :meth:`health_json` at ``/health`` on a daemon thread
        (``port=0`` auto-assigns). Returns the bound port; idempotent —
        a second call returns the live endpoint's port. Torn down by
        :meth:`close_metrics_http` (every transport's ``close()`` calls
        it, so a supervisor restart can never leak the socket)."""
        if getattr(self, "_metrics_http", None) is None:
            from pytorch_ps_mpi_tpu_torch.telemetry.http_server import (
                MetricsHTTPServer,
            )

            # the routes read their monitors at REQUEST time: a monitor
            # attached after the listener started is served immediately
            self._metrics_http = MetricsHTTPServer(
                self.prometheus_text, port=port, host=host,
                routes={"/health": lambda: (self.health_json(),
                                            "application/json"),
                        "/history": self.history_json,
                        "/fleet": self.fleet_json},
            )
        return self._metrics_http.port

    def close_metrics_http(self) -> None:
        http = getattr(self, "_metrics_http", None)
        self._metrics_http = None
        if http is not None:
            http.close()

    # -- the observability plane ------------------------------------------
    def arm_observability(self, cfg: Dict[str, Any], *,
                          name: str = "server") -> None:
        """Attach the observability plane from the job ``cfg``
        (``registry.py:915``): the one wiring point ``serve()`` (through
        the ServingCore) and ``sharded.server_main`` share.

        - ``timeseries``/``timeseries_kw``: the in-process TSDB, sampled
          by :meth:`observability_tick` on the serve thread from host
          counters only, persisted into ``timeseries_dir`` (else
          ``telemetry_dir``), served at ``/history``;
        - ``slo``/``slo_kw``: the burn-rate watchdog over that TSDB (it
          arms the TSDB), verdicts into ``slo-<name>.jsonl``, the flight
          recorder and ``/health``'s ``slo`` section;
        - ``profile``/``profile_dir``/``profile_kw``: the continuous
          sampling profiler, started here, written to
          ``profile-<name>.txt`` by :meth:`finalize_observability`;
        - ``fleet``/``fleet_dir``/``fleet_kw``: the fleet poller behind
          ``/fleet``; with a ``fleet_dir`` and a live metrics endpoint
          this server registers itself there (``cfg["fleet_name"]`` or
          ``name``), so a restarted generation rejoins under its name;
        - ``freshness``/``freshness_kw`` and ``hop_anatomy``/
          ``hop_anatomy_kw``: the read-path freshness tracker and the
          leader-hop occupancy profiler, writing into ``telemetry_dir``.
        """
        out_dir = cfg.get("timeseries_dir") or cfg.get("telemetry_dir")
        if (cfg.get("timeseries") or cfg.get("timeseries_kw")
                or cfg.get("slo") or cfg.get("slo_kw")):
            from pytorch_ps_mpi_tpu_torch.telemetry.timeseries import \
                MetricsHistory

            self.timeseries_db = MetricsHistory(
                dir=out_dir, name=name, **(cfg.get("timeseries_kw") or {}))
        if cfg.get("slo") or cfg.get("slo_kw"):
            from pytorch_ps_mpi_tpu_torch.telemetry.slo import SLOWatchdog

            # attaches itself to self.slo_watchdog + scrape registry
            SLOWatchdog(self, cfg, history=self.timeseries_db, name=name,
                        dir=out_dir)
        if cfg.get("freshness") or cfg.get("freshness_kw"):
            from pytorch_ps_mpi_tpu_torch.telemetry.freshness import (
                FreshnessTracker,
            )

            # attaches itself to self.freshness_tracker + scrape
            # registry; freshness_kw overrides come through the cfg
            FreshnessTracker(self, cfg, name=name, dir=out_dir)
        if cfg.get("hop_anatomy") or cfg.get("hop_anatomy_kw"):
            from pytorch_ps_mpi_tpu_torch.telemetry.hop_anatomy import (
                HopAnatomy,
            )

            # attaches itself to self.hop_anatomy + scrape registry. A
            # tree leader FEEDS it per round (parallel.tree); the root
            # arms it too and replays the leaders' tailed rows into it
            HopAnatomy(self, cfg, name=name)
        if cfg.get("profile") or cfg.get("profile_dir"):
            from pytorch_ps_mpi_tpu_torch.telemetry.profiler import \
                SamplingProfiler

            self.profiler = SamplingProfiler(
                name=name,
                dir=cfg.get("profile_dir") or cfg.get("telemetry_dir"),
                **(cfg.get("profile_kw") or {})).start()
        if cfg.get("fleet") or cfg.get("fleet_dir"):
            from pytorch_ps_mpi_tpu_torch.telemetry import fleet as _fleet

            self.fleet_monitor = _fleet.FleetMonitor(
                endpoints=cfg.get("fleet_endpoints"),
                fleet_dir=cfg.get("fleet_dir"),
                **(cfg.get("fleet_kw") or {}))
            http = getattr(self, "_metrics_http", None)
            if cfg.get("fleet_dir") and http is not None:
                fname = str(cfg.get("fleet_name") or name)
                # extra card fields (a tree leader's group and members)
                # ride the registration verbatim
                _fleet.register_endpoint(
                    cfg["fleet_dir"], fname, http.port,
                    role=cfg.get("fleet_role", "server"),
                    **(cfg.get("fleet_meta") or {}))
                self.__dict__["_fleet_registration"] = (
                    cfg["fleet_dir"], fname)

    def observability_tick(self) -> None:
        """Sample the TSDB and evaluate the SLO rules, from the owning
        loop at tick cadence on the transport pumps' thread. The sample
        is :meth:`metrics`: host counters, never a device read. One
        attribute check when nothing is armed."""
        db = self.timeseries_db
        if db is not None:
            db.sample(self.metrics())
            wd = self.slo_watchdog
            if wd is not None:
                wd.evaluate()

    def finalize_observability(self) -> Dict[str, Any]:
        """Stop the profiler, flush the history, the SLO, freshness and
        hop-anatomy planes, and return their final sections and artifact
        paths. Idempotent (the serve loop calls it to collect its metrics
        sections; ``close()`` calls it again as a backstop). The sources
        and the fleet registration stay attached: ``/history`` and
        ``/fleet`` answer, and the member keeps its card, until the
        endpoint dies with ``server.close()``."""
        out: Dict[str, Any] = {}
        first = not self.__dict__.get("_obs_closed", False)
        self.__dict__["_obs_closed"] = True
        prof = self.profiler
        if prof is not None:
            prof.stop()
            path = prof.write() if first else None
            out["profile"] = prof.snapshot()
            if path is not None:
                out["profile"]["file"] = path
        db = self.timeseries_db
        if db is not None:
            db.close()  # flush buffered rows; queries keep working
            out["history"] = db.snapshot()
        wd = self.slo_watchdog
        if wd is not None:
            wd.close()
            out["slo"] = wd.snapshot()
        ft = self.freshness_tracker
        if ft is not None:
            ft.close()
            out["freshness"] = ft.snapshot()
        ha = self.hop_anatomy
        if ha is not None:
            ha.close()
            out["hop"] = ha.snapshot()
        return out

    def close_observability(self) -> Dict[str, Any]:
        """:meth:`finalize_observability` and the fleet deregistration:
        the transport ``close()`` teardown, so a member leaves the pane
        only when its server generation really dies."""
        out = self.finalize_observability()
        reg = self.__dict__.pop("_fleet_registration", None)
        if reg is not None:
            from pytorch_ps_mpi_tpu_torch.telemetry.fleet import \
                deregister_endpoint

            deregister_endpoint(*reg)
        return out

"""Online health diagnosis: per-worker verdicts from live telemetry.

The recorder gave the stack raw streams (FlightRecorder spans, the canonical
server metrics) and the resilience layer gave it failure counters (rejected frames,
retries, respawns) — but nothing turned those into *answers*. This
module is that layer: a :class:`HealthMonitor` that runs INSIDE the
serve loop (fed from the same thread via the resilience layer's ``on_tick`` hook and
the per-gradient consume site — no new thread ever touches a native
transport handle) and continuously derives, per worker:

- **push-latency and staleness EWMAs** with **median+MAD anomaly
  flags** (robust to the scheduler spikes a mean/stddev gate trips on);
- **straggler attribution**: ``compute-bound`` vs ``wire-bound`` vs
  ``reconnect-churning``, using the span timings the worker loop
  already measures (shipped as tiny per-step *beacon* JSONL rows into
  ``cfg["health_dir"]`` — the worker-process half of the recorder
  story, readable online instead of only at exit) plus the resilience
  retry/reconnect counters and the server-side frame-rejection counts;
- **round critical-path analysis** for ``sync_barrier`` mode: which
  worker gated each round (last to become ready) and its cumulative
  gating seconds — the per-worker bill for the straggler effect the
  async protocol exists to dodge.

Verdicts surface three ways: the ``/health`` JSON route on the
``/metrics`` HTTP endpoint (both transports — the endpoint lives on
:class:`~pytorch_ps_mpi_tpu_torch.telemetry.registry.PSServerTelemetry` now),
``tools/ps_top.py`` (a live terminal dashboard polling ``/health``),
and scrape-registry instruments (``ps_worker_anomaly_total``,
``ps_round_gating_seconds``, ``ps_worker_health`` — beside the
``ps_staleness_p50/p95/p99`` gauges every server now emits).

Everything here is plain-Python state updated by O(1) calls; the serve
loop pays one None-check per gradient when diagnosis is off, matching
the recorder's zero-cost-when-disabled contract.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: verdict → numeric code for the ``ps_worker_health`` gauge
VERDICT_CODES = {"ok": 0.0, "slow": 1.0, "churning": 2.0, "missing": 3.0,
                 "quarantined": 4.0}


class Ewma:
    """Exponentially weighted moving average; ``None`` until the first
    update (a 0.0 prior would drown early samples)."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        v = self.value
        self.value = float(x) if v is None else v + self.alpha * (x - v)
        return self.value


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class MadWindow:
    """Bounded sample window with a median+MAD anomaly gate.

    A sample is anomalous when it exceeds the window median by more than
    ``k * 1.4826 * MAD`` (1.4826 scales MAD to a normal's sigma) with an
    absolute ``floor`` so a near-zero-variance window (MAD 0 — common
    for integer staleness and for tightly-clocked steps) doesn't flag
    every jitter. Robust: a minority of past anomalies in the window
    shifts the median/MAD far less than it would a mean/stddev."""

    def __init__(self, maxlen: int = 128, k: float = 4.0,
                 floor: float = 0.05, min_samples: int = 5):
        self.win: deque = deque(maxlen=int(maxlen))
        self.k = float(k)
        self.floor = float(floor)
        self.min_samples = int(min_samples)

    def check_and_add(self, x: float) -> bool:
        """True iff ``x`` is anomalous vs the CURRENT window; ``x`` is
        then added either way (bounded window: old anomalies age out)."""
        anomalous = False
        if len(self.win) >= self.min_samples:
            med = _median(list(self.win))
            mad = _median([abs(v - med) for v in self.win])
            anomalous = (x - med) > max(self.k * 1.4826 * mad, self.floor)
        self.win.append(float(x))
        return anomalous

    def stats(self) -> Dict[str, float]:
        xs = list(self.win)
        if not xs:
            return {"p50": 0.0, "p95": 0.0, "n": 0}
        return {"p50": _percentile(xs, 0.50),
                "p95": _percentile(xs, 0.95), "n": len(xs)}


class BeaconWriter:
    """The worker-process half of online diagnosis: one tiny JSONL row
    per step into ``<health_dir>/beacon-<worker>.jsonl`` with the SAME
    durations the recorder spans measure (compute, wire, deliberate
    straggle) plus the resilience counters — appended and flushed
    so the server-side monitor can tail it live, unlike the recorder
    dump which only lands at process exit."""

    def __init__(self, health_dir: str, worker: int):
        os.makedirs(health_dir, exist_ok=True)
        self.path = beacon_path(health_dir, worker)
        self.worker = int(worker)
        self._f = open(self.path, "a")

    def step(self, step: int, compute_s: float, wire_s: float,
             straggle_s: float = 0.0, retries: int = 0,
             reconnects: int = 0) -> None:
        self._f.write(json.dumps({
            "worker": self.worker, "step": int(step), "t": time.time(),
            "compute_s": round(float(compute_s), 6),
            "wire_s": round(float(wire_s), 6),
            "straggle_s": round(float(straggle_s), 6),
            "retries": int(retries), "reconnects": int(reconnects),
        }) + "\n")
        self._f.flush()

    def close(self, retries: int = 0, reconnects: int = 0) -> None:
        if self._f is None:
            return
        try:
            self._f.write(json.dumps({
                "worker": self.worker, "done": True, "t": time.time(),
                "retries": int(retries), "reconnects": int(reconnects),
            }) + "\n")
            self._f.flush()
        finally:
            f, self._f = self._f, None
            f.close()


def beacon_path(health_dir: str, worker: int) -> str:
    return os.path.join(health_dir, f"beacon-{int(worker)}.jsonl")


def read_beacon_rows(path: str, offset: int) -> "tuple[List[dict], int]":
    """Incrementally read COMPLETE lines appended past ``offset``;
    returns (rows, new_offset). A partially-written trailing line is
    left for the next call — the tail-follower contract."""
    if not os.path.exists(path):
        return [], offset
    rows: List[dict] = []
    with open(path, "rb") as f:
        f.seek(offset)
        buf = f.read()
    end = buf.rfind(b"\n")
    if end < 0:
        return [], offset
    for line in buf[: end + 1].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rows.append(json.loads(line))
        except ValueError:
            pass  # torn write; the writer flushes whole lines, rare
    return rows, offset + end + 1


class _WorkerState:
    __slots__ = (
        "grads", "last_arrival", "inter_ewma", "inter_win", "wait_ewma",
        "stale_ewma", "stale_win", "stale_last", "anomalies",
        "last_anomaly", "compute_ewma", "wire_ewma", "straggle_total",
        "retries", "reconnects", "steps_beaconed", "done",
        "gated_rounds", "gating_s", "beacon_offset",
    )

    def __init__(self, knobs: Dict[str, Any]):
        self.grads = 0
        self.last_arrival: Optional[float] = None
        self.wait_ewma = Ewma(knobs["ewma_alpha"])
        self.inter_ewma = Ewma(knobs["ewma_alpha"])
        self.inter_win = MadWindow(knobs["window"], knobs["mad_k"],
                                   knobs["mad_floor_s"],
                                   knobs["min_samples"])
        self.stale_ewma = Ewma(knobs["ewma_alpha"])
        self.stale_win = MadWindow(knobs["window"], knobs["mad_k"],
                                   knobs["stale_floor"],
                                   knobs["min_samples"])
        self.stale_last = 0
        self.anomalies = 0
        self.last_anomaly: Optional[Dict[str, Any]] = None
        self.compute_ewma = Ewma(knobs["ewma_alpha"])
        self.wire_ewma = Ewma(knobs["ewma_alpha"])
        self.straggle_total = 0.0
        self.retries = 0
        self.reconnects = 0
        self.steps_beaconed = 0
        self.done = False
        self.gated_rounds = 0
        self.gating_s = 0.0
        self.beacon_offset = 0


#: tuning knobs and their defaults (overridable via ``cfg["health_kw"]``)
DEFAULT_KNOBS: Dict[str, Any] = {
    "window": 128,          # MAD window length (samples)
    "mad_k": 4.0,           # anomaly gate: x - median > k * 1.4826 * MAD
    "mad_floor_s": 0.05,    # absolute latency gate floor (seconds)
    "stale_floor": 2.0,     # absolute staleness gate floor (versions)
    "min_samples": 5,       # window warmup before the gate arms
    "ewma_alpha": 0.25,
    "slow_factor": 4.0,     # EWMA vs fleet-median multiplier for "slow"
    "anomaly_decay_s": 30.0,  # a flagged worker stays "slow" this long
    "churn_threshold": 3,   # retries+reconnects (or rejected frames)
    "missing_after_s": 30.0,
}


class HealthMonitor:
    """Derives per-worker health verdicts from the live streams.

    Feed points (all same-thread with the serve loop):

    - :meth:`observe_grad` at every consumed gradient (worker id,
      staleness, the poll-wait preceding it);
    - :meth:`observe_round` when a ``sync_barrier`` round completes,
      with each participant's first-ready time — critical-path
      attribution;
    - :meth:`tick` at the serve loop's tick cadence — tails the worker
      beacon files in ``cfg["health_dir"]``.

    ``server`` is any PS server carrying the
    :class:`~pytorch_ps_mpi_tpu_torch.telemetry.registry.PSServerTelemetry`
    surface; passing it wires the monitor into the server's scrape
    registry and ``/health`` route. Tests may instead pass
    ``num_workers`` and drive the feed points directly.
    """

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, num_workers: Optional[int] = None, **overrides):
        cfg = cfg or {}
        self.knobs = dict(DEFAULT_KNOBS)
        self.knobs.update(cfg.get("health_kw") or {})
        self.knobs.update(overrides)
        self.server = server
        if num_workers is None:
            if server is None:
                raise ValueError("need a server or num_workers")
            num_workers = int(server.num_workers)
        self.num_workers = int(num_workers)
        self.health_dir = cfg.get("health_dir")
        self._w = [_WorkerState(self.knobs) for _ in range(self.num_workers)]
        self._t0 = time.monotonic()
        self._t0_wall = time.time()
        self.rounds = 0
        if server is not None:
            server.health_monitor = self
            self.register(server.scrape_registry())

    # -- feed points ------------------------------------------------------
    def observe_grad(self, worker: int, staleness: int,
                     wait_s: float = 0.0, now: Optional[float] = None
                     ) -> None:
        if not 0 <= worker < self.num_workers:
            return  # a rogue id is the frame layer's problem, not ours
        t = time.monotonic() if now is None else float(now)
        h = self._w[worker]
        h.grads += 1
        # the idle poll time the server spent waiting before this
        # gradient — the serve loop's straggler-wait, per worker
        h.wait_ewma.update(float(wait_s))
        h.stale_last = int(staleness)
        h.stale_ewma.update(float(staleness))
        if h.stale_win.check_and_add(float(staleness)):
            self._flag(h, worker, "staleness", float(staleness), t)
        if h.last_arrival is not None:
            inter = t - h.last_arrival
            h.inter_ewma.update(inter)
            if h.inter_win.check_and_add(inter):
                self._flag(h, worker, "push_latency", inter, t)
        h.last_arrival = t

    def observe_round(self, ready_at: Dict[int, float],
                      active: List[int]) -> None:
        """Critical path of one completed sync round: the LAST worker to
        become ready gated it; its gating time is how long it kept the
        round open past the second-slowest participant."""
        self.rounds += 1
        times = sorted((t, w) for w, t in ready_at.items() if w in active)
        if len(times) < 2:
            return  # a 1-worker round has no critical path to bill
        gate_s = times[-1][0] - times[-2][0]
        w = times[-1][1]
        self._w[w].gated_rounds += 1
        self._w[w].gating_s += max(0.0, gate_s)

    def tick(self, now: Optional[float] = None) -> None:
        """Tail the worker beacon files (same thread as the serve loop —
        file reads only, no native handles)."""
        if not self.health_dir:
            return
        for wid in range(self.num_workers):
            h = self._w[wid]
            rows, h.beacon_offset = read_beacon_rows(
                beacon_path(self.health_dir, wid), h.beacon_offset)
            for r in rows:
                if r.get("done"):
                    h.done = True
                else:
                    h.steps_beaconed += 1
                    h.compute_ewma.update(float(r.get("compute_s", 0.0)))
                    h.wire_ewma.update(float(r.get("wire_s", 0.0)))
                    h.straggle_total += float(r.get("straggle_s", 0.0))
                # counters are absolute in every row: take the latest
                h.retries = int(r.get("retries", h.retries))
                h.reconnects = int(r.get("reconnects", h.reconnects))

    # -- verdicts ---------------------------------------------------------
    def _flag(self, h: _WorkerState, worker: int, kind: str,
              value: float, now: float) -> None:
        h.anomalies += 1
        h.last_anomaly = {"kind": kind, "value": round(value, 6),
                          "t_mono": now}
        from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

        record_event("diag.anomaly", worker=worker, anomaly=kind,
                     value=value)

    def _frames_rejected(self, worker: int) -> int:
        if self.server is None:
            return 0
        return int(getattr(self.server, "frames_rejected", {}
                           ).get(worker, 0))

    def _verdict(self, worker: int, fleet_inter_med: Optional[float],
                 now: Optional[float] = None
                 ) -> "tuple[str, Optional[str]]":
        h = self._w[worker]
        k = self.knobs
        now = time.monotonic() if now is None else float(now)
        nm = getattr(self.server, "numerics_monitor", None)
        if nm is not None and nm.is_quarantined(worker):
            # numerics outranks everything: a worker emitting NaNs is
            # broken whatever its latency looks like
            return "quarantined", "nonfinite"
        if h.grads == 0 and not h.done:
            if now - self._t0 > k["missing_after_s"]:
                return "missing", None
            return "ok", None  # startup grace (interpreter start, first build)
        if (not h.done and h.last_arrival is not None
                and now - h.last_arrival > k["missing_after_s"]):
            return "missing", None
        churn = h.retries + h.reconnects
        if (churn >= k["churn_threshold"]
                or self._frames_rejected(worker) >= k["churn_threshold"]):
            return "churning", "reconnect-churn"
        recent_anomaly = (
            h.last_anomaly is not None
            and now - h.last_anomaly["t_mono"] <= k["anomaly_decay_s"]
        )
        ewma_slow = (
            fleet_inter_med is not None and fleet_inter_med > 0
            and h.inter_ewma.value is not None
            and h.inter_ewma.value > k["slow_factor"] * fleet_inter_med
        )
        if recent_anomaly or ewma_slow:
            return "slow", self._attribution(h)
        return "ok", None

    @staticmethod
    def _attribution(h: _WorkerState) -> str:
        """compute-bound vs wire-bound from the beacon span EWMAs: the
        deliberate straggler sleep counts as compute (it emulates slow
        compute); injected delays, pushes, reads, and retry backoff all
        land in the wire bucket (see the worker loop's accounting)."""
        c, w = h.compute_ewma.value, h.wire_ewma.value
        if c is None and w is None:
            return "unknown"  # no beacons: can't split the step
        return "wire-bound" if (w or 0.0) > (c or 0.0) else "compute-bound"

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/health`` document: fleet rollup + one verdict row per
        worker. Pure reads — safe at scrape time from the HTTP thread.
        ``now`` (monotonic-clock override) lets deterministic tests run
        the verdicts on a synthetic timeline."""
        now = time.monotonic() if now is None else float(now)
        inter_ewmas = [h.inter_ewma.value for h in self._w
                       if h.inter_ewma.value is not None]
        fleet_med = _median(inter_ewmas) if inter_ewmas else None
        nm = getattr(self.server, "numerics_monitor", None)
        # ONE numerics snapshot, indexed per worker below — the verdict
        # section and the per-worker rows can never drift apart
        nsnap = nm.snapshot() if nm is not None else None
        lt = getattr(self.server, "lineage_tracker", None)
        workers = []
        for wid in range(self.num_workers):
            h = self._w[wid]
            verdict, cause = self._verdict(wid, fleet_med, now)
            last_age = (
                None if h.last_arrival is None
                else round(now - h.last_arrival, 3)
            )
            num_row = nsnap["workers"][wid] if nsnap is not None else None
            workers.append({
                "worker": wid,
                "verdict": verdict,
                "cause": cause,
                "done": h.done,
                "grads": h.grads,
                "push_interarrival_s": {
                    "ewma": h.inter_ewma.value,
                    **{k: round(v, 6) if k != "n" else v
                       for k, v in h.inter_win.stats().items()},
                },
                "staleness": {"ewma": h.stale_ewma.value,
                              "last": h.stale_last},
                "anomalies": h.anomalies,
                "last_anomaly": h.last_anomaly,
                "server_wait_ewma_s": h.wait_ewma.value,
                "compute_ewma_s": h.compute_ewma.value,
                "wire_ewma_s": h.wire_ewma.value,
                "steps_beaconed": h.steps_beaconed,
                "straggle_total_s": round(h.straggle_total, 6),
                "retries": h.retries,
                "reconnects": h.reconnects,
                "frames_rejected": self._frames_rejected(wid),
                "last_seen_age_s": last_age,
                "gating": {"rounds": h.gated_rounds,
                           "seconds": round(h.gating_s, 6)},
                "numerics": num_row,
                # exact per-push staleness/e2e from the frame trace IDs
                # (telemetry.lineage) — the measured numbers beside the
                # EWMA estimates above; None when lineage is unarmed
                "lineage": (lt.worker_summary(wid)
                            if lt is not None else None),
            })
        fleet: Dict[str, Any] = {
            "anomaly_total": sum(h.anomalies for h in self._w),
            "rounds": self.rounds,
            "slow_workers": sum(1 for w in workers
                                if w["verdict"] == "slow"),
        }
        if self.server is not None:
            from pytorch_ps_mpi_tpu_torch.telemetry.registry import (
                HEALTH_FLEET_ROLLUP_KEYS,
                ps_server_metrics,
            )

            m = ps_server_metrics(self.server)
            # the rollup subset is IMPORTED from the canonical schema's
            # home (not hand-listed here) so the two can never drift —
            # psanalyze's metrics-surface rule checks it statically too
            fleet.update({k: m[k] for k in HEALTH_FLEET_ROLLUP_KEYS})
        t_wall = time.time()
        out = {
            "armed": True,
            "t_wall": t_wall,
            # canonical sample-ordering fields (this PR's satellite):
            # every /health payload carries ts + uptime_s so the fleet
            # poller can order and age member samples uniformly
            "ts": t_wall,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "n_workers": self.num_workers,
            "fleet": fleet,
            "workers": workers,
        }
        if nsnap is not None:
            # the numerics verdict section: quarantine state, grad-norm
            # trajectory summary, latest codec-fidelity probe, postmortems
            out["numerics"] = nsnap
        if lt is not None:
            # the lineage section: exact e2e/staleness distributions,
            # composition counters, stage-level critical paths
            out["lineage"] = lt.snapshot()
        an = getattr(self.server, "anatomy", None)
        if an is not None:
            # the anatomy section: per-round stage decomposition,
            # critical-path shares, the ranked what-if advisor — the
            # pane ps_top renders and the report tabulates
            out["anatomy"] = an.snapshot()
        ha = getattr(self.server, "hop_anatomy", None)
        if ha is not None:
            # the hop section: leader-pipeline sub-stage occupancy,
            # per-leader busy fractions, the streaming-headroom board
            out["hop"] = ha.snapshot()
        sc = getattr(self.server, "serving_core", None)
        if sc is not None and sc.armed:
            # the serving section: snapshot-ring occupancy, read queue
            # depth, per-tenant read counts, shed/coalesce counters —
            # the read tier's half of the fleet picture
            out["serving"] = sc.serving_snapshot()
        wd = getattr(self.server, "slo_watchdog", None)
        if wd is not None:
            # the slo section: per-rule burn rates, latched breach
            # states, recent verdicts — what the fleet pane rolls up
            out["slo"] = wd.snapshot()
        cl = getattr(self.server, "controller", None)
        if cl is not None:
            # the control section: executed actions, wire epoch, LR
            # weights, eviction/probation state — the verdict→action
            # half of the pane (ps_top renders it as the control pane)
            out["control"] = cl.snapshot()
        db = getattr(self.server, "timeseries_db", None)
        if db is not None:
            out["history"] = db.snapshot()
        return out

    def render_json(self) -> str:
        return json.dumps(self.snapshot())

    # -- scrape registry --------------------------------------------------
    def register(self, registry) -> None:
        """Mirror verdict/anomaly/gating state into scrape instruments —
        the same per-worker-labeled-series discipline as
        ``ps_frames_rejected_total`` (no unlabeled sibling that would
        double PromQL sums)."""

        def collect(r) -> None:
            inter_ewmas = [h.inter_ewma.value for h in self._w
                           if h.inter_ewma.value is not None]
            fleet_med = _median(inter_ewmas) if inter_ewmas else None
            for wid in range(self.num_workers):
                h = self._w[wid]
                lab = {"worker": str(wid)}
                r.counter(
                    "ps_worker_anomaly_total",
                    "push-latency/staleness observations flagged by the "
                    "median+MAD gate", labels=lab).set(float(h.anomalies))
                r.counter(
                    "ps_round_gating_seconds",
                    "cumulative sync-round critical-path time this "
                    "worker gated (last-ready attribution)",
                    labels=lab).set(h.gating_s)
                r.counter(
                    "ps_rounds_gated_total",
                    "sync rounds whose critical path ended on this "
                    "worker", labels=lab).set(float(h.gated_rounds))
                verdict, _ = self._verdict(wid, fleet_med)
                r.gauge(
                    "ps_worker_health",
                    "verdict code: 0 ok, 1 slow, 2 churning, 3 missing",
                    labels=lab).set(VERDICT_CODES[verdict])

        registry.add_collector(collect)

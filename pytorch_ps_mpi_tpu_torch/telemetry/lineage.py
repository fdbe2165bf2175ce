"""End-to-end gradient lineage: causal push IDs from encode to publish.

Every observability layer before this one was per-process: recorder
spans, ``/health`` verdicts and numerics stats each
see only their own side of the wire, so per-push latency and staleness
were *estimated* from interarrival EWMAs rather than *measured*, and a
divergence postmortem could not say which worker pushes composed the bad
published version. This module closes that gap with a **trace ID**
stamped into every framed gradient push at the worker's encode site —

    ``(worker id, worker step, monotonic push seq)``

— carried by the v2 frame header (``resilience.frames``: step, seq and
the worker's ``send_wall`` timestamp ride beside the CRC and config
fingerprint) through BOTH transports, and consumed server-side by a
:class:`LineageTracker` fed from the shared ``framed_poll`` loop and the
serve loop's publish site. The tracker gives every published version a
recorded **lineage**: the exact set of (worker, step, staleness, bytes,
per-stage wall times) pushes that composed it, written as
``lineage-<name>.jsonl`` rows beside the recorder dumps.

On top of the raw lineage:

- **exact distributions** — per-push end-to-end latency (worker encode →
  version published) and exact per-push staleness replace/validate the
  health monitor's EWMA estimates; they surface as new canonical
  ``PS_SERVER_METRIC_KEYS`` and as ``ps_push_e2e_seconds`` /
  ``ps_push_wire_seconds`` histograms on both transports;
- **clock-skew estimation** — :func:`estimate_clock_offset` fits a
  per-worker offset from the frame (send_wall, recv_wall) timestamp
  pairs so ``trace_export`` can merge worker + server recorder spans
  into ONE Chrome trace with flow events (arrows) linking a worker's
  push span to the server's consume span;
- **critical-path extraction** — for sync-barrier rounds, which
  worker's which *stage* (produce / wire / decode) gated the round,
  sharpening the health monitor's last-ready attribution into a stage-level answer;
- **postmortem lineage** — ``telemetry.numerics`` embeds the offending
  worker's recent pushes and the last published composition into its
  ``postmortem-*.json`` captures.

Zero-cost-when-disabled like every other telemetry layer: the framed
poll and the serve loop each pay one ``None``-check per push when
lineage is off, and the tracker self-times its own bookkeeping
(``overhead_s``) so ``make trace-smoke`` can hold it to the standing
<=5% telemetry budget.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

PyTree = Any

#: push-latency histogram buckets (seconds): sub-ms shm hops through
#: multi-second straggler waits
LATENCY_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: the per-push stage names critical-path extraction attributes to
STAGES = ("produce", "wire", "decode")

#: tuning knobs and their defaults (overridable via ``cfg["lineage_kw"]``)
LINEAGE_KNOBS: Dict[str, Any] = {
    "window": 4096,      # e2e/wire/staleness sample windows (pushes)
    "ring": 256,         # recent composed pushes kept for postmortems
    "flush_every": 64,   # JSONL rows buffered between flushes
}


def trace_id(worker: int, step: int, seq: int) -> str:
    """The canonical string form of a push trace ID — what flow events
    in the merged Chrome trace use as their ``id``."""
    return f"{int(worker)}/{int(step)}/{int(seq)}"


def estimate_clock_offset(
    pairs: Sequence[Tuple[float, float]]
) -> float:
    """Estimate the clock offset between two processes from
    ``(send_ts, recv_ts)`` wall-timestamp pairs of the same frames
    (sender's clock stamps ``send_ts``, receiver's stamps ``recv_ts``).

    Returns the estimated ``receiver_clock - sender_clock`` offset in
    seconds, using the classic one-way lower-envelope estimator:
    ``min(recv - send)`` over all pairs. Since the true one-way latency
    is non-negative, the minimum difference bounds the offset from
    above and is achieved by the fastest frame — so the estimate is
    biased by (at most) the *minimum* network latency, not the jittery
    mean. The degenerate single-pair case returns that pair's
    difference. Raises ``ValueError`` on an empty input (there is no
    offset to estimate)."""
    diffs = [float(r) - float(s) for s, r in pairs]
    if not diffs:
        raise ValueError("need at least one (send, recv) pair")
    return min(diffs)


def clock_offsets_from_rows(
    rows: Iterable[Dict[str, Any]]
) -> Dict[int, float]:
    """Per-worker clock offsets (``server_clock - worker_clock``
    estimates) from lineage JSONL rows — every push in every
    ``publish``/``drop`` row contributes its (send_wall, recv_wall)
    pair. Workers with no pushes are absent from the result."""
    pairs: Dict[int, List[Tuple[float, float]]] = {}
    for row in rows:
        pushes = list(row.get("pushes") or [])
        if "push" in row:
            pushes.append(row["push"])
        for p in pushes:
            s, r = p.get("send_wall"), p.get("recv_wall")
            if s is None or r is None:
                continue
            pairs.setdefault(int(p["worker"]), []).append(
                (float(s), float(r)))
    return {w: estimate_clock_offset(ps) for w, ps in pairs.items()}


def load_lineage_rows(path: str) -> List[Dict[str, Any]]:
    """Read a ``lineage-*.jsonl`` file back into its row list (torn
    trailing lines skipped — the writer flushes whole lines)."""
    rows: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                pass
    return rows


# the one nearest-rank percentile shared with the diagnosis layer —
# exact-vs-EWMA comparisons must use ONE quantile definition
from pytorch_ps_mpi_tpu_torch.telemetry.diagnosis import _percentile


class _WorkerLineage:
    __slots__ = ("pushes", "stale_last", "stale_win", "e2e_last",
                 "e2e_win", "gated_rounds")

    def __init__(self, window: int):
        self.pushes = 0
        self.stale_last: Optional[int] = None
        self.stale_win: deque = deque(maxlen=window)
        self.e2e_last: Optional[float] = None
        self.e2e_win: deque = deque(maxlen=window)
        self.gated_rounds = 0


class LineageTracker:
    """Server-side lineage: consumes the trace IDs ``framed_poll``
    decodes from the v2 frame headers and bills every published version
    with the exact pushes that composed it.

    Feed points (all same-thread with the serve loop):

    - :meth:`observe_consume` for EVERY counted pop of a valid frame
      (``framed_poll`` calls it — applied and stale-dropped pushes
      alike), with the push meta the frame header carried;
    - :meth:`discard_last` when the serve loop drops a consumed push
      before applying it (numerics skip/abort) — the push gets a
      ``drop`` lineage row instead of silently joining the next
      version's composition;
    - :meth:`observe_publish` right after each ``server.publish`` with
      the new version and the measured apply+publish wall — pops the
      uncomposed pushes (one per ``workers`` entry in sync-barrier
      mode, everything pending in async mode), stamps their end-to-end
      latency, and writes the ``publish`` lineage row.

    ``server`` is any PS server carrying the
    :class:`~pytorch_ps_mpi_tpu_torch.telemetry.registry.PSServerTelemetry`
    surface; passing it attaches the tracker
    (``server.lineage_tracker`` — the canonical-schema source for the
    new ``lineage_pushes`` / ``push_e2e_p*_ms`` keys and ``framed_poll``'s
    feed hook) and registers the scrape instruments. Tests may pass
    ``num_workers`` and drive the feed points directly.
    """

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, num_workers: Optional[int] = None, name: str = "server",
                 **overrides):
        cfg = cfg or {}
        self.knobs = dict(LINEAGE_KNOBS)
        self.knobs.update(cfg.get("lineage_kw") or {})
        self.knobs.update(overrides)
        self.server = server
        if num_workers is None:
            if server is None:
                raise ValueError("need a server or num_workers")
            num_workers = int(server.num_workers)
        self.num_workers = int(num_workers)
        self.name = name
        self.dir = cfg.get("lineage_dir") or cfg.get("telemetry_dir")
        win = int(self.knobs["window"])
        self._w = [_WorkerLineage(win) for _ in range(self.num_workers)]
        self.consumed = 0        # valid frames counted (applied + dropped)
        self.composed = 0        # pushes billed to a published version
        self.drops = 0           # stale/numerics-dropped pushes
        self.publishes = 0
        self.rounds = 0          # multi-push publishes (sync rounds)
        self.staleness_exact: Dict[int, int] = {}
        self.e2e_win: deque = deque(maxlen=win)
        self.wire_win: deque = deque(maxlen=win)
        self._uncomposed: Dict[int, deque] = {
            w: deque() for w in range(self.num_workers)
        }
        self._recent: deque = deque(maxlen=int(self.knobs["ring"]))
        self.last_publish: Optional[Dict[str, Any]] = None
        #: (worker, stage) → rounds that worker's stage gated
        self.critical_path: Dict[Tuple[int, str], int] = {}
        self.overhead_s = 0.0    # self-timed bookkeeping cost
        self._f = None
        self._rows_since_flush = 0
        self._h_e2e = None
        self._h_wire = None
        #: the attached round-anatomy engine (telemetry.anatomy) — fed
        #: one publish row per published version; None when unarmed
        #: (one None-check per publish)
        self.anatomy = None
        if server is not None:
            server.lineage_tracker = self
            self.register(server.scrape_registry())

    # -- feed points ------------------------------------------------------
    def observe_consume(self, meta: Dict[str, Any]) -> None:
        """One valid frame popped by ``framed_poll``. ``meta`` carries
        ``worker/step/seq/version_read/staleness/bytes/send_wall/
        recv_wall`` (+ ``decode_s`` when decoded, ``stale_drop=True``
        when the bounded-staleness gate dropped it)."""
        t0 = time.perf_counter()
        w = int(meta["worker"])
        if not 0 <= w < self.num_workers:
            return  # rogue ids are the frame layer's problem
        self.consumed += 1
        stale = int(meta.get("staleness", 0))
        self.staleness_exact[stale] = self.staleness_exact.get(stale, 0) + 1
        h = self._w[w]
        h.pushes += 1
        h.stale_last = stale
        h.stale_win.append(float(stale))
        if meta.get("stale_drop"):
            self.drops += 1
            self._write_row({"kind": "drop", "reason": "stale",
                            "t": meta.get("recv_wall", time.time()),
                             "push": meta})
        else:
            self._uncomposed[w].append(meta)
        self.overhead_s += time.perf_counter() - t0

    def discard_last(self, worker: int, reason: str = "numerics") -> None:
        """The serve loop consumed this worker's latest push but will
        never apply it (numerics skip/abort): pull it back out of the
        composition queue and give it its own ``drop`` row."""
        t0 = time.perf_counter()
        q = self._uncomposed.get(int(worker))
        if q:
            meta = q.pop()
            self.drops += 1
            self._write_row({"kind": "drop", "reason": reason,
                             "t": time.time(), "push": meta})
        self.overhead_s += time.perf_counter() - t0

    def observe_publish(self, version: int, apply_s: float,
                        workers: Optional[Sequence[int]] = None,
                        now: Optional[float] = None) -> Dict[str, Any]:
        """Bill the new published ``version`` with its composing pushes.
        ``workers`` (sync-barrier mode) pops exactly one queued push per
        listed worker — mirroring the serve loop's own
        ``pending[w].popleft()`` — while ``None`` (async mode) pops
        everything uncomposed (exactly the one push just applied)."""
        t0 = time.perf_counter()
        now = time.time() if now is None else float(now)
        pushes: List[Dict[str, Any]] = []
        if workers is None:
            for w in range(self.num_workers):
                while self._uncomposed[w]:
                    pushes.append(self._uncomposed[w].popleft())
        else:
            for w in workers:
                q = self._uncomposed.get(int(w))
                if q:
                    pushes.append(q.popleft())
        for p in pushes:
            send = p.get("send_wall")
            recv = p.get("recv_wall")
            # RAW cross-clock differences, deliberately unclamped: a
            # negative wire_s is the documented NTP-skew smell (the
            # worker's clock runs ahead of the server's by more than
            # the wire latency) — clamping would hide exactly the
            # condition the runbook tells operators to look for
            p["e2e_s"] = None if send is None else now - send
            p["wire_s"] = (None if send is None or recv is None
                           else recv - send)
            h = self._w[int(p["worker"])]
            if p["e2e_s"] is not None:
                h.e2e_last = p["e2e_s"]
                h.e2e_win.append(p["e2e_s"])
                self.e2e_win.append(p["e2e_s"])
                if self._h_e2e is not None:
                    self._h_e2e.observe(p["e2e_s"])
            if p["wire_s"] is not None:
                self.wire_win.append(p["wire_s"])
                if self._h_wire is not None:
                    self._h_wire.observe(p["wire_s"])
            self._recent.append(p)
        self.composed += len(pushes)
        self.publishes += 1
        row = {"kind": "publish", "version": int(version), "t": now,
               "apply_s": round(float(apply_s), 6), "pushes": pushes}
        self.last_publish = row
        self._write_row(row)
        if len(pushes) >= 2:
            self._observe_round(row)
        self.overhead_s += time.perf_counter() - t0
        if self.anatomy is not None:
            # the round-anatomy engine decomposes the SAME row this
            # tracker just wrote — exact critical paths and what-if
            # projections from the one causal record (self-timed there,
            # deliberately outside this tracker's overhead clock)
            self.anatomy.observe_publish(row)
        return row

    def _observe_round(self, publish_row: Dict[str, Any]) -> None:
        """Stage-level critical path of one multi-push (sync-barrier)
        round: the LAST push to arrive gated it; its dominant stage —
        ``produce`` (gap since that worker's previous send: compute +
        read + any straggle), ``wire`` (send→recv transfer+queue) or
        ``decode`` — is the round's answer. Sharpens the health monitor's last-ready
        worker attribution into *which stage of whose pipeline*."""
        pushes = publish_row["pushes"]
        gate = max(pushes, key=lambda p: p.get("recv_wall") or 0.0)
        w = int(gate["worker"])
        stages: Dict[str, Optional[float]] = {
            "wire": gate.get("wire_s"),
            "decode": gate.get("decode_s"),
        }
        prev_send = self._prev_send_wall(w, gate)
        stages["produce"] = (
            None if prev_send is None or gate.get("send_wall") is None
            else max(0.0, gate["send_wall"] - prev_send)
        )
        known = {k: v for k, v in stages.items() if v is not None}
        if not known:
            return
        stage = max(known, key=known.get)
        self.rounds += 1
        self._w[w].gated_rounds += 1
        key = (w, stage)
        self.critical_path[key] = self.critical_path.get(key, 0) + 1
        self._write_row({
            "kind": "round", "round": self.rounds,
            "version": publish_row["version"], "t": publish_row["t"],
            "gating_worker": w, "stage": stage,
            "stage_s": round(known[stage], 6),
            "stages": {k: (None if v is None else round(v, 6))
                       for k, v in stages.items()},
            "trace": trace_id(w, gate.get("step", 0), gate.get("seq", 0)),
        })

    def _prev_send_wall(self, worker: int,
                        gate: Dict[str, Any]) -> Optional[float]:
        """The gating worker's previous composed push's send time —
        scan the recent ring backwards past the gating push itself."""
        seen_gate = False
        for p in reversed(self._recent):
            if p is gate:
                seen_gate = True
                continue
            if seen_gate and int(p["worker"]) == worker:
                return p.get("send_wall")
        return None

    # -- disk -------------------------------------------------------------
    def _write_row(self, row: Dict[str, Any]) -> None:
        if not self.dir:
            return
        if self._f is None:
            os.makedirs(self.dir, exist_ok=True)
            self._f = open(lineage_path(self.dir, self.name), "a")
        self._f.write(json.dumps(row) + "\n")
        self._rows_since_flush += 1
        if self._rows_since_flush >= int(self.knobs["flush_every"]):
            self._f.flush()
            self._rows_since_flush = 0

    def close(self) -> None:
        if self._f is not None:
            f, self._f = self._f, None
            f.flush()
            f.close()

    # -- read side --------------------------------------------------------
    def recent(self, k: int = 16,
               worker: Optional[int] = None) -> List[Dict[str, Any]]:
        """The last ``k`` composed pushes (optionally one worker's) —
        what a numerics postmortem embeds as the offender's history."""
        rows = [p for p in self._recent
                if worker is None or int(p["worker"]) == int(worker)]
        return rows[-int(k):]

    def e2e_ms_quantile(self, q: float) -> float:
        return 1e3 * _percentile(list(self.e2e_win), q)

    def wire_ms_quantile(self, q: float) -> float:
        return 1e3 * _percentile(list(self.wire_win), q)

    def staleness_quantile(self, q: float) -> float:
        """Exact weighted quantile over every consumed push's frame-
        carried staleness — the measured number the health EWMAs estimate."""
        from pytorch_ps_mpi_tpu_torch.telemetry.registry import staleness_quantile

        return staleness_quantile(self.staleness_exact, q)

    def worker_summary(self, worker: int) -> Optional[Dict[str, Any]]:
        """Per-worker lineage digest for ``/health`` rows and
        ``ps_top``'s ``stale(exact)`` / ``e2e ms`` columns."""
        if not 0 <= worker < self.num_workers:
            return None
        h = self._w[worker]
        return {
            "pushes": h.pushes,
            "stale_last": h.stale_last,
            "stale_p50": _percentile(list(h.stale_win), 0.50),
            "e2e_ms_last": (None if h.e2e_last is None
                            else round(1e3 * h.e2e_last, 3)),
            "e2e_ms_p50": round(1e3 * _percentile(list(h.e2e_win), 0.50),
                                3),
            "gated_rounds": h.gated_rounds,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The lineage section of the serve call's returned metrics (and
        of ``/health`` when diagnosis is armed). Pure reads."""
        return {
            "armed": True,
            "consumed": self.consumed,
            "composed": self.composed,
            "drops": self.drops,
            "publishes": self.publishes,
            "rounds": self.rounds,
            "e2e_ms": {"p50": round(self.e2e_ms_quantile(0.50), 3),
                       "p95": round(self.e2e_ms_quantile(0.95), 3),
                       "p99": round(self.e2e_ms_quantile(0.99), 3)},
            "wire_ms": {"p50": round(self.wire_ms_quantile(0.50), 3),
                        "p95": round(self.wire_ms_quantile(0.95), 3)},
            # snapshot in ONE C-level call first: /health scrapes run on
            # the HTTP thread while the serve thread inserts new keys
            # (same hazard registry.staleness_quantile documents)
            "staleness_exact": {int(k): int(v) for k, v
                                in list(self.staleness_exact.items())},
            "critical_path": [
                {"worker": w, "stage": s, "rounds": n}
                for (w, s), n in sorted(list(
                    self.critical_path.items()))
            ],
            "overhead_s": round(self.overhead_s, 6),
            "workers": [self.worker_summary(w)
                        for w in range(self.num_workers)],
        }

    # -- scrape registry --------------------------------------------------
    def register(self, registry) -> None:
        """Histograms observed at publish time + scrape-time gauges for
        the exact quantiles — the measured numbers beside (and
        validating) the health EWMA estimates."""
        self._h_e2e = registry.histogram(
            "ps_push_e2e_seconds", LATENCY_BUCKETS,
            "exact per-push end-to-end latency: worker encode (frame "
            "send_wall) to the composed version's publish",
        )
        self._h_wire = registry.histogram(
            "ps_push_wire_seconds", LATENCY_BUCKETS,
            "exact per-push wire latency: frame send_wall to the "
            "server's pop (cross-clock; see clock-skew caveats)",
        )

        def collect(r) -> None:
            r.counter(
                "ps_lineage_pushes_total",
                "pushes billed to a published version (composed lineage)",
            ).set(float(self.composed))
            r.counter(
                "ps_lineage_drops_total",
                "consumed pushes that never composed a version "
                "(stale drop, numerics skip)",
            ).set(float(self.drops))
            r.gauge(
                "ps_push_e2e_p50_ms",
                "exact per-push end-to-end latency p50 (ms)",
            ).set(self.e2e_ms_quantile(0.50))
            r.gauge(
                "ps_push_e2e_p95_ms",
                "exact per-push end-to-end latency p95 (ms)",
            ).set(self.e2e_ms_quantile(0.95))
            r.gauge(
                "ps_staleness_exact_p50",
                "exact per-push staleness p50 from frame trace IDs "
                "(versions)",
            ).set(self.staleness_quantile(0.50))
            r.gauge(
                "ps_staleness_exact_p95",
                "exact per-push staleness p95 from frame trace IDs "
                "(versions)",
            ).set(self.staleness_quantile(0.95))

        registry.add_collector(collect)


def lineage_path(lineage_dir: str, name) -> str:
    """``lineage-<name>.jsonl`` — the ``lineage-`` prefix keeps these
    rows out of recorder-JSONL merges, like ``beacon-``/``numerics-``."""
    return os.path.join(lineage_dir, f"lineage-{name}.jsonl")

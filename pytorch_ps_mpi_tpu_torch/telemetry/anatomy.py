"""Round-anatomy causal profiler: exact per-round critical paths and
Coz-style what-if projections from recorded lineage.

The lineage layer records exact causal data — every framed push
carries a (worker, step, seq) trace ID plus its encode-site ``send_wall``,
every published version gets a row naming its exact composing pushes,
and composed trailers carry the origin trace IDs through every
tree hop.  What no layer did until now is turn those rows into the
question an operator actually asks: *which stage limits round time, and
what would speeding it up buy?*  :class:`RoundAnatomy` is that layer:

- **causal DAG per published version** — each publish row is
  reconstructed into per-push stage segments using the canonical stage
  taxonomy :data:`STAGES`:

  ===============  =========================================================
  ``produce``      the pushing worker's gap since its previous send
                   (read + backprop + deliberate straggle; same worker
                   clock, so no offset correction is needed)
  ``encode``       the leader's upstream re-encode (hop rows only; a
                   direct push's encode is inside ``produce`` — the
                   frame is sealed at the encode site)
  ``wire``         frame ``send_wall`` → server ``recv_wall``,
                   clock-corrected (below)
  ``leader_fold``  composed pushes: last origin-worker send → the
                   leader's own hop encode (the group fold window)
  ``root_fold``    the server-side decode/fold of the gating push
  ``opt_publish``  the round's optimizer update + publish wall
  ``barrier``      the residual: round time not attributable to any
                   measured segment (degraded-round waits, scheduling).
                   Deliberately NOT a phantom stage — the advisor never
                   projects a speedup for it
  ===============  =========================================================

- **clock-offset correction** — the lineage layer's lower-envelope fit, applied
  online: per worker the running envelope ``min(recv − send)`` bounds
  ``server_clock − worker_clock`` from above.  Correction engages only
  when the envelope is NEGATIVE (proof of skew: true wire latency is
  positive, so ``recv − send < 0`` can only be clock offset); a positive
  envelope is trusted, so genuinely constant wire latency (a real WAN
  hop) stays attributed to the wire stage instead of being absorbed into
  the offset estimate.  Either way no stage duration can come out
  negative — the negative-skew case shifts the whole envelope to zero.

- **exact critical path per round** — the gating (last-arriving) push's
  chain decomposes the round; per-stage critical-path shares and
  durations accumulate in bounded windows.

- **Coz-style what-if projections** — for every speedup-able stage the
  engine replays its retained rounds with the stage virtually sped up
  ("stage X 20% faster") and with the gating worker's stage pulled to
  the fleet median ("debottleneck"), and reports the projected
  round-time saving.  Virtual speedups move each push's arrival, so a
  projection correctly shows ~zero saving for a stage that is never on
  the critical path.

- **regime estimation for the controller** — :meth:`regime_estimate`
  derives the fleet wire-vs-compute balance from the measured stage
  windows; ``control.Controller`` consumes it in preference to beacon
  medians when lineage is armed (a worker whose beacons are off or
  skewed cannot hide a wire-bound fleet).  The estimator's outputs ride
  the controller's persisted TSDB input rows, so replay stays
  byte-identical by construction.

Two modes, one engine: live (attached to a PS server, fed by the
:class:`~pytorch_ps_mpi_tpu_torch.telemetry.lineage.LineageTracker` at every
publish, writing ``anatomy-<name>.jsonl`` rows) and offline
(:func:`anatomy_from_rows` over persisted ``lineage-*.jsonl`` +
``lineage-leader*.jsonl`` files — ``tools/telemetry_report.py``'s
anatomy section and ``tools/whatif_smoke.py``'s gate).  Zero cost when
disabled (one ``None`` check per publish) and self-timed
(``overhead_s``) against the standing <=5% telemetry budget.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: the canonical stage taxonomy (order = causal order within a round);
#: ``barrier`` is the residual bucket and is never advised on
STAGES = ("produce", "encode", "wire", "leader_fold", "root_fold",
          "opt_publish", "barrier")

#: stages the what-if advisor may project speedups for (everything
#: measured; ``barrier`` is a residual, not a stage anyone can optimize)
SPEEDUP_STAGES = ("produce", "encode", "wire", "leader_fold", "root_fold",
                  "opt_publish")

#: the advisor's virtual-speedup grid (Coz-style "stage X this much
#: faster"); the 0.2 column is the canonical headline number
WHATIF_FRACS = (0.1, 0.2, 0.5)

#: tuning knobs and their defaults (overridable via ``cfg["anatomy_kw"]``)
ANATOMY_KNOBS: Dict[str, Any] = {
    "window": 512,       # rounds retained for advisor projections
    "stage_window": 1024,  # per-(worker, stage) duration samples kept
    "flush_every": 32,   # JSONL rows buffered between flushes
    "min_rounds": 4,     # rounds before regime_estimate answers
    # a produce gap wildly past the worker's own history (a barrier
    # stall, a supervisor-restart window, a stale-dropped push's hole)
    # is NOT compute: clip it at this multiple of the worker's rolling
    # median so the excess falls into the barrier residual instead of
    # masquerading as a phantom produce stage.  Genuine stragglers (a
    # few x slower) stay measured; only order-of-magnitude stalls clip.
    "produce_cap_x": 8.0,
}


def anatomy_path(out_dir: str, name) -> str:
    """``anatomy-<name>.jsonl`` — a registered sidecar prefix
    (:data:`pytorch_ps_mpi_tpu_torch.telemetry.SIDECAR_PREFIXES`), routed away
    from the recorder-span merge like every other sidecar."""
    return os.path.join(out_dir, f"anatomy-{name}.jsonl")


def _med(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _p(vals: Sequence[float], q: float) -> float:
    s = sorted(vals)
    if not s:
        return math.nan
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class _Envelope:
    """Running lower-envelope clock fit per worker: ``min(recv − send)``
    bounds ``server − worker`` clock offset from above (the lineage layer's
    ``estimate_clock_offset``, applied online).  ``shift()`` is the
    correction added to raw ``recv − send`` wire times: 0 while the
    envelope is positive (clocks trusted; constant latency is real
    latency), ``−envelope`` once it goes negative (proof of skew)."""

    __slots__ = ("lo",)

    def __init__(self):
        self.lo: Optional[float] = None

    def feed(self, diff: float) -> None:
        if self.lo is None or diff < self.lo:
            self.lo = diff

    def shift(self) -> float:
        return -self.lo if self.lo is not None and self.lo < 0 else 0.0

    def offset(self) -> Optional[float]:
        return self.lo


class RoundAnatomy:
    """The causal round profiler.  Live construction mirrors the other
    monitors (``RoundAnatomy(server, cfg)`` attaches ``server.anatomy``
    and registers scrape instruments); tests and the offline loaders
    pass ``num_workers`` and drive :meth:`observe_publish` directly.

    Feed point: one call per published version with the lineage publish
    row (the same dict :meth:`LineageTracker.observe_publish` writes —
    ``pushes`` carrying worker/step/seq/send_wall/recv_wall/decode_s and
    optional composed trailers, ``apply_s``, ``t``).  Same-thread with
    the serve loop, like every monitor feed point.
    """

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, num_workers: Optional[int] = None,
                 name: str = "server", **overrides: Any):
        cfg = cfg or {}
        self.knobs = dict(ANATOMY_KNOBS)
        self.knobs.update(cfg.get("anatomy_kw") or {})
        self.knobs.update(overrides)
        self.server = server
        if num_workers is None:
            if server is None:
                raise ValueError("need a server or num_workers")
            num_workers = int(server.num_workers)
        self.num_workers = int(num_workers)
        self.name = str(name)
        self.dir = (cfg.get("lineage_dir") or cfg.get("telemetry_dir"))
        self.rounds = 0
        self.publishes = 0
        self._prev_pub_t: Optional[float] = None
        self._prev_send: Dict[int, float] = {}
        #: worker → its previous push's corrected wire time: the push
        #: protocols BLOCK until the server acks, so the previous wire
        #: transfer is inside the worker's inter-send gap and must be
        #: carved out of ``produce`` (else a wire-delayed worker's delay
        #: double-counts into both stages and the advisor ties)
        self._last_wire: Dict[int, float] = {}
        self._env: Dict[int, _Envelope] = {}
        #: bounded round records the advisor replays
        self._rounds: deque = deque(maxlen=int(self.knobs["window"]))
        #: stage → critical-path rounds (stage gated)
        self.critical: Dict[str, int] = {}
        #: (worker, stage) → bounded duration window
        self._stage_win: Dict[Tuple[int, str], deque] = {}
        #: (origin worker, step, seq) → measured (fold_s, encode_s) from
        #: leader hop rows — joined to composed pushes by trace ID (the
        #: hop row carries the group id, the root push the leader wid;
        #: the composed trace IDs are the one key both sides share)
        self._hop_trace: Dict[Tuple[int, int, int], Tuple[float, float]] = {}
        self._hop_trace_order: deque = deque()
        #: group id → recent per-hop fold walls (the structural
        #: controller's hot-hop attribution input — see :meth:`hot_hop`)
        self._group_fold: Dict[int, deque] = {}
        self.overhead_s = 0.0
        self._f = None
        self._rows_since_flush = 0
        if server is not None:
            server.anatomy = self
            reg = getattr(server, "scrape_registry", None)
            if reg is not None:
                self.register(reg())

    # -- feed points ------------------------------------------------------
    def observe_hop(self, row: Dict[str, Any]) -> None:
        """One leader ``hop`` row (``lineage-leader<g>.jsonl``): per-hop
        fold/re-encode walls sharpen the composed-push expansion the
        trailer alone can only bound.  Offline feed (the report and the
        smoke load leader files beside the server's); joined to the
        root's composed pushes by the trailer trace IDs."""
        fold = float(row.get("fold_s") or 0.0)
        enc = float(row.get("encode_s") or 0.0)
        if "leader" in row:
            g = int(row["leader"])
            if g not in self._group_fold:
                self._group_fold[g] = deque(maxlen=8)
            self._group_fold[g].append(fold)
        cap = 4 * int(self.knobs["stage_window"])
        for e in row.get("composed") or ():
            key = (int(e.get("worker", -1)), int(e.get("step", 0)),
                   int(e.get("seq", 0)))
            if key not in self._hop_trace:
                self._hop_trace_order.append(key)
            self._hop_trace[key] = (fold, enc)
        while len(self._hop_trace_order) > cap:
            old = self._hop_trace_order.popleft()
            self._hop_trace.pop(old, None)

    def hot_hop(self) -> Optional[int]:
        """The group whose recent hops fold slowest (mean over the last
        8 observed hop rows per group) — the structural controller's
        ``hot_group`` input: WHICH leader to split when the advisor
        names ``leader_fold`` the top stage.  ``None`` until at least
        two groups have reported (a single group has no 'hotter')."""
        means = {g: sum(w) / len(w)
                 for g, w in self._group_fold.items() if w}
        if len(means) < 2:
            return None
        return max(means, key=means.get)

    def observe_reader_round(self, row: Dict[str, Any]) -> Dict[str, Any]:
        """One reader/follower poll cycle (the read-plane counterpart of
        a training round): written as a ``kind="reader_round"`` row into
        the same ``anatomy-<name>.jsonl`` sidecar.  The offline loaders
        filter on ``kind == "round"``, so reader rounds ride the file
        without perturbing round reconstruction — ``ps_report``/greppers
        see the replica's pull cadence, lag, and relay volume next to
        the server rounds that produced the versions it relays."""
        out = dict(row)
        out["kind"] = "reader_round"
        out.setdefault("t", time.time())
        out["name"] = self.name
        self._write_row(out)
        return out

    def observe_publish(self, row: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Decompose one publish row into its round anatomy.  Returns the
        anatomy round row (also written to ``anatomy-<name>.jsonl`` when
        a directory is armed), or None for push-less publishes (the
        initial parameter publish)."""
        t0 = time.perf_counter()
        try:
            return self._observe(row)
        finally:
            self.overhead_s += time.perf_counter() - t0

    def _observe(self, row: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        pushes = list(row.get("pushes") or [])
        t_pub = float(row.get("t", 0.0))
        self.publishes += 1
        if not pushes:
            self._prev_pub_t = t_pub
            return None
        # round span: previous publish → this publish; the first round
        # anchors at its earliest send (no previous version exists)
        sends = [float(p["send_wall"]) for p in pushes
                 if p.get("send_wall") is not None]
        t_start = (self._prev_pub_t if self._prev_pub_t is not None
                   else (min(sends) if sends else t_pub))
        round_s = max(0.0, t_pub - t_start)
        apply_s = float(row.get("apply_s") or 0.0)

        # feed the clock envelopes BEFORE decomposing: the correction a
        # push needs may be proven by the push itself (first skewed pair)
        for p in pushes:
            w, s, r = p.get("worker"), p.get("send_wall"), p.get("recv_wall")
            if w is None or s is None or r is None:
                continue
            self._env.setdefault(int(w), _Envelope()).feed(float(r) - float(s))

        segs = [self._segments(p) for p in pushes]
        # the gating push: last arrival on the server clock
        gate_i = max(range(len(pushes)),
                     key=lambda i: pushes[i].get("recv_wall") or 0.0)
        gate = dict(segs[gate_i])
        gate["root_fold"] = float(pushes[gate_i].get("decode_s") or 0.0)
        gate["opt_publish"] = apply_s
        known = {k: v for k, v in gate.items()
                 if k in SPEEDUP_STAGES and v is not None}
        attributed = sum(known.values())
        gate["barrier"] = max(0.0, round_s - attributed)
        # the dominant measured stage gates the round; a round whose
        # residual dwarfs every measurement (a degraded round waiting on
        # the barrier) is attributed to the barrier wait — NEVER to a
        # phantom measured stage
        if known and max(known.values()) >= gate["barrier"]:
            stage = max(known, key=known.get)
        else:
            stage = "barrier"
        self.rounds += 1
        self.critical[stage] = self.critical.get(stage, 0) + 1
        gw = int(pushes[gate_i].get("worker", -1))
        for i, p in enumerate(pushes):
            w = int(p.get("worker", -1))
            for st, v in segs[i].items():
                if v is None:
                    continue
                self._stage_win.setdefault(
                    (w, st), deque(maxlen=int(self.knobs["stage_window"]))
                ).append(float(v))
        for st in ("root_fold", "opt_publish"):
            self._stage_win.setdefault(
                (gw, st), deque(maxlen=int(self.knobs["stage_window"]))
            ).append(float(gate[st]))
        rec = {
            "kind": "round",
            "version": int(row.get("version", 0)),
            "t": t_pub,
            "round_s": round(round_s, 6),
            "gating_worker": gw,
            "stage": stage,
            "stages": {k: (None if gate.get(k) is None
                           else round(float(gate[k]), 6))
                       for k in STAGES},
            # per-push arrival offsets relative to round start + their
            # speedup-able chains — what the advisor replays
            "pushes": [
                {"worker": int(p.get("worker", -1)),
                 "arrive_s": round(max(
                     0.0, float(p.get("recv_wall") or t_start) - t_start), 6),
                 "segs": {k: (None if v is None else round(float(v), 6))
                          for k, v in segs[i].items()}}
                for i, p in enumerate(pushes)
            ],
            "post_s": round(gate["root_fold"] + gate["opt_publish"], 6),
        }
        self._rounds.append(rec)
        self._write_row(rec)
        self._prev_pub_t = t_pub
        for i, p in enumerate(pushes):
            if p.get("worker") is not None and p.get("send_wall") is not None:
                self._prev_send[int(p["worker"])] = float(p["send_wall"])
                if segs[i].get("wire") is not None:
                    self._last_wire[int(p["worker"])] = float(
                        segs[i]["wire"])
            # origin workers inside a composed trailer advance their own
            # produce anchors too (their next composed push's gap)
            for e in (p.get("composed") or ()):
                if e.get("worker") is not None and e.get("send_wall"):
                    self._prev_send[int(e["worker"])] = float(e["send_wall"])
        return rec

    def _segments(self, p: Dict[str, Any]) -> Dict[str, Optional[float]]:
        """One push's speedup-able chain segments (produce / encode /
        wire / leader_fold).  All durations are clamped non-negative;
        the wire segment carries the envelope's skew shift."""
        w = p.get("worker")
        send = p.get("send_wall")
        recv = p.get("recv_wall")
        env = self._env.get(int(w)) if w is not None else None
        wire = None
        if send is not None and recv is not None:
            wire = float(recv) - float(send)
            if env is not None:
                wire += env.shift()
            wire = max(0.0, wire)
        composed = p.get("composed") or ()
        leader_fold = None
        encode = None
        if len(composed) >= 1 and send is not None:
            hop = None
            for e in composed:
                hop = self._hop_trace.get((
                    int(e.get("worker", -1)), int(e.get("step", 0)),
                    int(e.get("seq", 0))))
                if hop is not None:
                    break
            if hop is not None:
                # the leader's hop row measured both halves directly
                leader_fold, encode = max(0.0, hop[0]), max(0.0, hop[1])
            else:
                # trailer-only bound: the frame's send_wall is the
                # LEADER's encode site; the trailer's newest origin send
                # bounds when the group fold could have started.
                # Cross-clock (worker → leader), clamped like every
                # segment.
                origin_sends = [float(e["send_wall"]) for e in composed
                                if e.get("send_wall")]
                if origin_sends:
                    leader_fold = max(0.0, float(send) - max(origin_sends))
        produce = None
        if w is not None and send is not None:
            prev = self._prev_send.get(int(w))
            if composed:
                # a composed push's produce is the ORIGIN side's story;
                # the leader's own cadence is fold + upstream push
                prev = None
            if prev is not None:
                # the inter-send gap minus the worker's PREVIOUS wire
                # transfer (a blocking ack-based push sits inside the
                # gap — without the carve-out a slow wire would
                # double-count into produce and the advisor would tie)
                produce = max(0.0, float(send) - prev
                              - self._last_wire.get(int(w), 0.0))
                hist = self._stage_win.get((int(w), "produce"))
                if hist and len(hist) >= 3:
                    # barrier stalls / restart windows / dropped-push
                    # holes inflate the send gap without the worker
                    # computing: clip at produce_cap_x × the worker's
                    # own rolling median — the excess lands in the
                    # round's barrier residual, never a phantom stage
                    cap = float(self.knobs["produce_cap_x"]) * _med(hist)
                    produce = min(produce, cap)
        return {"produce": produce, "encode": encode, "wire": wire,
                "leader_fold": leader_fold}

    # -- what-if engine ---------------------------------------------------
    @staticmethod
    def _project_round(rec: Dict[str, Any], stage: str, *,
                       frac: Optional[float] = None,
                       floor: Optional[float] = None) -> float:
        """One round's projected duration with ``stage`` virtually sped
        up PER PUSH (Coz virtual speedup: every push's arrival moves,
        then the barrier max is re-taken).  Exactly one of ``frac``
        (proportional: each segment loses ``frac`` of itself) or
        ``floor`` (debottleneck: each segment is pulled down to the
        fleet median, never past it) selects the cut.  Per push, not
        per worker — an async/aggregated publish can compose several
        pushes from ONE worker, and a worker-keyed cut would bill the
        last push's cut to all of them.  Post-barrier time rides the
        constant ``slack`` term, so only the barrier max moves under a
        chain-stage speedup."""
        def _cut(seg: float) -> float:
            c = seg * frac if frac is not None else max(0.0, seg - floor)
            return min(seg, c)

        round_s = float(rec["round_s"])
        if stage in ("root_fold", "opt_publish"):
            st = float(rec["stages"].get(stage) or 0.0)
            return max(0.0, round_s - _cut(st))
        arrivals = []
        for p in rec.get("pushes") or ():
            a = float(p["arrive_s"])
            seg = p["segs"].get(stage)
            if seg is not None:
                a -= _cut(float(seg))
            arrivals.append(max(0.0, a))
        if not arrivals:
            return round_s
        old_gate = max(float(p["arrive_s"]) for p in rec["pushes"])
        # slack = everything in the round that is not the barrier max
        # (post-fold, scheduling) — held constant under the projection
        slack = round_s - old_gate
        return max(0.0, max(arrivals) + slack)

    # -- thread-safe read snapshots ---------------------------------------
    # /health and /metrics scrapes run on the HTTP thread while the
    # serve thread appends rounds and stage samples: every reader below
    # snapshots the shared deques/dict in ONE C-level call first (the
    # same hazard registry.staleness_quantile documents) so an append
    # or a first-key insert can never raise "mutated during iteration"
    # into a 500.
    def _rounds_snapshot(self) -> List[Dict[str, Any]]:
        return list(self._rounds)

    def _stage_vals(self, stage: str,
                    worker: Optional[int] = None) -> List[float]:
        """Flattened duration samples for one stage (optionally one
        worker's) from atomically-snapshotted windows."""
        out: List[float] = []
        for (w, st), win in list(self._stage_win.items()):
            if st == stage and (worker is None or w == worker):
                out.extend(win)  # list(win) implicit: extend is C-level
        return out

    def whatif(self, stage: str, frac: float) -> Dict[str, float]:
        """Virtual speedup: ``stage`` ``frac`` faster for EVERY worker.
        Returns projected total/saved seconds and the saving fraction
        over the retained rounds."""
        if stage not in SPEEDUP_STAGES:
            raise ValueError(f"stage {stage!r} is not speedup-able "
                             f"(one of {SPEEDUP_STAGES})")
        total = saved = 0.0
        for rec in self._rounds_snapshot():
            round_s = float(rec["round_s"])
            new_s = self._project_round(rec, stage, frac=float(frac))
            total += round_s
            saved += max(0.0, round_s - new_s)
        return {"stage": stage, "frac": float(frac),
                "total_s": round(total, 6), "saved_s": round(saved, 6),
                "saving_frac": round(saved / total, 6) if total > 0 else 0.0}

    def debottleneck(self, stage: str) -> Dict[str, float]:
        """The "what if this stage were typical" projection: every
        worker's ``stage`` pulled down to the fleet median for that
        stage (never sped past it).  This is the number the what-if
        smoke validates against a measured A/B: removing one worker's
        injected wire delay is exactly a debottleneck of the wire
        stage."""
        if stage not in SPEEDUP_STAGES:
            raise ValueError(f"stage {stage!r} is not speedup-able")
        med = _med(self._stage_vals(stage))
        total = saved = 0.0
        for rec in self._rounds_snapshot():
            round_s = float(rec["round_s"])
            new_s = self._project_round(rec, stage, floor=med)
            total += round_s
            saved += max(0.0, round_s - new_s)
        return {"stage": stage, "fleet_p50_s": round(med, 6),
                "total_s": round(total, 6), "saved_s": round(saved, 6),
                "saving_frac": round(saved / total, 6) if total > 0 else 0.0}

    def advisor(self) -> List[Dict[str, Any]]:
        """The ranked what-if table: one row per speedup-able stage with
        its critical-path share, per-speedup projections, and the
        debottleneck saving — ranked by debottleneck saving (the
        actionable number), then by the 20% projection.  Cached per
        decomposed-round count like :meth:`_whatif20`: ``/health``
        calls this via :meth:`snapshot` per scrape, and replaying the
        retained window ~24× (6 stages × 4 projections) between rounds
        would burn HTTP-thread CPU recomputing identical tables."""
        cached = self.__dict__.get("_advisor_cache")
        if cached is not None and cached[0] == self.rounds:
            return cached[1]
        rows = []
        rounds = max(1, self.rounds)
        for stage in SPEEDUP_STAGES:
            fleet = self._stage_vals(stage)
            if not fleet and not self.critical.get(stage):
                continue
            row: Dict[str, Any] = {
                "stage": stage,
                "critical_rounds": int(self.critical.get(stage, 0)),
                "critical_share": round(
                    self.critical.get(stage, 0) / rounds, 4),
                "p50_ms": round(1e3 * _med(fleet), 3) if fleet else None,
                "p95_ms": (round(1e3 * _p(fleet, 0.95), 3)
                           if fleet else None),
                "debottleneck": self.debottleneck(stage),
            }
            for f in WHATIF_FRACS:
                row[f"whatif_{int(f * 100)}"] = self.whatif(stage, f)
            rows.append(row)
        rows.sort(key=lambda r: (-r["debottleneck"]["saving_frac"],
                                 -r["whatif_20"]["saving_frac"],
                                 r["stage"]))
        self.__dict__["_advisor_cache"] = (self.rounds, rows)
        return rows

    # -- controller estimator ---------------------------------------------
    def regime_estimate(self) -> Optional[Dict[str, float]]:
        """The lineage-derived wire-vs-compute balance: fleet MEDIAN of
        per-worker wire/produce medians over the measured stage windows
        (median-of-medians — one skewed or delayed worker cannot drag
        the fleet's regime, the same robustness argument as the beacon
        path it replaces).  None until ``min_rounds`` rounds have been
        decomposed — the controller falls back to beacon medians."""
        if self.rounds < int(self.knobs["min_rounds"]):
            return None
        wires, computes = [], []
        for w in range(self.num_workers):
            wWin = self._stage_vals("wire", worker=w)
            pWin = self._stage_vals("produce", worker=w)
            if wWin:
                wires.append(_med(wWin))
            if pWin:
                computes.append(_med(pWin))
        if not wires or not computes:
            # BOTH sides or nothing: a tree root only sees composed
            # hops (produce is the origin side's story, never filled
            # here), so a wire-only estimate would read as wire_frac
            # 1.0 and drive the codec rule to maximum compression on a
            # fleet whose compute it cannot see — fall back to beacons
            return None
        return {"wire_s": _med(wires),
                "compute_s": _med(computes),
                "n": float(self.rounds)}

    # -- surfaces ---------------------------------------------------------
    def wire_share(self) -> float:
        """Fraction of decomposed rounds gated by the wire stage."""
        return (self.critical.get("wire", 0) / self.rounds
                if self.rounds else 0.0)

    def _whatif20(self, stage: str) -> float:
        """``whatif(stage, 0.2)["saving_frac"]``, cached per decomposed-
        round count: the canonical metrics dict is built at TSDB tick
        cadence (~5 Hz) and scrape collectors run per scrape — replaying
        the retained window that often would bill real serve/HTTP-thread
        time for numbers that only change per round."""
        cache = self.__dict__.setdefault("_whatif20_cache", {})
        hit = cache.get(stage)
        if hit is not None and hit[0] == self.rounds:
            return hit[1]
        v = self.whatif(stage, 0.2)["saving_frac"]
        cache[stage] = (self.rounds, v)
        return v

    def top_saving_frac(self) -> float:
        """The advisor's best projected saving at the canonical 20%
        virtual speedup — the headline "what would speeding something
        up buy" gauge (round-cached, see :meth:`_whatif20`)."""
        best = 0.0
        for stage in SPEEDUP_STAGES:
            if not self.critical.get(stage):
                continue
            best = max(best, self._whatif20(stage))
        return best

    def snapshot(self) -> Dict[str, Any]:
        """The anatomy section of ``/health`` and the serve metrics —
        pure reads over the bounded windows."""
        rounds = max(1, self.rounds)
        return {
            "armed": True,
            "rounds": self.rounds,
            "publishes": self.publishes,
            "critical_path": [
                {"stage": s, "rounds": n,
                 "share": round(n / rounds, 4)}
                for s, n in sorted(list(self.critical.items()),
                                   key=lambda kv: -kv[1])
            ],
            "stages": {
                s: {"p50_ms": round(1e3 * _med(vals), 3),
                    "p95_ms": round(1e3 * _p(vals, 0.95), 3)}
                for s, vals in ((s, self._stage_vals(s))
                                for s in STAGES)
                if vals
            },
            "clock_offsets": {
                int(w): (None if e.offset() is None
                         else round(e.offset(), 6))
                for w, e in sorted(list(self._env.items()))
            },
            "advisor": self.advisor()[:4],
            "regime": self.regime_estimate(),
            "overhead_s": round(self.overhead_s, 6),
        }

    def register(self, registry) -> None:
        """Scrape instruments: the canonical-key twins plus per-stage
        labeled gauges (share / p50 / 20%-what-if saving per stage)."""

        def collect(r) -> None:
            r.counter(
                "ps_anatomy_rounds_total",
                "rounds decomposed into exact critical paths",
            ).set(float(self.rounds))
            r.gauge(
                "ps_anatomy_wire_share",
                "fraction of decomposed rounds whose critical path is "
                "the wire stage",
            ).set(self.wire_share())
            r.gauge(
                "ps_anatomy_top_saving_frac",
                "best projected round-time saving at a 20% virtual "
                "stage speedup (Coz-style what-if)",
            ).set(self.top_saving_frac())
            rounds = max(1, self.rounds)
            for stage in STAGES:
                vals = self._stage_vals(stage)
                share = self.critical.get(stage, 0) / rounds
                r.gauge("ps_anatomy_stage_share",
                        "critical-path share per stage",
                        labels={"stage": stage}).set(share)
                if vals:
                    r.gauge("ps_anatomy_stage_p50_ms",
                            "per-stage duration p50 (ms)",
                            labels={"stage": stage}).set(
                                1e3 * _med(vals))
                if stage in SPEEDUP_STAGES and self.rounds:
                    r.gauge("ps_anatomy_whatif_saving_frac",
                            "projected round-time saving fraction at a "
                            "20% virtual speedup of this stage",
                            labels={"stage": stage}).set(
                                self._whatif20(stage))

        registry.add_collector(collect)

    # -- disk -------------------------------------------------------------
    def _write_row(self, row: Dict[str, Any]) -> None:
        if not self.dir:
            return
        if self._f is None:
            os.makedirs(self.dir, exist_ok=True)
            self._f = open(anatomy_path(self.dir, self.name), "a")
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


# ---------------------------------------------------------------------------
# offline reconstruction (report sections, smokes, tests)
# ---------------------------------------------------------------------------

def load_anatomy_rows(path: str) -> List[Dict[str, Any]]:
    """``anatomy-*.jsonl`` → row list (torn trailing lines skipped)."""
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


def anatomy_from_round_rows(round_rows: Iterable[Dict[str, Any]],
                            num_workers: Optional[int] = None,
                            **overrides: Any) -> RoundAnatomy:
    """Rebuild a :class:`RoundAnatomy` from its OWN persisted
    ``anatomy-*.jsonl`` round rows (the report's preferred source: the
    live engine already decomposed them).  Owned here — beside
    :meth:`RoundAnatomy._observe`, which populates the same windows
    live — so the offline and live state can never desynchronize."""
    rows = sorted((r for r in round_rows
                   if isinstance(r, dict) and r.get("kind") == "round"),
                  key=lambda r: float(r.get("t", 0.0)))
    if num_workers is None:
        ws = [int(p.get("worker", 0)) for r in rows
              for p in (r.get("pushes") or ())]
        num_workers = (max(ws) + 1) if ws else 1
    eng = RoundAnatomy(num_workers=num_workers, **overrides)
    cap = int(eng.knobs["stage_window"])
    for r in rows:
        eng._rounds.append(r)
        eng.rounds += 1
        eng.publishes += 1
        stage = r.get("stage", "barrier")
        eng.critical[stage] = eng.critical.get(stage, 0) + 1
        for p in r.get("pushes") or ():
            for st, v in (p.get("segs") or {}).items():
                if v is None:
                    continue
                eng._stage_win.setdefault(
                    (int(p.get("worker", -1)), st),
                    deque(maxlen=cap)).append(float(v))
        gw = int(r.get("gating_worker", -1))
        for st in ("root_fold", "opt_publish"):
            v = (r.get("stages") or {}).get(st)
            if v is not None:
                eng._stage_win.setdefault(
                    (gw, st), deque(maxlen=cap)).append(float(v))
    return eng


def anatomy_from_rows(lineage_rows: Iterable[Dict[str, Any]],
                      num_workers: Optional[int] = None,
                      **overrides: Any) -> RoundAnatomy:
    """Rebuild a :class:`RoundAnatomy` offline from persisted lineage
    rows (server ``publish``/``drop`` rows + leader ``hop`` rows mixed
    freely — they are split here).  Rows are replayed in time order, so
    the offline engine decomposes the same rounds the live one did —
    the determinism the offline advisor and the tests lean on."""
    rows = sorted((r for r in lineage_rows if isinstance(r, dict)),
                  key=lambda r: float(r.get("t", 0.0)))
    if num_workers is None:
        ws = [int(p.get("worker", 0))
              for r in rows if r.get("kind") == "publish"
              for p in (r.get("pushes") or ())]
        for r in rows:
            if r.get("kind") == "hop":
                ws.extend(int(e.get("worker", 0))
                          for e in (r.get("composed") or ()))
        num_workers = (max(ws) + 1) if ws else 1
    eng = RoundAnatomy(num_workers=num_workers, **overrides)
    for r in rows:
        kind = r.get("kind")
        if kind == "hop":
            eng.observe_hop(r)
        elif kind == "publish":
            eng.observe_publish(r)
    return eng

"""Hop anatomy: leader-pipeline occupancy tracing and the
streaming-headroom scoreboard.

The round anatomy named ``leader_fold`` the tree's critical stage —
a 719–931 ms hop window at 64 workers — but nothing could see *inside*
that window: between a worker push's ``send_wall`` and the leader's one
upstream frame, the leader's time dissolves into an unattributed blur of
waiting, validating, folding, re-encoding and pushing.  This module is
the occupancy plane for that window.  Per leader, per round, the hop
timeline is reconstructed into sub-stage intervals:

``ingest_wait``
    waiting for group members' pushes to arrive (round start → fold
    start, minus measured validate time);
``validate``
    native PSF2 frame validation (magic/size/fingerprint/CRC), summed
    from the per-frame stamps ``tcpps.cpp``'s bounded ring captures;
``fold`` / ``finalize``
    the compressed-domain fold loop and its one-per-round finalize —
    the fold side is additionally attributable to native kernel time
    through ``wirecodec.cpp``'s per-fold-call span ring;
``encode`` / ``upstream_push``
    the EF re-encode and the one-frame upstream send;
``idle``
    whatever the stamps could not attribute (clamped ≥ 0).

Both native rings are bounded and drop-and-count on overflow — the hot
paths never block or reallocate for observability (the round anatomy's overhead
contract, ≤ 5%).  They are armed and drained only from the pump-owning
thread, the same affinity rule ``tps_server_read_stats`` documents.

The **streaming-headroom projection** is the plane's headline: the tree
ROADMAP's #1 open item is the DynamiQ-style streaming leader hop
(ingest ⇄ fold ⇄ encode overlapped instead of serialized), and
:meth:`HopAnatomy.project` computes what that would buy — round time if
the three pipeline legs were perfectly overlapped (the max of the leg
sums plus a per-frame fill/drain tail) against the measured serial sum.
``headroom_ratio = serial / overlapped``: ≈ 1.0 means the pipeline is
already busy (splitting the group is the fix); ≫ 1 means the hop is
serial and streaming is the fix — the topo controller's upgraded
``leader_fold_hot`` verdict reads exactly this distinction.  The
projection is a pure function of the persisted row's (rounded) fields,
so an offline replay reproduces it byte-for-byte — the what-if smoke's
determinism contract, inherited from the round anatomy.

Rows land in ``hop-<name>.jsonl`` (a registered sidecar prefix, routed
away from the recorder-span merge like every other sidecar).
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: the hop timeline's sub-stage taxonomy, in pipeline order
HOP_STAGES = ("ingest_wait", "validate", "fold", "finalize", "encode",
              "upstream_push", "idle")

#: stages that are WORK (occupancy's numerator) — waiting and idle are not
BUSY_STAGES = ("validate", "fold", "finalize", "encode", "upstream_push")

#: the three pipeline legs a streaming leader would overlap
PIPE_LEGS = (("ingest_wait", "validate"), ("fold", "finalize"),
             ("encode", "upstream_push"))

#: engine tuning knobs and their defaults (``cfg["hop_anatomy_kw"]``)
HOP_KNOBS: Dict[str, Any] = {
    "window": 512,        # hop rounds retained for the scoreboard
    "stage_window": 1024,  # per-stage duration samples kept
    "flush_every": 32,    # JSONL rows buffered between flushes
    "min_rounds": 2,      # rounds before the scoreboard answers
    "ring_capacity": 4096,  # native interval-ring entries (spans/stamps)
}


def hop_path(out_dir: str, name) -> str:
    """``hop-<name>.jsonl`` — a registered sidecar prefix
    (:data:`pytorch_ps_mpi_tpu_torch.telemetry.SIDECAR_PREFIXES`), routed away
    from the recorder-span merge like every other sidecar."""
    return os.path.join(out_dir, f"hop-{name}.jsonl")


def _med(vals) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _r6(v: float) -> float:
    # observe_round's ``round=`` kwarg shadows the builtin in its scope
    return round(float(v), 6)


def _r4(v: float) -> float:
    return round(float(v), 4)


def _p(vals, q: float) -> float:
    s = sorted(vals)
    if not s:
        return math.nan
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class HopAnatomy:
    """The leader-pipeline occupancy profiler.  Live construction
    mirrors the other monitors (``HopAnatomy(server, cfg)`` attaches
    ``server.hop_anatomy`` and registers scrape instruments); tests and
    the offline loaders construct bare and drive :meth:`observe_row`.

    Two feed points:

    * :meth:`observe_round` — the measuring process (a tree leader)
      passes its per-round sub-stage walls; the engine builds the
      canonical row, ingests it, and persists it.
    * :meth:`observe_row` — a persisted (or relayed) row is replayed
      into the same windows; the root's hop tailer and the offline
      loaders use this, so live and replayed state cannot diverge.
    """

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, name: str = "server", **overrides: Any):
        cfg = cfg or {}
        self.knobs = dict(HOP_KNOBS)
        self.knobs.update(cfg.get("hop_anatomy_kw") or {})
        self.knobs.update(overrides)
        self.server = server
        self.name = str(name)
        self.dir = (cfg.get("lineage_dir") or cfg.get("telemetry_dir"))
        self.rounds = 0
        self.frames = 0
        #: native interval-ring entries surrendered to overflow
        self.ring_drops = 0
        self._rounds: deque = deque(maxlen=int(self.knobs["window"]))
        #: stage → bounded duration window (seconds)
        self._stage_win: Dict[str, deque] = {}
        #: per-round scoreboard windows
        self._busy: deque = deque(maxlen=int(self.knobs["window"]))
        self._headroom: deque = deque(maxlen=int(self.knobs["window"]))
        self._serial: deque = deque(maxlen=int(self.knobs["window"]))
        #: leader id → bounded per-leader windows (the fleet view on a
        #: root that tails several leaders' rows)
        self._leaders: Dict[int, Dict[str, Any]] = {}
        self.overhead_s = 0.0
        self._f = None
        self._rows_since_flush = 0
        if server is not None:
            server.hop_anatomy = self
            reg = getattr(server, "scrape_registry", None)
            if reg is not None:
                self.register(reg())

    # -- the projection -----------------------------------------------------
    @staticmethod
    def project(stages: Dict[str, Any], frames: int
                ) -> Tuple[float, float, float]:
        """Streaming-headroom projection from one round's sub-stage
        sums: ``(serial_s, overlap_s, headroom_ratio)``.

        ``serial_s`` is the measured serialized pipeline (every leg back
        to back — idle excluded, it is neither work nor overlappable).
        ``overlap_s`` is the projected round if the three legs ran
        perfectly overlapped: the bottleneck leg's sum plus a pipeline
        fill/drain tail — the non-bottleneck legs' cost for ONE frame,
        which no schedule can hide.  Pure arithmetic over the (rounded)
        row fields, so replays reproduce it byte-identically."""
        legs = [sum(float(stages.get(s) or 0.0) for s in leg)
                for leg in PIPE_LEGS]
        serial = sum(legs)
        bottleneck = max(legs)
        tail = (serial - bottleneck) / max(int(frames), 1)
        overlap = bottleneck + tail
        ratio = serial / overlap if overlap > 0 else 1.0
        return round(serial, 6), round(overlap, 6), round(ratio, 4)

    # -- feed points ----------------------------------------------------------
    def observe_round(self, *, leader: int, round: int, frames: int,
                      stages: Dict[str, float],
                      round_s: Optional[float] = None,
                      t: Optional[float] = None,
                      drops: int = 0, native: bool = False,
                      fold_calls: int = 0, fold_busy_s: float = 0.0,
                      ) -> Dict[str, Any]:
        """One measured leader round → the canonical ``hop_round`` row
        (ingested AND persisted).  ``stages`` carries the measured
        sub-stage walls (idle is derived here, never passed); ``drops``
        counts native ring entries lost to overflow this round."""
        t0 = time.perf_counter()
        st = {s: _r6(stages.get(s) or 0.0)
              for s in HOP_STAGES if s != "idle"}
        attributed = sum(st.values())
        wall = (float(round_s) if round_s is not None else attributed)
        st["idle"] = _r6(max(0.0, wall - attributed))
        serial, overlap, ratio = self.project(st, frames)
        busy = sum(st[s] for s in BUSY_STAGES)
        rec = {
            "kind": "hop_round", "version": 1,
            "t": float(t if t is not None else time.time()),
            "leader": int(leader), "round": int(round),
            "frames": int(frames), "round_s": _r6(wall),
            "stages": st,
            "serial_s": serial, "overlap_s": overlap,
            "headroom_ratio": ratio,
            "busy_frac": _r4(busy / wall) if wall > 0 else 0.0,
            "drops": int(drops), "native": bool(native),
            "fold_calls": int(fold_calls),
            "fold_busy_s": _r6(fold_busy_s),
        }
        self._ingest(rec)
        self._write_row(rec)
        self.overhead_s += time.perf_counter() - t0
        return rec

    def observe_row(self, row: Dict[str, Any]) -> None:
        """Replay one persisted ``hop_round`` row into the windows (the
        root's hop tailer, the offline loaders).  Never writes — the row
        already lives in its producer's sidecar."""
        if not isinstance(row, dict) or row.get("kind") != "hop_round":
            return
        t0 = time.perf_counter()
        self._ingest(row)
        self.overhead_s += time.perf_counter() - t0

    def _ingest(self, rec: Dict[str, Any]) -> None:
        self.rounds += 1
        self.frames += int(rec.get("frames") or 0)
        self.ring_drops += int(rec.get("drops") or 0)
        self._rounds.append(rec)
        cap = int(self.knobs["stage_window"])
        for s, v in (rec.get("stages") or {}).items():
            self._stage_win.setdefault(s, deque(maxlen=cap)).append(
                float(v))
        self._busy.append(float(rec.get("busy_frac") or 0.0))
        self._headroom.append(float(rec.get("headroom_ratio") or 1.0))
        self._serial.append(float(rec.get("serial_s") or 0.0))
        g = int(rec.get("leader", -1))
        lw = self._leaders.setdefault(g, {
            "rounds": 0,
            "busy": deque(maxlen=64), "headroom": deque(maxlen=64),
            "round_s": deque(maxlen=64),
        })
        lw["rounds"] += 1
        lw["busy"].append(float(rec.get("busy_frac") or 0.0))
        lw["headroom"].append(float(rec.get("headroom_ratio") or 1.0))
        lw["round_s"].append(float(rec.get("round_s") or 0.0))

    # -- scoreboard reads -----------------------------------------------------
    def _armed(self) -> bool:
        return self.rounds >= int(self.knobs["min_rounds"])

    def busy_frac(self) -> float:
        """Median per-round busy fraction: the share of the hop window
        the leader spent WORKING (validate/fold/finalize/encode/push)
        rather than waiting — 0.0 until ``min_rounds`` rounds landed."""
        return round(_med(list(self._busy)), 4) if self._armed() else 0.0

    def headroom_ratio(self) -> float:
        """Median streaming-headroom ratio (serial / overlapped): how
        much faster a perfectly pipelined hop would run this workload.
        1.0 = no headroom (or not enough rounds to answer)."""
        return (round(_med(list(self._headroom)), 4)
                if self._armed() else 1.0)

    def ingest_wait_ms(self) -> float:
        vals = list(self._stage_win.get("ingest_wait") or ())
        return round(1e3 * _med(vals), 3) if self._armed() and vals else 0.0

    def serial_ms(self) -> float:
        return (round(1e3 * _med(list(self._serial)), 3)
                if self._armed() else 0.0)

    def hot_leader(self) -> Optional[int]:
        """The leader with the highest median busy fraction — the topo
        controller's occupancy-based hot-group input.  None until two
        leaders report (a single leader has no 'hotter')."""
        meds = {g: _med(list(w["busy"]))
                for g, w in self._leaders.items() if w["busy"]}
        if len(meds) < 2:
            return None
        return max(meds, key=meds.get)

    def snapshot(self) -> Dict[str, Any]:
        """The hop-anatomy section of ``/health`` and the serve metrics
        — pure reads over the bounded windows."""
        return {
            "armed": True,
            "rounds": self.rounds,
            "frames": self.frames,
            "ring_drops": self.ring_drops,
            "busy_frac": self.busy_frac(),
            "ingest_wait_ms": self.ingest_wait_ms(),
            "headroom_ratio": self.headroom_ratio(),
            "serial_ms": self.serial_ms(),
            "stages": {
                s: {"p50_ms": round(1e3 * _med(vals), 3),
                    "p95_ms": round(1e3 * _p(vals, 0.95), 3)}
                for s, vals in ((s, list(self._stage_win.get(s) or ()))
                                for s in HOP_STAGES)
                if vals
            },
            "leaders": {
                int(g): {
                    "rounds": w["rounds"],
                    "busy_frac": round(_med(list(w["busy"])), 4),
                    "headroom_ratio": round(_med(list(w["headroom"])), 4),
                    "round_ms": round(1e3 * _med(list(w["round_s"])), 3),
                }
                for g, w in sorted(self._leaders.items())
            },
            "hot_leader": self.hot_leader(),
            "overhead_s": round(self.overhead_s, 6),
        }

    def register(self, registry) -> None:
        """Scrape instruments: the canonical-key twins plus per-stage
        labeled p50 gauges."""

        def collect(r) -> None:
            r.counter(
                "ps_hop_rounds_total",
                "leader hop rounds decomposed into sub-stage intervals",
            ).set(float(self.rounds))
            r.gauge(
                "ps_hop_busy_frac",
                "median share of the hop window the leader pipeline "
                "spent working (validate/fold/finalize/encode/push)",
            ).set(self.busy_frac())
            r.gauge(
                "ps_hop_ingest_wait_ms",
                "median per-round wait for group pushes to arrive (ms)",
            ).set(self.ingest_wait_ms())
            r.gauge(
                "ps_hop_stream_headroom_ratio",
                "median serial/overlapped round-time ratio — what a "
                "streaming (pipelined) leader hop would buy",
            ).set(self.headroom_ratio())
            r.gauge(
                "ps_hop_serial_ms",
                "median serialized hop pipeline time per round (ms)",
            ).set(self.serial_ms())
            r.counter(
                "ps_hop_ring_drops_total",
                "native interval-ring entries dropped to overflow "
                "(bounded rings never block the hot path)",
            ).set(float(self.ring_drops))
            for stage in HOP_STAGES:
                vals = list(self._stage_win.get(stage) or ())
                if vals:
                    r.gauge("ps_hop_stage_p50_ms",
                            "per-sub-stage duration p50 (ms)",
                            labels={"stage": stage}).set(
                                1e3 * _med(vals))

        registry.add_collector(collect)

    # -- disk -----------------------------------------------------------------
    def _write_row(self, row: Dict[str, Any]) -> None:
        if not self.dir:
            return
        if self._f is None:
            os.makedirs(self.dir, exist_ok=True)
            self._f = open(hop_path(self.dir, self.name), "a")
        self._f.write(json.dumps(row) + "\n")
        self._rows_since_flush += 1
        if self._rows_since_flush >= int(self.knobs["flush_every"]):
            self._f.flush()
            self._rows_since_flush = 0

    def flush(self) -> None:
        """Force the row buffer to disk — a leader calls this per round
        so the root's hop tailer (and the topo controller behind it)
        reads occupancy live, not ``flush_every`` rounds late."""
        if self._f is not None:
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

def load_hop_rows(path: str) -> List[Dict[str, Any]]:
    """``hop-*.jsonl`` → row list (torn trailing lines skipped)."""
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


def hop_anatomy_from_rows(rows: Iterable[Dict[str, Any]],
                          **overrides: Any) -> HopAnatomy:
    """Rebuild a :class:`HopAnatomy` from persisted ``hop_round`` rows.
    Rows are replayed in time order into the same windows the live
    engine fills, and the projection each row carries was computed from
    the row's own rounded fields — so the replayed scoreboard (and a
    re-projection of any row) is byte-identical to the live one."""
    ordered = sorted((r for r in rows if isinstance(r, dict)
                      and r.get("kind") == "hop_round"),
                     key=lambda r: (float(r.get("t", 0.0)),
                                    int(r.get("leader", -1)),
                                    int(r.get("round", 0))))
    eng = HopAnatomy(**overrides)
    for r in ordered:
        eng.observe_row(r)
    return eng


# ---------------------------------------------------------------------------
# Chrome-trace tracks
# ---------------------------------------------------------------------------

#: hop tracks sit above device pids so leader timelines group together
HOP_PID_BASE = 2000


def hop_trace_events(hop_rows: Iterable[Dict[str, Any]],
                     lineage_rows: Optional[Iterable[Dict[str, Any]]] = None,
                     *, t0_wall: float = 0.0) -> List[Dict[str, Any]]:
    """``hop_round`` rows → per-leader Chrome-trace tracks: one ``X``
    span per sub-stage (laid out back to back ending at the row's wall
    time, idle excluded) on pid ``HOP_PID_BASE + leader``.  When the
    leaders' lineage ``hop`` rows are also given, each composed push
    gets a flow STEP event (``ph: "t"``) anchored mid-fold-span with the
    push's canonical trace id — threading the existing worker-push →
    root-consume lineage arrows through the leader's hop track."""
    from pytorch_ps_mpi_tpu_torch.telemetry.lineage import trace_id

    composed: Dict[Tuple[int, int], List[Tuple]] = {}
    for row in lineage_rows or ():
        if row.get("kind") != "hop":
            continue
        key = (int(row.get("leader", -1)), int(row.get("round", -1)))
        composed[key] = [
            (e.get("worker"), e.get("step"), e.get("seq"))
            for e in (row.get("composed") or ())
        ]
    out: List[Dict[str, Any]] = []
    pids: Dict[int, int] = {}
    order = [s for s in HOP_STAGES if s != "idle"]
    for row in hop_rows:
        if not isinstance(row, dict) or row.get("kind") != "hop_round":
            continue
        g = int(row.get("leader", -1))
        pid = pids.setdefault(g, HOP_PID_BASE + len(pids))
        st = row.get("stages") or {}
        total = sum(float(st.get(s) or 0.0) for s in order)
        cursor = (float(row.get("t", 0.0)) - t0_wall - total) * 1e6
        fold_mid = None
        for s in order:
            dur_us = float(st.get(s) or 0.0) * 1e6
            if dur_us <= 0.0:
                continue
            out.append({
                "ph": "X", "name": f"hop.{s}", "cat": "hop",
                "pid": pid, "tid": 1, "ts": cursor, "dur": dur_us,
                "args": {"leader": g, "round": row.get("round"),
                         "frames": row.get("frames")},
            })
            if s == "fold":
                fold_mid = cursor + dur_us * 0.5
            cursor += dur_us
        if fold_mid is None:
            fold_mid = cursor
        for key in composed.get((g, int(row.get("round", -1))), ()):
            out.append({
                "ph": "t", "cat": "lineage", "name": "grad push",
                "id": trace_id(*key), "pid": pid, "tid": 1,
                "ts": fold_mid,
            })
    for g, pid in pids.items():
        out.append({
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": f"leader {g} (hop anatomy)"},
        })
    return out

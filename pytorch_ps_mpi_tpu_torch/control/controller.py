"""Self-driving control plane: close the verdict→action loop
(the JAX package's ``control/controller.py``).

The port differs from the JAX module in three documented ways
(ROADMAP queue 3): the engine's read p95 target comes from
``control_kw``, else ``slo_kw``'s targets, else
:data:`~pytorch_ps_mpi_tpu_torch.telemetry.slo.DEFAULT_TARGETS`, and no
bench record is read; :func:`apply_epoch` ignores a malformed epoch
document but raises when the new codec's kernels cannot be built or
loaded on the worker's card; the renegotiated wires are
:class:`~pytorch_ps_mpi_tpu_torch.parallel.dcn.CodecWire` objects on the
server's and the workers' devices.


Every robustness verdict the stack produces — quarantine offenses
(``telemetry.numerics``), exact per-push staleness (``telemetry.lineage``),
SLO burn rates over the TSDB (``telemetry.slo``), churn counters and
straggler attribution (``telemetry.diagnosis``) — used to feed only
dashboards. The :class:`Controller` turns them into recorded,
replayable, reversible **actions**, executed from inside the serve loop
(fed at the same ``on_tick``/consume sites as the monitors; no thread
ever touches a native transport handle):

1. **codec / ``bucket_mb`` / agg-mode renegotiation** from the measured
   wire-vs-compute balance ("On the Utility of Gradient Compression":
   compression only wins in specific wire-vs-compute regimes, so the
   regime is picked *online*).  The regime inputs come from the
   lineage-derived round-anatomy estimator
   (:meth:`telemetry.anatomy.RoundAnatomy.regime_estimate`) whenever
   lineage is armed — measured wire-stage times from frame
   timestamps, immune to a worker whose beacons are off or skewed —
   with the beacon-median fleet EWMAs as the fallback; the row's
   ``regime_src`` records which source fed it. A renegotiation is an **epoch bump**
   executed through the frame handshake: the server installs the
   new :class:`~pytorch_ps_mpi_tpu_torch.parallel.dcn.CodecWire` beside the
   old one and accepts BOTH fingerprints during the transition
   (in-flight old-epoch frames are consumed, never rejected), the new
   epoch is published to the workers via an atomically-replaced
   ``control-epoch.json`` they poll between steps, and the old epoch
   retires once every live worker has pushed on the new one (or the
   settle window lapses). Ladder entries must not exceed the boot
   wire's payload size — transport buffers are sized once at boot.
2. **staleness-aware per-worker LR scaling** from the exact lineage
   staleness distribution: PAPER.md's AsySG-InCon bound shrinks the
   stable LR as staleness grows, so a worker whose observed staleness
   runs above the fleet median gets its pushes de-weighted by
   ``((1 + fleet_p50) / (1 + worker_stale)) ** gamma`` — applied as a
   per-push weight in the serve loop, so no worker-side change is
   required, and restored to 1.0 when its staleness falls back.
3. **auto-evict / readmit**: numerics-quarantined workers get probation
   readmission after a clean probe window (the probation doubles on
   every re-offense); churn-verdict workers are backoff-evicted from
   the sync barrier (their queued pushes are held, the round completes
   degraded over the survivors) and rejoin through the existing
   degraded-round machinery when the backoff lapses.
4. **read-tier tuning**: admission depth follows the shed rate (raised
   under shed pressure while the read p95 holds its target, halved when
   the p95 burns), and the snapshot ring grows on ring-ageout pressure.
5. **structural actions** (rule ``topo``, armed by
   ``cfg["topo_actions"]``): the TOPOLOGY itself becomes an actuator.
   When the anatomy advisor ranks ``leader_fold`` as the top
   debottleneck (or one tree leader churns past its respawn latch) the
   hot group is SPLIT — members migrate to a freshly promoted leader
   through ``run_tree``'s pinned-port respawn machinery, every
   in-flight push exactly accounted by the existing degraded-round
   fold (see :mod:`pytorch_ps_mpi_tpu_torch.control.topo`). Shed-rate burn
   scales the follower read tier OUT (spawn
   ``serve_readonly --follow-endpoint`` replicas); replica-lag burn or
   a sustained-idle tier scales it back IN. The fleet skew
   verdict becomes a recorded shard split/merge PLAN
   (``control-topo.json``) applied at the next generation. Structural
   actions are latched, flap-counted, reversible rows like every other
   rule — ``group_replan`` has ``group_merge``, ``shard_split`` has
   ``shard_merge``, a scale-out has its scale-in.

Every decision is an event row in ``control-<name>.jsonl`` carrying the
**triggering verdict**, the old/new setting, and the worker (when
per-worker); every rule sits behind a cooldown+hysteresis latch
(SLOWatchdog-style) so the controller can never flap
(evict→readmit→evict of one worker inside a cooldown window is counted
in ``flaps`` and must stay 0).

**Replayability.** The decision core (:class:`ControlEngine`) is a pure
function of its input rows: at every evaluation the live controller
flattens its inputs into one ``{key: float}`` row, persists it through
the TSDB (``timeseries-control-<name>.jsonl``, full precision,
every evaluated row — the ingest throttle is bypassed), and feeds the
engine. :meth:`Controller.replay` over those persisted TSDB rows
re-derives the **identical action sequence** — the "every decision
is a recorded, replayable event" discipline, now for actions instead of
verdicts. The read p95 setpoint is ``cfg["control_kw"]
["read_p95_target_ms"]``, else ``cfg["slo_kw"]["targets"]["read_p95_ms"]``,
else :data:`telemetry.slo.DEFAULT_TARGETS`.

Every action row carries its **triggering verdict** with a
monotonically increasing ``id`` and the owning ``rule`` name injected
by the engine itself — the audit join key ``telemetry_report`` uses to
show actions next to the verdicts that caused them (and, being pure
engine state, byte-identical under replay).

Opt-outs: ``control_kw["pin"]`` lists rule names
(``codec``/``lr_scale``/``evict``/``read_tier``/``topo``) whose
settings are pinned — the controller observes but never acts on them.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: tuning knobs and their defaults (overridable via ``cfg["control_kw"]``)
CONTROL_KNOBS: Dict[str, Any] = {
    "eval_every_s": 0.5,       # evaluation cadence (at the serve tick)
    "warmup_s": 2.0,           # observe-only window after the first row
    "window_s": 5.0,           # rate window for counter-derived signals
    "cooldown_s": 10.0,        # default per-rule action cooldown
    "ewma_alpha": 0.25,        # per-worker staleness EWMA (lineage off)
    "pin": (),                 # rule names the controller must not touch
    # -- codec / bucket_mb / agg renegotiation (rule "codec") -----------
    "ladder": None,            # [{"codec","codec_kw","bucket_mb"}, ...];
    #                            entry 0 MUST be the boot wire config;
    #                            None disables the rule entirely
    "wire_hi": 0.65,           # wire fraction above => downshift (idx+1)
    "wire_lo": 0.25,           # wire fraction below => upshift (idx-1)
    "settle_s": 5.0,           # max transition age before forced retire
    "settle_min_s": 1.0,       # min transition age before ANY retire —
    #                            in-flight old-epoch frames get at least
    #                            this grace even when the seen fleet has
    #                            already switched (or, after a server
    #                            restart, is still empty)
    # -- staleness-aware per-worker LR scaling (rule "lr_scale") --------
    "lr_gamma": 1.0,           # weight = ((1+p50)/(1+stale))**gamma
    "lr_min_scale": 0.25,      # weight floor (never mute a worker)
    "lr_step": 0.1,            # min |delta| before a scale action fires
    "lr_stale_margin": 1.0,    # only de-weight past p50 + margin
    # -- auto-evict / readmit (rule "evict") ----------------------------
    "churn_evict": 6.0,        # churn delta per window => barrier evict
    "evict_backoff_s": 5.0,    # eviction span; doubles per repeat
    "evict_backoff_max_s": 120.0,
    "max_evict_frac": 0.5,     # never evict past this fraction of fleet
    "probation_s": 4.0,        # clean window before quarantine readmit
    "probation_factor": 2.0,   # probation doubles per re-offense
    "probation_max_s": 300.0,
    # -- read-tier tuning (rule "read_tier") ----------------------------
    "shed_hi_per_s": 1.0,      # sheds/s above => raise admission depth
    "depth_min": 4,
    "depth_max": 1024,
    "ring_grow_per_s": 0.5,    # ring ageouts/s above => grow the ring
    "ring_max": 64,
    "read_p95_target_ms": None,  # None => slo.DEFAULT_TARGETS
    # -- structural actions (rule "topo"; cfg["topo_actions"] arms) -----
    "topo_actions": False,       # master switch (mirrors cfg key)
    "replan_max": 1,             # group splits per run (spare wid slots)
    "replan_cooldown_s": 20.0,   # min gap between structural replans
    "leader_fold_hot_frac": 0.2,  # advisor saving_frac flagging a hop hot
    "hop_streaming_headroom": 1.2,  # serial/overlap ratio => fix:streaming
    "leader_churn_replan": 2.0,  # leader respawns before a churn replan
    "replica_min": 0,            # read-tier floor (scale-out bootstraps)
    "replica_max": 4,            # read-tier ceiling
    "replica_cooldown_s": 10.0,  # min gap between replica scale steps
    "replica_shed_per_s": 2.0,   # root sheds/s that scale the tier OUT
    "replica_lag_hi": 8.0,       # worst replica lag (versions) => IN
    # freshness-burn scale-out: the fleet's worst-edge age (the
    # freshness plane's serving_age_ms_max rollup) past this wall bound
    # means readers somewhere see a stale model — add serving capacity
    "replica_age_hi_ms": 5000.0,
    "shard_cooldown_s": 30.0,    # min gap between shard plan changes
    "shard_split_skew": 0.5,     # fleet skew spread_frac that splits
    "shard_merge_skew": 0.1,     # spread below which a split merges back
}

#: rule names ``control_kw["pin"]`` accepts
RULES = ("codec", "lr_scale", "evict", "read_tier", "topo")


def epoch_path(control_dir: str) -> str:
    return os.path.join(control_dir, "control-epoch.json")


def actions_path(control_dir: str, name: str) -> str:
    return os.path.join(control_dir, f"control-{name}.jsonl")


def write_epoch(control_dir: str, doc: Dict[str, Any]) -> str:
    """Atomically publish the current wire epoch for the worker fleet
    (write-to-temp + rename — a worker's poll can never read a torn
    document)."""
    os.makedirs(control_dir, exist_ok=True)
    path = epoch_path(control_dir)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def poll_epoch(control_dir: str, state: Dict[str, Any]
               ) -> Optional[Dict[str, Any]]:
    """Worker-side epoch poll: one ``os.stat`` per call (cheap enough
    for every step); parses the document only when the file changed and
    returns it only when it names a NEWER epoch than ``state`` has seen.
    ``state`` is the caller's mutable ``{"epoch": int, "mtime": int}``."""
    path = epoch_path(control_dir)
    try:
        st = os.stat(path)
    except OSError:
        return None
    if st.st_mtime_ns == state.get("mtime"):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        # transient read failure (EMFILE, rename race): do NOT latch
        # the mtime — the next poll must retry, or this worker would
        # silently miss the epoch and be config-rejected after retire
        return None
    state["mtime"] = st.st_mtime_ns
    if not isinstance(doc, dict):
        return None
    if int(doc.get("epoch", 0)) <= int(state.get("epoch", 0)):
        return None
    state["epoch"] = int(doc["epoch"])
    return doc


def ladder_agg_ok(ladder, agg_req: str = "auto") -> List[bool]:
    """Per-rung compressed-domain capability, derived from the codec
    registry under the same exactness policy serve() applies (an
    approximate algebra needs the explicit ``agg == "on"``).
    Deterministic from cfg alone, so live and replayed engines agree on
    whether a retire re-arms aggregation. The serve loop still
    re-validates the REAL wire (per-unit shapes) before folding."""
    out: List[bool] = []
    for e in ladder or ():
        try:
            from pytorch_ps_mpi_tpu_torch.codecs import get_codec

            c = get_codec(e["codec"], **(e.get("codec_kw") or {}))
            ok = bool(getattr(c, "supports_aggregate", False)) and (
                str(agg_req) == "on"
                or getattr(c, "agg_exact", True))
        except Exception:
            ok = False
        out.append(ok)
    return out


def rung_key(doc: Dict[str, Any]) -> tuple:
    """The identity of a ladder rung or an epoch document: its codec,
    keywords and bucket size (raises ``KeyError``/``ValueError``/
    ``TypeError`` on a malformed one)."""
    return (str(doc["codec"]),
            json.dumps(doc.get("codec_kw") or {}, sort_keys=True),
            float(doc.get("bucket_mb", 0.0)))


def prepare_ladder(worker, ladder, boot: Optional[tuple] = None) -> int:
    """Build the wire of every rung of ``ladder`` but the ``boot`` one on
    a transport worker at its boot (``worker.prepare_wire``), so that a
    later :func:`apply_epoch` swaps a built wire in and the step that
    switches costs what any other does. A rung the worker cannot take
    is skipped (the epoch then declines as it would have); a kernel
    build or load failure raises. Returns the rungs prepared."""
    prep = getattr(worker, "prepare_wire", None)
    if prep is None:
        return 0
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    n = 0
    for entry in ladder or ():
        try:
            key = rung_key(entry)
            code = get_codec(key[0], **(entry.get("codec_kw") or {}))
        except (KeyError, ValueError, TypeError):
            continue
        if key != boot:
            n += bool(prep(key, code, bucket_mb=key[2]))
    return n


def apply_epoch(worker, doc: Dict[str, Any]) -> bool:
    """Apply a polled epoch document to a transport worker: build the
    codec and renegotiate the wire (the rung's wire that
    :func:`prepare_ladder` built, where there is one). Returns False
    when the worker's transport declines (tree leaf conns, unframed
    wires) or the document is malformed (an unknown codec, a missing
    key, a bad value): the worker keeps pushing its old epoch and the
    server keeps consuming it until the old epoch retires. A failure to
    build or load the new codec's kernels on the worker's card is not a
    malformed document and raises (``renegotiate`` loads them before it
    switches the wire), so no worker stays on the old codec without
    saying so."""
    reneg = getattr(worker, "renegotiate", None)
    if reneg is None:
        return False
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    try:
        key = rung_key(doc)
        code = get_codec(key[0], **(doc.get("codec_kw") or {}))
    except (KeyError, ValueError, TypeError):
        return False
    return bool(reneg(code, bucket_mb=key[2], key=key))


def slo_read_target(cfg: Dict[str, Any],
                    knobs: Dict[str, Any]) -> Optional[float]:
    """The read p95 setpoint a live run and its replay agree on: the
    ``read_p95_target_ms`` knob, else the SLO watchdog's ``read_p95_ms``
    target from ``cfg["slo_kw"]``, else None (the engine's default)."""
    if knobs.get("read_p95_target_ms") is not None:
        return float(knobs["read_p95_target_ms"])
    t = ((cfg.get("slo_kw") or {}).get("targets") or {}).get("read_p95_ms")
    return float(t) if t is not None else None


def _r(v: float, nd: int = 6) -> float:
    """One rounding discipline for every number that lands in an action
    row — replay must reproduce rows byte-identically."""
    return round(float(v), nd)


class _RateWindow:
    """Windowed per-second delta of a monotonic counter fed as (t, v)
    samples — reset-clamped like the TSDB's rate (a counter that resets
    across a server restart reads as 0, not negative)."""

    __slots__ = ("win",)

    def __init__(self, maxlen: int = 64):
        self.win: deque = deque(maxlen=maxlen)

    def rate(self, t: float, v: float, window_s: float) -> float:
        self.win.append((t, v))
        t0 = t - window_s
        pts = [(tt, vv) for tt, vv in self.win if tt >= t0]
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return 0.0
        return max(0.0, (pts[-1][1] - pts[0][1])
                   / (pts[-1][0] - pts[0][0]))


class ControlEngine:
    """The pure decision core: ``step(row) -> [action rows]``.

    Deterministic by construction — no wall clock, no randomness, no
    live-state reads; everything a rule consults arrives in the input
    row (which is why live and replayed runs derive identical action
    sequences). All mutation is internal latch state.
    """

    def __init__(self, knobs: Dict[str, Any], num_workers: int,
                 *, agg_capable: bool = False,
                 depth: int = 64, ring: int = 8,
                 ladder_idx: int = 0, epoch: int = 0,
                 agg_ok: Optional[List[bool]] = None,
                 seed_transition: bool = False,
                 read_p95_target_ms: Optional[float] = None):
        self.knobs = dict(CONTROL_KNOBS)
        self.knobs.update(knobs or {})
        self.num_workers = int(num_workers)
        self.pin = set(self.knobs.get("pin") or ())
        bad = self.pin - set(RULES)
        if bad:
            raise ValueError(f"unknown pinned rule(s) {sorted(bad)}; "
                             f"rules are {RULES}")
        ladder = self.knobs.get("ladder")
        self.ladder: List[Dict[str, Any]] = (
            [dict(e) for e in ladder] if ladder else [])
        # per-rung compressed-domain capability: agg_on is only emitted
        # at a retire whose rung can actually fold (see ladder_agg_ok)
        self.agg_ok: List[bool] = (
            list(agg_ok) if agg_ok is not None
            else [True] * len(self.ladder))
        self.ladder_idx = int(ladder_idx)
        self.agg_capable = bool(agg_capable)
        self.agg_suspended = False
        self._agg_was_on = False  # re-arm after the transition retires
        self.epoch = int(epoch)
        self.transition_since: Optional[float] = None
        # a restored generation (ladder_idx/epoch from the epoch file)
        # anchors its retiring-transition grace window at the FIRST
        # evaluation's timestamp — engine-side, so replay with the same
        # init reproduces the retire row
        self._seed_transition = bool(seed_transition)
        self.lr_scale: Dict[int, float] = {}
        self.evicted: Dict[int, float] = {}        # worker -> until_t
        self._evict_backoff: Dict[int, float] = {}
        self._evict_span: Dict[int, float] = {}    # span of the CURRENT
        self._evict_guard: Dict[int, float] = {}   # no re-evict before t
        self.probation: Dict[int, Dict[str, float]] = {}
        self._probation_span: Dict[int, float] = {}
        self.depth = int(depth)
        self.ring = int(ring)
        if read_p95_target_ms is not None:
            self.read_p95_target_ms = float(read_p95_target_ms)
        elif self.knobs["read_p95_target_ms"] is not None:
            self.read_p95_target_ms = float(
                self.knobs["read_p95_target_ms"])
        else:
            from pytorch_ps_mpi_tpu_torch.telemetry.slo import \
                DEFAULT_TARGETS

            self.read_p95_target_ms = float(DEFAULT_TARGETS["read_p95_ms"])
        # structural-action state (rule "topo"): the engine's intended
        # shape — the executors chase it, never the other way round
        self.replans = 0           # tree group splits in force
        self.replicas = 0          # intended read-tier replica count
        self.shard_extra = 0       # planned shard-count delta (+1/0)
        self._replica_idle_since: Optional[float] = None
        self.topo_actions = 0      # structural action rows emitted
        self.actions: List[Dict[str, Any]] = []
        self.flaps = 0
        self.t0: Optional[float] = None
        self._last_action: Dict[Any, float] = {}
        # flap detection memory: last few (t, old, new) per (rule,worker)
        self._act_hist: Dict[Any, deque] = {}
        self._rates: Dict[str, _RateWindow] = {}

    # -- bookkeeping ------------------------------------------------------
    def _rate(self, key: str, t: float, v: float) -> float:
        rw = self._rates.get(key)
        if rw is None:
            rw = self._rates[key] = _RateWindow()
        return rw.rate(t, v, float(self.knobs["window_s"]))

    def _cooled(self, key: Any, t: float,
                span: Optional[float] = None) -> bool:
        last = self._last_action.get(key)
        span = float(self.knobs["cooldown_s"]) if span is None else span
        return last is None or t - last >= span

    def _act(self, t: float, rule: str, action: str, old: Any, new: Any,
             verdict: Dict[str, Any], worker: Optional[int] = None,
             latch: Any = None) -> Dict[str, Any]:
        # the latch key must be the SAME one the rule's _cooled() check
        # reads, or the cooldown never engages (default: per rule+worker)
        key = (rule, worker) if latch is None else latch
        # flap detection: a DOUBLE reversal on one (rule, worker) inside
        # one cooldown window — e.g. evict→readmit→evict — is a flap. A
        # single reversal (de-weight then restore, evict then backoff
        # readmit) is the reversible-actions contract working, not a
        # flap. The latches are tuned so this never fires; the counter
        # exists so chaos runs can assert it stayed 0.
        hist = self._act_hist.setdefault(key, deque(maxlen=4))
        if (len(hist) >= 2
                and t - hist[-2][0] < float(self.knobs["cooldown_s"])
                and new == hist[-1][1] and hist[-1][2] == hist[-2][1]):
            self.flaps += 1
        hist.append((t, old, new))
        # audit join key: every verdict carries a monotone id + the
        # owning rule — engine state, so replay reproduces both
        verdict = {"id": len(self.actions), "rule": rule, **verdict}
        row: Dict[str, Any] = {
            "t": _r(t, 4), "rule": rule, "action": action,
            "old": old, "new": new, "verdict": verdict,
        }
        if worker is not None:
            row["worker"] = int(worker)
        if rule == "topo":
            self.topo_actions += 1
        self.actions.append(row)
        self._last_action[key] = t
        return row

    # -- the sweep --------------------------------------------------------
    def step(self, row: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One evaluation over a flat input row. Returns the NEW action
        rows (usually empty)."""
        t = float(row["ts"])
        if self.t0 is None:
            self.t0 = t
        if self._seed_transition:
            self.transition_since = t
            self._seed_transition = False
        n0 = len(self.actions)
        warm = t - self.t0 >= float(self.knobs["warmup_s"])
        self._step_codec(row, t, warm)
        if warm:
            self._step_lr(row, t)
            self._step_evict(row, t)
            self._step_read_tier(row, t)
            self._step_topo(row, t)
        return self.actions[n0:]

    # -- rule: codec / bucket_mb / agg renegotiation ----------------------
    def _step_codec(self, row: Dict[str, Any], t: float,
                    warm: bool) -> None:
        if not self.ladder or "codec" in self.pin:
            return
        # transition retire runs even during warmup (a transition only
        # exists because an action already fired)
        if self.transition_since is not None:
            pending = row.get("epoch_pending", 0.0)
            age = t - self.transition_since
            aged = age >= float(self.knobs["settle_s"])
            settled = (pending <= 0
                       and age >= float(self.knobs["settle_min_s"]))
            if settled or aged:
                self._act(t, "codec", "epoch_retire",
                          self.epoch - 1, self.epoch,
                          {"kind": "transition_done",
                           "epoch_pending": _r(pending),
                           "settled": bool(pending <= 0)})
                self.transition_since = None
                if self._agg_was_on:
                    if (0 <= self.ladder_idx < len(self.agg_ok)
                            and self.agg_ok[self.ladder_idx]):
                        self._agg_was_on = False
                        self.agg_suspended = False
                        self._act(t, "codec", "agg_on", 0.0, 1.0,
                                  {"kind": "transition_done",
                                   "epoch": self.epoch})
                    # else: this rung cannot fold — aggregation STAYS
                    # suspended (truthfully: no agg_on row, agg_mode 0)
                    # until a later transition lands on a capable rung
            return
        if not warm:
            return
        wire_s = float(row.get("wire_s", 0.0))
        compute_s = float(row.get("compute_s", 0.0))
        total = wire_s + compute_s
        frac = wire_s / total if total > 0 else None
        down = (frac is not None and frac > float(self.knobs["wire_hi"])
                and self.ladder_idx + 1 < len(self.ladder))
        up = (frac is not None and frac < float(self.knobs["wire_lo"])
              and self.ladder_idx > 0)
        if not (down or up):
            if (self.agg_suspended and self._agg_was_on
                    and 0 <= self.ladder_idx < len(self.agg_ok)
                    and self.agg_ok[self.ladder_idx]
                    and self._cooled(("codec", None), t)):
                # an agg_off whose renegotiation never materialized (the
                # balance fell back in band before the cooled re-check):
                # abandon it and re-arm, or the run pays decode-sum cost
                # forever on one noisy evaluation
                self.agg_suspended = False
                self._agg_was_on = False
                self._act(t, "codec", "agg_on", 0.0, 1.0,
                          {"kind": "renegotiation_abandoned",
                           "wire_frac": (None if frac is None
                                         else _r(frac))})
            return
        if not self._cooled(("codec", None), t):
            return
        verdict = {"kind": "wire_bound" if down else "compute_bound",
                   "wire_frac": _r(frac), "wire_s": _r(wire_s),
                   "compute_s": _r(compute_s)}
        if self.agg_capable and not self.agg_suspended:
            # step 1 of a renegotiation under armed aggregation: suspend
            # the compressed-domain fold first (the serve loop drains
            # its raw round queues on the decode path), bump the epoch
            # at the NEXT cooled evaluation
            self.agg_suspended = True
            self._agg_was_on = True
            self._act(t, "codec", "agg_off", 1.0, 0.0, verdict)
            return
        old_i, new_i = self.ladder_idx, (
            self.ladder_idx + 1 if down else self.ladder_idx - 1)
        self.ladder_idx = new_i
        self.epoch += 1
        self.transition_since = t
        self._act(t, "codec", "renegotiate",
                  self._ladder_name(old_i), self._ladder_name(new_i),
                  {**verdict, "epoch": self.epoch})

    def _ladder_name(self, i: int) -> str:
        e = self.ladder[i]
        name = str(e.get("codec"))
        if e.get("bucket_mb"):
            name += f"@{e['bucket_mb']}mb"
        return name

    # -- rule: staleness-aware per-worker LR scaling ----------------------
    def _step_lr(self, row: Dict[str, Any], t: float) -> None:
        if "lr_scale" in self.pin:
            return
        p50 = float(row.get("stale_p50", 0.0))
        gamma = float(self.knobs["lr_gamma"])
        lo = float(self.knobs["lr_min_scale"])
        step = float(self.knobs["lr_step"])
        margin = float(self.knobs["lr_stale_margin"])
        for w in range(self.num_workers):
            stale = float(row.get(f"w{w}_stale", 0.0))
            if stale > p50 + margin:
                target = max(lo, min(
                    1.0, ((1.0 + p50) / (1.0 + stale)) ** gamma))
            else:
                target = 1.0  # staleness back in band: restore full LR
            target = _r(target, 3)
            cur = self.lr_scale.get(w, 1.0)
            if abs(target - cur) < step or not self._cooled(
                    ("lr_scale", w), t):
                continue
            self.lr_scale[w] = target
            self._act(t, "lr_scale", "scale", cur, target,
                      {"kind": "stale", "worker_stale": _r(stale),
                       "fleet_p50": _r(p50), "gamma": gamma}, worker=w)

    # -- rule: auto-evict / readmit ---------------------------------------
    def _step_evict(self, row: Dict[str, Any], t: float) -> None:
        if "evict" in self.pin:
            return
        k = self.knobs
        # quarantine probation readmission
        for w in range(self.num_workers):
            quar = row.get(f"w{w}_quar", 0.0) > 0
            if not quar:
                self.probation.pop(w, None)
                continue
            pr = self.probation.get(w)
            if pr is None:
                span = self._probation_span.get(
                    w, float(k["probation_s"]))
                self.probation[w] = {"since": t, "span": span,
                                     "nonf": row.get(f"w{w}_nonfinite",
                                                     0.0)}
                continue
            if row.get(f"w{w}_nonfinite", 0.0) > pr["nonf"]:
                # new offense while quarantined: restart the clean
                # window (and lengthen the next one)
                pr["since"] = t
                pr["nonf"] = row.get(f"w{w}_nonfinite", 0.0)
                continue
            if t - pr["since"] >= pr["span"]:
                self._probation_span[w] = min(
                    float(k["probation_max_s"]),
                    pr["span"] * float(k["probation_factor"]))
                self.probation.pop(w, None)
                self._act(t, "evict", "readmit_quarantine", 1.0, 0.0,
                          {"kind": "probation_clean",
                           "clean_s": _r(t - pr["since"]),
                           "nonfinite": _r(pr["nonf"]),
                           "next_probation_s": _r(
                               self._probation_span[w])}, worker=w)
        # churn-verdict barrier eviction / backoff readmission
        max_evicted = max(1, int(self.num_workers
                                 * float(k["max_evict_frac"])))
        for w in range(self.num_workers):
            until = self.evicted.get(w)
            if until is not None:
                if t >= until:
                    span = self._evict_span.get(
                        w, float(k["evict_backoff_s"]))
                    del self.evicted[w]
                    # re-evict guard: the flap window — churn must
                    # re-accumulate for a full backoff before this
                    # worker can be evicted again
                    self._evict_guard[w] = t + span
                    self._act(t, "evict", "readmit", 1.0, 0.0,
                              {"kind": "backoff_elapsed",
                               "evicted_s": _r(span)}, worker=w)
                continue
            churn_rate = self._rate(f"w{w}_churn", t,
                                    float(row.get(f"w{w}_churn", 0.0)))
            churn_delta = churn_rate * float(k["window_s"])
            if (churn_delta >= float(k["churn_evict"])
                    and len(self.evicted) < max_evicted
                    and t >= self._evict_guard.get(w, -1e18)
                    and self._cooled(("evict", w), t)):
                backoff = self._evict_backoff.get(
                    w, float(k["evict_backoff_s"]))
                self.evicted[w] = t + backoff
                self._evict_span[w] = backoff
                self._evict_backoff[w] = min(
                    float(k["evict_backoff_max_s"]), backoff * 2.0)
                self._act(t, "evict", "evict", 0.0, 1.0,
                          {"kind": "churning",
                           "churn_per_window": _r(churn_delta),
                           "backoff_s": _r(backoff)}, worker=w)

    # -- rule: read-tier tuning -------------------------------------------
    def _step_read_tier(self, row: Dict[str, Any], t: float) -> None:
        if "read_tier" in self.pin or row.get("serving", 0.0) <= 0:
            return
        k = self.knobs
        shed_rate = self._rate("reads_shed", t,
                               float(row.get("reads_shed", 0.0)))
        p95 = float(row.get("read_p95_ms", 0.0))
        target = self.read_p95_target_ms
        if (p95 > target and self.depth > int(k["depth_min"])
                and self._cooled(("read_tier", "depth"), t)):
            old = self.depth
            self.depth = max(int(k["depth_min"]), self.depth // 2)
            self._act(t, "read_tier", "depth", old, self.depth,
                      {"kind": "read_p95_burn", "read_p95_ms": _r(p95),
                       "target_ms": _r(target)},
                      latch=("read_tier", "depth"))
        elif (shed_rate > float(k["shed_hi_per_s"])
              and p95 < 0.8 * target
              and self.depth < int(k["depth_max"])
              and self._cooled(("read_tier", "depth"), t)):
            old = self.depth
            self.depth = min(int(k["depth_max"]), self.depth * 2)
            self._act(t, "read_tier", "depth", old, self.depth,
                      {"kind": "shed_pressure",
                       "sheds_per_s": _r(shed_rate),
                       "read_p95_ms": _r(p95), "target_ms": _r(target)},
                      latch=("read_tier", "depth"))
        ageout_rate = self._rate("ring_ageouts", t,
                                 float(row.get("ring_ageouts", 0.0)))
        if (ageout_rate > float(k["ring_grow_per_s"])
                and self.ring < int(k["ring_max"])
                and self._cooled(("read_tier", "ring"), t)):
            old = self.ring
            self.ring = min(int(k["ring_max"]), self.ring * 2)
            self._act(t, "read_tier", "ring", old, self.ring,
                      {"kind": "ring_thrash",
                       "ageouts_per_s": _r(ageout_rate)},
                      latch=("read_tier", "ring"))

    # -- rule: structural actions (topology as an actuator) ---------------
    def _step_topo(self, row: Dict[str, Any], t: float) -> None:
        if not self.knobs.get("topo_actions") or "topo" in self.pin:
            return
        k = self.knobs
        # (a) tree re-plan: the advisor's ranked debottleneck decides —
        # a replan only fires when leader_fold is the TOP stage and its
        # projected saving clears the hot threshold (or a leader churns
        # past the respawn latch: respawn loops are structural too)
        if row.get("tree_groups", 0.0) > 0:
            hot = int(row.get("hot_group", -1.0))
            churn_grp = int(row.get("hot_churn_group", -1.0))
            saving = float(row.get("lf_saving_frac", 0.0))
            fold_hot = (row.get("lf_top", 0.0) > 0 and hot >= 0
                        and saving >= float(k["leader_fold_hot_frac"]))
            churn_hot = (churn_grp >= 0
                         and float(row.get("leader_respawns", 0.0))
                         >= float(k["leader_churn_replan"]))
            if (self.replans < int(k["replan_max"])
                    and (fold_hot or churn_hot)
                    and self._cooled(("topo", "replan"), t,
                                     float(k["replan_cooldown_s"]))):
                self.replans += 1
                if fold_hot:
                    verdict = {"kind": "leader_fold_hot", "group": hot,
                               "saving_frac": _r(saving)}
                    if row.get("hop_rounds", 0.0) > 0:
                        # hop anatomy refines the verdict: a serial
                        # pipeline with real streaming headroom wants
                        # an overlapped hop, not more leaders; a busy
                        # pipeline with no headroom wants the split
                        headroom = float(
                            row.get("hop_headroom_ratio", 1.0))
                        verdict["fix"] = (
                            "streaming"
                            if headroom
                            >= float(k["hop_streaming_headroom"])
                            else "split")
                        verdict["hop_busy_frac"] = _r(
                            row.get("hop_busy_frac", 0.0))
                        verdict["hop_headroom_ratio"] = _r(headroom)
                else:
                    verdict = {"kind": "leader_churn",
                               "group": churn_grp,
                               "respawns": _r(row.get(
                                   "leader_respawns", 0.0))}
                self._act(t, "topo", "group_replan",
                          self.replans - 1, self.replans, verdict,
                          latch=("topo", "replan"))
            elif (self.replans > 0 and not fold_hot and not churn_hot
                  # merge hysteresis: the hop must be COLD (saving well
                  # under the split threshold) for a doubled cooldown —
                  # a split that merges back on one quiet window would
                  # be the replan-storm failure mode
                  and saving < 0.5 * float(k["leader_fold_hot_frac"])
                  and self._cooled(("topo", "replan"), t,
                                   2.0 * float(k["replan_cooldown_s"]))):
                self.replans -= 1
                self._act(t, "topo", "group_merge",
                          self.replans + 1, self.replans,
                          {"kind": "hotspot_cleared",
                           "saving_frac": _r(saving)},
                          latch=("topo", "replan"))
        # (b) elastic read tier: shed burn scales OUT, replica-lag burn
        # or a sustained-idle tier scales IN — replicas are actuators,
        # not hand-sized cfg
        if row.get("serving", 0.0) > 0 and int(k["replica_max"]) > 0:
            shed_rate = self._rate("topo_reads_shed", t,
                                   float(row.get("reads_shed", 0.0)))
            lag = float(row.get("replica_lag_max", 0.0))
            # freshness burn: the worst edge's age-of-information (the
            # fleet serving_age_ms_max rollup, persisted in THIS row)
            edge_age = float(row.get("edge_age_ms", 0.0))
            age_hot = edge_age >= float(k["replica_age_hi_ms"])
            if (shed_rate > 0 or age_hot
                    or self.replicas <= int(k["replica_min"])):
                self._replica_idle_since = None
            elif self._replica_idle_since is None:
                self._replica_idle_since = t
            idle = (self._replica_idle_since is not None
                    and t - self._replica_idle_since
                    >= 2.0 * float(k["replica_cooldown_s"]))
            if (self.replicas < int(k["replica_max"])
                    and (shed_rate >= float(k["replica_shed_per_s"])
                         or age_hot
                         or self.replicas < int(k["replica_min"]))
                    and self._cooled(("topo", "replica"), t,
                                     float(k["replica_cooldown_s"]))):
                old = self.replicas
                self.replicas += 1
                if shed_rate >= float(k["replica_shed_per_s"]):
                    verdict = {"kind": "shed_pressure",
                               "sheds_per_s": _r(shed_rate)}
                elif age_hot:
                    verdict = {"kind": "edge_age_burn",
                               "edge_age_ms": _r(edge_age)}
                else:
                    verdict = {"kind": "tier_floor",
                               "replica_min": int(k["replica_min"])}
                self._act(t, "topo", "replica", old, self.replicas,
                          verdict, latch=("topo", "replica"))
            elif (self.replicas > int(k["replica_min"])
                  and (lag >= float(k["replica_lag_hi"]) or idle)
                  and self._cooled(("topo", "replica"), t,
                                   float(k["replica_cooldown_s"]))):
                old = self.replicas
                self.replicas -= 1
                if lag >= float(k["replica_lag_hi"]):
                    verdict = {"kind": "replica_lag_burn",
                               "lag_versions": _r(lag)}
                else:
                    verdict = {"kind": "tier_idle",
                               "idle_s": _r(t - self._replica_idle_since)}
                self._act(t, "topo", "replica", old, self.replicas,
                          verdict, latch=("topo", "replica"))
        # (c) shard split/merge: the fleet skew verdict becomes a
        # recorded PLAN (control-topo.json; applied at the next
        # generation through sharded.planned_shards) — never a live
        # migration
        shards = int(row.get("shards_n", 0.0))
        if shards >= 2:
            skew = float(row.get("shard_skew", 0.0))
            if (self.shard_extra == 0
                    and row.get("shard_skew_hot", 0.0) > 0
                    and skew >= float(k["shard_split_skew"])
                    and self._cooled(("topo", "shard"), t,
                                     float(k["shard_cooldown_s"]))):
                self.shard_extra = 1
                self._act(t, "topo", "shard_split", shards, shards + 1,
                          {"kind": "shard_skew",
                           "spread_frac": _r(skew)},
                          latch=("topo", "shard"))
            elif (self.shard_extra > 0
                  and skew <= float(k["shard_merge_skew"])
                  and self._cooled(("topo", "shard"), t,
                                   2.0 * float(k["shard_cooldown_s"]))):
                self.shard_extra = 0
                self._act(t, "topo", "shard_merge", shards + 1, shards,
                          {"kind": "skew_cleared",
                           "spread_frac": _r(skew)},
                          latch=("topo", "shard"))

    # -- surfaces ---------------------------------------------------------
    def lr_scale_min(self) -> float:
        return min(self.lr_scale.values()) if self.lr_scale else 1.0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "actions_total": len(self.actions),
            "flaps": self.flaps,
            "epoch": self.epoch,
            "ladder": [self._ladder_name(i)
                       for i in range(len(self.ladder))],
            "ladder_idx": self.ladder_idx,
            "transition_active": self.transition_since is not None,
            "agg_suspended": self.agg_suspended,
            "lr_scale": {int(w): v for w, v in sorted(
                self.lr_scale.items())},
            "evicted": sorted(self.evicted),
            "probation": sorted(self.probation),
            "admission_depth": self.depth,
            "ring": self.ring,
            "read_p95_target_ms": _r(self.read_p95_target_ms, 3),
            "pinned": sorted(self.pin),
            "topo_armed": bool(self.knobs.get("topo_actions")),
            "topo_actions": self.topo_actions,
            "group_replans": self.replans,
            "replicas": self.replicas,
            "shard_extra": self.shard_extra,
            "recent_actions": self.actions[-8:],
        }


class Controller:
    """The live half: builds input rows from the attached server +
    monitors, persists them through the TSDB, feeds the
    :class:`ControlEngine`, and EXECUTES the actions it emits.

    Construction mirrors the monitors (``Controller(server, cfg)``
    attaches ``server.controller`` and registers scrape instruments);
    feed points are :meth:`observe_push` at the serve loop's consume
    site and :meth:`tick` at its tick cadence — both same-thread with
    the transport pumps.
    """

    def __init__(self, server, cfg: Optional[Dict[str, Any]] = None,
                 *, core=None, name: str = "server", **overrides: Any):
        cfg = cfg or {}
        self.knobs = dict(CONTROL_KNOBS)
        self.knobs.update(cfg.get("control_kw") or {})
        self.knobs.update(overrides)
        # the structural-action switch is a TOP-LEVEL cfg key (callers
        # arm it like cfg["control"]); the knob mirrors it so the pure
        # engine sees one boolean — replay() derives it the same way
        if cfg.get("topo_actions"):
            self.knobs["topo_actions"] = True
        self.server = server
        self.core = core if core is not None else getattr(
            server, "serving_core", None)
        self.name = str(name)
        self.num_workers = int(server.num_workers)
        self.cfg = cfg
        self.dir = (cfg.get("control_dir") or cfg.get("telemetry_dir"))
        ladder = self.knobs.get("ladder")
        if ladder:
            self._check_ladder(ladder)
            if (not getattr(server, "frame", False)
                    or getattr(server, "wire", None) is None
                    or getattr(server, "tree_slots", 0)):
                # a wire that cannot renegotiate (unframed, codec-less,
                # or a tree trailer wire whose hop codec is the tree's
                # own agreement) must not run the codec rule at all —
                # the engine's epoch would drift fictitiously while
                # every execution failed
                print("control: codec ladder disabled — this wire "
                      "cannot renegotiate (needs frame_check + a codec "
                      "wire, non-tree)", flush=True)
                ladder = None
                self.knobs["ladder"] = None
        if ladder:
            if not self.dir:
                # without the epoch file the workers can never learn a
                # new epoch: the forced settle-window retire would then
                # config-reject the whole fleet forever — fail at
                # construction, not mid-run
                raise ValueError(
                    "a codec ladder needs cfg['control_dir'] (or "
                    "telemetry_dir): workers poll control-epoch.json "
                    "there to follow renegotiations")
            # every rung must fit the boot wire's frame size NOW: a rung
            # that only failed inside the action executor would leave
            # the engine's ladder_idx/epoch permanently diverged from
            # the real wire (the executor swallows exceptions by design)
            self._check_ladder_sizes(server, ladder)
        depth = (self.core.admission_depth if self.core is not None
                 else int(CONTROL_KNOBS["depth_min"]))
        ring = (int(self.core.knobs["ring"]) if self.core is not None
                else 8)
        self.engine = ControlEngine(
            self.knobs, self.num_workers,
            agg_capable=False,  # serve() calls set_agg before the loop
            depth=depth, ring=ring,
            agg_ok=ladder_agg_ok(self.knobs.get("ladder"),
                                 str(cfg.get("agg", "auto"))),
            read_p95_target_ms=slo_read_target(cfg, self.knobs))
        # elastic read tier: the replica scaler is built lazily at the
        # first scale action (the core's read listener may bind after
        # construction) — see _replica_scaler()
        self._replicas = None
        # per-worker staleness EWMAs — the lineage-off fallback input
        # (exact per-push staleness windows win when lineage is armed)
        self._stale_ewma: Dict[int, Optional[float]] = {}
        self._last_eval = 0.0
        self.exec_errors = 0
        self.overhead_s = 0.0

        self.history = None
        self._actions_f = None
        self.actions_file: Optional[str] = None
        if self.dir:
            from pytorch_ps_mpi_tpu_torch.telemetry.timeseries import (
                MetricsHistory,
            )

            self.history = MetricsHistory(
                dir=self.dir, name=f"control-{self.name}")
            self.actions_file = actions_path(self.dir, self.name)
            os.makedirs(self.dir, exist_ok=True)
            self._actions_f = open(self.actions_file, "a")
        server.controller = self
        reg = getattr(server, "scrape_registry", None)
        if reg is not None:
            self.register(reg())
        # a supervisor-restarted server generation rejoins the fleet's
        # current wire epoch: the epoch file outlives the generation
        self._restore_epoch()

    @staticmethod
    def _check_ladder(ladder) -> None:
        for i, e in enumerate(ladder):
            if not isinstance(e, dict) or not e.get("codec"):
                raise ValueError(
                    f"control ladder entry {i} must be a dict with a "
                    f"'codec' name, got {e!r}")

    @staticmethod
    def _check_ladder_sizes(server, ladder) -> None:
        """Build each rung's wire against the server template and check
        it fits the boot frame (the same cap ``renegotiate_wire``
        enforces) — one CPU wire a rung, at construction."""
        from pytorch_ps_mpi_tpu_torch.codecs import get_codec
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import CodecWire

        boot = int(server._expected_payload)
        for i, e in enumerate(ladder):
            code = get_codec(e["codec"], **(e.get("codec_kw") or {}))
            # the sizes alone: a CPU wire allocates nothing on the card
            w = CodecWire(code, server.template, device="cpu",
                          bucket_mb=float(e.get("bucket_mb", 0.0)))
            if w.wire_bytes > boot:
                raise ValueError(
                    f"control ladder entry {i} ({e['codec']!r}) needs "
                    f"{w.wire_bytes} B payloads but the boot wire (and "
                    f"every transport buffer) was sized for {boot} B — "
                    "ladder entries must not exceed the boot wire")

    # -- properties the serve loop reads ----------------------------------
    @property
    def agg_suspended(self) -> bool:
        return self.engine.agg_suspended

    @property
    def epoch(self) -> int:
        return self.engine.epoch

    @property
    def actions_total(self) -> int:
        return len(self.engine.actions)

    @property
    def flaps(self) -> int:
        return self.engine.flaps

    @property
    def evicted(self):
        return self.engine.evicted

    @property
    def topo_actions_total(self) -> int:
        return self.engine.topo_actions

    @property
    def group_replans(self) -> int:
        return self.engine.replans

    @property
    def replicas_live(self) -> int:
        """REAL live replica processes (the scaler's truth), not the
        engine's intent — a failed spawn shows up as the gap."""
        return self._replicas.live if self._replicas is not None else 0

    def lr_scale_min(self) -> float:
        return self.engine.lr_scale_min()

    def push_weight(self, worker: int) -> float:
        """The per-push LR weight the serve loop applies — 1.0 unless
        the lr_scale rule has de-weighted this worker."""
        return self.engine.lr_scale.get(int(worker), 1.0)

    def is_evicted(self, worker: int) -> bool:
        return int(worker) in self.engine.evicted

    def set_agg(self, armed: bool) -> None:
        """serve() reports whether compressed-domain aggregation is
        armed — a codec renegotiation then sequences agg_off → epoch
        bump → retire → agg_on."""
        self.engine.agg_capable = bool(armed)

    # -- feed points ------------------------------------------------------
    def observe_push(self, worker: int, staleness: int) -> None:
        """O(1) per consumed push (the same consume site that feeds the
        HealthMonitor): per-worker staleness EWMA — the lr_scale input
        when lineage's exact windows are not armed."""
        w = int(worker)
        a = float(self.knobs["ewma_alpha"])
        v = self._stale_ewma.get(w)
        self._stale_ewma[w] = (float(staleness) if v is None
                               else v + a * (staleness - v))

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation (self-throttled to ``eval_every_s``): build
        the input row, persist it, run the engine, execute the new
        actions. Returns the new action rows."""
        t = time.time() if now is None else float(now)
        if t - self._last_eval < float(self.knobs["eval_every_s"]):
            return []
        t0 = time.thread_time()
        self._last_eval = t
        row = self._input_row(t)
        if self.history is not None:
            # force: every engine-evaluated row must persist, or replay
            # would see fewer rows than the live engine did. The one
            # case force cannot bypass — a non-monotone wall clock
            # (NTP step) — must then skip the evaluation too: an
            # unpersisted row feeding the engine would break the
            # byte-identical replay contract.
            if not self.history.sample(row, now=t, force=True):
                self.overhead_s += time.thread_time() - t0
                return []
        actions = self.engine.step(row)
        for a in actions:
            self._record(a)
            self._execute(a)
        self.overhead_s += time.thread_time() - t0
        return actions

    # -- input row --------------------------------------------------------
    def _input_row(self, t: float) -> Dict[str, float]:
        server = self.server
        m = server.metrics()
        row: Dict[str, float] = {
            "ts": t,
            "stale_p50": m["staleness_p50"],
            "stale_p95": m["staleness_p95"],
            "stale_drops": m["stale_drops"],
            "grads_received": m["grads_received"],
            "frames_rejected": m["frames_rejected"],
            "push_e2e_p95_ms": m["push_e2e_p95_ms"],
            "reads_shed": m["reads_shed"],
            "read_p95_ms": m["read_p95_ms"],
            "decodes_per_publish": m["decodes_per_publish"],
            "serving": 1.0 if (self.core is not None
                               and self.core.armed) else 0.0,
            "ring_ageouts": float(self.core.ring_ageouts
                                  if self.core is not None else 0.0),
            "epoch_pending": float(self._epoch_pending()),
        }
        hm = getattr(server, "health_monitor", None)
        nm = getattr(server, "numerics_monitor", None)
        lt = getattr(server, "lineage_tracker", None)
        an = getattr(server, "anatomy", None)
        # wire-vs-compute regime: the lineage-derived round-anatomy
        # estimator wins when armed and warmed — it measures the wire
        # stage from frame timestamps (clock-corrected), so a worker
        # whose BEACONS are off or skewed cannot hide a wire-bound
        # fleet.  Beacon medians are the fallback.  Either way the
        # numbers land in THIS persisted row, so replay consumes the
        # estimator's output byte-identically without knowing which
        # source produced it.
        est = an.regime_estimate() if an is not None else None
        if est is not None:
            row["compute_s"] = float(est["compute_s"])
            row["wire_s"] = float(est["wire_s"])
            row["regime_src"] = 1.0  # 1 = lineage anatomy, 0 = beacons
        else:
            compute, wire = [], []
            if hm is not None:
                for h in hm._w:
                    if h.compute_ewma.value is not None:
                        compute.append(h.compute_ewma.value)
                    if h.wire_ewma.value is not None:
                        wire.append(h.wire_ewma.value)

            def _med(xs):
                # fleet MEDIAN, not mean: one compute-bound straggler
                # must not mask a wire-bound fleet (the same robustness
                # argument as the diagnosis layer's median+MAD gates) —
                # the codec rule picks the regime for the FLEET
                s = sorted(xs)
                n = len(s)
                return (s[n // 2] if n % 2
                        else 0.5 * (s[n // 2 - 1] + s[n // 2])) if s else 0.0

            row["compute_s"] = _med(compute)
            row["wire_s"] = _med(wire)
            row["regime_src"] = 0.0
        respawns = getattr(server, "_supervisor_respawns", None) or {}
        for w in range(self.num_workers):
            if lt is not None and lt._w[w].stale_win:
                win = sorted(lt._w[w].stale_win)
                stale = float(win[min(len(win) - 1,
                                      int(round(0.95 * (len(win) - 1))))])
            else:
                stale = float(self._stale_ewma.get(w) or 0.0)
            row[f"w{w}_stale"] = stale
            row[f"w{w}_quar"] = (1.0 if nm is not None
                                 and nm.is_quarantined(w) else 0.0)
            row[f"w{w}_nonfinite"] = float(
                nm._w[w].nonfinite if nm is not None else 0.0)
            churn = float(server.frames_rejected.get(w, 0))
            churn += 2.0 * float(respawns.get(w, 0))
            if hm is not None:
                churn += float(hm._w[w].retries + hm._w[w].reconnects)
            row[f"w{w}_churn"] = churn
            row[f"w{w}_grads"] = float(
                hm._w[w].grads if hm is not None else 0.0)
        if self.knobs.get("topo_actions"):
            row.update(self._topo_inputs(an))
        return row

    def _topo_inputs(self, an) -> Dict[str, float]:
        """Structural-rule inputs, flattened into the persisted row —
        the topo rule replays from THESE numbers, never from live state.
        ``topo_state`` is the run_tree supervisor's shape bulletin
        (groups in force, leader respawn churn); the advisor supplies
        the ranked leader_fold saving; the fleet poller supplies shard
        skew and the worst replica's lag."""
        server = self.server
        ts = getattr(server, "topo_state", None) or {}
        out: Dict[str, float] = {
            "tree_groups": float(ts.get("groups", 0.0)),
            "leader_respawns": float(ts.get("leader_respawns", 0.0)),
            "hot_churn_group": float(ts.get("hot_churn_group", -1.0)),
        }
        lf_top, lf_saving, hot_group = 0.0, 0.0, -1.0
        if an is not None:
            adv = an.advisor()
            if adv and adv[0].get("stage") == "leader_fold":
                lf_top = 1.0
            lf = next((a for a in adv
                       if a.get("stage") == "leader_fold"), None)
            if lf is not None:
                lf_saving = float((lf.get("debottleneck") or {}).get(
                    "saving_frac", 0.0))
            hot = an.hot_hop()
            if hot is not None:
                hot_group = float(hot)
        out["lf_top"] = lf_top
        out["lf_saving_frac"] = lf_saving
        out["hot_group"] = hot_group
        # hop-anatomy occupancy plane (0.0 / 1.0 neutral when unarmed —
        # hop_rounds==0 keeps the topo rule byte-identical to a run
        # without hop tracing)
        ha = getattr(server, "hop_anatomy", None)
        hop_rounds = hop_busy = 0.0
        hop_headroom = 1.0
        if ha is not None and ha.rounds:
            hop_rounds = float(ha.rounds)
            hop_busy = float(ha.busy_frac())
            hop_headroom = float(ha.headroom_ratio())
        out["hop_rounds"] = hop_rounds
        out["hop_busy_frac"] = hop_busy
        out["hop_headroom_ratio"] = hop_headroom
        out["replicas_live"] = float(self.replicas_live)
        lag = skew = skew_hot = shards = edge_age = 0.0
        fm = getattr(server, "fleet_monitor", None)
        if fm is not None:
            try:
                snap = fm.poll()
            except Exception:
                snap = None
            if snap and snap.get("armed"):
                fleet = snap.get("fleet") or {}
                lag = float(fleet.get("replica_lag_versions_max", 0.0))
                # worst-edge age-of-information: the freshness plane's
                # fleet rollup — the evidence behind edge_age_burn
                edge_age = float(fleet.get("serving_age_ms_max", 0.0))
                shards = float(sum(
                    1 for m in (snap.get("members") or {}).values()
                    if m.get("ok") and m.get("role") == "shard"))
                for v in (snap.get("skew") or {}).values():
                    skew = max(skew, float(v.get("spread_frac", 0.0)))
                    if v.get("flagged"):
                        skew_hot = 1.0
        out["replica_lag_max"] = lag
        out["edge_age_ms"] = edge_age
        out["shard_skew"] = skew
        out["shard_skew_hot"] = skew_hot
        out["shards_n"] = shards
        return out

    def _epoch_pending(self) -> int:
        """Live workers still pushing an older epoch (0 outside a
        transition) — the retire signal."""
        table = getattr(self.server, "_epoch_table", None)
        if not table:
            return 0
        seen = getattr(self.server, "_epoch_seen", {})
        cur = getattr(self.server, "_epoch", 0)
        pending = 0
        for w in range(self.num_workers):
            if w not in self.server.last_seen:
                continue  # never-seen workers are the supervisor's story
            if seen.get(w, 0) < cur:
                pending += 1
        return pending

    # -- action recording + execution -------------------------------------
    def _record(self, action: Dict[str, Any]) -> None:
        if self._actions_f is not None:
            self._actions_f.write(json.dumps(action) + "\n")
            self._actions_f.flush()
        from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

        record_event("control.action", rule=action["rule"],
                     action=action["action"],
                     worker=action.get("worker"),
                     old=str(action["old"]), new=str(action["new"]))

    def _execute(self, action: Dict[str, Any]) -> None:
        """Apply one engine action to the live system. Failures are
        counted, not propagated — a broken actuator must not take the
        serve loop down (and the recorded row stays the engine's
        deterministic decision, not the execution outcome) — except a
        codec's kernels that do not build or load on the card
        (:class:`~pytorch_ps_mpi_tpu_torch.parallel.dcn.KernelLoadError`):
        counted, the server would stay on its old codec while the
        engine, its rows and their replay say the fleet switched."""
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import KernelLoadError

        try:
            self._execute_inner(action)
        except KernelLoadError:
            raise
        except Exception as e:
            self.exec_errors += 1
            from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

            record_event("control.exec_error", rule=action["rule"],
                         action=action["action"], error=str(e))

    def _execute_inner(self, action: Dict[str, Any]) -> None:
        rule, act = action["rule"], action["action"]
        if rule == "codec":
            if act == "renegotiate":
                entry = self.engine.ladder[self.engine.ladder_idx]
                from pytorch_ps_mpi_tpu_torch.codecs import get_codec

                code = get_codec(entry["codec"],
                                 **(entry.get("codec_kw") or {}))
                self.server.renegotiate_wire(
                    code, bucket_mb=float(entry.get("bucket_mb", 0.0)))
                if self.dir:
                    write_epoch(self.dir, {
                        "epoch": self.engine.epoch,
                        "codec": entry["codec"],
                        "codec_kw": entry.get("codec_kw") or {},
                        "bucket_mb": float(entry.get("bucket_mb", 0.0)),
                    })
            elif act == "epoch_retire":
                fin = getattr(self.server, "finish_renegotiation", None)
                if fin is not None:
                    fin()
            # agg_off / agg_on: pure engine state; the serve loop reads
            # ctl.agg_suspended at its round sites
        elif rule == "evict":
            if act == "readmit_quarantine":
                nm = getattr(self.server, "numerics_monitor", None)
                if nm is not None:
                    nm.readmit(int(action["worker"]))
            # evict / readmit: engine state read by the sync barrier
        elif rule == "read_tier":
            if self.core is None:
                return
            if act == "depth":
                self.core.set_admission_depth(int(action["new"]))
            elif act == "ring":
                self.core.set_ring(int(action["new"]))
        elif rule == "topo":
            if act in ("group_replan", "group_merge"):
                # the run_tree supervisor installed the actuator: it
                # owns the leader processes and the pinned ports
                ta = getattr(self.server, "topo_actuator", None)
                if ta is not None:
                    if act == "group_replan":
                        ta.request_replan(action["verdict"])
                    else:
                        ta.request_merge(action["verdict"])
            elif act == "replica":
                sc = self._replica_scaler()
                if sc is not None:
                    sc.scale_to(int(action["new"]), action["verdict"])
            elif act in ("shard_split", "shard_merge"):
                if self.dir:
                    from pytorch_ps_mpi_tpu_torch.control.topo import (
                        write_shard_plan,
                    )

                    write_shard_plan(self.dir, int(action["new"]),
                                     action["verdict"])

    def _replica_scaler(self):
        """Build the replica scaler on first use: the read tier must be
        live (core with a bound read listener) and a control/telemetry
        dir armed — else replica actions record but cannot execute
        (counted in ``exec_errors`` by the caller's raise)."""
        if self._replicas is not None:
            return self._replicas
        rp = getattr(self.core, "read_port", None)
        if not rp or not self.dir:
            raise RuntimeError(
                "replica scale action needs a live read tier "
                "(cfg['read_port']) and a control/telemetry dir")
        from pytorch_ps_mpi_tpu_torch.control.topo import ReplicaScaler

        self._replicas = ReplicaScaler(
            "127.0.0.1", int(rp), dir=self.dir,
            fleet_dir=self.cfg.get("fleet_dir"))
        return self._replicas

    def _restore_epoch(self) -> None:
        """A restarted server generation must rejoin the fleet's current
        wire epoch BEFORE consuming: workers renegotiated by a previous
        generation keep pushing the bumped fingerprint, which a
        boot-wire server would config-reject forever."""
        if not self.dir or not self.engine.ladder:
            return
        state: Dict[str, Any] = {"epoch": 0, "mtime": 0}
        doc = poll_epoch(self.dir, state)
        if doc is None:
            return
        idx = next((i for i, e in enumerate(self.engine.ladder)
                    if e.get("codec") == doc.get("codec")
                    and float(e.get("bucket_mb", 0.0))
                    == float(doc.get("bucket_mb", 0.0))), None)
        if idx is None or idx == self.engine.ladder_idx:
            return
        from pytorch_ps_mpi_tpu_torch.codecs import get_codec
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import KernelLoadError

        entry = self.engine.ladder[idx]
        code = get_codec(entry["codec"], **(entry.get("codec_kw") or {}))
        try:
            self.server.renegotiate_wire(
                code, bucket_mb=float(entry.get("bucket_mb", 0.0)))
        except KernelLoadError:
            raise  # the card cannot run the fleet's codec: no server
        except Exception as e:
            # a failed restore must never crash Controller construction
            # — a supervisor would respawn-loop the generation forever.
            # Skipping leaves new-epoch pushes config-rejected (visible
            # churn) instead of a dead server.
            self.exec_errors += 1
            from pytorch_ps_mpi_tpu_torch.telemetry.recorder import (
                record_event,
            )

            record_event("control.exec_error", rule="codec",
                         action="restore_epoch", error=str(e))
            return
        # the old (boot) epoch stays accepted for a real grace window
        # (settle_min_s .. settle_s, anchored at the FIRST evaluation):
        # workers that pushed boot-fingerprint frames just before this
        # generation came up are consumed, not rejected
        self.engine.ladder_idx = idx
        self.engine.epoch = int(doc["epoch"])
        self.engine._seed_transition = True
        setattr(self.server, "_epoch", int(doc["epoch"]))

    # -- surfaces ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out = self.engine.snapshot()
        out.update({
            "armed": True,
            "name": self.name,
            "exec_errors": self.exec_errors,
            "overhead_s": _r(self.overhead_s),
            "actions_file": self.actions_file,
            "input_file": (self.history.path
                           if self.history is not None else None),
        })
        return out

    def register(self, registry) -> None:
        def collect(r) -> None:
            r.counter("ps_control_actions_total",
                      "controller actions executed (all rules)").set(
                          float(self.actions_total))
            r.counter("ps_control_flaps_total",
                      "action reversals inside one cooldown window "
                      "(should stay 0)").set(float(self.flaps))
            r.gauge("ps_control_epoch",
                    "current wire epoch (codec renegotiations since "
                    "boot)").set(float(self.epoch))
            r.gauge("ps_control_evicted",
                    "workers currently backoff-evicted from the sync "
                    "barrier").set(float(len(self.engine.evicted)))
            r.gauge("ps_control_lr_scale_min",
                    "smallest per-worker staleness LR weight in force "
                    "(1 = no de-weighting)").set(
                        float(self.lr_scale_min()))
            r.counter("ps_topo_actions_total",
                      "structural (topology) actions: group replans, "
                      "replica scale steps, shard plan changes").set(
                          float(self.topo_actions_total))
            r.gauge("ps_replicas_live",
                    "read-tier replica processes currently live "
                    "(controller-spawned)").set(float(self.replicas_live))
            r.counter("ps_group_replans_total",
                      "tree group splits currently in force (a merge "
                      "reverts one)").set(float(self.group_replans))

        registry.add_collector(collect)

    def close(self) -> None:
        if self.history is not None:
            self.history.close()
        sc, self._replicas = self._replicas, None
        if sc is not None:
            sc.close()
        f, self._actions_f = self._actions_f, None
        if f is not None:
            f.close()

    # -- replay -----------------------------------------------------------
    @classmethod
    def replay(cls, rows: List[Dict[str, Any]], *,
               num_workers: int, cfg: Optional[Dict[str, Any]] = None,
               agg_capable: bool = False, depth: int = 64, ring: int = 8,
               ladder_idx: int = 0, epoch: int = 0,
               seed_transition: bool = False,
               **overrides: Any) -> List[Dict[str, Any]]:
        """Re-derive the action sequence from persisted TSDB rows
        (``timeseries-control-<name>.jsonl`` via
        :func:`~pytorch_ps_mpi_tpu_torch.telemetry.timeseries.load_timeseries_rows`).
        Deterministic: the same rows, knobs and INITIAL setpoints
        produce byte-identical action rows — the controller twin of
        ``SLOWatchdog.replay``. Pass the live run's boot
        ``depth``/``ring`` (the serving knobs); for a supervisor-
        restarted generation that restored a wire epoch from
        ``control-epoch.json``, additionally pass its restored
        ``ladder_idx``/``epoch`` and ``seed_transition=True``."""
        knobs = dict((cfg or {}).get("control_kw") or {})
        knobs.update(overrides)
        # same derivation as the live __init__: the top-level cfg switch
        # arms the topo rule — replay must see the identical knob
        if (cfg or {}).get("topo_actions"):
            knobs["topo_actions"] = True
        eng = ControlEngine(
            knobs, num_workers, agg_capable=agg_capable,
            depth=depth, ring=ring, ladder_idx=ladder_idx, epoch=epoch,
            seed_transition=seed_transition,
            agg_ok=ladder_agg_ok(knobs.get("ladder"),
                                 str((cfg or {}).get("agg", "auto"))),
            read_p95_target_ms=slo_read_target(cfg or {}, knobs))
        out: List[Dict[str, Any]] = []
        for r in rows:
            out.extend(eng.step(r["m"]))
        return out

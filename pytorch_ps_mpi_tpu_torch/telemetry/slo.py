"""SLO watchdog: multi-window burn-rate rules over the metrics history
(the JAX package's ``telemetry/slo.py``).

The read-only half of the self-driving control plane:
every signal a future controller would act on first becomes a measured,
retained, *gated* verdict here. A rule names one canonical metric key,
a target, and how to read the series (``value`` — windowed mean of a
gauge like ``push_e2e_p95_ms`` — or ``rate`` — windowed per-second
delta of a counter like ``stale_drops``/``reads_shed``). Its **burn
rate** is measured/target; the SRE multi-window discipline applies: a
rule breaches only when BOTH the short window (fast detection) and the
long window (flap suppression) burn above the threshold, and the breach
is **latched** — one verdict event when it trips, one recovery event
when both windows drop back under ``recovery_factor``, nothing in
between. An injected straggler therefore trips *exactly one* burn
verdict, not one per tick.

Verdicts are recorded three ways, all replayable (determinism
discipline — :meth:`SLOWatchdog.replay` re-derives the identical
verdict sequence from the persisted ``timeseries-*.jsonl`` rows):

- flight-recorder events (``slo.breach`` / ``slo.recover``);
- ``slo-<name>.jsonl`` rows beside the other telemetry side channels
  (routed away from the recorder-span merge like ``lineage-*``);
- the ``slo`` section in ``/health`` and ``/fleet``, plus the
  ``ps_slo_burn_rate{rule=...}`` gauge and ``ps_slo_breaches_total``
  scrape instruments.

Targets come from the committed perf trajectory when one exists:
:func:`derive_targets` reads ``bench_gate``-style
``benchmarks/results/*.jsonl`` rows and ``BENCH_r*.json`` round records
and sets each target at ``median × slack`` — the SLO is "don't regress
past what this repo has measured", the same contract ``bench_gate``
enforces offline, now evaluated live. Explicit
``cfg["slo_kw"]["targets"]`` always wins; :data:`DEFAULT_TARGETS` backs
everything else.
"""

from __future__ import annotations

import glob
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

#: tuning knobs and their defaults (overridable via ``cfg["slo_kw"]``)
SLO_KNOBS: Dict[str, Any] = {
    "eval_every_s": 0.5,     # evaluation cadence (at the serve tick)
    "short_window_s": 5.0,   # fast-detection window
    "long_window_s": 30.0,   # flap-suppression window
    "burn_threshold": 1.0,   # burn > this on BOTH windows => breach
    "recovery_factor": 0.9,  # both windows under thr*this => recover
    "min_samples": 4,        # window warmup before a rule can breach
    "slack": 2.0,            # derive_targets: target = median * slack
    "targets": {},           # explicit {key: target} overrides
    "rules": None,           # full rule-list override
}

#: fallback targets when no measured trajectory covers a key — generous
#: by design: an SLO that false-positives on a healthy laptop run is
#: worse than one that only catches real regressions
DEFAULT_TARGETS: Dict[str, float] = {
    "push_e2e_p95_ms": 500.0,     # exact lineage e2e (worker -> publish)
    "read_p95_ms": 250.0,         # read-tier service time
    "stale_drops_per_s": 0.2,     # staleness-bound violations
    "reads_shed_per_s": 0.5,      # admission-control rejections
    "frames_rejected_per_s": 0.2,  # wire corruption / config drift
    "decodes_per_publish": 16.0,  # decode storm (agg regression)
    "codec_rel_error": 1.5,       # probe fidelity (unbiased codecs ~1)
    # age-of-information at the serving edge: generous because the age
    # grows between publishes by construction (a finished training run
    # serves a correctly-aging snapshot — that is not an incident);
    # smokes/tests that want a tight edge-staleness gate override this
    "serving_age_ms": 60000.0,
    # leader hop occupancy: a pipeline pinned near-saturation round
    # after round is paying a structural cost (split or stream it);
    # 0.95 leaves bursty rounds alone and catches the sustained burn
    "hop_busy_frac": 0.95,
}

#: map a measured artifact field -> the SLO target key it calibrates
_ARTIFACT_FIELDS: Dict[str, str] = {
    "e2e_ms_p95": "push_e2e_p95_ms",
    "push_e2e_p95_ms": "push_e2e_p95_ms",
    "read_p95_ms": "read_p95_ms",
}


def slo_path(slo_dir: str, name: str) -> str:
    return os.path.join(slo_dir, f"slo-{name}.jsonl")


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def derive_targets(results_dir: Optional[str] = None,
                   bench_glob: Optional[str] = None,
                   slack: float = 2.0) -> Dict[str, float]:
    """Targets from the committed perf trajectory: scan bench_gate-style
    JSONL rows (``benchmarks/results/*.jsonl``) and ``BENCH_r*.json``
    round records for the fields in :data:`_ARTIFACT_FIELDS`; each
    covered key's target is ``median(measured) × slack``. Keys with no
    measured history keep :data:`DEFAULT_TARGETS`. Unreadable files are
    skipped — a corrupt artifact must never unarm the watchdog."""
    seen: Dict[str, List[float]] = {}

    def _take(obj: Any) -> None:
        if not isinstance(obj, dict):
            return
        for field, key in _ARTIFACT_FIELDS.items():
            v = obj.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and math.isfinite(float(v)) and float(v) > 0:
                seen.setdefault(key, []).append(float(v))

    paths: List[str] = []
    if results_dir and os.path.isdir(results_dir):
        paths.extend(sorted(glob.glob(os.path.join(results_dir,
                                                   "*.jsonl"))))
    if bench_glob:
        paths.extend(sorted(glob.glob(bench_glob)))
    for p in paths:
        try:
            with open(p) as f:
                text = f.read()
        except OSError:
            continue
        if p.endswith(".jsonl"):
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    _take(json.loads(line))
                except ValueError:
                    continue
        else:
            try:
                doc = json.loads(text)
            except ValueError:
                continue
            _take(doc.get("parsed") if isinstance(doc, dict) else None)
            _take(doc)
    out = dict(DEFAULT_TARGETS)
    for key, vals in seen.items():
        out[key] = _median(vals) * float(slack)
    return out


def default_rules(targets: Dict[str, float]) -> List[Dict[str, Any]]:
    """The standing rule set over the canonical metric keys every server
    already emits. ``mode="value"`` reads the windowed mean of a gauge;
    ``mode="rate"`` reads the windowed per-second delta of a counter."""
    t = {**DEFAULT_TARGETS, **targets}
    return [
        {"name": "push_e2e_p95", "key": "push_e2e_p95_ms",
         "mode": "value", "target": t["push_e2e_p95_ms"],
         "help": "exact per-push e2e latency p95 (lineage-measured)"},
        {"name": "read_p95", "key": "read_p95_ms",
         "mode": "value", "target": t["read_p95_ms"],
         "help": "read-tier service time p95"},
        {"name": "stale_drops", "key": "stale_drops",
         "mode": "rate", "target": t["stale_drops_per_s"],
         "help": "staleness-bound violations per second"},
        {"name": "reads_shed", "key": "reads_shed",
         "mode": "rate", "target": t["reads_shed_per_s"],
         "help": "admission-control sheds per second"},
        {"name": "frames_rejected", "key": "frames_rejected",
         "mode": "rate", "target": t["frames_rejected_per_s"],
         "help": "wire-frame rejections per second"},
        {"name": "decodes_per_publish", "key": "decodes_per_publish",
         "mode": "value", "target": t["decodes_per_publish"],
         "help": "payload decodes per published version"},
        {"name": "codec_rel_error", "key": "codec_rel_error",
         "mode": "value", "target": t["codec_rel_error"],
         "help": "online codec-fidelity probe rel-error"},
        {"name": "serving_age", "key": "serving_age_ms",
         "mode": "value", "target": t["serving_age_ms"],
         "help": "age-of-information of the served version (freshness "
                 "plane; worst tenant)"},
        {"name": "hop_occupancy", "key": "hop_busy_frac",
         "mode": "value", "target": t["hop_busy_frac"],
         "help": "leader hop-pipeline occupancy (hop anatomy; "
                 "sustained saturation wants a split or a streaming "
                 "hop — read hop_stream_headroom_ratio for which)"},
    ]


class _RuleState:
    __slots__ = ("rule", "breached", "breaches", "burn_short", "burn_long")

    def __init__(self, rule: Dict[str, Any]):
        self.rule = rule
        self.breached = False
        self.breaches = 0
        self.burn_short: Optional[float] = None
        self.burn_long: Optional[float] = None


class SLOWatchdog:
    """Burn-rate rule engine over a :class:`~.timeseries.MetricsHistory`.

    ``server`` (optional) wires the scrape instruments and the
    ``/health`` section (the monitor-attachment pattern of
    HealthMonitor/NumericsMonitor/LineageTracker); ``history`` is the
    TSDB the rules read. :meth:`evaluate` runs at the serve loop's tick
    cadence on the serve thread; it self-throttles to
    ``eval_every_s``."""

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, history, name: str = "server",
                 dir: Optional[str] = None, **overrides: Any):
        cfg = cfg or {}
        self.knobs = dict(SLO_KNOBS)
        self.knobs.update(cfg.get("slo_kw") or {})
        self.knobs.update(overrides)
        self.history = history
        self.name = str(name)
        self.server = server
        targets = dict(self.knobs.get("targets") or {})
        rules = self.knobs.get("rules")
        if rules is None:
            rules = default_rules(targets)
        else:
            # explicit rule list: targets still override by key name
            rules = [dict(r) for r in rules]
            for r in rules:
                if r["key"] in targets:
                    r["target"] = targets[r["key"]]
        for r in rules:
            if float(r.get("target", 0.0)) <= 0:
                raise ValueError(
                    f"SLO rule {r.get('name')!r} needs a positive "
                    f"target, got {r.get('target')!r}")
        self._states = [_RuleState(r) for r in rules]
        self.breaches_total = 0
        self.evals = 0
        self.verdicts: List[Dict[str, Any]] = []  # bounded tail below
        self._last_eval = 0.0
        self.overhead_s = 0.0

        self.path: Optional[str] = None
        self._f = None
        if dir:
            os.makedirs(dir, exist_ok=True)
            self.path = slo_path(dir, self.name)
            self._f = open(self.path, "a")
        if server is not None:
            server.slo_watchdog = self
            reg = getattr(server, "scrape_registry", None)
            if reg is not None:
                self.register(reg())

    # -- evaluation -------------------------------------------------------
    def _burn(self, rule: Dict[str, Any], window_s: float,
              now: float) -> Optional[float]:
        stats = self.history.window_stats(rule["key"], window_s, now=now)
        if stats.get("n", 0) < int(self.knobs["min_samples"]):
            return None
        measured = (stats["rate_per_s"] if rule["mode"] == "rate"
                    else stats["mean"])
        return float(measured) / float(rule["target"])

    def evaluate(self, now: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
        """One rule sweep; returns the NEW verdict events (usually
        empty). ``now`` overrides the wall clock for replay."""
        t_wall = time.time() if now is None else float(now)
        if t_wall - self._last_eval < float(self.knobs["eval_every_s"]):
            return []
        t0 = time.thread_time()  # CPU self-cost (see MetricsHistory)
        self._last_eval = t_wall
        self.evals += 1
        thr = float(self.knobs["burn_threshold"])
        rec_thr = thr * float(self.knobs["recovery_factor"])
        new: List[Dict[str, Any]] = []
        for st in self._states:
            bs = self._burn(st.rule, float(self.knobs["short_window_s"]),
                            t_wall)
            bl = self._burn(st.rule, float(self.knobs["long_window_s"]),
                            t_wall)
            st.burn_short, st.burn_long = bs, bl
            if bs is None or bl is None:
                continue
            if not st.breached and bs > thr and bl > thr:
                st.breached = True
                st.breaches += 1
                self.breaches_total += 1
                new.append(self._verdict("breach", st, t_wall))
            elif st.breached and bs < rec_thr and bl < rec_thr:
                st.breached = False
                new.append(self._verdict("recover", st, t_wall))
        self.overhead_s += time.thread_time() - t0
        return new

    def _verdict(self, kind: str, st: _RuleState,
                 t_wall: float) -> Dict[str, Any]:
        r = st.rule
        row = {
            "kind": kind,
            "rule": r["name"],
            "key": r["key"],
            "mode": r["mode"],
            "target": r["target"],
            "burn_short": round(st.burn_short, 4),
            "burn_long": round(st.burn_long, 4),
            "t": round(t_wall, 4),
            "name": self.name,
        }
        self.verdicts.append(row)
        if len(self.verdicts) > 256:
            del self.verdicts[:128]
        if self._f is not None:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

        record_event(f"slo.{kind}", rule=r["name"], key=r["key"],
                     burn_short=row["burn_short"],
                     burn_long=row["burn_long"], target=r["target"])
        return row

    # -- surfaces ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "armed": True,
            "name": self.name,
            "evals": self.evals,
            "breaches_total": self.breaches_total,
            "burning": [st.rule["name"] for st in self._states
                        if st.breached],
            "overhead_s": round(self.overhead_s, 6),
            "rules": [{
                "name": st.rule["name"],
                "key": st.rule["key"],
                "mode": st.rule["mode"],
                "target": st.rule["target"],
                "burn_short": st.burn_short,
                "burn_long": st.burn_long,
                "breached": st.breached,
                "breaches": st.breaches,
            } for st in self._states],
            "recent_verdicts": self.verdicts[-8:],
            "file": self.path,
        }

    def register(self, registry) -> None:
        """``ps_slo_burn_rate{rule=...}`` (long-window burn, the alert
        input) + ``ps_slo_breaches_total`` — per-rule labeled series
        beside one rollup counter, same discipline as the diagnosis
        instruments."""

        def collect(r) -> None:
            for st in self._states:
                lab = {"rule": st.rule["name"]}
                r.gauge("ps_slo_burn_rate",
                        "long-window SLO burn rate (measured/target; "
                        ">1 is budget-burning)", labels=lab).set(
                            float(st.burn_long or 0.0))
                r.counter("ps_slo_breaches_total",
                          "latched SLO breach verdicts",
                          labels=lab).set(float(st.breaches))
            r.counter("ps_slo_breaches_all_total",
                      "latched SLO breach verdicts (all rules)").set(
                          float(self.breaches_total))

        registry.add_collector(collect)

    def close(self) -> None:
        f, self._f = self._f, None
        if f is not None:
            f.close()

    # -- replay -----------------------------------------------------------
    @classmethod
    def replay(cls, rows: List[Dict[str, Any]],
               rules: Optional[List[Dict[str, Any]]] = None,
               **overrides: Any) -> List[Dict[str, Any]]:
        """Re-derive the verdict sequence from persisted
        ``timeseries-*.jsonl`` rows — deterministic: the same rows and
        rules produce byte-identical verdicts (modulo the recorder,
        which replay leaves untouched). The offline half of the 
        "every decision is a recorded, replayable event" discipline."""
        from pytorch_ps_mpi_tpu_torch.telemetry.timeseries import (
            history_from_rows,
        )

        h = history_from_rows([], name="replay")
        kw = dict(overrides)
        if rules is not None:
            kw["rules"] = rules
        wd = cls(history=h, name="replay", **kw)
        out: List[Dict[str, Any]] = []
        for r in rows:
            h.sample(r["m"], now=float(r["t"]))
            out.extend(wd.evaluate(now=float(r["t"])))
        return out

"""ps_top: live terminal dashboard over the PS ``/health`` endpoint (the
JAX package's ``tools/ps_top.py``, run as ``python -m
pytorch_ps_mpi_tpu_torch.ps_top``).

``top`` for the async fleet: polls the JSON the serve loop's
:class:`~pytorch_ps_mpi_tpu_torch.telemetry.diagnosis.HealthMonitor` publishes
at ``/health`` (beside ``/metrics`` — both transports serve it now) and
redraws one verdict row per worker: health verdict, straggler
attribution (compute-bound / wire-bound / reconnect-churn), push
interarrival EWMA + p95, staleness EWMA, lineage columns (``stale-x``
— the EXACT last per-push staleness from the frame trace IDs — and
``e2e-ms`` — exact p50 end-to-end push latency, worker encode to
published version; filled when the ``LineageTracker`` is armed, ``-``
otherwise), anomaly count, sync-round gating bill, retry/reconnect
counters, numerics columns (grad-norm EWMA, non-finite push count,
codec rel-error — filled when the ``NumericsMonitor`` is armed, ``-``
otherwise), and last-seen age. A numerics-quarantined worker renders
the ``quarantined`` verdict.

Usage::

  python -m pytorch_ps_mpi_tpu_torch.ps_top http://127.0.0.1:9100        # or host:port
  python -m pytorch_ps_mpi_tpu_torch.ps_top 9100 --interval 0.5          # localhost port
  python -m pytorch_ps_mpi_tpu_torch.ps_top 9100 --once                  # one frame, no tty

The summary line carries the homomorphic-aggregation rollup when the
server reports it: ``agg=on/off`` (compressed-domain rounds armed),
``dec/pub`` (payload decodes per gradient-composed publish — 1.00 under
aggregation, ~world-size on the decode-sum path) and ``agg_fb`` (pushes
that fell back to decode-sum while aggregation was explicitly
requested).

When round anatomy is armed (``telemetry.anatomy``, auto with lineage)
the frame grows an ``anatomy`` pane: per-stage critical-path shares
(which stage gates the rounds) and the top what-if advisor rows —
"speeding stage X up 20% saves Y% of round time".

When the parameter-serving read tier is armed the frame grows a
``serving`` block: a reader rollup line (reads/s, read p50/p95, shed,
coalesce hits, queue depth) and one row per tenant namespace (ring
occupancy, latest version, read count, and — when the freshness plane
has stamped a birth record — the live age-of-information ``age``
column: wall age of the version this tenant is serving, skew-corrected
back to the root's publish clock). A ``fresh`` line above the tenant
rows carries the publish→visible latency p50/p95 and trailer-reply
volume. The ``reads`` sort key orders the tenant rows by read count.

Keybindings (when stdin is a tty): ``q`` quit · ``p`` pause/resume ·
``s`` cycle the sort column (worker → verdict → interarrival → e2e →
gating → numerics → reads) · ``n`` jump straight to the numerics sort
(NaN count, then grad norm) · ``e`` jump to the exact-e2e-latency
sort · ``d`` jump to the reads sort · ``r`` force an immediate
refresh.

``--fleet`` switches to the fleet pane: ``target`` is then a fleet
registration DIRECTORY (``cfg["fleet_dir"]`` — sharded servers,
supervisor generations and the read tier register themselves there) or
a comma-separated list of base endpoints (``host:port`` / URLs). One
frame shows the merged rollup (summed counters, worst verdict, SLO
breach totals), per-shard skew flags, one row per member, and history
sparklines per metric pulled from each member's ``/history`` route::

  python -m pytorch_ps_mpi_tpu_torch.ps_top --fleet /tmp/run/fleet
  python -m pytorch_ps_mpi_tpu_torch.ps_top --fleet 127.0.0.1:9100,127.0.0.1:9101 --once
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional

SORT_KEYS = ("worker", "verdict", "interarrival", "e2e", "gating",
             "numerics", "reads")

_VERDICT_ORDER = {"quarantined": 0, "missing": 1, "churning": 2, "slow": 3,
                  "ok": 4}
_COLOR = {"ok": "\x1b[32m", "slow": "\x1b[33m", "churning": "\x1b[35m",
          "missing": "\x1b[31m", "quarantined": "\x1b[31m"}
_RESET = "\x1b[0m"


#: (key, counter?) sparkline rows per member in the fleet pane —
#: counters spark their per-sample DELTAS (activity), gauges the values
FLEET_SPARK_KEYS = (("grads_received", True), ("staleness_p95", False),
                    ("push_e2e_p95_ms", False), ("reads_total", True))

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(vals: List[float], width: int = 24) -> str:
    """Unicode min-max sparkline of the last ``width`` values (pure)."""
    vals = [float(v) for v in vals][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        return _SPARK_BLOCKS[0] * len(vals)
    return "".join(
        _SPARK_BLOCKS[min(7, int((v - lo) / (hi - lo) * 7.999))]
        for v in vals)


def fetch_history_values(base_url: str, key: str, window: float = 120.0,
                         timeout: float = 2.0) -> List[float]:
    """One member's ``/history`` points for ``key`` → the value list
    ([] on any failure — a dead member must not kill the pane)."""
    url = (f"{base_url.rstrip('/')}/history?key={key}"
           f"&window={window:g}")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            doc = json.loads(r.read().decode())
        return [float(p[1]) for p in doc.get("points") or []]
    except Exception:
        return []


def render_fleet(snap: Dict[str, Any],
                 histories: Optional[Dict[Any, List[float]]] = None,
                 color: bool = False) -> str:
    """One fleet-pane frame from a ``/fleet`` document plus optional
    ``{(member, key): values}`` history series (pure — the testable
    core, like :func:`render_table`)."""
    if not snap.get("armed", True) and not snap.get("members"):
        return "fleet monitor not armed / no members registered"
    lines: List[str] = []
    fleet = snap.get("fleet", {})
    slo = snap.get("slo", {})
    worst = fleet.get("worst_verdict") or "-"
    lines.append(
        f"ps_top --fleet  members={snap.get('n_ok', 0)}/"
        f"{snap.get('n_members', 0)} ok  "
        f"grads={int(fleet.get('grads_received', 0))}  "
        f"stale_drops={int(fleet.get('stale_drops', 0))}  "
        f"reads={int(fleet.get('reads_total', 0))}  "
        f"shed={int(fleet.get('reads_shed', 0))}  "
        f"worst={worst}  "
        f"slo_breaches={int(slo.get('breaches_total', 0))}"
        + (f"  BURNING: {','.join(slo.get('burning', []))}"
           if slo.get("burning") else "")
    )
    ctl = snap.get("control") or {}
    if ctl.get("members_armed"):
        # fleet controller rollup: one line answers "is the fleet
        # self-driving, did anything flap, who is evicted"
        flaps = int(ctl.get("flaps", 0))
        lines.append(
            f"  control: {ctl.get('members_armed', 0)} armed  "
            f"actions={int(ctl.get('actions_total', 0))}  "
            f"flaps={flaps}{' (!)' if flaps else ''}  "
            f"epoch={int(ctl.get('epoch_max', 0))}"
            + (f"  evicted={','.join(ctl.get('evicted', []))}"
               if ctl.get("evicted") else ""))
    for key, s in sorted((snap.get("skew") or {}).items()):
        flag = "SKEW" if s.get("flagged") else "ok"
        lines.append(
            f"  skew[{key}]: min={s.get('min', 0):g} "
            f"max={s.get('max', 0):g} "
            f"spread={s.get('spread_frac', 0) * 100:.0f}% [{flag}]")
    if fleet.get("hop_rounds"):
        # hop-anatomy rollup: the max across members is the hottest
        # leader's occupancy and the biggest streaming-headroom win —
        # the two numbers the split-vs-streaming call needs
        lines.append(
            f"  hop: rounds={int(fleet.get('hop_rounds', 0))}  "
            f"busy_max={fleet.get('hop_busy_frac_max', 0) * 100:.0f}%  "
            f"headroom_max="
            f"{fleet.get('hop_stream_headroom_ratio_max', 1.0):.2f}x")
    for g, row in sorted((snap.get("groups") or {}).items()):
        # aggregation-tree per-group rollup: which pod is behind, which
        # leader is down, how many worker pushes its hop composed
        leaves = row.get("leaves") or []
        lines.append(
            f"  group[{g}]: leaders {row.get('n_ok', 0)}/"
            f"{row.get('n_members', 0)} ok  "
            f"leaves={','.join(str(w) for w in leaves) or '-'}  "
            f"grads={int(row.get('grads_received', 0))}  "
            f"composed={int(row.get('tree_composed', 0))}  "
            f"worst={row.get('worst_verdict') or '-'}")
    members = sorted((snap.get("members") or {}).values(),
                     key=lambda m: m.get("name", ""))
    replicas = [m for m in members if m.get("role") == "replica"]
    if replicas:
        # follower-tree rollup: tree freshness is its laggiest hop —
        # edge_age is the worst served-version wall age across the tree
        lag_max = fleet.get("replica_lag_versions_max", 0.0)
        relayed = fleet.get("follower_bytes_relayed", 0.0)
        lines.append(
            f"  replicas: {len(replicas)}  lag_max={lag_max:.0f}v  "
            f"edge_age={fleet.get('serving_age_ms_max', 0):.0f}ms  "
            f"relayed={int(relayed)}B  "
            f"conns={int(fleet.get('native_read_conns', 0))}")
    cols = ["member", "role", "grp", "ok", "verdict", "grads", "version",
            "lag", "edge-age", "stale-p95", "e2e-p95", "reads", "up",
            "age"]
    rows = []
    for m in members:
        mm = m.get("metrics") or {}
        rows.append([
            str(m.get("name")), str(m.get("role", "-")),
            "-" if m.get("group") is None else str(m["group"]),
            "yes" if m.get("ok") else (m.get("error") or "no"),
            m.get("verdict") or "-",
            str(int(mm.get("grads_received", 0))),
            str(int(mm.get("publish_version", 0))),
            (f"{mm.get('replica_lag_versions', 0):.0f}"
             if m.get("role") == "replica" else "-"),
            ("-" if "serving_age_ms" not in mm
             else f"{mm['serving_age_ms']:.0f}ms"),
            f"{mm.get('staleness_p95', 0):.1f}",
            f"{mm.get('push_e2e_p95_ms', 0):.1f}",
            str(int(mm.get("reads_total", 0))),
            f"{m.get('uptime_s') or 0:.0f}s",
            "-" if m.get("age_s") is None else f"{m['age_s']:.1f}s",
        ])
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    fmt = "  ".join(f"{{:<{w}}}" if i in (0, 1, 2, 3, 4) else f"{{:>{w}}}"
                    for i, w in enumerate(widths))
    lines.append(fmt.format(*cols))
    lines.append("  ".join("-" * w for w in widths))
    for m, r in zip(members, rows):
        line = fmt.format(*r)
        if m.get("upstream"):
            line += f"  <- {m['upstream']}"
        if color and (m.get("verdict") in _COLOR):
            line = _COLOR[m["verdict"]] + line + _RESET
        lines.append(line)
    if histories:
        lines.append("")
        lines.append("history (sparklines, oldest→newest):")
        for (member, key), vals in sorted(histories.items()):
            if not vals:
                continue
            lines.append(f"  {member:<12} {key:<18} "
                         f"{sparkline(vals)}  last={vals[-1]:g}")
    lines.append("[fleet]  q quit · p pause · r refresh")
    return "\n".join(lines)


def fleet_histories(snap: Dict[str, Any], window: float = 120.0
                    ) -> Dict[Any, List[float]]:
    """Pull the sparkline series for every ok member (counters become
    per-sample deltas so the spark shows ACTIVITY, not a ramp)."""
    out: Dict[Any, List[float]] = {}
    for name, m in (snap.get("members") or {}).items():
        if not m.get("ok"):
            continue
        for key, is_counter in FLEET_SPARK_KEYS:
            vals = fetch_history_values(m["url"], key, window=window)
            if is_counter and len(vals) > 1:
                vals = [max(0.0, b - a) for a, b in zip(vals, vals[1:])]
            if vals and any(v != 0 for v in vals):
                out[(name, key)] = vals
    return out


def normalize_url(target: str) -> str:
    if target.startswith("http"):
        url = target
    elif ":" in target:
        url = f"http://{target}"
    else:
        url = f"http://127.0.0.1:{target}"
    return url.rstrip("/") + ("" if url.endswith("/health") else "/health")


def fetch(url: str, timeout: float = 5.0) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def render_control(control: Dict[str, Any]) -> List[str]:
    """The control pane lines from a ``/health`` ``control`` section
    (pure — the testable core): action/flap counts, wire epoch +
    ladder position, LR de-weights, eviction/probation state, read-tier
    setpoints, and the last-action tail."""
    ladder = control.get("ladder") or []
    idx = control.get("ladder_idx", 0)
    rung = (f"  wire={ladder[idx]}" if 0 <= idx < len(ladder) else "")
    flaps = int(control.get("flaps", 0))
    lines = [
        f"control  actions={control.get('actions_total', 0)}  "
        f"flaps={flaps}{' (!)' if flaps else ''}  "
        f"epoch={control.get('epoch', 0)}"
        f"{'*' if control.get('transition_active') else ''}{rung}  "
        f"depth={control.get('admission_depth', 0)}  "
        f"ring={control.get('ring', 0)}"
        + ("  agg=SUSPENDED" if control.get("agg_suspended") else "")
        + ("  pinned=" + ",".join(control["pinned"])
           if control.get("pinned") else "")
    ]
    scales = {int(w): v for w, v in
              (control.get("lr_scale") or {}).items() if v != 1.0}
    bits = []
    if scales:
        bits.append("lr " + " ".join(
            f"w{w}={v:.2f}" for w, v in sorted(scales.items())))
    if control.get("evicted"):
        bits.append("evicted " + ",".join(
            f"w{w}" for w in control["evicted"]))
    if control.get("probation"):
        bits.append("probation " + ",".join(
            f"w{w}" for w in control["probation"]))
    if bits:
        lines.append("  " + "  ".join(bits))
    if control.get("topo_armed"):
        lines.append(
            f"  topo  actions={control.get('topo_actions', 0)}  "
            f"replans={control.get('group_replans', 0)}  "
            f"replicas={control.get('replicas', 0)}  "
            f"shard_extra={control.get('shard_extra', 0)}")
    for a in (control.get("recent_actions") or [])[-3:]:
        who = "" if a.get("worker") is None else f" w{a['worker']}"
        lines.append(
            f"  {a.get('rule')}.{a.get('action')}{who}: "
            f"{a.get('old')} -> {a.get('new')} "
            f"[{(a.get('verdict') or {}).get('kind')}]")
    return lines


def render_anatomy(anatomy: Dict[str, Any]) -> List[str]:
    """The anatomy pane lines from a ``/health`` ``anatomy`` section
    (pure — the testable core): critical-path shares per stage and the
    top what-if advisor rows ("speeding stage X up 20% saves Y% of
    round time")."""
    rounds = int(anatomy.get("rounds", 0))
    crit = anatomy.get("critical_path") or []
    parts = "  ".join(
        f"{c['stage']}={c['share'] * 100:.0f}%" for c in crit[:4])
    lines = [f"anatomy  rounds={rounds}  critical: {parts or '-'}"]
    for a in (anatomy.get("advisor") or [])[:3]:
        w20 = a.get("whatif_20") or {}
        db = a.get("debottleneck") or {}
        p50 = a.get("p50_ms")
        lines.append(
            f"  whatif [{a['stage']}] p50="
            f"{'-' if p50 is None else f'{p50:.1f}ms'}  "
            f"-20% saves {w20.get('saving_frac', 0) * 100:.1f}%  "
            f"debottleneck saves {db.get('saving_frac', 0) * 100:.1f}%")
    return lines


def render_hop(hop: Dict[str, Any]) -> List[str]:
    """The hop-anatomy pane lines from a ``/health`` ``hop`` section
    (pure — the testable core): fleet-of-leaders occupancy header plus
    one column row per leader — who is busy, who would a streaming hop
    actually help (headroom), who is the hot leader."""
    rounds = int(hop.get("rounds", 0))
    lines = [
        f"hop      rounds={rounds}  "
        f"busy={hop.get('busy_frac', 0) * 100:.0f}%  "
        f"headroom={hop.get('headroom_ratio', 1.0):.2f}x  "
        f"serial p50={hop.get('serial_ms', 0):.1f}ms  "
        f"ingest-wait p50={hop.get('ingest_wait_ms', 0):.1f}ms  "
        f"drops={int(hop.get('ring_drops', 0))}"]
    hot = hop.get("hot_leader")
    for g, row in sorted((hop.get("leaders") or {}).items(),
                         key=lambda kv: str(kv[0])):
        lines.append(
            f"  leader {g}: rounds={int(row.get('rounds', 0))}  "
            f"busy={row.get('busy_frac', 0) * 100:.0f}%  "
            f"headroom={row.get('headroom_ratio', 1.0):.2f}x  "
            f"round p50={row.get('round_ms', 0):.1f}ms"
            + ("  [hot]" if str(g) == str(hot) else ""))
    return lines


def render_table(health: Dict[str, Any], sort: str = "worker",
                 color: bool = False) -> str:
    """One dashboard frame from a ``/health`` document (pure — the
    testable core)."""
    lines: List[str] = []
    fleet = health.get("fleet", {})
    if not health.get("armed", False):
        return ("health monitor not armed on this server "
                "(run with health/health_dir/health_port configured)")
    # homomorphic-aggregation rollup: agg=on means the serve loop sums
    # pushes in the compressed domain; dec/pub is decodes per gradient-
    # composed publish (1.00 in aggregation mode, ~world on decode-sum)
    agg_bits = ""
    if "decodes_per_publish" in fleet:
        agg_bits = (
            f"agg={'on' if fleet.get('agg_mode') else 'off'}  "
            f"dec/pub={fleet.get('decodes_per_publish', 0):.2f}  "
        )
        if fleet.get("agg_fallbacks"):
            agg_bits += f"agg_fb={int(fleet['agg_fallbacks'])}  "
    lines.append(
        f"ps_top  workers={health.get('n_workers')}  "
        f"grads={int(fleet.get('grads_received', 0))}  "
        f"stale_drops={int(fleet.get('stale_drops', 0))}  "
        f"staleness p50/p95/p99="
        f"{fleet.get('staleness_p50', 0):.1f}/"
        f"{fleet.get('staleness_p95', 0):.1f}/"
        f"{fleet.get('staleness_p99', 0):.1f}  "
        f"{agg_bits}"
        f"anomalies={fleet.get('anomaly_total', 0)}  "
        f"rounds={fleet.get('rounds', 0)}  "
        f"up={health.get('uptime_s', 0):.0f}s"
    )
    serving = health.get("serving")
    if serving:
        # reader rollup: the read tier's load/latency/shed picture
        lines.append(
            f"serving  reads/s={serving.get('reads_per_s', 0):.1f}  "
            f"read p50/p95={serving.get('read_p50_ms', 0):.2f}/"
            f"{serving.get('read_p95_ms', 0):.2f}ms  "
            f"shed={serving.get('reads_shed', 0)}  "
            f"coalesce={serving.get('coalesce_hits', 0)}  "
            f"nm={serving.get('reads_not_modified', 0)}  "
            f"q={serving.get('queue_depth', 0)}  "
            f"conns={serving.get('connections', 0)}"
        )
        fresh = serving.get("freshness") or {}
        if fresh.get("fresh_replies") or fresh.get("tenants"):
            # freshness plane: publish→edge-visible latency quantiles
            # + trailer-reply volume (the age column below is live AoI)
            lines.append(
                f"fresh    "
                f"p50/p95={fresh.get('read_fresh_p50_ms', 0):.1f}/"
                f"{fresh.get('read_fresh_p95_ms', 0):.1f}ms  "
                f"replies={int(fresh.get('fresh_replies', 0))}")
        fresh_t = fresh.get("tenants") or {}
        tenants = list((serving.get("tenants") or {}).items())
        if sort == "reads":
            tenants.sort(key=lambda kv: -int(kv[1].get("reads", 0)))
        for tname, t in tenants:
            age = (fresh_t.get(tname) or {}).get("age_ms")
            lines.append(
                f"  tenant {tname}: reads={t.get('reads', 0)}  "
                f"ring={t.get('occupancy', 0)}/{t.get('ring', 0)}  "
                f"latest=v{t.get('latest', 0)}  "
                f"age={'-' if age is None else f'{age:.0f}ms'}  "
                f"refs_out={t.get('refs_out', 0)}"
            )
    control = health.get("control")
    if control:
        lines.extend(render_control(control))
    anatomy = health.get("anatomy")
    if anatomy:
        lines.extend(render_anatomy(anatomy))
    hop = health.get("hop")
    if hop and hop.get("rounds"):
        lines.extend(render_hop(hop))
    cols = ["wk", "verdict", "cause", "grads", "inter-ewma", "inter-p95",
            "stale-ewma", "stale-x", "e2e-ms", "gnorm", "nan", "relerr",
            "anom", "gate-rounds", "gate-s", "retry", "reconn", "rej",
            "seen-ago"]
    rows = []
    workers = list(health.get("workers", []))

    def _num(w) -> dict:
        return w.get("numerics") or {}

    def _nan_count(w):
        return int(_num(w).get("nonfinite") or 0)

    def _gnorm(w):
        return _num(w).get("grad_norm_ewma")

    def _relerr(w):
        probe = _num(w).get("probe") or {}
        return probe.get("rel_error")

    def _lin(w) -> dict:
        return w.get("lineage") or {}

    def _e2e(w):
        return _lin(w).get("e2e_ms_p50")

    if sort == "verdict":
        workers.sort(key=lambda w: _VERDICT_ORDER.get(w["verdict"], 9))
    elif sort == "interarrival":
        workers.sort(key=lambda w: -(w["push_interarrival_s"]["ewma"]
                                     or 0.0))
    elif sort == "e2e":
        # slowest exact end-to-end push latency first (lineage-measured)
        workers.sort(key=lambda w: -(_e2e(w) or 0.0))
    elif sort == "gating":
        workers.sort(key=lambda w: -w["gating"]["seconds"])
    elif sort == "numerics":
        # worst numbers first: NaN offenders, then the loudest gradients
        workers.sort(key=lambda w: (-_nan_count(w), -(_gnorm(w) or 0.0)))
    for w in workers:
        inter = w["push_interarrival_s"]
        stale = w["staleness"]
        verdict = w["verdict"] + (" (done)" if w.get("done") else "")
        gnorm, relerr = _gnorm(w), _relerr(w)
        stale_x = _lin(w).get("stale_last")
        e2e = _e2e(w)
        rows.append([
            str(w["worker"]), verdict, w["cause"] or "-",
            str(w["grads"]), _fmt_s(inter.get("ewma")),
            _fmt_s(inter.get("p95")),
            "-" if stale.get("ewma") is None else f"{stale['ewma']:.2f}",
            "-" if stale_x is None else str(stale_x),
            "-" if e2e is None else f"{e2e:.1f}",
            "-" if gnorm is None else f"{gnorm:.3g}",
            str(_nan_count(w)) if _num(w) else "-",
            "-" if relerr is None else f"{relerr:.3f}",
            str(w["anomalies"]), str(w["gating"]["rounds"]),
            f"{w['gating']['seconds']:.2f}", str(w["retries"]),
            str(w["reconnects"]), str(w["frames_rejected"]),
            _fmt_s(w.get("last_seen_age_s")),
        ])
    widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
              for i, c in enumerate(cols)]
    fmt = "  ".join(f"{{:<{w}}}" if i in (1, 2) else f"{{:>{w}}}"
                    for i, w in enumerate(widths))
    lines.append(fmt.format(*cols))
    lines.append("  ".join("-" * w for w in widths))
    for w, r in zip(workers, rows):
        line = fmt.format(*r)
        if color and w["verdict"] in _COLOR:
            line = _COLOR[w["verdict"]] + line + _RESET
        lines.append(line)
    lines.append(f"[sort: {sort}]  q quit · p pause · s sort · "
                 "n numerics · e e2e · d reads · r refresh")
    return "\n".join(lines)


class _Keys:
    """Raw, non-blocking single-key reads from a tty (restores the
    terminal on exit); a no-op stub off-tty so ``ps_top`` also runs
    under pipes/CI."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._old = None
        if self.enabled:
            try:
                import termios
                import tty

                self._termios = termios
                self._old = termios.tcgetattr(sys.stdin.fileno())
                tty.setcbreak(sys.stdin.fileno())
            except Exception:
                self.enabled = False

    def poll(self) -> Optional[str]:
        if not self.enabled:
            return None
        import select

        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1)
        return None

    def restore(self) -> None:
        if self._old is not None:
            self._termios.tcsetattr(
                sys.stdin.fileno(), self._termios.TCSADRAIN, self._old)


def _fleet_monitor(target: str):
    """A FleetMonitor from the CLI target: a registration directory or
    a comma-separated endpoint list."""
    sys.path.insert(0, os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    from pytorch_ps_mpi_tpu_torch.telemetry.fleet import FleetMonitor

    if os.path.isdir(target):
        return FleetMonitor(fleet_dir=target)
    return FleetMonitor(endpoints=[t for t in target.split(",") if t])


def _fleet_main(args) -> int:
    mon = _fleet_monitor(args.target)

    def frame() -> str:
        snap = mon.poll(force=True)
        return render_fleet(snap, fleet_histories(
            snap, window=args.spark_window), color=not args.no_color)

    if args.once:
        print(render_fleet(mon.poll(force=True), fleet_histories(
            mon.poll(), window=args.spark_window), color=False))
        return 0
    keys = _Keys()
    paused = False
    deadline = time.time() + args.duration if args.duration else None
    out = "(waiting for first fleet poll...)"
    try:
        while True:
            if not paused:
                try:
                    out = frame()
                except Exception as e:
                    out = f"fleet poll failed: {type(e).__name__}: {e}"
            sys.stdout.write("\x1b[2J\x1b[H" + out
                             + ("\n[PAUSED]" if paused else "") + "\n")
            sys.stdout.flush()
            t_next = time.time() + args.interval
            while time.time() < t_next:
                k = keys.poll()
                if k == "q":
                    return 0
                if k == "p":
                    paused = not paused
                    break
                if k == "r":
                    break
                if deadline and time.time() > deadline:
                    return 0
                time.sleep(0.05)
            if deadline and time.time() > deadline:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        keys.restore()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("target",
                    help="/health URL, host:port, or a bare local port")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="poll interval seconds")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no tty control)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="exit after this many seconds (0 = forever)")
    ap.add_argument("--no-color", action="store_true")
    ap.add_argument("--fleet", action="store_true",
                    help="fleet pane: target is a fleet registration "
                         "dir (cfg['fleet_dir']) or comma-separated "
                         "base endpoints")
    ap.add_argument("--spark-window", type=float, default=120.0,
                    help="fleet mode: history window for the "
                         "sparklines (seconds)")
    args = ap.parse_args(argv)

    if args.fleet:
        return _fleet_main(args)
    url = normalize_url(args.target)

    if args.once:
        print(render_table(fetch(url), color=False))
        return 0

    keys = _Keys()
    sort_i = 0
    paused = False
    deadline = time.time() + args.duration if args.duration else None
    frame = "(waiting for first scrape...)"
    try:
        while True:
            if not paused:
                try:
                    frame = render_table(fetch(url),
                                         sort=SORT_KEYS[sort_i],
                                         color=not args.no_color)
                except Exception as e:
                    frame = f"scrape failed: {type(e).__name__}: {e}"
            sys.stdout.write("\x1b[2J\x1b[H" + frame
                             + ("\n[PAUSED]" if paused else "") + "\n")
            sys.stdout.flush()
            t_next = time.time() + args.interval
            while time.time() < t_next:
                k = keys.poll()
                if k == "q":
                    return 0
                if k == "p":
                    paused = not paused
                    break
                if k == "s":
                    sort_i = (sort_i + 1) % len(SORT_KEYS)
                    break
                if k == "n":
                    sort_i = SORT_KEYS.index("numerics")
                    break
                if k == "e":
                    sort_i = SORT_KEYS.index("e2e")
                    break
                if k == "d":
                    sort_i = SORT_KEYS.index("reads")
                    break
                if k == "r":
                    break
                if deadline and time.time() > deadline:
                    return 0
                time.sleep(0.05)
            if deadline and time.time() > deadline:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        keys.restore()


if __name__ == "__main__":
    sys.exit(main())

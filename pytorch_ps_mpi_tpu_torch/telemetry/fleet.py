"""FleetMonitor: one merged observability pane over N PS endpoints (the
JAX package's ``telemetry/fleet.py``).

Every process so far serves its OWN ``/metrics`` + ``/health`` — a
sharded run is S panes, a supervised run is a new pane per server
generation, and the read tier is another. This module folds them into
one: a :class:`FleetMonitor` polls every registered endpoint's
Prometheus text and ``/health`` JSON and merges them into a single
snapshot — summed counters, per-member labeled series, a worst-verdict
rollup, and per-shard skew detection — served at ``/fleet`` on any
armed server and rendered by ``python -m pytorch_ps_mpi_tpu_torch.ps_top
--fleet``.

Membership is a **registration directory**, not a static list: each
member writes ``endpoint-<name>.json`` (:func:`register_endpoint`) when
its metrics endpoint binds and removes it on clean close
(:func:`deregister_endpoint`). Registration is an atomic overwrite
keyed by name, so a supervisor-restarted server generation — whose
auto-assigned port changed — *rejoins* the pane under the same name
instead of orphaning a dead URL; ``sharded.server_main`` registers
``shard<i>`` the same way. Static ``endpoints=[...]`` URLs compose with
the directory for fixed fleets.

Polling runs wherever the monitor lives — the ``/fleet`` route fetches
on the HTTP thread (daemon, plain ``urllib`` to other ports, never a
native handle) with a min-interval cache, so scraping ``/fleet`` at any
rate costs the fleet one poll per ``min_poll_s``. The samples merged
are ordered/aged by the ``ts``/``uptime_s`` fields every ``/metrics``
and ``/health`` payload now carries.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

#: tuning knobs and their defaults (overridable via ``cfg["fleet_kw"]``)
FLEET_KNOBS: Dict[str, Any] = {
    "timeout_s": 2.0,      # per-endpoint fetch timeout
    "min_poll_s": 0.5,     # snapshot cache TTL (poll coalescing)
    "skew_frac": 0.5,      # (max-min)/max past this flags skew
    "skew_min": 16.0,      # no skew verdicts below this absolute max
}

#: counters summed across members into the fleet rollup
_SUM_KEYS: Dict[str, str] = {
    "grads_received": "ps_grads_received_total",
    "bytes_received": "ps_wire_bytes_received_total",
    "stale_drops": "ps_stale_drops_total",
    "reads_total": "ps_reads_total",
    "reads_shed": "ps_reads_shed_total",
    # read plane: open native reader conns and follower relay volume sum
    # across the tree (the tree-wide serving capacity actually in use)
    "native_read_conns": "ps_native_read_conns",
    "follower_bytes_relayed": "ps_follower_bytes_relayed_total",
    "slo_breaches": "ps_slo_breaches_all_total",
    "tree_composed": "ps_tree_composed_total",
    "control_actions": "ps_control_actions_total",
    "anatomy_rounds": "ps_anatomy_rounds_total",
    # structural control: fleet-wide action volume, live replica count,
    # and splits currently in force — sums because each member's
    # controller only counts its OWN actuations
    "topo_actions": "ps_topo_actions_total",
    "replicas_live": "ps_replicas_live",
    "group_replans": "ps_group_replans_total",
    # hop anatomy: fleet-wide decomposed leader rounds (each leader
    # only counts its OWN hop rounds)
    "hop_rounds": "ps_hop_rounds_total",
}

#: gauges rolled up as the fleet max (worst member)
_MAX_KEYS: Dict[str, str] = {
    "staleness_p95": "ps_staleness_p95",
    "push_e2e_p95_ms": "ps_push_e2e_p95_ms",
    "read_p95_ms": "ps_read_p95_ms",
    "decodes_per_publish": "ps_decodes_per_publish",
    # the worst member's wire-gated critical-path share: a tree where
    # ONE pod's hop is wire-bound shows up here even when the fleet sum
    # looks healthy (per-hop cost attribution, DynamiQ's lesson)
    "anatomy_wire_share": "ps_anatomy_wire_share",
    "anatomy_top_saving_frac": "ps_anatomy_top_saving_frac",
    # the WORST replica's staleness: a distribution tree is only as
    # fresh as its laggiest hop, so the rollup takes the fleet max
    "replica_lag_versions": "ps_replica_lag_versions",
    # worst-edge-age: the wall age of the stalest served version across
    # the tree (the freshness plane's fleet rollup — what "how stale is
    # the model a reader at the edge sees" actually maxes out at)
    "serving_age_ms": "ps_serving_age_ms",
    # the HOTTEST leader pipeline: occupancy and streaming headroom are
    # per-leader verdict inputs, so the rollup takes the fleet max —
    # one saturated (or one serial) hop is where the next fix goes
    "hop_busy_frac": "ps_hop_busy_frac",
    "hop_stream_headroom_ratio": "ps_hop_stream_headroom_ratio",
}

#: per-member gauges the skew detector compares across shards
_SKEW_KEYS = ("grads_received", "publish_version")

_VERDICT_RANK = {"ok": 0, "slow": 1, "churning": 2, "missing": 3,
                 "quarantined": 4}

_line_re = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(\S+)\s*$")
_label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus_text(text: str) -> List[Dict[str, Any]]:
    """Prometheus exposition text → ``[{name, labels, value}]`` rows
    (``# HELP``/``# TYPE`` skipped; label values unescaped enough for
    the simple labels this stack emits). The one parser — the fleet
    poller and ``tools/telemetry_report.py`` share it."""
    series: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _line_re.match(line)
        if not m:
            continue
        name, labels_text, raw = m.groups()
        try:
            value = float(raw.replace("+Inf", "inf"))
        except ValueError:
            continue
        labels = dict(_label_re.findall(labels_text)) if labels_text else {}
        series.append({"name": name, "labels": labels, "value": value})
    return series


# ---------------------------------------------------------------------------
# endpoint registration (the cross-process membership mechanism)
# ---------------------------------------------------------------------------

def endpoint_path(fleet_dir: str, name: str) -> str:
    return os.path.join(fleet_dir, f"endpoint-{name}.json")


def register_endpoint(fleet_dir: str, name: str, port: int,
                      host: str = "127.0.0.1", role: str = "server",
                      **meta: Any) -> str:
    """Write (atomically, overwrite-by-name) this member's endpoint
    card. A re-registration under the same name — a respawned server
    generation, a shard restart — REPLACES the old card, so the pane
    follows the member across ports instead of polling a corpse."""
    os.makedirs(fleet_dir, exist_ok=True)
    path = endpoint_path(fleet_dir, name)
    doc = {"name": str(name), "url": f"http://{host}:{int(port)}",
           "role": str(role), "pid": os.getpid(),
           "registered_wall": time.time(), **meta}
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def deregister_endpoint(fleet_dir: str, name: str) -> None:
    try:
        os.remove(endpoint_path(fleet_dir, name))
    except OSError:
        pass


def list_endpoints(fleet_dir: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for p in sorted(glob.glob(os.path.join(fleet_dir, "endpoint-*.json"))):
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue  # torn write mid-registration; next poll sees it
        if isinstance(doc, dict) and doc.get("url"):
            out.append(doc)
    return out


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

class FleetMonitor:
    """Poll + merge N endpoints into the ``/fleet`` document.

    ``endpoints`` is a list of base URLs (or ``{"name","url","role"}``
    dicts) for fixed members; ``fleet_dir`` adds the registration
    directory, rescanned per poll so members come and go without
    restarting the pane."""

    def __init__(self, endpoints: Optional[List[Any]] = None,
                 fleet_dir: Optional[str] = None, **overrides: Any):
        self.knobs = dict(FLEET_KNOBS)
        self.knobs.update(overrides)
        self.fleet_dir = fleet_dir
        self._static: List[Dict[str, Any]] = []
        for i, e in enumerate(endpoints or []):
            if isinstance(e, str):
                url = e if e.startswith("http") else f"http://{e}"
                self._static.append({"name": f"static-{i}", "url": url,
                                     "role": "server"})
            else:
                self._static.append(dict(e))
        self._lock = threading.Lock()
        self._poll_lock = threading.Lock()  # serializes the sweep itself
        self._cache: Optional[Dict[str, Any]] = None
        self._cache_t = 0.0
        self.polls = 0

    # -- membership -------------------------------------------------------
    def members(self) -> List[Dict[str, Any]]:
        out = {m["name"]: m for m in self._static}
        if self.fleet_dir:
            for doc in list_endpoints(self.fleet_dir):
                out[doc["name"]] = doc
        return [out[k] for k in sorted(out)]

    # -- polling ----------------------------------------------------------
    def _fetch(self, url: str, path: str) -> Optional[str]:
        try:
            with urllib.request.urlopen(
                    url.rstrip("/") + path,
                    timeout=float(self.knobs["timeout_s"])) as r:
                return r.read().decode()
        except Exception:
            return None

    def _poll_member(self, member: Dict[str, Any]) -> Dict[str, Any]:
        url = member["url"]
        row: Dict[str, Any] = {
            "name": member["name"], "url": url,
            "role": member.get("role", "server"), "ok": False,
            "error": None, "ts": None, "uptime_s": None, "age_s": None,
            "verdict": None, "metrics": {}, "labeled": [],
        }
        if member.get("group") is not None:
            # aggregation-tree cards carry their group id + leaf members
            row["group"] = member["group"]
            row["members"] = member.get("members")
        if member.get("upstream") is not None:
            # replica cards carry their tree edge: who they follow and
            # how many downstream replicas they are provisioned to feed
            row["upstream"] = member["upstream"]
            row["fanout"] = member.get("fanout")
        text = self._fetch(url, "/metrics")
        if text is None:
            row["error"] = "unreachable"
            return row
        flat: Dict[str, float] = {}
        for s in parse_prometheus_text(text):
            if s["labels"]:
                if "le" not in s["labels"]:  # histogram buckets are noise
                    row["labeled"].append(
                        {"name": s["name"], "labels": s["labels"],
                         "value": s["value"]})
            else:
                flat[s["name"]] = s["value"]
        row["ok"] = True
        row["ts"] = flat.get("ps_scrape_ts_seconds")
        row["uptime_s"] = flat.get("ps_uptime_seconds")
        if row["ts"] is not None:
            row["age_s"] = round(max(0.0, time.time() - row["ts"]), 3)
        m: Dict[str, float] = {}
        for k, prom in {**_SUM_KEYS, **_MAX_KEYS}.items():
            if prom in flat:
                m[k] = flat[prom]
        m["publish_version"] = flat.get("ps_publish_version", 0.0)
        row["metrics"] = m
        health = self._fetch(url, "/health")
        if health is not None:
            try:
                doc = json.loads(health)
            except ValueError:
                doc = {}
            worst = None
            for w in doc.get("workers") or []:
                v = w.get("verdict")
                if v is not None and (
                        worst is None
                        or _VERDICT_RANK.get(v, 0)
                        > _VERDICT_RANK.get(worst, 0)):
                    worst = v
            row["verdict"] = worst
            slo = doc.get("slo")
            if isinstance(slo, dict):
                row["slo"] = {"breaches_total": slo.get(
                    "breaches_total", 0), "burning": slo.get(
                        "burning", [])}
            serving = doc.get("serving")
            if isinstance(serving, dict):
                row["serving"] = {
                    "reads_per_s": serving.get("reads_per_s", 0.0),
                    "queue_depth": serving.get("queue_depth", 0),
                }
            control = doc.get("control")
            if isinstance(control, dict):
                # the member's controller card: what the pane's
                # controller rollup sums/maxes across the fleet
                row["control"] = {
                    "actions_total": control.get("actions_total", 0),
                    "flaps": control.get("flaps", 0),
                    "epoch": control.get("epoch", 0),
                    "evicted": control.get("evicted", []),
                    "lr_scale": control.get("lr_scale", {}),
                    "recent_actions": (control.get("recent_actions")
                                       or [])[-3:],
                }
        return row

    def _cache_fresh(self, now: float) -> Optional[Dict[str, Any]]:
        with self._lock:
            if (self._cache is not None
                    and now - self._cache_t
                    < float(self.knobs["min_poll_s"])):
                return self._cache
        return None

    def poll(self, force: bool = False) -> Dict[str, Any]:
        """The merged fleet snapshot, cached for ``min_poll_s`` so any
        number of concurrent ``/fleet`` scrapes cost one fleet sweep:
        the sweep itself is serialized, and a scrape that waited behind
        an in-flight sweep reuses its result instead of re-sweeping."""
        if not force:
            snap = self._cache_fresh(time.time())
            if snap is not None:
                return snap
        with self._poll_lock:
            now = time.time()
            if not force:
                # double-check: the sweep we waited behind just filled
                # the cache — N concurrent scrapes, one sweep
                snap = self._cache_fresh(now)
                if snap is not None:
                    return snap
            members = [self._poll_member(m) for m in self.members()]
            snap = self._merge(members, now)
            with self._lock:
                self._cache, self._cache_t = snap, now
                self.polls += 1
            return snap

    def _merge(self, members: List[Dict[str, Any]],
               now: float) -> Dict[str, Any]:
        ok = [m for m in members if m["ok"]]
        fleet: Dict[str, Any] = {}
        for k in _SUM_KEYS:
            fleet[k] = sum(m["metrics"].get(k, 0.0) for m in ok)
        for k in _MAX_KEYS:
            vals = [m["metrics"][k] for m in ok if k in m["metrics"]]
            fleet[f"{k}_max"] = max(vals) if vals else 0.0
        worst = None
        for m in ok:
            v = m["verdict"]
            if v is not None and (worst is None
                                  or _VERDICT_RANK.get(v, 0)
                                  > _VERDICT_RANK.get(worst, 0)):
                worst = v
        fleet["worst_verdict"] = worst
        # per-shard skew: a healthy sharded fleet advances together; one
        # shard falling behind on applied work or publish version is the
        # balance problem Li et al.'s partitioning can hide
        skew: Dict[str, Any] = {}
        shards = [m for m in ok if m.get("role") == "shard"] or ok
        if len(shards) > 1:
            for k in _SKEW_KEYS:
                vals = {m["name"]: m["metrics"].get(k, 0.0)
                        for m in shards if k in m["metrics"]}
                if len(vals) < 2:
                    continue
                mx, mn = max(vals.values()), min(vals.values())
                spread = (mx - mn) / mx if mx > 0 else 0.0
                skew[k] = {
                    "min": mn, "max": mx,
                    "spread_frac": round(spread, 4),
                    "flagged": bool(
                        mx >= float(self.knobs["skew_min"])
                        and spread > float(self.knobs["skew_frac"])),
                    "per_member": vals,
                }
        slo = {
            "breaches_total": sum(
                int((m.get("slo") or {}).get("breaches_total", 0))
                for m in ok),
            "burning": sorted({
                f"{m['name']}:{r}" for m in ok
                for r in (m.get("slo") or {}).get("burning", [])}),
        }
        # controller rollup: one line answers "is the fleet self-driving
        # and did anything flap" without opening every member's pane
        control = {
            "actions_total": sum(
                int((m.get("control") or {}).get("actions_total", 0))
                for m in ok),
            "flaps": sum(
                int((m.get("control") or {}).get("flaps", 0))
                for m in ok),
            "epoch_max": max(
                [int((m.get("control") or {}).get("epoch", 0))
                 for m in ok] or [0]),
            "evicted": sorted({
                f"{m['name']}:w{w}" for m in ok
                for w in (m.get("control") or {}).get("evicted", [])}),
            "members_armed": sum(
                1 for m in ok if m.get("control") is not None),
        }
        # per-group rollups: members whose registration card carries a
        # group id (aggregation-tree leaders) roll up side by side, so
        # one pane answers "which pod is behind" without PromQL
        groups: Dict[str, Any] = {}
        for m in members:
            g = m.get("group")
            if g is None:
                continue
            row = groups.setdefault(str(g), {
                "n_members": 0, "n_ok": 0, "grads_received": 0.0,
                "tree_composed": 0.0, "leaves": [], "worst_verdict": None,
            })
            row["n_members"] += 1
            row["leaves"] = sorted(set(row["leaves"])
                                   | set(m.get("members") or []))
            if not m["ok"]:
                continue
            row["n_ok"] += 1
            row["grads_received"] += m["metrics"].get("grads_received", 0.0)
            row["tree_composed"] += m["metrics"].get("tree_composed", 0.0)
            v = m.get("verdict")
            if v is not None and (
                    row["worst_verdict"] is None
                    or _VERDICT_RANK.get(v, 0)
                    > _VERDICT_RANK.get(row["worst_verdict"], 0)):
                row["worst_verdict"] = v
        # merged per-worker labeled series, member-tagged so one pane
        # shows e.g. every shard's rejection counters side by side
        labeled = [{"member": m["name"], **s}
                   for m in ok for s in m["labeled"]]
        return {
            "armed": True,
            "ts": round(now, 3),
            "n_members": len(members),
            "n_ok": len(ok),
            "members": {m["name"]: m for m in members},
            "fleet": fleet,
            "skew": skew,
            "groups": groups,
            "slo": slo,
            "control": control,
            "labeled": labeled,
        }

    # -- surfaces ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return self.poll()

    def render_http(self, query: Optional[Dict[str, Any]] = None
                    ) -> Tuple[str, str]:
        q = query or {}
        snap = self.poll(force=str(q.get("force", "")) in ("1", "true"))
        if str(q.get("labeled", "")) not in ("1", "true"):
            snap = {k: v for k, v in snap.items() if k != "labeled"}
            snap["members"] = {
                name: {k: v for k, v in m.items() if k != "labeled"}
                for name, m in snap["members"].items()
            }
        return json.dumps(snap), "application/json"

"""MetricsHistory: the in-process time-series database behind ``/history``
(the JAX package's ``telemetry/timeseries.py``; it imports no framework).

Every observability surface before this module was *instantaneous* —
counters, EWMAs and quantile gauges with no retained history. This is
the missing substrate: a dependency-free TSDB that retains a bounded
window of every canonical metric key, sampled on the serve thread at
the existing ``on_tick`` cadence (no new threads ever touch a native
transport handle), and queryable while the run is still going.

Design:

- **one ring per (key, tier)** — a raw ring holds every sample
  ``(t, value)``; downsampled tiers (default 1 s / 10 s / 60 s
  resolutions) hold per-bucket aggregates ``(t, last, min, max, sum,
  n)`` folded in as samples arrive, so a 60 s-tier point costs the same
  whether the raw cadence was 5 Hz or 50 Hz. Memory is fixed at
  construction: ``capacity × keys`` per tier, regardless of run length.
- **queries pick the finest tier that still covers the window** —
  ``range(key, t0, t1)`` walks raw first, then 1 s, 10 s, 60 s; windowed
  quantiles/rates (:meth:`quantile`, :meth:`rate`,
  :meth:`window_stats`) weight downsampled points by their fold count,
  so a p95 over an aged window degrades gracefully ("within
  downsampling error") instead of returning nothing.
- **persistence** — raw samples append (buffered, ``flush_every``) to
  ``timeseries-<name>.jsonl`` rows ``{"t": wall, "m": {key: value}}``
  with bounded retention: past ``retention_rows`` the file is compacted
  in place to its newest half, so a week-long run cannot fill the disk.
  :func:`load_timeseries_rows` / :func:`history_from_rows` rebuild a
  queryable history offline (``tools/telemetry_report.py``'s history
  section, SLO replay).
- **HTTP** — :meth:`render_http` backs the ``/history?key=...&window=``
  route the :class:`~.registry.PSServerTelemetry` mixin serves on both
  transports, torn down by ``server.close()`` like ``/metrics`` and
  ``/health``. Reads are lock-free snapshots of append-only deques
  (atomic under the GIL), safe from the scrape thread while the serve
  thread samples.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: tuning knobs and their defaults (overridable via ``cfg["timeseries_kw"]``)
TS_KNOBS: Dict[str, Any] = {
    # (resolution_s, ring_capacity) per downsampled tier — 15 min at 1 s,
    # 90 min at 10 s, 6 h at 60 s
    "tiers": ((1.0, 900), (10.0, 540), (60.0, 360)),
    "raw_capacity": 2048,        # raw samples kept (at tick cadence ~7 min)
    "sample_min_interval_s": 0.2,  # ingest throttle under a fast tick
    "flush_every": 64,           # buffered rows per persistence append
    "retention_rows": 20000,     # jsonl rows before in-place compaction
    "max_points": 400,           # /history reply size bound (strided)
}

#: a downsampled point: (bucket_t, last, min, max, sum, n)
_Bucket = Tuple[float, float, float, float, float, int]


def timeseries_path(ts_dir: str, name: str) -> str:
    return os.path.join(ts_dir, f"timeseries-{name}.jsonl")


def _weighted_quantile(pairs: List[Tuple[float, int]], q: float) -> float:
    """Exact weighted q-quantile of ``[(value, weight)]`` — the same
    discipline as ``registry.staleness_quantile``; NaN when empty."""
    if not pairs:
        return math.nan
    items = sorted(pairs)
    total = sum(n for _, n in items)
    target = q * total
    cum = 0
    for v, n in items:
        cum += n
        if cum >= target:
            return float(v)
    return float(items[-1][0])


class MetricsHistory:
    """Fixed-memory retained history for a flat ``{key: float}`` stream.

    ``keys=None`` admits every numeric key the first sample carries (plus
    any later ones); pass an explicit tuple to pin the schema. ``dir``
    arms persistence (``timeseries-<name>.jsonl``); None keeps the TSDB
    purely in-memory. All timestamps are wall-clock (``time.time()``)
    so fleet tooling can order samples across processes — the satellite
    ``ts`` field in ``/metrics``/``/health`` exists for the same reason.
    """

    def __init__(self, keys: Optional[Sequence[str]] = None,
                 dir: Optional[str] = None, name: str = "server",
                 **overrides: Any):
        self.knobs = dict(TS_KNOBS)
        self.knobs.update(overrides)
        self.name = str(name)
        self._keys_pinned = keys is not None
        self._raw: Dict[str, deque] = {}
        if keys:
            for k in keys:
                self._raw[k] = deque(maxlen=int(self.knobs["raw_capacity"]))
        tiers = tuple(self.knobs["tiers"])
        self._tier_res: List[float] = [float(r) for r, _ in tiers]
        self._tier_cap: List[int] = [int(c) for _, c in tiers]
        # closed buckets per tier: key -> deque[_Bucket]
        self._tiers: List[Dict[str, deque]] = [{} for _ in tiers]
        # open (still-folding) bucket per tier: key -> [t, last, mn, mx, s, n]
        self._open: List[Dict[str, list]] = [{} for _ in tiers]
        self.samples = 0
        self.last_t: Optional[float] = None
        self.overhead_s = 0.0  # self-timed sample() cost (the ≤5% story)
        self._t0 = time.time()

        self.path: Optional[str] = None
        self._buf: List[str] = []
        self._rows_written = 0
        if dir:
            os.makedirs(dir, exist_ok=True)
            self.path = timeseries_path(dir, self.name)

    # -- ingest -----------------------------------------------------------
    def sample(self, metrics: Dict[str, Any],
               now: Optional[float] = None, force: bool = False) -> bool:
        """Fold one ``{key: value}`` snapshot in; returns False when the
        sample was throttled (non-monotone timestamp or below the min
        interval — ``force=True`` skips the throttle, for the one
        closing sample that must capture the FINAL counter state).
        Serve-thread only, like every monitor feed point."""
        # self-cost in THREAD CPU time: on an oversubscribed box a
        # wall-clock timer bills scheduler preemption (5 ms "samples"
        # that cost 200 us of CPU) to the observability plane — the
        # ≤5% budget gates what the plane actually takes from the
        # serve thread
        t0 = time.thread_time()
        t = time.time() if now is None else float(now)
        if self.last_t is not None:
            if t <= self.last_t:
                return False  # clock went backwards / duplicate tick
            # epsilon keeps an exactly-at-cadence stream (t += 0.2 with
            # float accumulation error) from dropping alternate samples
            if (not force and t - self.last_t
                    < float(self.knobs["sample_min_interval_s"]) - 1e-6):
                return False
        row: Dict[str, float] = {}
        for k, v in metrics.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            v = float(v)
            if math.isnan(v) or math.isinf(v):
                continue
            ring = self._raw.get(k)
            if ring is None:
                if self._keys_pinned:
                    continue
                ring = self._raw.setdefault(
                    k, deque(maxlen=int(self.knobs["raw_capacity"])))
            ring.append((t, v))
            row[k] = v
            for ti, res in enumerate(self._tier_res):
                bt = math.floor(t / res) * res
                ob = self._open[ti].get(k)
                if ob is None:
                    self._open[ti][k] = [bt, v, v, v, v, 1]
                elif ob[0] == bt:
                    ob[1] = v
                    ob[2] = min(ob[2], v)
                    ob[3] = max(ob[3], v)
                    ob[4] += v
                    ob[5] += 1
                else:  # bucket boundary crossed: close the old one
                    ring2 = self._tiers[ti].setdefault(
                        k, deque(maxlen=self._tier_cap[ti]))
                    ring2.append(tuple(ob))
                    self._open[ti][k] = [bt, v, v, v, v, 1]
        self.samples += 1
        self.last_t = t
        if self.path is not None and row:
            # full precision on purpose: SLO replay re-derives verdicts
            # from these rows, and a rounded timestamp can move a sample
            # across a window boundary (replay != live)
            self._buf.append(json.dumps({"t": t, "m": row}))
            if len(self._buf) >= int(self.knobs["flush_every"]):
                self.flush()
        self.overhead_s += time.thread_time() - t0
        return True

    # -- persistence ------------------------------------------------------
    def flush(self) -> None:
        if self.path is None or not self._buf:
            return
        with open(self.path, "a") as f:
            f.write("\n".join(self._buf) + "\n")
        self._rows_written += len(self._buf)
        self._buf = []
        if self._rows_written > int(self.knobs["retention_rows"]):
            self._compact()

    def _compact(self) -> None:
        """Bounded retention: rewrite the file keeping the newest half,
        so the append path stays O(1) and the file stays O(retention)."""
        keep = int(self.knobs["retention_rows"]) // 2
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return
        tail = lines[-keep:]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(tail)
        os.replace(tmp, self.path)
        self._rows_written = len(tail)

    def close(self) -> None:
        self.flush()

    # -- queries ----------------------------------------------------------
    def keys(self) -> List[str]:
        return sorted(self._raw)

    def _series(self, key: str, t0: float,
                tier: Optional[int] = None
                ) -> Tuple[float, List[Tuple[float, float, int]]]:
        """(resolution_s, [(t, value, weight)]) for the finest tier whose
        ring still covers ``t0`` (raw = resolution 0). ``tier`` pins one:
        -1 raw, 0.. downsampled."""
        if tier is not None:
            if tier < 0:
                ring = self._raw.get(key) or ()
                return 0.0, [(t, v, 1) for t, v in ring if t >= t0]
            ring2 = list(self._tiers[tier].get(key) or ())
            ob = self._open[tier].get(key)
            if ob is not None:
                ring2.append(tuple(ob))
            return self._tier_res[tier], [
                (b[0], b[4] / b[5], b[5]) for b in ring2 if b[0] >= t0]
        ring = self._raw.get(key)
        if ring and (ring[0][0] <= t0 or len(ring) < ring.maxlen):
            # raw still reaches back to t0 (or the run is younger than
            # the ring) — exact samples, weight 1
            return 0.0, [(t, v, 1) for t, v in ring if t >= t0]
        for ti in range(len(self._tier_res)):
            ring2 = self._tiers[ti].get(key)
            if ring2 and (ring2[0][0] <= t0
                          or len(ring2) < self._tier_cap[ti]):
                return self._series(key, t0, tier=ti)
        # nothing covers that far back: coarsest tier is the best we have
        return self._series(key, t0,
                            tier=len(self._tier_res) - 1
                            if self._tier_res else -1)

    def range(self, key: str, t0: Optional[float] = None,
              t1: Optional[float] = None,
              tier: Optional[int] = None) -> List[Tuple[float, float]]:
        """``[(t, value)]`` within ``[t0, t1]`` (defaults: everything
        retained .. now) from the finest covering tier. Downsampled
        points carry the bucket mean at the bucket start time."""
        # default = everything retained, NOT construction time: a
        # history rebuilt from persisted rows (history_from_rows) holds
        # samples that predate its own construction
        lo = float("-inf") if t0 is None else float(t0)
        hi = float("inf") if t1 is None else float(t1)
        _, pts = self._series(key, lo, tier=tier)
        return [(t, v) for t, v, _ in pts if t <= hi]

    def window_stats(self, key: str, window_s: float,
                     now: Optional[float] = None) -> Dict[str, float]:
        """min/max/mean/p50/p95/last/rate over the trailing window —
        the one-call summary ``/history`` and the SLO watchdog read."""
        now = time.time() if now is None else float(now)
        res, pts = self._series(key, now - float(window_s))
        if not pts:
            return {"n": 0, "tier_s": res}
        vals = [v for _, v, _ in pts]
        wq = [(v, n) for _, v, n in pts]
        n_samples = sum(n for _, _, n in pts)
        first_t, last_t = pts[0][0], pts[-1][0]
        out = {
            "n": n_samples,
            "points": len(pts),
            "tier_s": res,
            "first_t": first_t,
            "last_t": last_t,
            "last": vals[-1],
            "min": min(vals),
            "max": max(vals),
            "mean": sum(v * n for _, v, n in pts) / max(1, n_samples),
            "p50": _weighted_quantile(wq, 0.50),
            "p95": _weighted_quantile(wq, 0.95),
        }
        if last_t > first_t:
            # counter reading: per-second delta over the window (negative
            # deltas — a counter reset across a restart — clamp to 0)
            out["rate_per_s"] = max(
                0.0, (vals[-1] - vals[0]) / (last_t - first_t))
        else:
            out["rate_per_s"] = 0.0
        return out

    def quantile(self, key: str, q: float, window_s: float,
                 now: Optional[float] = None) -> float:
        """Windowed q-quantile of the sampled series (weighted by fold
        count on downsampled tiers); NaN when the window is empty."""
        now = time.time() if now is None else float(now)
        _, pts = self._series(key, now - float(window_s))
        return _weighted_quantile([(v, n) for _, v, n in pts], q)

    def rate(self, key: str, window_s: float,
             now: Optional[float] = None) -> float:
        return self.window_stats(key, window_s, now=now).get(
            "rate_per_s", 0.0)

    # -- surfaces ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "armed": True,
            "name": self.name,
            "keys": len(self._raw),
            "samples": self.samples,
            "last_t": self.last_t,
            "overhead_s": round(self.overhead_s, 6),
            "tiers": [{"res_s": r, "capacity": c}
                      for r, c in zip(self._tier_res, self._tier_cap)],
            "file": self.path,
            "rows_written": self._rows_written + len(self._buf),
        }

    def query(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The ``/history`` document. No ``key`` → the key listing +
        meta; with ``key`` (and optional ``window`` seconds, ``tier``,
        ``q``) → strided points + windowed stats."""
        key = params.get("key")
        if not key:
            return {**self.snapshot(), "key_names": self.keys()}
        key = str(key)
        if key not in self._raw:
            return {"error": f"unknown key {key!r}",
                    "key_names": self.keys()}
        window = float(params.get("window", 300.0))
        # the window is anchored at the NEWEST sample, not the wall
        # clock: a drained run (or an offline replay) keeps answering
        # with its data instead of an empty aged-out window
        now = self.last_t if self.last_t is not None else time.time()
        tier = params.get("tier")
        tier = int(tier) if tier not in (None, "") else None
        res, pts = self._series(key, now - window, tier=tier)
        stride = max(1, -(-len(pts) // int(self.knobs["max_points"])))
        points = [[round(t, 4), v] for t, v, _ in pts[::stride]]
        out = {
            "key": key,
            "window_s": window,
            "tier_s": res,
            "points": points,
            "stats": self.window_stats(key, window, now=now),
        }
        q = params.get("q")
        if q not in (None, ""):
            out["quantile"] = {"q": float(q),
                               "value": self.quantile(key, float(q),
                                                      window, now=now)}
        return out

    def render_http(self, query: Optional[Dict[str, Any]] = None
                    ) -> Tuple[str, str]:
        return json.dumps(self.query(query or {})), "application/json"


# ---------------------------------------------------------------------------
# offline: reload a persisted history (report sections, SLO replay)
# ---------------------------------------------------------------------------

def load_timeseries_rows(path: str) -> List[Dict[str, Any]]:
    """``timeseries-*.jsonl`` → ``[{"t": .., "m": {..}}]`` (torn trailing
    lines skipped — the writer appends whole lines, but a crash can cut
    the last one)."""
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except ValueError:
                continue
            if isinstance(r, dict) and "t" in r and isinstance(
                    r.get("m"), dict):
                rows.append(r)
    return rows


def history_from_rows(rows: List[Dict[str, Any]], name: str = "replay",
                      **overrides: Any) -> MetricsHistory:
    """Rebuild a queryable (in-memory) history from persisted rows —
    deterministic: the same rows produce the same windows, which is what
    makes SLO verdicts replayable."""
    h = MetricsHistory(dir=None, name=name, **overrides)
    for r in rows:
        h.sample(r["m"], now=float(r["t"]))
    return h

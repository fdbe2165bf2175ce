"""Counters, gauges, bucketed histograms and their Prometheus text
(``pytorch_ps_mpi_tpu/telemetry/registry.py:21-470``).

The instruments and :class:`MetricsRegistry` are the JAX package's, so
the same observations render the same text in both packages. A PS
server's :meth:`~pytorch_ps_mpi_tpu_torch.utils.metrics.PSServerCounters.scrape_registry`
is one of these, and the read tier registers its ``ps_read_seconds``
histogram and its scrape collectors there. The canonical key list lives
in ``utils/metrics.py``; ``ps_server_registry`` and the HTTP endpoint
come with ROADMAP queue 1 item 3.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

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

    def add_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        """Register a scrape-time callback that refreshes instruments
        from external state (server counters) before each render."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in list(self._collectors):
            fn(self)

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

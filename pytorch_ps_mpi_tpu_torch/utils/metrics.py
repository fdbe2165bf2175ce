"""The per-step metrics schema and the helpers that read it.

The reference returned a wall-clock and byte-count dict from every
``step`` (``ps.py:116-148,162-191``); the JAX package keeps its keys in
``MPI_PS._schema_dict`` (``pytorch_ps_mpi_tpu/ps.py:1898-1925``). The
port returns the same keys so callers read either package's dict alike.
``StepTimer``, ``MetricsAccumulator`` and ``print_summary`` are the JAX
package's ``utils/metrics.py``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Union

#: every key of the step metrics dict, in the JAX package's order
SCHEMA_KEYS = (
    "code_wait",
    "iallgather_prepare_time",
    "isend_time",
    "comm_wait",
    "decode_time",
    "optim_step_time",
    "msg_bytes",
    "packaged_bytes",
    "wire_lowering",
    "wire_bytes_per_worker",
    "bucket_count",
    "bucket_bytes_total",
    "agg_launches",
)


def schema_dict(*, msg_bytes: float, packaged_bytes: float,
                wire_lowering: str, wire_bytes_per_worker: float,
                bucket_count: float, bucket_bytes_total: float,
                agg_launches: float) -> Dict[str, Union[float, str]]:
    """A fresh metrics dict: the byte fields are static per optimizer,
    the timing fields start at 0 and the step fills what it observes.
    ``bucket_count`` 0 means the per-leaf path; ``agg_launches`` is the
    aggregation's units a step (buckets, or leaves)."""
    return {
        "code_wait": 0.0,
        "iallgather_prepare_time": 0.0,
        "isend_time": 0.0,
        "comm_wait": 0.0,
        "decode_time": 0.0,
        "optim_step_time": 0.0,
        "msg_bytes": float(msg_bytes),
        "packaged_bytes": float(packaged_bytes),
        "wire_lowering": wire_lowering,
        "wire_bytes_per_worker": float(wire_bytes_per_worker),
        "bucket_count": float(bucket_count),
        "bucket_bytes_total": float(bucket_bytes_total),
        "agg_launches": float(agg_launches),
    }


class StepTimer:
    """Accumulates named wall-clock segments into :attr:`data`.

    >>> t = StepTimer()
    >>> with t("comm_wait"): ...
    >>> t.data
    {'comm_wait': 0.0123}

    With the run-wide flight recorder enabled, every segment is also a
    span there.
    """

    def __init__(self):
        self.data: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        t0_mono = time.monotonic()  # recorder spans stamp their start
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.data[name] = self.data.get(name, 0.0) + dt
            from pytorch_ps_mpi_tpu_torch.telemetry.recorder import \
                get_recorder

            rec = get_recorder()
            if rec is not None:
                rec.event(name, kind="span", ts=t0_mono, dur=dt)


def print_summary(obj, _depth: int = 0) -> str:
    """One-line summary of a nested dict/list with tensors shown as their
    shapes (the reference's debug printer, ``mpi_comms.py:176-184``);
    printed at the top level, and returned."""
    if isinstance(obj, dict):
        out = "{" + ", ".join(f"{k}: {print_summary(v, _depth + 1)}"
                              for k, v in obj.items()) + "}"
    elif isinstance(obj, (list, tuple)):
        out = "[" + ", ".join(print_summary(v, _depth + 1)
                              for v in obj) + "]"
    elif hasattr(obj, "shape") and getattr(obj, "ndim", 0) > 0:
        out = f"array{tuple(obj.shape)}"
    else:
        out = repr(obj)
    if _depth == 0:
        print(out)
    return out


class MetricsAccumulator:
    """Collects per-step metrics dicts and reports each key's mean (the
    reference's ``data`` list that its caller kept)."""

    def __init__(self):
        self._rows: List[Dict[str, float]] = []

    def add(self, row: Dict[str, float]) -> None:
        self._rows.append(dict(row))

    def mean(self) -> Dict[str, float]:
        """Each numeric key's mean over the rows that have it; strings
        (``wire_lowering``) and lists (``bucket_grad_norms``) are
        skipped."""
        sums: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for row in self._rows:
            for k, val in row.items():
                if not isinstance(val, (int, float)):
                    continue
                sums[k] += val
                counts[k] += 1
        return {k: sums[k] / counts[k] for k in sums}

    def __len__(self) -> int:
        return len(self._rows)


# -- the async parameter server's canonical counters ---------------------------

from pytorch_ps_mpi_tpu_torch.telemetry.registry import (  # noqa: E402
    PS_SERVER_METRIC_KEYS, PSServerTelemetry, staleness_quantile)


class PSServerCounters(PSServerTelemetry):
    """The counters and the telemetry surface a PS server keeps (the JAX
    package's ``PSServerTelemetry``): :meth:`metrics` (the canonical
    dict), :meth:`scrape_registry` (the server's one registry, on which
    the read tier, the monitors and the serve loop register their
    instruments), ``/metrics`` and ``/health`` over HTTP
    (:meth:`start_metrics_http`). Shared by the shm and the TCP
    server."""

    def _close_serving(self) -> None:
        """The read tier, the HTTP endpoint and the per-process
        observability plane die with the server (``dcn.py:741-751``,
        ``tcp.py:655-668``): a restart never leaks a listener, and the
        fleet card goes first."""
        self.close_observability()
        self.close_metrics_http()
        if self.serving_core is not None:
            self.serving_core.close()


__all__ = ["SCHEMA_KEYS", "schema_dict", "StepTimer", "print_summary",
           "MetricsAccumulator", "PS_SERVER_METRIC_KEYS",
           "staleness_quantile", "PSServerCounters"]

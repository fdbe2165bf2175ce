"""The per-step metrics schema and the helpers that read it.

The reference returned a wall-clock and byte-count dict from every
``step`` (``ps.py:116-148,162-191``); the JAX package keeps its keys in
``MPI_PS._schema_dict`` (``pytorch_ps_mpi_tpu/ps.py:1898-1925``). The
port returns the same keys so callers read either package's dict alike.
``StepTimer``, ``MetricsAccumulator`` and ``print_summary`` are the JAX
package's ``utils/metrics.py`` (without its telemetry recorder, which
the port does not have yet).
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
    """

    def __init__(self):
        self.data: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.data[name] = (self.data.get(name, 0.0)
                               + time.perf_counter() - t0)


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
        (``wire_lowering``) are skipped."""
        sums: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        for row in self._rows:
            for k, val in row.items():
                if isinstance(val, str):
                    continue
                sums[k] += val
                counts[k] += 1
        return {k: sums[k] / counts[k] for k in sums}

    def __len__(self) -> int:
        return len(self._rows)


# -- the async parameter server's canonical counters ---------------------------

#: the keys of a PS server's ``metrics()``, the JAX package's
#: ``telemetry.registry.PS_SERVER_METRIC_KEYS`` in its order. The port
#: counts the wire, the staleness, the aggregation, the tree's composed
#: pushes and the read tier; the subsystems it does not have yet
#: (numerics, lineage, anatomy, the controller) report 0.0, as the JAX
#: package's do unarmed.
PS_SERVER_METRIC_KEYS = (
    "ts", "uptime_s", "grads_received", "bytes_received",
    "raw_bytes_per_grad", "wire_bytes_per_grad", "compression_ratio",
    "stale_drops", "bucket_count", "wire_units_per_push", "frames_rejected",
    "staleness_p50", "staleness_p95", "staleness_p99", "nonfinite_total",
    "grad_norm", "update_ratio", "codec_rel_error", "ef_residual_norm",
    "lineage_pushes", "push_e2e_p50_ms", "push_e2e_p95_ms", "anatomy_rounds",
    "anatomy_wire_share", "anatomy_top_saving_frac", "agg_mode",
    "decodes_per_publish", "agg_fallbacks", "tree_composed", "reads_total",
    "read_p50_ms", "read_p95_ms", "delta_bytes_saved", "reads_shed",
    "coalesce_hits", "reads_not_modified", "native_read_conns",
    "replica_lag_versions", "follower_bytes_relayed", "control_actions",
    "control_epoch", "control_evicted", "control_lr_scale_min",
    "topo_actions", "replicas_live", "group_replans", "read_fresh_p50_ms",
    "read_fresh_p95_ms", "serving_age_ms", "fresh_hop_count", "hop_rounds",
    "hop_busy_frac", "hop_ingest_wait_ms", "hop_stream_headroom_ratio",
    "hop_serial_ms", "hop_ring_drops",
)


def staleness_quantile(seen: Dict[int, int], q: float) -> float:
    """Exact weighted q-quantile of a ``{staleness: count}`` dict; 0.0
    when empty."""
    items = sorted(seen.items())
    total = sum(int(n) for _, n in items)
    if total == 0:
        return 0.0
    cum = 0
    for v, n in items:
        cum += int(n)
        if cum >= q * total:
            return float(v)
    return float(items[-1][0])


class PSServerCounters:
    """The counters a PS server keeps, :meth:`metrics` (the canonical dict
    over them and an armed read tier's keys) and :meth:`scrape_registry`
    (the JAX package's ``PSServerTelemetry`` without
    ``ps_server_registry``'s collector and the HTTP endpoint, which wait
    for ROADMAP queue 1 item 3). Shared by the shm and the TCP server."""

    #: the read tier's :class:`~pytorch_ps_mpi_tpu_torch.serving.ServingCore`
    #: when one was built on this server (``parallel/async_train.serve``,
    #: ``parallel/sharded.server_main``); closed with the server
    serving_core = None
    _registry = None

    def scrape_registry(self):
        """This server's :class:`~pytorch_ps_mpi_tpu_torch.telemetry.
        MetricsRegistry` (``registry.py:811``): the read tier's latency
        histogram and its scrape collectors live on it."""
        if self._registry is None:
            from pytorch_ps_mpi_tpu_torch.telemetry import MetricsRegistry

            self._registry = MetricsRegistry()
        return self._registry

    def _close_serving(self) -> None:
        """The read tier dies with the server (``dcn.py:741-751``,
        ``tcp.py:655-668``): a restart never leaks its listener."""
        if self.serving_core is not None:
            self.serving_core.close()

    #: payload decodes (one a consumed push on the decode path, one a
    #: round under compressed-domain aggregation)
    decodes_done: int = 0
    #: gradient-composed publishes (the initial publish excluded)
    grad_publishes: int = 0
    #: 1.0 while the serve loop folds pushes in the compressed domain
    agg_mode: float = 0.0
    #: pushes decoded while ``cfg["agg"] == "on"`` asked for aggregation
    agg_fallbacks: int = 0
    frames_rejected_total: int = 0

    @property
    def frames_rejected(self) -> Dict[int, int]:
        """Rejected frames by worker."""
        return self.__dict__.setdefault("_frames_rejected", {})

    def _reject_frame(self, worker: int, reason: str) -> None:
        d = self.frames_rejected
        d[worker] = d.get(worker, 0) + 1
        self.frames_rejected_total += 1
        reasons = self.__dict__.setdefault("reject_reasons", {})
        reasons[reason] = reasons.get(reason, 0) + 1

    def metrics(self) -> Dict[str, float]:
        wire = self.wire
        if wire is not None:
            raw, nbytes = float(wire.raw_bytes), float(wire.wire_bytes)
            plan = wire.plan
            buckets = float(plan.num_buckets) if plan is not None else 0.0
            units = buckets if plan is not None else float(len(wire.shapes))
        else:
            raw = nbytes = float(self._flat_params * 4)
            buckets, units = 0.0, 1.0 if self._flat_params else 0.0
        out = {k: 0.0 for k in PS_SERVER_METRIC_KEYS}
        out.update(
            ts=time.time(),
            uptime_s=max(0.0, time.monotonic() - self._t0_mono),
            grads_received=float(self.grads_received),
            bytes_received=float(self.bytes_received),
            raw_bytes_per_grad=raw, wire_bytes_per_grad=nbytes,
            compression_ratio=raw / nbytes if nbytes else 0.0,
            stale_drops=float(self.stale_drops), bucket_count=buckets,
            wire_units_per_push=units,
            frames_rejected=float(self.frames_rejected_total),
            staleness_p50=staleness_quantile(self.staleness_seen, 0.50),
            staleness_p95=staleness_quantile(self.staleness_seen, 0.95),
            staleness_p99=staleness_quantile(self.staleness_seen, 0.99),
            agg_mode=float(self.agg_mode),
            decodes_per_publish=(float(self.decodes_done)
                                 / float(self.grad_publishes)
                                 if self.grad_publishes else 0.0),
            agg_fallbacks=float(self.agg_fallbacks),
            tree_composed=float(getattr(self, "tree_composed", 0)),
        )
        sc = self.serving_core
        if sc is not None and sc.armed:
            out.update(sc.read_metrics())
        # the transport's own worker reads (TCP GET_PARAMS) count too
        out["reads_total"] += float(getattr(self, "_reads_total", 0))
        out["reads_not_modified"] += float(getattr(
            self, "_reads_not_modified", 0))
        return out

"""The per-process telemetry layer (``pytorch_ps_mpi_tpu/telemetry``):
the JAX package's modules of it, framework-free and copied here, and
:mod:`.numerics` on torch.

- :class:`FlightRecorder` — bounded, thread-safe structured event/span
  log (monotonic timestamps, worker id, step, staleness) with JSONL
  export. A process-global recorder is installed with :func:`configure`;
  every instrumented call site guards on :func:`get_recorder` returning
  ``None``, so a disabled recorder costs one attribute read per step.
- :class:`MetricsRegistry` — counters, gauges, bucketed histograms with
  a Prometheus text rendering; :class:`PSServerTelemetry` gives the shm
  and TCP parameter servers one canonical metric schema, and
  :class:`MetricsHTTPServer` serves it at ``/metrics`` and ``/health``.
- :mod:`trace export <.trace_export>` — merges recorder spans, lineage
  flow arrows and ``torch.profiler`` device rows into one
  Chrome/Perfetto timeline.
- :mod:`diagnosis <.diagnosis>` — :class:`HealthMonitor`'s per-worker
  verdicts (EWMA + MAD anomaly flags, compute/wire/churn straggler
  attribution, sync-round gating) from worker beacons.
- :mod:`lineage <.lineage>` — :class:`LineageTracker` bills every
  published version with the framed pushes (trace IDs) that composed it.
- :mod:`numerics <.numerics>` — gradient statistics reduced on the
  device, codec-fidelity probe rows, the non-finite quarantine with its
  skip/zero/abort policy and postmortems (:class:`NumericsMonitor`).
- :mod:`anatomy <.anatomy>` and :mod:`hop anatomy <.hop_anatomy>` —
  per-round critical paths with the what-if advisor, and the tree
  leaders' hop sub-stages.
- :mod:`freshness <.freshness>` — the read path's FRS1 trailer and
  :class:`FreshnessTracker`'s publish→visible rows.

- :mod:`timeseries <.timeseries>` — :class:`MetricsHistory`, the
  in-process TSDB (raw and 1 s/10 s/60 s rings a canonical key, sampled
  at the serve loop's tick from host counters, persisted, served at
  ``/history``).
- :mod:`slo <.slo>` — :class:`SLOWatchdog`'s latched multi-window
  burn-rate verdicts over that history, replayable from its rows.
- :mod:`profiler <.profiler>` — :class:`SamplingProfiler`, the always-on
  collapsed-stack sampler (a host thread that makes no CUDA call), and
  the native fold and pump cycle counters.
- :mod:`fleet <.fleet>` — :class:`FleetMonitor`'s ``/fleet`` pane over
  every registered server and read tier.

The controller that acts on these verdicts is ``control/``.
"""

from typing import Dict, Optional

#: The ONE registry of JSONL sidecar prefixes written under the
#: telemetry directory.  A "sidecar" is any structured side channel that
#: is NOT a flight-recorder event log (``server.jsonl`` /
#: ``worker-N.jsonl``): its rows have no recorder name/kind, so letting
#: one into the recorder-span merge corrupts the trace and the report.
#: Every observability PR used to patch the exclusion list in TWO
#: hand-maintained places (``tools/telemetry_report.py`` dir mode and
#: ``examples/train_async._export_telemetry``); both now route through
#: this map, and ``tools/psanalyze``'s ``sidecar-registry`` rule makes
#: an UNDECLARED prefix a lint failure instead of a live-run surprise.
#:
#: prefix → report route: the ``tools/telemetry_report.py`` section the
#: file feeds (``None`` = operator-facing raw log with no report
#: section — excluded from report collection entirely).
SIDECAR_PREFIXES: Dict[str, Optional[str]] = {
    "faults-": None,          # injected-fault event logs (resilience)
    "beacon-": None,          # worker health beacons (diagnosis tails)
    "numerics-": "numerics",  # grad-norm trajectories + fidelity probes
    "lineage-": "lineage",    # per-version push compositions + hop rows
    "anatomy-": "anatomy",    # round-anatomy critical-path rows
    "timeseries-": "history",  # retained metric history (TSDB)
    "slo-": "slo",            # SLO verdict events
    "control-": "actions",    # controller action rows
    "freshness-": "freshness",  # publish→edge propagation + delivery rows
    "hop-": "hop",            # leader hop sub-stage occupancy rows
}


def sidecar_prefix(path: str) -> Optional[str]:
    """The declared sidecar prefix of a telemetry-dir ``.jsonl`` file
    name/path, or None for recorder files (``server.jsonl``,
    ``worker-N.jsonl``) and anything else."""
    import os as _os

    base = _os.path.basename(path)
    if not base.endswith(".jsonl"):
        return None
    for p in SIDECAR_PREFIXES:
        if base.startswith(p):
            return p
    return None


def is_sidecar(path: str) -> bool:
    """True when the file must stay OUT of the recorder-span merge."""
    return sidecar_prefix(path) is not None


from pytorch_ps_mpi_tpu_torch.telemetry.recorder import (
    FlightRecorder,
    configure,
    disable,
    get_recorder,
    install,
    load_jsonl,
    record_event,
    span,
)
from pytorch_ps_mpi_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    HEALTH_FLEET_ROLLUP_KEYS,
    Histogram,
    MetricsRegistry,
    PS_SERVER_METRIC_KEYS,
    PSServerTelemetry,
    ps_server_metrics,
    ps_server_registry,
    staleness_quantile,
)
from pytorch_ps_mpi_tpu_torch.telemetry.http_server import MetricsHTTPServer
from pytorch_ps_mpi_tpu_torch.telemetry.diagnosis import (
    BeaconWriter,
    HealthMonitor,
)
from pytorch_ps_mpi_tpu_torch.telemetry.lineage import (
    LineageTracker,
    clock_offsets_from_rows,
    estimate_clock_offset,
    load_lineage_rows,
    trace_id,
)
from pytorch_ps_mpi_tpu_torch.telemetry.numerics import (
    NumericsMonitor,
    ProbeWriter,
    sanitize_tree,
    tree_stats,
    update_weight_ratio,
)
from pytorch_ps_mpi_tpu_torch.telemetry.timeseries import (
    MetricsHistory,
    history_from_rows,
    load_timeseries_rows,
)
from pytorch_ps_mpi_tpu_torch.telemetry.profiler import (
    SamplingProfiler,
    load_profile,
    merge_profiles,
    top_frames,
)
from pytorch_ps_mpi_tpu_torch.telemetry.slo import (
    SLOWatchdog,
    derive_targets,
)
from pytorch_ps_mpi_tpu_torch.telemetry.fleet import (
    FleetMonitor,
    deregister_endpoint,
    parse_prometheus_text,
    register_endpoint,
)
from pytorch_ps_mpi_tpu_torch.telemetry.trace_export import (
    export_chrome_trace,
    merged_trace_events,
)
from pytorch_ps_mpi_tpu_torch.telemetry.anatomy import (
    RoundAnatomy,
    anatomy_from_round_rows,
    anatomy_from_rows,
    load_anatomy_rows,
)
from pytorch_ps_mpi_tpu_torch.telemetry.freshness import (
    FreshnessTracker,
    freshness_flow_events,
    load_fresh_rows,
)
from pytorch_ps_mpi_tpu_torch.telemetry.hop_anatomy import (
    HopAnatomy,
    hop_anatomy_from_rows,
    hop_trace_events,
    load_hop_rows,
)

__all__ = [
    "SIDECAR_PREFIXES",
    "sidecar_prefix",
    "is_sidecar",
    "RoundAnatomy",
    "anatomy_from_round_rows",
    "anatomy_from_rows",
    "load_anatomy_rows",
    "FlightRecorder",
    "configure",
    "disable",
    "get_recorder",
    "install",
    "load_jsonl",
    "record_event",
    "span",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "HEALTH_FLEET_ROLLUP_KEYS",
    "PS_SERVER_METRIC_KEYS",
    "PSServerTelemetry",
    "ps_server_metrics",
    "ps_server_registry",
    "staleness_quantile",
    "MetricsHTTPServer",
    "BeaconWriter",
    "HealthMonitor",
    "LineageTracker",
    "clock_offsets_from_rows",
    "estimate_clock_offset",
    "load_lineage_rows",
    "trace_id",
    "NumericsMonitor",
    "ProbeWriter",
    "sanitize_tree",
    "MetricsHistory",
    "history_from_rows",
    "load_timeseries_rows",
    "SamplingProfiler",
    "load_profile",
    "merge_profiles",
    "top_frames",
    "SLOWatchdog",
    "derive_targets",
    "FleetMonitor",
    "deregister_endpoint",
    "parse_prometheus_text",
    "register_endpoint",
    "tree_stats",
    "update_weight_ratio",
    "export_chrome_trace",
    "merged_trace_events",
    "FreshnessTracker",
    "freshness_flow_events",
    "load_fresh_rows",
    "HopAnatomy",
    "hop_anatomy_from_rows",
    "hop_trace_events",
    "load_hop_rows",
]

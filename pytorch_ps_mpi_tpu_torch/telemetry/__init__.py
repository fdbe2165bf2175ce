"""The telemetry pieces the read tier needs (``pytorch_ps_mpi_tpu/telemetry``):

- :mod:`.registry`: counters, gauges, bucketed histograms and the
  Prometheus text rendering (:class:`MetricsRegistry`), on which a PS
  server's scrape registry and the read tier's latency histogram live;
- :mod:`.freshness`: the FRS1 freshness trailer of the read wire;
- :mod:`.diagnosis`: :class:`Ewma`, which the follower's lag decays by;
- :mod:`.lineage`: :func:`estimate_clock_offset`, the reader's clock
  skew.

The rest of the JAX package's telemetry (the flight recorder, the HTTP
endpoint, health, numerics, lineage tracking, anatomy, the fleet and
``FreshnessTracker``) comes with ROADMAP queue 1 item 3, which extends
these files.
"""

from pytorch_ps_mpi_tpu_torch.telemetry.registry import (Counter, Gauge,
                                                         Histogram,
                                                         MetricsRegistry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

"""Online diagnosis helpers (``pytorch_ps_mpi_tpu/telemetry/diagnosis.py``).

Only :class:`Ewma` so far: the follower tier decays its replica lag by
it. ``HealthMonitor`` and the verdicts come with ROADMAP queue 1 item 3.
"""

from __future__ import annotations

from typing import Optional


class Ewma:
    """Exponentially weighted moving average (``diagnosis.py:50-63``);
    ``None`` until the first update (a 0.0 prior would drown early
    samples)."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        v = self.value
        self.value = float(x) if v is None else v + self.alpha * (x - v)
        return self.value

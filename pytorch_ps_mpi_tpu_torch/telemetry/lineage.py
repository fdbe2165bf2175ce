"""Gradient lineage helpers (``pytorch_ps_mpi_tpu/telemetry/lineage.py``).

Only :func:`estimate_clock_offset` so far: a read-tier reader estimates
its clock's offset from the served trailer's with it. ``LineageTracker``
comes with ROADMAP queue 1 item 3.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def estimate_clock_offset(pairs: Sequence[Tuple[float, float]]) -> float:
    """``receiver_clock - sender_clock`` in seconds from ``(send_ts,
    recv_ts)`` pairs of the same messages (``lineage.py:80``): the
    one-way lower envelope ``min(recv - send)``, biased by at most the
    fastest message's latency. Raises ``ValueError`` on no pairs."""
    diffs = [float(r) - float(s) for s, r in pairs]
    if not diffs:
        raise ValueError("need at least one (send, recv) pair")
    return min(diffs)

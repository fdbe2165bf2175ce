"""One reader a per-layer metric, ``metrics/<name>.py``, each with
``read(ctx) -> float | None``: None where the run gave it nothing to
read, and the harness then leaves the metric out of the line.

``ctx`` holds ``cfg``, ``mix``, ``family``, ``shapes`` (the leaves in
the optimizer's order), ``plain`` (the traced run's timed stretch:
``steps``, ``wall_s``, ``intervals_ms``, ``step_time_s``), ``trace``
(the profiled stretch: ``rows``, ``busy_s``, ``window_s``, ``steps``),
``staged`` (the ``instrument=True`` steps' ``data`` and whether their
kernel launches matched a plain step's) and ``device``.
"""

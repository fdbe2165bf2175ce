"""``grad_time`` of ``instrument=True`` steps (forward and backward,
ended by a device sync), mean in ms."""

import statistics


def read(ctx):
    vals = [d["grad_time"] for d in ctx.staged["data"] if "grad_time" in d]
    return statistics.fmean(vals) * 1e3 if vals else None

"""``optim_step_time`` of ``instrument=True`` steps (the optimizer's
update), mean in ms."""

import statistics


def read(ctx):
    vals = [d["optim_step_time"] for d in ctx.staged["data"]
            if "optim_step_time" in d]
    return statistics.fmean(vals) * 1e3 if vals else None

"""Mean of ``MPI_PS.step``'s own ``step_time`` over the traced run's
timed stretch, in ms."""

import statistics


def read(ctx):
    times = ctx.plain["step_time_s"]
    return statistics.fmean(times) * 1e3 if times else None

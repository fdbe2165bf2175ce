"""Device idle over the profiled stretch under none of the program's
``ps.grad``, ``ps.aggregate`` and ``ps.update`` ranges, in ms a step: the
step's glue, its final wait (``ps.wait``) and the time between steps.
With the three stages' idle it sums, times the steps, to the stretch's
idle time (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "entry")

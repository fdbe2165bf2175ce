"""Device idle inside the program's ``ps.grad`` ranges (forward, backward,
the loss's reduce) over the profiled stretch, in ms a step: the window
less the union of the device rows, where a moment under two stages
counts to the earlier (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "grad")

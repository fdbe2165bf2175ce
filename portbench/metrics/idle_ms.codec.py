"""Device idle inside the program's ``ps.aggregate`` ranges (every encode,
the exchange and the decode-sum) over the profiled stretch, in ms a
step: the window less the union of the device rows, where a moment under
two stages counts to the earlier (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "codec")

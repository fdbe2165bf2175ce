"""Runtime calls that put a row on the device (kernel launches, memsets,
copies) starting inside the program's ``ps.update`` ranges (average,
clip, the optimizer, the new parameters taken), a profiled step, on any
thread (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.launch_calls(ctx.trace, "update")

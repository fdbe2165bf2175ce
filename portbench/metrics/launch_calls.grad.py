"""Runtime calls that put a row on the device (kernel launches, memsets,
copies) starting inside the program's ``ps.grad`` ranges (forward,
backward, the loss's reduce), a profiled step, on any thread
(``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.launch_calls(ctx.trace, "grad")

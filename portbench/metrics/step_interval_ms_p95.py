"""The 95th percentile of the step intervals of the traced run's timed
stretch (step-end CUDA events), in ms."""

from portbench.harness.window import p95


def read(ctx):
    iv = ctx.plain["intervals_ms"]
    return p95(iv) if iv else None

"""The whole step's share of the configuration's declared peak: model
FLOPs a step (the family's count from the shapes) times the steps of the
traced run's timed stretch, over its wall time and the peak, in %."""


def read(ctx):
    p = ctx.plain
    if not p["steps"] or p["wall_s"] <= 0:
        return None
    flops = ctx.family.step_flops(ctx.cfg, ctx.mix) * p["steps"]
    return 100.0 * flops / p["wall_s"] / float(ctx.cfg["peak_flops"])

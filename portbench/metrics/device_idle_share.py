"""Share of the profiled stretch in which no kernel, copy or memset ran
on the card: 1 - (union of the device rows) / (the stretch's wall), in
%."""


def read(ctx):
    tr = ctx.trace
    if not tr or tr["window_s"] <= 0 or not tr["rows"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

"""``code_wait`` plus ``decode_time`` of ``instrument=True`` steps (the
codec's encode, and its decode-sum where it has one), mean in ms. Read
only where a staged step launched the same kernels as a plain step:
else the stages run other units than the timed path."""

import statistics


def read(ctx):
    if not ctx.staged["units_match"]:
        return None
    vals = [d["code_wait"] + d.get("decode_time", 0.0)
            for d in ctx.staged["data"] if "code_wait" in d]
    return statistics.fmean(vals) * 1e3 if vals else None

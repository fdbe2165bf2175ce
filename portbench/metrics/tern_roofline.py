"""TernGrad's kernels' share of their roofline over the profiled
stretch, in %: the bytes the codec's two functions need for every unit
the kernels take (a flat bucket, or a leaf without buckets, whose size
divides by 512), at world 1, over HBM's rate, against the device time of
the ``tern_*`` rows. The encode reads the gradient in the parameters'
type and writes 2 bits an element and a scale; the random bits it draws
are not counted (``counts.tern_encode_bytes``). The unpack-sum reads the
payload and writes the float32 sum. The units come from the reference's
bucket plan of the leaves in the optimizer's order; a stretch whose
unpack-sum rows are not one a unit a step gives nothing."""

import math

from portbench.harness import counts
from portbench.harness.trace import kernel_seconds
from portbench.reference import bucketing


def units(ctx):
    import torch

    if ctx.mix["bucket_mb"] > 0:
        meta = {k: torch.empty(s, device="meta") for k, s in
                ctx.shapes.items()}
        plan = bucketing.plan(meta, ctx.mix["bucket_mb"])
        sizes = [sum(math.prod(ctx.shapes[k]) for k in b) for b in plan]
    else:
        sizes = [math.prod(s) for s in ctx.shapes.values()]
    return [n for n in sizes if n % 512 == 0 and n > 0]


def read(ctx):
    tr = ctx.trace
    if not tr or not ctx.mix["codec_args"].get("use_pallas"):
        return None
    seconds, n = kernel_seconds(tr["rows"], "tern_")
    sizes = units(ctx)
    _, unpacks = kernel_seconds(tr["rows"], "tern_unpack_sum")
    if seconds <= 0 or unpacks["tern_unpack_sum"] != len(sizes) * tr["steps"]:
        return None
    itemsize = {"float32": 4, "bfloat16": 2}[ctx.cfg["param_dtype"]]
    nbytes = sum(counts.tern_encode_bytes(m, itemsize)
                 + counts.tern_unpack_sum_bytes(m, 1) for m in sizes)
    need = tr["steps"] * counts.bound_seconds(nbytes)[0]
    return 100.0 * need / seconds

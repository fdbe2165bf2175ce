"""The exact top-k kernels' share of their roofline over the profiled
stretch, in %: 4n + 8k bytes a leaf the radix kernels take (float32
leaves of at least 8,192 elements with k = round(fraction * n) < n; the
smaller ones take the sort), over HBM's rate, against the device time of
the ``radix_hist``/``compact_*`` rows. A stretch whose scatter rows are
not one such leaf a step gives nothing."""

import math

from portbench.harness import counts
from portbench.harness.trace import kernel_seconds

#: the smallest leaf the radix kernels take (4 blocks of 2,048)
KERNEL_MIN = 8192


def read(ctx):
    tr = ctx.trace
    frac = ctx.mix["codec_args"].get("fraction")
    if not tr or not frac or not ctx.mix["codec_args"].get("pallas"):
        return None
    leaves = []
    for shape in ctx.shapes.values():
        n = math.prod(shape)
        k = min(max(1, int(round(n * frac))), n)
        if n >= KERNEL_MIN and k < n:
            leaves.append((n, k))
    seconds, c = kernel_seconds(tr["rows"], "radix_hist", "compact_count",
                                "compact_scatter")
    if seconds <= 0 or c["compact_scatter"] != len(leaves) * tr["steps"]:
        return None
    nbytes = sum(counts.topk_bytes(n, k) for n, k in leaves)
    return 100.0 * tr["steps"] * counts.bound_seconds(nbytes)[0] / seconds

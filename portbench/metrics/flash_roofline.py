"""The flash attention kernels' share of their roofline over the
profiled stretch, in %: the least time the calls need (the larger of
their bytes over HBM's rate and their operations over the bf16 peak,
each call's from ``[batch * heads, seq, head_dim]``) over the device
time of the ``flash_*`` rows. A forward is one row, a backward two (dq,
then dk and dv)."""

from portbench.harness import counts
from portbench.harness.trace import kernel_seconds


def read(ctx):
    tr, cfg, mix = ctx.trace, ctx.cfg, ctx.mix
    if not tr:
        return None
    seconds, n = kernel_seconds(tr["rows"], "flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv")
    fwd, bwd = n["flash_fwd"], n["flash_bwd_dq"]
    if not fwd or seconds <= 0 or bwd != n["flash_bwd_dkv"]:
        return None
    heads = cfg["num_attention_heads"]
    shape = (mix["batch"] * heads, mix["seq"], cfg["hidden_size"] // heads)
    need = (fwd * counts.bound_seconds(*counts.flash_fwd(*shape))[0]
            + bwd * counts.bound_seconds(*counts.flash_bwd(*shape))[0])
    return 100.0 * need / seconds

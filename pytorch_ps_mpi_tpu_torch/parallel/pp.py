"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis
(``pytorch_ps_mpi_tpu/parallel/pp.py``).

S homogeneous stages, one a rank of the ``pipe`` axis: stage s's
parameters are row s of a ``[pipe, ...]`` stack (``stage_spec``), so each
rank holds, and steps the optimizer state of, its own stage. The
schedule is the JAX ``lax.scan``'s, a loop of S + M − 1 ticks
(``pp.py:86-131``): at tick t stage s runs microbatch t − s and hands its
activation to stage s + 1 with ``comms.ring_permute``. The backward
pipeline is autograd's: the permute's backward is the reverse hop.

Every rank sends on every tick, and every tick's activation feeds the
next tick through a ``torch.where`` with a tensor condition, as the JAX
double ``where`` does (``pp.py:109-117``): on warm-up and drain ticks a
stage computes on ones and the result is masked out, so no NaN of the
garbage reaches the outputs or the gradients, and every rank's autograd
graph has the same collectives in the same order (a permute that one
rank's graph dropped would leave its neighbour waiting).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.mesh import P, axis_group

Params = Dict[str, Any]


def _pipeline_scan(stage_params: Params, x_mb: torch.Tensor,
                   stage_fn: Callable, pipe_axis, mesh=None):
    """The tick schedule: ``(out, is_last)``, ``out [M, ...]`` the last
    stage's outputs there (zeros elsewhere)."""
    g = axis_group(pipe_axis, mesh)
    params = {k: v[0] for k, v in stage_params.items()}
    s_count, me = g.size, g.index
    m = x_mb.shape[0]
    dev = x_mb.device
    is_first = torch.tensor(me == 0, device=dev)
    is_last = me == s_count - 1
    outs = [torch.zeros_like(x_mb[0]) for _ in range(m)]
    cur = torch.zeros_like(x_mb[0])
    for t in range(s_count + m - 1):
        mb_idx = t - me                           # the microbatch this stage sees
        valid = 0 <= mb_idx < m
        feed = x_mb[min(max(t, 0), m - 1)]
        x_in = torch.where(is_first, feed, cur)
        safe_in = torch.where(torch.tensor(valid, device=dev), x_in,
                              torch.ones_like(x_in))
        y = stage_fn(params, safe_in)
        # the last stage banks finished microbatches; a select on every
        # rank and tick, so the loss reaches every tick's activation
        slot = min(max(mb_idx, 0), m - 1)
        write = torch.tensor(is_last and valid, device=dev)
        outs[slot] = outs[slot] + torch.where(write, y, torch.zeros_like(y))
        # the wrap-around edge S-1 -> 0 carries what stage 0 ignores
        cur = comms.ring_permute(y, g)
    return torch.stack(outs), is_last


def pipeline_apply(stage_params: Params, x_mb: torch.Tensor,
                   stage_fn: Callable, pipe_axis, local_grads: bool = False,
                   mesh=None) -> torch.Tensor:
    """Run ``stage_fn`` once a stage over M microbatches (``pp.py:48``).
    ``stage_params``: this rank's stage (leaves ``[1, ...]``); ``x_mb
    [M, mb, ...]`` replicated over the axis (stage 0 reads it);
    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape``. Returns the
    last stage's ``[M, mb, ...]`` outputs on every rank (a sum over the
    axis, the identity backward; ``local_grads`` is accepted for the JAX
    signature, as in ``parallel.tp``)."""
    out, is_last = _pipeline_scan(stage_params, x_mb, stage_fn, pipe_axis,
                                  mesh)
    # a select, not a branch: every rank's graph reaches its permutes
    masked = torch.where(torch.tensor(is_last, device=out.device), out,
                         torch.zeros_like(out))
    return comms.psum_fwd_identity_bwd(masked, axis_group(pipe_axis, mesh))


def pipeline_loss(stage_params: Params, x_mb: torch.Tensor,
                  y_mb: torch.Tensor, stage_fn: Callable, loss_fn: Callable,
                  pipe_axis, local_grads: bool = False,
                  mesh=None) -> torch.Tensor:
    """The mean over microbatches of ``loss_fn(pipeline(x_mb)[i],
    y_mb[i])`` (``pp.py:133``), taken on the last stage and summed over
    the axis (its backward the identity): differentiate it for the
    backward pipeline; each rank's gradients are its own stage's."""
    out, is_last = _pipeline_scan(stage_params, x_mb, stage_fn, pipe_axis,
                                  mesh)
    local = torch.stack([loss_fn(out[i], y_mb[i])
                         for i in range(out.shape[0])]).mean()
    masked = torch.where(torch.tensor(is_last, device=local.device), local,
                         torch.zeros_like(local))
    return comms.psum_fwd_identity_bwd(masked, axis_group(pipe_axis, mesh))


def init_stage_stack(key, s_count: int, init_one: Callable) -> Params:
    """``[pipe]``-stacked parameters: ``init_one(gen)`` once a stage from
    one generator (``key``: a seed or a ``torch.Generator``), each leaf
    stacked on a new leading axis (``pp.py:161``)."""
    from pytorch_ps_mpi_tpu_torch.parallel.tp import _gen

    gen = _gen(key)
    stages = [init_one(gen) for _ in range(s_count)]
    return {k: torch.stack([s[k] for s in stages]) for k in stages[0]}


def stage_spec(params: Params, pipe_axis: str) -> Dict[str, P]:
    """Every stacked leaf sharded over the pipe axis."""
    return {k: P(pipe_axis) for k in params}

"""Typed collectives on ``torch.distributed``.

The counterpart of ``pytorch_ps_mpi_tpu/comms.py`` for the synchronous
step:

- a sum across ranks, per tensor and per flat bucket
  (``allreduce_sum_buckets``);
- an all-gather that stacks every rank's tensor on a new leading
  ``[world]`` axis (the reference's ``Iallgatherv``,
  ``mpi_comms.py:160-163``);
- the leader (ZeRO-1) pair: a tiled reduce-scatter (``lax.psum_scatter``
  with ``tiled=True``, ``ps.py:250``) and a tiled all-gather
  (``lax.all_gather`` with ``tiled=True``, ``ps.py:309``);
- the rank-0 parameter server's gather and broadcast
  (``gather_to_leader``, ``broadcast_from_leader``; reference
  ``mpi_comms.py:60-133``);
- the ragged all-gather of a payload with a static cap and an int32
  true-length sidecar (``ragged_all_gather``, ``comms.py:124``).

- an all-gather with a gradient (``all_gather_with_grad``): the
  statistics' collective of SyncBatchNorm, whose backward all-reduces the
  cotangent as ``lax.all_gather``'s transpose does;
- the mean across ranks of a tree (``allreduce_mean_tree``, ``lax.pmean``
  over a model's running statistics), one all-reduce a dtype.

With no process group each is the identity (``all_gather`` an
``unsqueeze(0)``), matching the JAX package on a one-device mesh.

:data:`calls` counts the collective calls made, by kind, as the kernel
wrappers keep ``.launches``: the counterpart of the JAX package's
``bucketing.count_collectives``. Identity calls without a group count
nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from pytorch_ps_mpi_tpu_torch.mesh import rank, world_size

Tree = Any

#: collective calls made since the last :func:`reset_calls`, by kind
calls: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                         "reduce_scatter": 0, "broadcast": 0, "gather": 0}


def reset_calls() -> None:
    for kind in calls:
        calls[kind] = 0


def allreduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` across ranks into a new tensor (reference
    ``ps.py:161,176``: allgather + host ``sum(grads)`` as one collective)."""
    if not dist.is_initialized():
        return x
    out = x.clone()
    dist.all_reduce(out)
    calls["all_reduce"] += 1
    return out


def allreduce_sum_buckets(buckets: Sequence[torch.Tensor],
                          wire_dtype: Optional[torch.dtype] = None
                          ) -> List[torch.Tensor]:
    """One sum across ranks a flat bucket (``comms.py:62``). ``wire_dtype``
    narrows each bucket on the wire and casts back, unconditionally, so
    the numerics equal the per-leaf path's bit for bit."""
    if wire_dtype is None:
        return [allreduce_sum(b) for b in buckets]
    return [allreduce_sum(b.to(wire_dtype)).to(b.dtype) for b in buckets]


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading ``[world]`` axis, in
    rank order."""
    if not dist.is_initialized():
        return x.unsqueeze(0)
    x = x.contiguous()
    out = torch.empty((world_size(),) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), x)
    calls["all_gather"] += 1
    return out


def all_gather_tiled(x: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``x`` concatenated in rank order, ``[world * n]``
    (``lax.all_gather(..., tiled=True)``)."""
    if not dist.is_initialized():
        return x
    x = x.contiguous()
    out = torch.empty((world_size() * x.numel(),), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x)
    calls["all_gather"] += 1
    return out


def reduce_scatter_tiled(x: torch.Tensor) -> torch.Tensor:
    """The sum across ranks of 1-D ``x`` (``[world * ss]``), of which this
    rank keeps rows ``[rank * ss, (rank + 1) * ss)``
    (``lax.psum_scatter(..., tiled=True)``)."""
    if not dist.is_initialized():
        return x
    x = x.contiguous()
    out = torch.empty((x.numel() // world_size(),), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x)
    calls["reduce_scatter"] += 1
    return out


def gather_to_leader(x: torch.Tensor) -> Optional[torch.Tensor]:
    """Every rank's ``x`` stacked ``[world, ...]`` on the leader, rank 0
    (reference ``igather``, ``mpi_comms.py:60-93``); ``None`` on the other
    ranks. The JAX package lowers it to an all-gather, so there every
    rank holds the stack; the leader's is the same."""
    if not dist.is_initialized():
        return x.unsqueeze(0)
    x = x.contiguous()
    out = None
    if rank() == 0:
        out = torch.empty((world_size(),) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    dist.gather(x, list(out.unbind(0)) if out is not None else None, dst=0)
    calls["gather"] += 1
    return out


def broadcast_from_leader(x: torch.Tensor) -> torch.Tensor:
    """Every rank receives the leader's ``x`` (reference ``ibroadcast``,
    ``mpi_comms.py:127-133``), in a new tensor."""
    if not dist.is_initialized():
        return x
    out = x.contiguous().clone()
    dist.broadcast(out, src=0)
    calls["broadcast"] += 1
    return out


def ragged_all_gather(payload: Tree, length: torch.Tensor):
    """All-gather a variable-length payload: ``(payloads, lengths)``, every
    tensor of ``payload`` stacked ``[world, ...]`` and the ranks' int32
    true lengths ``[world]``, each an all-gather.

    The counterpart of the reference's two-phase protocol (sizes first,
    then ``Iallgatherv``, ``mpi_comms.py:144-174``) in the JAX package's
    form (``comms.py:124-143``): the payload's size is its static cap,
    each rank's true length rides beside it, and the receiver masks the
    slots past it."""
    return all_gather_tree(payload), all_gather(length.to(torch.int32))


class _AllGatherWithGrad(torch.autograd.Function):
    """:func:`all_gather` in the forward; in the backward every rank's
    cotangent of the ``[world, ...]`` stack is summed across ranks and
    this rank keeps its row, the cotangent of its own ``x``."""

    @staticmethod
    def forward(ctx, x):
        return all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce_sum(g.contiguous())[rank()]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_gather` that autograd differentiates: one all-gather in
    the forward and one all-reduce in the backward, both counted. A
    statistic that every rank computes from the gathered stack (a
    SyncBatchNorm mean) so passes the gradient of every rank's loss back
    to the rank whose data it came from; ``dist.all_gather`` alone has no
    gradient, and the backward would stay per rank."""
    return _AllGatherWithGrad.apply(x)


def allreduce_mean_tree(tree: Tree) -> Tree:
    """The mean across ranks of every tensor of ``tree`` (floating), as
    ``lax.pmean`` over the tree: the tensors of one dtype are summed in
    one flat all-reduce and divided by the world."""
    if not dist.is_initialized():
        return tree
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        if not t.is_floating_point():
            raise TypeError(f"allreduce_mean_tree: {t.dtype} leaf; the "
                            "mean across ranks is of floating tensors")
        by_dtype.setdefault(t.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    w = world_size()
    for idx in by_dtype.values():
        flat = allreduce_sum(torch.cat([leaves[i].reshape(-1)
                                        for i in idx])) / w
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def tree_map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def allreduce_sum_tree(tree: Tree) -> Tree:
    return tree_map(allreduce_sum, tree)


def all_gather_tree(tree: Tree) -> Tree:
    return tree_map(all_gather, tree)


def broadcast_from_leader_tree(tree: Tree) -> Tree:
    """:func:`broadcast_from_leader` of every tensor of ``tree``: the
    parameter read-back of a broadcast-topology PS (``comms.py:111``)."""
    return tree_map(broadcast_from_leader, tree)


__all__ = [
    "calls", "reset_calls", "allreduce_sum", "allreduce_sum_buckets",
    "allreduce_sum_tree", "all_gather", "all_gather_tree",
    "all_gather_tiled", "reduce_scatter_tiled", "ragged_all_gather",
    "all_gather_with_grad", "allreduce_mean_tree",
    "gather_to_leader",
    "broadcast_from_leader", "broadcast_from_leader_tree", "tree_map",
]

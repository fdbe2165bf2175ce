"""Typed collectives on ``torch.distributed``.

The counterpart of ``pytorch_ps_mpi_tpu/comms.py:52-89`` for the
synchronous step: a sum across ranks and an all-gather that stacks every
rank's tensor on a new leading ``[world]`` axis (the reference's
``Iallgatherv``, ``mpi_comms.py:160-163``). With no process group these
are the identity and ``unsqueeze(0)``, matching the JAX package on a
one-device mesh. Ragged, leader and broadcast collectives come with a
later slice (ROADMAP queue 1 item 1).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from pytorch_ps_mpi_tpu_torch.mesh import world_size

Tree = Any


def allreduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` across ranks into a new tensor (reference
    ``ps.py:161,176``: allgather + host ``sum(grads)`` as one collective)."""
    if not dist.is_initialized():
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading ``[world]`` axis, in
    rank order."""
    if not dist.is_initialized():
        return x.unsqueeze(0)
    x = x.contiguous()
    out = torch.empty((world_size(),) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), x)
    return out


def tree_map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def allreduce_sum_tree(tree: Tree) -> Tree:
    return tree_map(allreduce_sum, tree)


def all_gather_tree(tree: Tree) -> Tree:
    return tree_map(all_gather, tree)


__all__ = [
    "allreduce_sum", "allreduce_sum_tree", "all_gather", "all_gather_tree",
    "tree_map",
]

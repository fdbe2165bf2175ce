"""The functional data-parallel train step (``pytorch_ps_mpi_tpu/
parallel/dp.py``).

The pipeline ``MPI_PS.step`` runs (grad -> encode -> collective ->
decode and sum -> update), built from the same functions of ``ps.py`` as
a pure function over ``name -> tensor`` dicts, for callers who thread
the state themselves instead of keeping an optimizer object.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from pytorch_ps_mpi_tpu_torch import comms, mesh
from pytorch_ps_mpi_tpu_torch.bucketing import plan_buckets
from pytorch_ps_mpi_tpu_torch.codecs import Codec, IdentityCodec
from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
from pytorch_ps_mpi_tpu_torch.ps import (Pipeline, _has_tensors, _view,
                                         aggregate_update, leader_init_state)

Params = Dict[str, torch.Tensor]


def _copy(tree: Any) -> Any:
    return comms.tree_map(
        lambda t: t.detach().clone() if torch.is_tensor(t) else t, tree)


def make_sync_train_step(loss_fn: Callable[[Params, Any], torch.Tensor], *,
                         optim: str = "sgd", code: Optional[Codec] = None,
                         mode: str = "allgather", average: bool = False,
                         bucket_mb: float = 0.0, **hyper):
    """Build ``(init_fn, step_fn)``.

    ``init_fn(params) -> (opt_state, codec_state)``;
    ``step_fn(params, opt_state, codec_state, batch, gen) -> (params,
    opt_state, codec_state, loss)``, this rank's ``batch``, ``gen`` the
    ``torch.Generator`` a codec that draws random numbers takes them from
    (``None`` for the others), ``loss`` the mean over ranks. ``step_fn``
    does not alter its inputs: it returns new tensors. Its aggregate and
    update are ``MPI_PS``'s, :func:`~pytorch_ps_mpi_tpu_torch.ps.
    aggregate_update`.

    ``mode="leader"`` is ZeRO-1 a leaf at a time (``init_fn`` gives this
    rank's :class:`~pytorch_ps_mpi_tpu_torch.ps.LeaderState`), the JAX
    package's lowering: a reduce-scatter for psum codecs, else every rank
    decode-sums the gathered payloads and slices its shard.
    ``bucket_mb > 0`` aggregates in flat buckets in ``mode="allgather"``
    with a bucketable codec; use ``MPI_PS(mode="leader", bucket_mb=...)``
    for bucketed ZeRO-1. ``init_fn`` fixes what the steps after it take
    from the parameters: the bucket plan over their shapes, and the
    ``codec_view`` of each leaf that carries one, which a codec whose
    result depends on the order of a leaf's elements sees it through.
    """
    code = code if code is not None else IdentityCodec()
    if mode not in ("allgather", "leader"):
        raise ValueError("mode must be 'allgather' or 'leader'")
    hyper_cls, init_state, update_fn = OPTIMIZERS[optim]
    h = hyper_cls(**hyper)
    size, rank = mesh.world_size(), mesh.rank()
    bucketed = (bucket_mb > 0 and mode == "allgather" and code.bucketable
                and not code.supports_fused_allreduce)
    if bucketed and _has_tensors(code.init_state((1,), torch.float32,
                                                 torch.device("meta"))):
        raise TypeError(f"{type(code).__name__}.bucketable=True but "
                        "init_state is non-empty: bucketable codecs must be "
                        "stateless")
    lowering = ("psum_scatter" if mode == "leader" and code.supports_psum
                else "")
    pipe: list = []

    def init_fn(params: Params):
        views = ({k: p.codec_view for k, p in params.items()
                  if hasattr(p, "codec_view")} if code.order_dependent
                 else {})
        params = {k: p.detach() for k, p in params.items()}
        seen = {k: _view(views, k, p) for k, p in params.items()}
        pipe[:] = [Pipeline(code, update_fn, h, mode, lowering, average,
                            size, rank,
                            plan=(plan_buckets(seen, bucket_mb) if bucketed
                                  else None),
                            views=views)]
        codec_state = {k: code.init_state(tuple(v.shape), v.dtype, v.device)
                       for k, v in seen.items()}
        if mode == "leader":
            return leader_init_state(params, init_state, size,
                                     rank), codec_state
        return init_state(params), codec_state

    def grads_and_loss(params: Params, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            g = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, g)), comms.allreduce_sum(loss.detach()) / size

    def step_fn(params: Params, opt_state, codec_state, batch,
                gen: Optional[torch.Generator] = None):
        if not pipe:
            raise RuntimeError("call init_fn(params) before step_fn")
        params, opt_state = _copy(params), _copy(opt_state)
        grads, loss = grads_and_loss(params, batch)
        params, opt_state, codec_state = aggregate_update(
            pipe[0], params, grads, opt_state, _copy(codec_state), gen)
        return params, opt_state, codec_state, loss

    return init_fn, step_fn

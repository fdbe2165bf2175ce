"""Tensor parallelism: Megatron column- and row-parallel layers
(``pytorch_ps_mpi_tpu/parallel/tp.py``; Shoeybi et al. 2019,
arXiv:1909.08053).

A transformer MLP or attention block keeps its activations sharded
between a column-parallel and a row-parallel product, so each block
costs one sum over the ``model`` axis. Parameter leaves carry a leading
``[tp]`` shard axis (``tp_param_spec``: ``P(tp_axis)`` for leaves of
more than one dimension); a rank holds its ``[1, ...]`` row
(``Mesh.shard``) and the functions squeeze it.

Gradients: PyTorch's autograd has no varying-axes types, so the region's
input always passes through ``comms.identity_fwd_psum_bwd`` and its
output reduction through ``comms.psum_fwd_identity_bwd`` (Megatron's
f and g), the gradients the JAX package gets from a vma-checked
``shard_map`` or from ``local_grads=True``. ``local_grads`` is accepted
for the JAX signature; both of its values give those gradients: each
rank's own weights' gradient, and the replicated input's summed over the
axis. Axes are names of ``mesh=`` (or ``mesh.Group``s).

Composition: heads are batch-like to attention, so ``tp_self_attention``
runs ring or Ulysses attention over ``seq_axis`` on its ``heads/tp``
local heads.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.mesh import P, axis_group
from pytorch_ps_mpi_tpu_torch.ops.attention import attention_ref

Params = Dict[str, Any]


def column_parallel(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w_local (+ b_local)``: the weight sharded on its output dim;
    no communication."""
    y = x @ w
    return y + b if b is not None else y


def row_parallel(y_local: torch.Tensor, w: torch.Tensor, tp_axis,
                 b: Optional[torch.Tensor] = None, local_grads: bool = False,
                 mesh=None) -> torch.Tensor:
    """``sum_tp(y_local @ w_local) (+ b)``: the weight sharded on its
    input dim, the output replicated; the block's one collective (its
    backward the identity)."""
    out = comms.psum_fwd_identity_bwd(y_local @ w, axis_group(tp_axis, mesh))
    return out + b if b is not None else out


def _sq(x: torch.Tensor) -> torch.Tensor:
    """Squeeze the leading local ``[1, ...]`` shard axis."""
    return x[0]


def tp_mlp(x: torch.Tensor, params: Params, tp_axis,
           local_grads: bool = False, mesh=None) -> torch.Tensor:
    """Column-parallel up-projection, GELU (tanh form, ``jax.nn.gelu``'s
    default), row-parallel down-projection: one sum over the axis.
    ``params``: ``w1 [1, d, f/tp]``, ``b1 [1, f/tp]``, ``w2 [1, f/tp, d]``
    (this rank's rows) and ``b2 [d]`` (replicated, added after the sum)."""
    g = axis_group(tp_axis, mesh)
    x = comms.identity_fwd_psum_bwd(x, g)
    h = F.gelu(column_parallel(x, _sq(params["w1"]), _sq(params["b1"])),
               approximate="tanh")
    return row_parallel(h, _sq(params["w2"]), g, params["b2"])


def tp_self_attention(x: torch.Tensor, params: Params, tp_axis, *,
                      seq_axis=None, causal: bool = False, sp: str = "ring",
                      local_grads: bool = False, mesh=None) -> torch.Tensor:
    """Self-attention with its heads split over ``tp_axis``
    (``tp.py:93``): a column-parallel QKV product (this rank's heads),
    attention on the local heads (ring or Ulysses over ``seq_axis`` when
    given, ``sp`` choosing; dense otherwise), a row-parallel output
    product: one sum over the axis. ``params``: ``wqkv [1, d, 3, h/tp,
    hd]``, ``wo [1, (h/tp)·hd, d]``, ``bo [d]``. Under ``sp="ulysses"`` the
    local head count must divide by the sequence axis's size."""
    if sp not in ("ring", "ulysses"):
        raise ValueError(f"sp must be 'ring' or 'ulysses', got {sp!r}")
    g = axis_group(tp_axis, mesh)
    x = comms.identity_fwd_psum_bwd(x, g)
    qkv = torch.einsum("bld,dche->blche", x, _sq(params["wqkv"]))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if seq_axis is not None and sp == "ulysses":
        from pytorch_ps_mpi_tpu_torch.parallel.ulysses import \
            ulysses_attention

        out = ulysses_attention(q, k, v, seq_axis, causal=causal, mesh=mesh)
    elif seq_axis is not None:
        from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_attention

        out = ring_attention(q, k, v, seq_axis, causal=causal, mesh=mesh)
    else:
        out = attention_ref(q, k, v, 0, 0, causal, q.shape[-1] ** -0.5)[0]
    flat = out.reshape(out.shape[0], out.shape[1], -1)  # [b, l, h_loc·hd]
    return row_parallel(flat, _sq(params["wo"]), g, params["bo"])


# -- host-side parameters (leading [tp] shard axis) -----------------------------

def _gen(key) -> torch.Generator:
    """A generator from ``key``: a seed, or a ``torch.Generator`` used as
    it is (the JAX functions take a PRNG key)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def init_tp_mlp(key, d: int, f: int, tp: int, scale: float = 0.02) -> Params:
    """``w1 [tp, d, f/tp]``, ``b1 [tp, f/tp]``, ``w2 [tp, f/tp, d]``,
    ``b2 [d]`` in float32 on the CPU, normal times ``scale`` from ``key``
    (a seed or a generator), biases 0."""
    assert f % tp == 0, (f, tp)
    gen = _gen(key)
    return {
        "w1": scale * torch.randn((tp, d, f // tp), generator=gen),
        "b1": torch.zeros((tp, f // tp)),
        "w2": scale * torch.randn((tp, f // tp, d), generator=gen),
        "b2": torch.zeros((d,)),
    }


def init_tp_attention(key, d: int, heads: int, tp: int,
                      scale: float = 0.02) -> Params:
    """``wqkv [tp, d, 3, h/tp, hd]``, ``wo [tp, (h/tp)·hd, d]``, ``bo [d]``
    as :func:`init_tp_mlp` makes its leaves."""
    assert heads % tp == 0 and d % heads == 0, (d, heads, tp)
    hd = d // heads
    gen = _gen(key)
    return {
        "wqkv": scale * torch.randn((tp, d, 3, heads // tp, hd),
                                    generator=gen),
        "wo": scale * torch.randn((tp, (heads // tp) * hd, d), generator=gen),
        "bo": torch.zeros((d,)),
    }


def tp_param_spec(params: Params, tp_axis: str) -> Dict[str, P]:
    """``P(tp_axis)`` for the leaves with the leading ``[tp]`` axis (more
    than one dimension), ``P()`` for the replicated biases."""
    return {k: P(tp_axis) if v.ndim > 1 else P() for k, v in params.items()}


def dense_equivalent_mlp(params: Params):
    """The TP shards joined into the dense ``(w1, b1, w2, b2)``."""
    return (torch.cat(list(params["w1"]), dim=-1),
            torch.cat(list(params["b1"]), dim=-1),
            torch.cat(list(params["w2"]), dim=0), params["b2"])


def dense_equivalent_attention(params: Params):
    """The TP shards joined into the dense ``(wqkv [d, 3, h, hd], wo
    [h·hd, d], bo)``."""
    return (torch.cat(list(params["wqkv"]), dim=2),
            torch.cat(list(params["wo"]), dim=0), params["bo"])

"""Expert parallelism: GShard top-k MoE over a mesh axis
(``pytorch_ps_mpi_tpu/parallel/ep.py``; Lepikhin et al. 2020,
arXiv:2006.16668). Top-1 is the Switch gate; ``top_k=2`` the classic
GShard gate, the chosen experts' probabilities renormalized a token.

Shapes, at an expert axis of D ranks: tokens ``x [n_loc, d]`` are this
rank's; it holds ``e_loc = E / D`` experts' FFN weights (rows of the
``[E, ...]`` stacks, ``moe_spec``) and the replicated router ``wr [d,
E]``. A rank routes, writes its tokens into per-expert capacity buffers
``[E, k·C, d]``, exchanges them with one ``comms.all_to_all`` (each rank
gets its experts' slots from every rank), runs its experts, sends the
results back with a second one, and combines them by the gates.

Capacity ``C`` is per (expert, source rank): a rank dispatches at most C
of its tokens to one expert for each choice rank, in token order (the
running count of :func:`_slots`); the rest are dropped (output 0 for
that choice). Ties between routers' probabilities go to the lower expert
index, in the top-1 argmax and the top-k sort alike (``lax.top_k``'s
order), so the dropped set is the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.mesh import P, axis_group

Params = Dict[str, Any]


def init_moe(key, d: int, f: int, n_experts: int,
             scale: float = 0.1) -> Params:
    """The router ``wr [d, E]`` (replicated) and the experts' ``w1 [E, d,
    f]`` and ``w2 [E, f, d]``, normal times ``scale`` from ``key`` (a seed
    or a generator), float32 on the CPU."""
    from pytorch_ps_mpi_tpu_torch.parallel.tp import _gen

    gen = _gen(key)
    return {
        "wr": scale * torch.randn((d, n_experts), generator=gen),
        "w1": scale * torch.randn((n_experts, d, f), generator=gen),
        "w2": scale * torch.randn((n_experts, f, d), generator=gen),
    }


def moe_spec(params: Params, expert_axis: str) -> Dict[str, P]:
    return {"wr": P(), "w1": P(expert_axis), "w2": P(expert_axis)}


def _topk_sorted(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last dim, ties to
    the lower index (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_top1(x: torch.Tensor, wr: torch.Tensor):
    """``(expert index, gate)`` a token: the argmax's softmax probability
    (``ep.py:71``)."""
    probs = torch.softmax(x @ wr, dim=-1)
    eidx = torch.argmax(probs, dim=-1)  # the first of tied maxima
    return eidx, torch.gather(probs, 1, eidx[:, None])[:, 0]


def _route_topk(x: torch.Tensor, wr: torch.Tensor, k: int):
    """``(indices [n, k], gates [n, k])``: the top-k probabilities,
    renormalized to sum to 1 a token (``ep.py:79``)."""
    probs = torch.softmax(x @ wr, dim=-1)
    gates, eidx = _topk_sorted(probs, k)
    return eidx, gates / torch.clamp(gates.sum(dim=-1, keepdim=True),
                                     min=1e-9)


def _slots(eidx: torch.Tensor, n_experts: int,
           capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot, keep)`` of each token in its expert's buffer for one
    choice rank: the running count of this rank's tokens routed to the
    same expert before it; kept below ``capacity`` (``ep.py:112-118``)."""
    onehot = F.one_hot(eidx, n_experts)
    pos = torch.cumsum(onehot, dim=0) * onehot       # 1-based
    slot0 = pos.amax(dim=1) - 1
    keep = (slot0 >= 0) & (slot0 < capacity)
    return torch.clamp(slot0, 0, capacity - 1), keep


def dispatch_plan(x: torch.Tensor, wr: torch.Tensor, n_experts: int,
                  capacity: int, top_k: int = 1):
    """The routing of :func:`moe_apply` without the exchange: ``(eidx [n,
    k], gates [n, k], slots [n, k], keep [n, k])``, which (token, choice)
    pairs are kept and where they land."""
    if top_k == 1:
        eidx, gate = _route_top1(x, wr)
        eidx_k, gate_k = eidx[:, None], gate[:, None]
    else:
        eidx_k, gate_k = _route_topk(x, wr, top_k)
    slots, keeps = zip(*(_slots(eidx_k[:, c], n_experts, capacity)
                         for c in range(eidx_k.shape[1])))
    return eidx_k, gate_k, torch.stack(slots, 1), torch.stack(keeps, 1)


def _dispatch_combine(x, eidx_k, gate_k, slots, keeps, w1, w2, group,
                      capacity: int) -> torch.Tensor:
    """Dispatch, experts and combine in one all-to-all round trip
    (``ep.py:89-147``): choice rank c writes its kept tokens into slots
    ``[c·C, (c+1)·C)`` of one ``[E, k·C, d]`` buffer."""
    n_loc, d = x.shape
    k = eidx_k.shape[1]
    n_dev, e_loc = group.size, w1.shape[0]
    n_experts = n_dev * e_loc
    buf = x.new_zeros((n_experts, k * capacity, d))
    zero = torch.zeros_like(x)
    for c in range(k):
        buf = buf.index_put(
            (eidx_k[:, c], c * capacity + slots[:, c]),
            torch.where(keeps[:, c, None], x, zero), accumulate=True)
    # rank j gets its experts' slots from every rank
    recv = comms.all_to_all(buf.reshape(n_dev, e_loc, k * capacity, d), group)
    tok = recv.permute(1, 0, 2, 3).reshape(e_loc, n_dev * k * capacity, d)
    h = F.gelu(torch.einsum("etd,edf->etf", tok, w1), approximate="tanh")
    y = torch.einsum("etf,efd->etd", h, w2)
    y = y.reshape(e_loc, n_dev, k * capacity, d).permute(1, 0, 2, 3)
    back = comms.all_to_all(y, group)                # to the source ranks
    out_buf = back.reshape(n_experts, k * capacity, d)
    out = torch.zeros_like(x)
    for c in range(k):
        tok_out = out_buf[eidx_k[:, c], c * capacity + slots[:, c]]
        tok_out = tok_out * gate_k[:, c, None]
        out = out + torch.where(keeps[:, c, None], tok_out,
                                torch.zeros_like(tok_out))
    return out


def moe_apply(x: torch.Tensor, params: Params, expert_axis, *, capacity: int,
              top_k: int = 1, mesh=None) -> torch.Tensor:
    """Top-k MoE forward of this rank's tokens (``ep.py:149``):
    ``x [n_loc, d]``, ``params`` ``wr [d, E]`` and this rank's ``w1 [e_loc,
    d, f]``, ``w2 [e_loc, f, d]``. Returns ``[n_loc, d]``, each token's
    gated expert outputs (0 for a dropped choice). Differentiable; the
    all-to-all's backward is the inverse exchange."""
    g = axis_group(expert_axis, mesh)
    w1, w2 = params["w1"], params["w2"]
    assert params["wr"].shape[1] == g.size * w1.shape[0], (
        params["wr"].shape, g.size, w1.shape)
    eidx_k, gate_k, slots, keeps = dispatch_plan(
        x, params["wr"], params["wr"].shape[1], capacity, top_k)
    return _dispatch_combine(x, eidx_k, gate_k, slots, keeps, w1, w2, g,
                             capacity)


def load_balance_loss(x: torch.Tensor, wr: torch.Tensor, top_k: int = 1,
                      expert_axis=None, mesh=None) -> torch.Tensor:
    """The Switch/GShard balance loss of this rank's tokens,
    ``E · Σ_e f_e · P_e`` (``ep.py:182``): ``f_e`` the share of (token,
    choice) assignments to expert e, ``P_e`` its mean router probability;
    1.0 at a uniform assignment. Differentiable through ``P_e``. With
    ``expert_axis`` the counts and means are taken over the axis (the
    sums' backward the identity, as the JAX vma-checked transpose)."""
    probs = torch.softmax(x @ wr, dim=-1)
    n_experts = wr.shape[1]
    _, eidx = _topk_sorted(probs, top_k)
    counts = F.one_hot(eidx, n_experts).to(probs.dtype).sum(dim=(0, 1))
    n_assign = torch.tensor(float(eidx.numel()), dtype=probs.dtype,
                            device=probs.device)
    p_mean = probs.mean(dim=0)
    if expert_axis is not None:
        g = axis_group(expert_axis, mesh)
        counts = comms.allreduce_sum(counts, g)
        n_assign = comms.allreduce_sum(n_assign, g)
        p_mean = comms.psum_fwd_identity_bwd(p_mean, g) / g.size
    f = counts / torch.clamp(n_assign, min=1.0)
    return n_experts * torch.sum(f * p_mean)


def moe_dense_oracle(x: torch.Tensor, params: Params,
                     top_k: int = 1) -> torch.Tensor:
    """One rank, every expert: each token through its own top-k experts,
    no capacity (``ep.py:216``); the dense routing of ``models.moe``."""
    h = F.gelu(torch.einsum("td,edf->tef", x, params["w1"]),
               approximate="tanh")
    y_all = torch.einsum("tef,efd->ted", h, params["w2"])
    n_experts = params["wr"].shape[1]
    if top_k == 1:
        eidx, gate = _route_top1(x, params["wr"])
        onehot = F.one_hot(eidx, n_experts).to(x.dtype)
        return torch.einsum("ted,te->td", y_all, onehot) * gate[:, None]
    eidx, gates = _route_topk(x, params["wr"], top_k)
    out = torch.zeros_like(x)
    for c in range(top_k):
        onehot = F.one_hot(eidx[:, c], n_experts).to(x.dtype)
        out = out + (torch.einsum("ted,te->td", y_all, onehot)
                     * gates[:, c][:, None])
    return out

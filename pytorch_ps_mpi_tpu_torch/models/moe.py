"""Switch-style MoE masked-LM encoder (``pytorch_ps_mpi_tpu/models/moe.py``),
the expert-parallel model family: BERT's pre-norm encoder with every
layer's FFN a top-k mixture of experts (``top_k=1`` Switch, Fedus et al.
2021; ``top_k=2`` GShard).

Two modes, the same parameters:

- ``expert_axis=None`` (default): dense routing, every token through
  its own experts on one rank (``parallel.ep.moe_dense_oracle``);
- ``expert_axis="expert"``: build the model with ``mesh=``; each
  MoE layer dispatches through ``parallel.ep.moe_apply`` (capacity
  buffers and two all-to-alls). The model is built with its rank's rows
  of the ``[E, ...]`` expert stacks (``moe_param_spec``).

Load balancing: with ``aux_loss_weight`` set, ``forward(...,
return_aux=True)`` returns ``(logits, aux)``, ``aux`` the sum over the
MoE layers of the weighted balance loss (``parallel.ep.
load_balance_loss``). flax ``sow``s each layer's into the ``"aux_loss"``
collection; the sum of that collection is this ``aux``. Add it to the
objective.

Parameter names are flax's: ``layer_{i}.SelfAttention_0``,
``LayerNorm_{0,1}``, ``MoEFFN_0.{wr,w1,w2}``, and ``tok_emb``,
``pos_emb``, ``LayerNorm_0``, ``mlm_head``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_ps_mpi_tpu_torch.mesh import (Device, P, axis_group,
                                           resolve_device)
from pytorch_ps_mpi_tpu_torch.models.bert import (BertConfig, Dense, Embed,
                                                  LayerNorm, SelfAttention)
from pytorch_ps_mpi_tpu_torch.parallel.ep import (load_balance_loss,
                                                  moe_apply,
                                                  moe_dense_oracle)


@dataclasses.dataclass(frozen=True)
class SwitchConfig:
    vocab_size: int = 1024
    hidden_size: int = 64
    num_layers: int = 2
    num_heads: int = 4
    intermediate_size: int = 128
    max_position: int = 128
    n_experts: int = 8
    capacity: int = 64          # per (expert, source rank)
    top_k: int = 1              # 1: Switch; 2: the GShard gate
    aux_loss_weight: float = 0.0
    expert_axis: Optional[str] = None
    dtype: torch.dtype = torch.float32
    attention: str = "full"     # the attention of the BERT blocks

    def bert_cfg(self) -> BertConfig:
        return BertConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            max_position=self.max_position, dtype=self.dtype,
            attention=self.attention)


class MoEFFN(nn.Module):
    """Top-k routed FFN over ``n_experts`` expert MLPs: ``wr [d, E]``,
    ``w1 [e, d, f]``, ``w2 [e, f, d]`` in float32, ``e`` this rank's
    experts (E without an expert axis). Computes in float32, returns the
    input's type. ``mesh``: the mesh of ``cfg.expert_axis``."""

    def __init__(self, cfg: SwitchConfig, e_local: int, mesh=None):
        super().__init__()
        c = self.cfg = cfg
        self.mesh = mesh
        d, f = c.hidden_size, c.intermediate_size
        self.wr = nn.Parameter(torch.empty(d, c.n_experts))
        self.w1 = nn.Parameter(torch.empty(e_local, d, f))
        self.w2 = nn.Parameter(torch.empty(e_local, f, d))

    def forward(self, x: torch.Tensor):
        """``x [b, l, d]`` -> ``(y [b, l, d], aux)``, ``aux`` the weighted
        balance loss (None at weight 0)."""
        c = self.cfg
        b, l, d = x.shape
        tok = x.reshape(b * l, d).float()
        params = {"wr": self.wr, "w1": self.w1, "w2": self.w2}
        aux = None
        if c.aux_loss_weight:
            aux = c.aux_loss_weight * load_balance_loss(
                tok, self.wr, top_k=c.top_k, expert_axis=c.expert_axis,
                mesh=self.mesh)
        if c.expert_axis is not None:
            out = moe_apply(tok, params, c.expert_axis, capacity=c.capacity,
                            top_k=c.top_k, mesh=self.mesh)
        else:
            out = moe_dense_oracle(tok, params, top_k=c.top_k)
        return out.reshape(b, l, d).to(x.dtype), aux


class SwitchEncoderLayer(nn.Module):
    def __init__(self, cfg: SwitchConfig, e_local: int, mesh=None):
        super().__init__()
        c = cfg
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype)
        self.SelfAttention_0 = SelfAttention(c.bert_cfg())
        self.LayerNorm_1 = LayerNorm(c.hidden_size, c.dtype)
        self.MoEFFN_0 = MoEFFN(c, e_local, mesh)

    def forward(self, x: torch.Tensor):
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        y, aux = self.MoEFFN_0(self.LayerNorm_1(x))
        return x + y, aux


class SwitchMLM(nn.Module):
    """Token-in, vocab-logits-out MoE masked-LM (pre-norm; every layer's
    FFN a Switch MoE). Parameters are float32 from ``seed``: BERT's
    initializer shapes, the router normal(0.02) and the experts
    normal(0.1) as flax's. With ``cfg.expert_axis`` the model holds this
    rank's experts of ``mesh``, cut from the whole stacks drawn from the
    seed."""

    def __init__(self, cfg: SwitchConfig, *, seed: int = 0,
                 device: Device = "cuda", mesh=None):
        super().__init__()
        c = self.cfg = cfg
        self.mesh = mesh
        e_local = c.n_experts
        if c.expert_axis is not None:
            e_local //= axis_group(c.expert_axis, mesh).size
        self.tok_emb = Embed(c.vocab_size, c.hidden_size, c.dtype)
        self.pos_emb = Embed(c.max_position, c.hidden_size, c.dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", SwitchEncoderLayer(c, e_local, mesh))
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype)
        self.mlm_head = Dense((c.hidden_size,), (c.vocab_size,), c.dtype)
        self._init(seed, mesh)
        self.to(resolve_device(device))

    @torch.no_grad()
    def _init(self, seed: int, mesh) -> None:
        gen = torch.Generator().manual_seed(seed)
        c = self.cfg
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.kernel.copy_(torch.randn(mod.kernel.shape, generator=gen)
                                 / math.sqrt(math.prod(mod.in_shape)))
                mod.bias.zero_()
            elif isinstance(mod, Embed):
                mod.embedding.copy_(
                    torch.randn(mod.embedding.shape, generator=gen)
                    / math.sqrt(mod.embedding.shape[0]))
            elif isinstance(mod, MoEFFN):
                d, f, e = c.hidden_size, c.intermediate_size, c.n_experts
                mod.wr.copy_(0.02 * torch.randn((d, e), generator=gen))
                for name, shape in (("w1", (e, d, f)), ("w2", (e, f, d))):
                    full = 0.1 * torch.randn(shape, generator=gen)
                    if mesh is not None and c.expert_axis is not None:
                        full = mesh.shard(full, P(c.expert_axis))
                    getattr(mod, name).copy_(full)

    def forward(self, tokens: torch.Tensor, position_offset: int = 0,
                return_aux: bool = False):
        """``tokens [B, L]`` -> float32 logits ``[B, L, V]``; with
        ``return_aux`` also the summed weighted balance loss (a float32
        scalar, 0 at weight 0)."""
        c = self.cfg
        positions = position_offset + torch.arange(tokens.shape[-1],
                                                   device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(positions)[None]
        aux_total = torch.zeros((), device=tokens.device)
        for i in range(c.num_layers):
            x, aux = getattr(self, f"layer_{i}")(x)
            if aux is not None:
                aux_total = aux_total + aux
        logits = self.mlm_head(self.LayerNorm_0(x)).float()
        return (logits, aux_total) if return_aux else logits


def moe_param_spec(params: Dict[str, Any], expert_axis: str) -> Dict[str, P]:
    """``P(expert_axis)`` for the expert stacks (``w1``/``w2`` of any
    ``MoEFFN``), ``P()`` for the rest (``moe.py:144``). ``params``:
    ``name -> tensor``."""
    return {k: P(expert_axis) if k.rsplit(".", 1)[-1] in ("w1", "w2")
            else P() for k in params}

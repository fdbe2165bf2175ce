"""BERT masked-LM in plain PyTorch, float32: the benchmark's reference
for the ``bert`` family.

The architecture is the one the port runs as ``BertConfig.base()``
(Devlin et al. 2018, with the departures the configuration file lists):
token and position embeddings summed, then per layer a pre-norm
self-attention block and a pre-norm feed-forward block with tanh GELU,
each added to the residual, then a final LayerNorm and an untied
vocabulary projection. LayerNorm's epsilon is the configuration's.

Weights are a ``name -> tensor`` dict with the benchmark's names and
layouts (:func:`shapes`): a kernel is ``[*in, *out]`` and the attention
input projection ``[H, 3, heads, head_dim]``, so every leaf flattens to
the element order the harness hands the program.

The loss is the cross-entropy over the masked positions, their mean over
the whole batch; :func:`loss_and_grads` takes it ``rows`` sequences at a
time so that the float32 activations of a large batch fit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import product

Weights = Dict[str, torch.Tensor]


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight's shape, in the order the port's module lists its
    parameters."""
    v, h = cfg["vocab_size"], cfg["hidden_size"]
    f, p = cfg["intermediate_size"], cfg["max_position_embeddings"]
    heads = cfg["num_attention_heads"]
    d = h // heads
    out = {"tok_emb.embedding": (v, h), "pos_emb.embedding": (p, h)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layer_{i}."
        out.update({
            pre + "LayerNorm_0.scale": (h,), pre + "LayerNorm_0.bias": (h,),
            pre + "SelfAttention_0.qkv.kernel": (h, 3, heads, d),
            pre + "SelfAttention_0.qkv.bias": (3, heads, d),
            pre + "SelfAttention_0.out.kernel": (heads, d, h),
            pre + "SelfAttention_0.out.bias": (h,),
            pre + "LayerNorm_1.scale": (h,), pre + "LayerNorm_1.bias": (h,),
            pre + "Dense_0.kernel": (h, f), pre + "Dense_0.bias": (f,),
            pre + "Dense_1.kernel": (f, h), pre + "Dense_1.bias": (h,),
        })
    out.update({"LayerNorm_0.scale": (h,), "LayerNorm_0.bias": (h,),
                "mlm_head.kernel": (h, v), "mlm_head.bias": (v,)})
    return out


def _dense(x, kernel, bias, n_in: int, mm: Callable) -> torch.Tensor:
    """``x [..., n_in]`` times the kernel viewed ``[n_in, n_out]``, plus
    the bias."""
    return mm(torch.matmul, x, kernel.reshape(n_in, -1)) + bias.reshape(-1)


def logits(w: Weights, tokens: torch.Tensor, cfg: dict,
           precision: str = "fp32") -> torch.Tensor:
    """``tokens [B, L]`` -> float32 logits ``[B, L, V]``."""
    mm = product(precision)
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    d = h // heads
    eps = cfg["layer_norm_eps"]
    b, l = tokens.shape

    def norm(x, pre):
        return F.layer_norm(x, (h,), w[pre + ".scale"], w[pre + ".bias"], eps)

    x = w["tok_emb.embedding"][tokens] + w["pos_emb.embedding"][:l][None]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layer_{i}."
        a = norm(x, pre + "LayerNorm_0")
        qkv = _dense(a, w[pre + "SelfAttention_0.qkv.kernel"],
                     w[pre + "SelfAttention_0.qkv.bias"], h, mm)
        qkv = qkv.reshape(b, l, 3, heads, d)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        s = mm(torch.matmul, q, k.transpose(-1, -2)) / math.sqrt(d)
        o = mm(torch.matmul, torch.softmax(s, dim=-1), v)    # [b, h, l, d]
        o = o.transpose(1, 2).reshape(b, l, heads * d)
        x = x + _dense(o, w[pre + "SelfAttention_0.out.kernel"],
                       w[pre + "SelfAttention_0.out.bias"], heads * d, mm)
        y = _dense(norm(x, pre + "LayerNorm_1"), w[pre + "Dense_0.kernel"],
                   w[pre + "Dense_0.bias"], h, mm)
        y = F.gelu(y, approximate="tanh")
        x = x + _dense(y, w[pre + "Dense_1.kernel"], w[pre + "Dense_1.bias"],
                       cfg["intermediate_size"], mm)
    return _dense(norm(x, "LayerNorm_0"), w["mlm_head.kernel"],
                  w["mlm_head.bias"], h, mm)


def masked_nll_sum(lg: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """The summed negative log-likelihood of the targets at the masked
    positions."""
    ll = torch.log_softmax(lg, dim=-1).gather(-1, targets[..., None])[..., 0]
    return -(ll * mask.to(ll.dtype)).sum()


def loss_and_grads(w: Weights, batch: dict, cfg: dict,
                   precision: str = "fp32", rows: int = 8
                   ) -> Tuple[torch.Tensor, Weights]:
    """The masked-LM loss of ``batch`` (``tokens``, ``targets``, ``mask``,
    each ``[B, L]``) and its gradient, ``rows`` sequences at a time."""
    leaves = {k: t.detach().requires_grad_() for k, t in w.items()}
    count = torch.clamp(batch["mask"].sum().to(torch.float32), min=1.0)
    grads = {k: torch.zeros_like(t) for k, t in w.items()}
    total = torch.zeros((), device=count.device)
    n = batch["tokens"].shape[0]
    for r in range(0, n, rows):
        sl = slice(r, min(r + rows, n))
        with torch.enable_grad():
            lg = logits(leaves, batch["tokens"][sl], cfg, precision)
            part = masked_nll_sum(lg, batch["targets"][sl],
                                  batch["mask"][sl]) / count
            gs = torch.autograd.grad(part, list(leaves.values()),
                                     allow_unused=True)
        for k, g in zip(leaves, gs):
            if g is not None:
                grads[k].add_(g)
        total = total + part.detach()
        del lg, part, gs
    return total, grads

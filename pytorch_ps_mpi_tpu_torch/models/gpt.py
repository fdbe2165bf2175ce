"""Decoder-only causal LM, the GPT family
(``pytorch_ps_mpi_tpu/models/gpt.py``): BERT's pre-norm blocks with the
causal mask on, and the LM head tied to the token embedding (Press &
Wolf 2017), as in GPT-2.

``attention="ring"`` with ``causal=True`` is the long-context training
shape: each rank holds a sequence shard (``position_offset`` its first
position) and the ring's blocks carry their global offsets into the
flash kernels' causal mask. Parameter names are flax's: ``tok_emb``,
``pos_emb``, ``layer_{i}`` (or ``layers`` under ``scan_layers``),
``LayerNorm_0`` and, untied, ``lm_head``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.models.bert import (BertConfig, Dense, Embed,
                                                  LayerNorm, add_layers,
                                                  encoder_stack,
                                                  init_like_flax,
                                                  init_scanned,
                                                  target_log_likelihood,
                                                  trunk)


def gpt_config(**kw) -> BertConfig:
    """A ``BertConfig`` with causal masking on (``gpt.py:31``)."""
    kw.setdefault("causal", True)
    return BertConfig(**kw)


def gpt_tiny(**kw) -> BertConfig:
    kw.setdefault("causal", True)
    return BertConfig.tiny(**kw)


class GPTLM(nn.Module):
    """Token-in, next-token-logits-out decoder (pre-norm, tied head).

    ``cfg.causal`` must be True: a bidirectional model on a next-token
    objective could read its targets, so it is rejected. Parameters are
    float32 from ``seed`` as ``BertMLM``'s; load a JAX model's with
    ``utils.interop.params_from_jax``. ``mesh``: the mesh of
    ``attention="ring"|"ulysses"`` (None: a world of one rank)."""

    def __init__(self, cfg: BertConfig, tie_embeddings: bool = True, *,
                 seed: int = 0, device: Device = "cuda", mesh=None):
        super().__init__()
        if not cfg.causal:
            raise ValueError("GPTLM requires cfg.causal=True")
        c = self.cfg = cfg
        self.tie_embeddings = tie_embeddings
        self.tok_emb = Embed(c.vocab_size, c.hidden_size, c.dtype)
        self.pos_emb = Embed(c.max_position, c.hidden_size, c.dtype)
        add_layers(self, c, mesh)
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype)
        if not tie_embeddings:
            self.lm_head = Dense((c.hidden_size,), (c.vocab_size,), c.dtype)
        if c.scan_layers:
            init_scanned(self, GPTLM(dataclasses.replace(c, scan_layers=False),
                                     tie_embeddings, seed=seed, device="cpu"))
        else:
            init_like_flax(self, seed)
        self.to(resolve_device(device))

    def forward(self, tokens: torch.Tensor,
                position_offset: int = 0) -> torch.Tensor:
        """``tokens [B, L]`` -> logits ``[B, L, V]`` (float32 under
        ``f32_logits``); ``position_offset`` is the first token's global
        position (a sequence shard's)."""
        c = self.cfg
        positions = position_offset + torch.arange(tokens.shape[-1],
                                                   device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(positions)[None]
        x = encoder_stack(c, trunk(self, c), x)
        x = self.LayerNorm_0(x)
        if self.tie_embeddings:
            logits = x @ self.tok_emb.embedding.to(c.dtype).T
        else:
            logits = self.lm_head(x)
        return logits.float() if c.f32_logits else logits


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   mask=None) -> torch.Tensor:
    """Next-token cross-entropy: position t predicts token t+1
    (``gpt.py:75``). ``mask [b, l]`` marks valid input positions; the last
    position has no target and is dropped."""
    ll = target_log_likelihood(logits[:, :-1], tokens[:, 1:])
    if mask is None:
        return -ll.mean()
    m = mask[:, 1:].float()
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)

"""The ``bert`` family: the port's ``BertMLM`` under masked-LM batches."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import bert as ref

#: the leaves past the last nonlinearity: their gradient is a smooth
#: function of the forward's activations
HEAD = ("mlm_head.kernel", "mlm_head.bias")


def _program_config(cfg: dict):
    from pytorch_ps_mpi_tpu_torch.models.bert import BertConfig

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    return BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position=cfg["max_position_embeddings"],
        dtype=dtype[cfg["compute_dtype"]], attention=cfg["attention"])


def program_model(cfg: dict, device) -> torch.nn.Module:
    """The port's model as a user builds it (its own weights are then
    overwritten with the benchmark's)."""
    from pytorch_ps_mpi_tpu_torch.models.bert import BertMLM

    return BertMLM(_program_config(cfg), seed=0, device=device)


def program_loss(model: torch.nn.Module):
    """The user's ``loss_fn(params, batch)`` for ``MPI_PS.step``."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch.models import mlm_loss

    def loss_fn(params, batch):
        lg = functional_call(model, params, (batch["tokens"],))
        return mlm_loss(lg, batch["targets"], batch["mask"])
    return loss_fn


def weights(cfg: dict, gen: torch.Generator, device
            ) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``gen``: every kernel and embedding from one
    draw of normal(0, initializer_range) clipped at two standard
    deviations, LayerNorm scales 1, biases 0."""
    shp = ref.shapes(cfg)
    drawn = [k for k in shp if k.endswith((".kernel", ".embedding"))]
    sizes = [torch.Size(shp[k]).numel() for k in drawn]
    std = cfg["initializer_range"]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(std).clamp_(-2 * std, 2 * std)
    out = dict(zip(drawn, (t.view(shp[k]) for t, k in
                           zip(torch.split(flat, sizes), drawn))))
    for k, s in shp.items():
        if k not in out:
            fill = 1.0 if k.endswith(".scale") else 0.0
            out[k] = torch.full(s, fill, device=device)
    return {k: out[k] for k in shp}


def pool(cfg: dict, mix: dict, gen: torch.Generator, device
         ) -> List[dict]:
    """``mix["pool"]`` masked-LM batches of ``[batch, seq]``, drawn in one
    call each: targets uniform over ``1..vocab-1``, each position masked
    with probability ``mask_rate`` and its token replaced by
    ``mask_token``."""
    shape = (mix["pool"], mix["batch"], mix["seq"])
    targets = torch.randint(1, cfg["vocab_size"], shape, generator=gen,
                            device=device)
    mask = torch.rand(shape, generator=gen, device=device) < mix["mask_rate"]
    tokens = torch.where(mask, torch.full_like(targets, mix["mask_token"]),
                         targets)
    return [{"tokens": tokens[i], "targets": targets[i], "mask": mask[i]}
            for i in range(mix["pool"])]


def samples(mix: dict) -> int:
    return mix["batch"]


def half(batch: dict) -> dict:
    """The first half of the batch's rows (a planted fault)."""
    n = batch["tokens"].shape[0] // 2
    return {k: t[:n] for k, t in batch.items()}


def reference_loss_and_grads(cfg: dict, w, batch: dict,
                             precision: str = "fp32"):
    return ref.loss_and_grads(w, batch, cfg, precision)


def matmul_params(cfg: dict) -> int:
    """Parameters that take part in a matrix product a token: the
    attention projections, the feed-forward layers and the MLM head."""
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    per_layer = 3 * h * h + h * h + 2 * h * f
    return cfg["num_hidden_layers"] * per_layer + h * v


def step_flops(cfg: dict, mix: dict) -> float:
    """Model FLOPs of one training step: 6 a matmul parameter a token
    (forward 2, backward 4), plus attention's scores and weighted sum,
    12 * layers * seq**2 * hidden a sequence."""
    b, s = mix["batch"], mix["seq"]
    attn = 12 * cfg["num_hidden_layers"] * s * s * cfg["hidden_size"]
    return float(6 * matmul_params(cfg) * b * s + attn * b)

"""The ``resnet`` family: the port's GroupNorm ``ResNet`` (bottleneck
blocks) under image-classification batches."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import resnet as ref

#: the leaves past the last ReLU and max-pool: their gradient is a smooth
#: function of the forward's activations
HEAD = ("head.weight", "head.bias")
#: side of the per-class mean images, upsampled to the image size
MEAN_SIDE = 28


def program_model(cfg: dict, device) -> torch.nn.Module:
    from pytorch_ps_mpi_tpu_torch.models.resnet import (BottleneckBlock,
                                                        ResNet)

    if cfg["block"] != "bottleneck" or cfg["norm"] != "group":
        raise ValueError("the resnet family runs bottleneck blocks with "
                         "GroupNorm")
    return ResNet(cfg["stage_sizes"], BottleneckBlock,
                  num_classes=cfg["num_classes"],
                  num_filters=cfg["num_filters"], norm="group",
                  in_channels=cfg["in_channels"], seed=0, device=device)


def program_loss(model: torch.nn.Module):
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch.data import cross_entropy_loss

    def loss_fn(params, batch):
        lg = functional_call(model, params, (batch["images"],))
        return cross_entropy_loss(lg, batch["labels"])
    return loss_fn


def weights(cfg: dict, gen: torch.Generator, device
            ) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``gen``: the convolutions from one draw of
    normals, each scaled to variance 2/fan_out (He et al. 2015), the head
    normal(0, 0.01), GroupNorm scales 1 and every bias 0."""
    shp = ref.shapes(cfg)
    convs = [k for k, s in shp.items() if len(s) == 4]
    sizes = [math.prod(shp[k]) for k in convs]
    flat = torch.randn(sum(sizes) + math.prod(shp["head.weight"]),
                       generator=gen, device=device)
    parts = torch.split(flat, sizes + [math.prod(shp["head.weight"])])
    out = {}
    for k, t in zip(convs, parts):
        o, _, kh, kw = shp[k]
        out[k] = t.view(shp[k]).mul_(math.sqrt(2.0 / (o * kh * kw)))
    out["head.weight"] = parts[-1].view(shp["head.weight"]).mul_(0.01)
    for k, s in shp.items():
        if k not in out:
            fill = 1.0 if k.endswith(".weight") else 0.0
            out[k] = torch.full(s, fill, device=device)
    return {k: out[k] for k in shp}


def pool(cfg: dict, mix: dict, gen: torch.Generator, device
         ) -> List[dict]:
    """``mix["pool"]`` batches of NHWC float32 images with a learnable
    class signal: unit normal noise plus half a normal class-mean image,
    drawn at ``MEAN_SIDE`` and repeated up to the image size."""
    p, b, side, c = (mix["pool"], mix["batch"], cfg["image_size"],
                     cfg["in_channels"])
    labels = torch.randint(0, cfg["num_classes"], (p, b), generator=gen,
                           device=device)
    means = torch.randn(cfg["num_classes"], MEAN_SIDE, MEAN_SIDE, c,
                        generator=gen, device=device).mul_(0.5)
    images = torch.randn(p, b, side, side, c, generator=gen, device=device)
    rep = -(-side // MEAN_SIDE)
    for i in range(p):
        m = means[labels[i]].repeat_interleave(rep, 1)
        images[i].add_(m.repeat_interleave(rep, 2)[:, :side, :side])
    return [{"images": images[i], "labels": labels[i]} for i in range(p)]


def samples(mix: dict) -> int:
    return mix["batch"]


def half(batch: dict) -> dict:
    n = batch["images"].shape[0] // 2
    return {k: t[:n] for k, t in batch.items()}


def reference_loss_and_grads(cfg: dict, w, batch: dict,
                             precision: str = "fp32"):
    return ref.loss_and_grads(w, batch, cfg, precision)


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def forward_flops(cfg: dict) -> float:
    """Forward FLOPs of one image: 2 a multiply-add of every convolution
    and of the head, from the shapes."""
    shp = ref.shapes(cfg)
    side = _out(cfg["image_size"], 7, 2)
    total = 2 * math.prod(shp["stem.weight"]) * side * side
    side = -(-side // 2)  # the max-pool
    for b, (cin, f, stride) in enumerate(ref.blocks(cfg)):
        pre = f"blocks.{b}."
        out = _out(side, 3, stride)
        total += 2 * math.prod(shp[pre + "conv1.weight"]) * side * side
        total += 2 * math.prod(shp[pre + "conv2.weight"]) * out * out
        total += 2 * math.prod(shp[pre + "conv3.weight"]) * out * out
        if pre + "shortcut.weight" in shp:
            total += 2 * math.prod(shp[pre + "shortcut.weight"]) * out * out
        side = out
    return float(total + 2 * math.prod(shp["head.weight"]))


def step_flops(cfg: dict, mix: dict) -> float:
    """Model FLOPs of one training step: the forward's, three times
    (the backward takes the gradients of inputs and of weights)."""
    return 3 * forward_flops(cfg) * mix["batch"]

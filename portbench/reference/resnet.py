"""ResNet-50 with GroupNorm in plain PyTorch, float32: the benchmark's
reference for the ``resnet`` family.

He et al. 2015's bottleneck ResNet (1x1, 3x3, 1x1 convolutions, the
stride on the 3x3, a projection shortcut of a 1x1 convolution and a norm
where a block changes the shape), with every BatchNorm replaced by
GroupNorm of ``gcd(32, channels)`` groups (Wu & He 2018). Convolutions
have no bias and pad ``k // 2`` on every side; the stem's 3x3 stride-2
max-pool pads as TensorFlow's ``"SAME"`` does (for an even size, one row
and column at the end). The head averages over space and applies a
linear layer. Images come NHWC.

Weights are a ``name -> tensor`` dict with the benchmark's names and
PyTorch's layouts (convolutions ``[out, in, kh, kw]``, the head
``[classes, features]``), listed by :func:`shapes`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import product

Weights = Dict[str, torch.Tensor]


def blocks(cfg: dict) -> List[Tuple[int, int, int]]:
    """``(in_channels, filters, stride)`` of every bottleneck block."""
    out, cin = [], cfg["num_filters"]
    for i, count in enumerate(cfg["stage_sizes"]):
        for j in range(count):
            filters = cfg["num_filters"] * 2 ** i
            out.append((cin, filters, 2 if i > 0 and j == 0 else 1))
            cin = filters * 4
    return out


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight's shape, in the order the port's module lists its
    parameters."""
    c0 = cfg["num_filters"]
    out = {"stem.weight": (c0, cfg["in_channels"], 7, 7),
           "stem_norm.weight": (c0,), "stem_norm.bias": (c0,)}
    for b, (cin, f, stride) in enumerate(blocks(cfg)):
        pre = f"blocks.{b}."
        out.update({
            pre + "conv1.weight": (f, cin, 1, 1),
            pre + "norm1.weight": (f,), pre + "norm1.bias": (f,),
            pre + "conv2.weight": (f, f, 3, 3),
            pre + "norm2.weight": (f,), pre + "norm2.bias": (f,),
            pre + "conv3.weight": (4 * f, f, 1, 1),
            pre + "norm3.weight": (4 * f,), pre + "norm3.bias": (4 * f,),
        })
        if stride != 1 or cin != 4 * f:
            out.update({pre + "shortcut.weight": (4 * f, cin, 1, 1),
                        pre + "shortcut_norm.weight": (4 * f,),
                        pre + "shortcut_norm.bias": (4 * f,)})
    feat = blocks(cfg)[-1][1] * 4
    out.update({"head.weight": (cfg["num_classes"], feat),
                "head.bias": (cfg["num_classes"],)})
    return out


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


def logits(w: Weights, images: torch.Tensor, cfg: dict,
           precision: str = "fp32") -> torch.Tensor:
    """``images [N, H, W, C]`` -> float32 logits ``[N, classes]``."""
    mm = product(precision)
    eps = cfg["norm_eps"]

    def conv(x, name, stride=1):
        k = w[name]
        return mm(F.conv2d, x, k, stride=stride, padding=k.shape[-1] // 2)

    def norm(x, name):
        c = x.shape[1]
        return F.group_norm(x, math.gcd(cfg["norm_groups"], c),
                            w[name + ".weight"], w[name + ".bias"], eps)

    x = images.permute(0, 3, 1, 2)
    x = torch.relu(norm(conv(x, "stem.weight", 2), "stem_norm"))
    x = _max_pool_same(x)
    for b, (cin, f, stride) in enumerate(blocks(cfg)):
        pre = f"blocks.{b}."
        y = torch.relu(norm(conv(x, pre + "conv1.weight"), pre + "norm1"))
        y = torch.relu(norm(conv(y, pre + "conv2.weight", stride),
                            pre + "norm2"))
        y = norm(conv(y, pre + "conv3.weight"), pre + "norm3")
        if stride != 1 or cin != 4 * f:
            x = norm(conv(x, pre + "shortcut.weight", stride),
                     pre + "shortcut_norm")
        x = torch.relu(y + x)
    pooled = x.mean(dim=(2, 3))
    return mm(torch.matmul, pooled, w["head.weight"].t()) + w["head.bias"]


def loss_and_grads(w: Weights, batch: dict, cfg: dict,
                   precision: str = "fp32", rows: int = 32
                   ) -> Tuple[torch.Tensor, Weights]:
    """The mean softmax cross-entropy of ``batch`` (``images``,
    ``labels``) and its gradient, ``rows`` images at a time."""
    leaves = {k: t.detach().requires_grad_() for k, t in w.items()}
    grads = {k: torch.zeros_like(t) for k, t in w.items()}
    n = batch["images"].shape[0]
    total = torch.zeros((), device=batch["images"].device)
    for r in range(0, n, rows):
        sl = slice(r, min(r + rows, n))
        with torch.enable_grad():
            lg = logits(leaves, batch["images"][sl], cfg, precision)
            part = F.cross_entropy(lg, batch["labels"][sl],
                                   reduction="sum") / n
            gs = torch.autograd.grad(part, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k].add_(g)
        total = total + part.detach()
        del lg, part, gs
    return total, grads

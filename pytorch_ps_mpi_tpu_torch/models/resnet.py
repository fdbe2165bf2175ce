"""ResNet-18/50 (``pytorch_ps_mpi_tpu/models/resnet.py``).

The public forward takes NHWC images, as the JAX model does, and
permutes to NCHW inside (PyTorch's convolution layout). Normalization is
GroupNorm with ``gcd(32, channels)`` groups and flax's ``eps=1e-6`` (not
PyTorch's 1e-5), so a model loaded with ``utils.interop.params_from_jax``
computes the JAX model's function. The residual shortcut keeps the flax
order: a projection (1x1 conv + norm) only where the block changes the
shape. ``norm="batch"`` (SyncBatchNorm) comes with a later slice.

Padding follows flax: the 3x3 and 7x7 convs pad explicitly and
symmetrically; the ImageNet stem's max-pool uses flax's ``"SAME"``
padding, which for even sizes pads one row and column at the end only.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.models.init import init_like_flax

#: flax's GroupNorm epsilon
GN_EPS = 1e-6


class AdaptiveGroupNorm(nn.GroupNorm):
    """GroupNorm with ``gcd(32, channels)`` groups, so narrow test models
    normalize as the JAX package's do."""

    def __init__(self, channels: int):
        super().__init__(math.gcd(32, channels), channels, eps=GN_EPS)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class ResNetBlock(nn.Module):
    """Basic 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.norm1 = AdaptiveGroupNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.norm2 = AdaptiveGroupNorm(filters)
        self.shortcut = self.shortcut_norm = None
        if stride != 1 or cin != filters:
            self.shortcut = _conv(cin, filters, 1, stride)
            self.shortcut_norm = AdaptiveGroupNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        res = x if self.shortcut is None else self.shortcut_norm(
            self.shortcut(x))
        return torch.relu(y + res)


class BottleneckBlock(nn.Module):
    """1x1-3x3-1x1 bottleneck (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        cout = filters * 4
        self.conv1 = _conv(cin, filters, 1)
        self.norm1 = AdaptiveGroupNorm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.norm2 = AdaptiveGroupNorm(filters)
        self.conv3 = _conv(filters, cout, 1)
        self.norm3 = AdaptiveGroupNorm(cout)
        self.shortcut = self.shortcut_norm = None
        if stride != 1 or cin != cout:
            self.shortcut = _conv(cin, cout, 1, stride)
            self.shortcut_norm = AdaptiveGroupNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        res = x if self.shortcut is None else self.shortcut_norm(
            self.shortcut(x))
        return torch.relu(y + res)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool with flax's ``"SAME"`` padding."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
        out = -(-size // 2)
        total = max((out - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 norm: str = "group", small_inputs: bool = False,
                 in_channels: int = 3, *, seed: int = 0,
                 device: Device = "cuda"):
        super().__init__()
        if norm != "group":
            raise NotImplementedError(
                "norm='batch' (SyncBatchNorm) is not ported yet "
                "(ROADMAP queue 1 item 4)")
        self.small_inputs = small_inputs
        if small_inputs:
            self.stem = _conv(in_channels, num_filters, 3)
        else:
            self.stem = _conv(in_channels, num_filters, 7, 2)
        self.stem_norm = AdaptiveGroupNorm(num_filters)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2 ** i, stride))
                cin = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        init_like_flax(self, seed)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC images -> float32 logits ``[N, num_classes]``."""
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.stem_norm(self.stem(x)))
        if not self.small_inputs:
            x = _max_pool_same(x)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3))).to(torch.float32)


def ResNet18(**kwargs) -> ResNet:
    return ResNet([2, 2, 2, 2], ResNetBlock, **kwargs)


def ResNet50(**kwargs) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, **kwargs)

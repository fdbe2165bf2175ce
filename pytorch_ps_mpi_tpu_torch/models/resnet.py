"""ResNet-18/50 (``pytorch_ps_mpi_tpu/models/resnet.py``).

The public forward takes NHWC images, as the JAX model does, and
permutes to NCHW inside (PyTorch's convolution layout). Normalization is
GroupNorm with ``gcd(32, channels)`` groups and flax's ``eps=1e-6`` (not
PyTorch's 1e-5), so a model loaded with ``utils.interop.params_from_jax``
computes the JAX model's function. The residual shortcut keeps the flax
order: a projection (1x1 conv + norm) only where the block changes the
shape.

``norm="batch"`` is flax's ``nn.BatchNorm`` (:class:`BatchNorm`): momentum
0.99 in flax's convention, eps 1e-5, statistics in float32, a biased
batch variance in the running var, the running statistics used when
``train=False``. ``bn_axis="data"`` makes it SyncBatchNorm: the batch
statistics are merged across the process group inside the forward, as
flax's ``axis_name`` does, so every rank normalizes as one rank seeing
the global batch would. The running statistics are buffers (``mean``,
``var``, flax's ``batch_stats`` names); :func:`apply_with_stats` is
flax's ``apply(..., mutable=["batch_stats"])``.

Padding follows flax: the 3x3 and 7x7 convs pad explicitly and
symmetrically; the ImageNet stem's max-pool uses flax's ``"SAME"``
padding, which for even sizes pads one row and column at the end only.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.models.init import (init_like_flax,
                                                 mark_flax_views)

#: flax's GroupNorm epsilon
GN_EPS = 1e-6


class AdaptiveGroupNorm(nn.GroupNorm):
    """GroupNorm with ``gcd(32, channels)`` groups, so narrow test models
    normalize as the JAX package's do."""

    def __init__(self, channels: int):
        super().__init__(math.gcd(32, channels), channels, eps=GN_EPS)


#: flax BatchNorm's defaults
BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def batch_stats(x: torch.Tensor, sync: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of NCHW ``x`` in float32.

    Each rank takes its mean and M2 (the sum of squared deviations) in two
    passes; with ``sync`` the ranks' ``(count, mean, M2)`` are gathered in
    one differentiable all-gather and merged by Chan's formula. flax takes
    ``E[x^2] - E[x]^2`` in one pass (``use_fast_variance``), which cancels
    where the mean is large against the spread; the two agree within the
    rounding of that cancellation (ROADMAP queue 3)."""
    x = x.to(torch.float32)
    dims = (0, 2, 3)
    n = x.numel() // x.shape[1]
    mean = x.mean(dims)
    m2 = torch.square(x - mean[:, None, None]).sum(dims)
    if not sync:
        return mean, m2 / n
    g = comms.all_gather_with_grad(
        torch.stack([torch.full_like(mean, float(n)), mean, m2]))
    counts, means, m2s = g[:, 0], g[:, 1], g[:, 2]
    total = counts.sum(0)
    # weights n_r / N: one rank's merge is its own mean and M2 exactly
    merged = (counts / total * means).sum(0)
    m2 = m2s.sum(0) + (counts * torch.square(means - merged)).sum(0)
    return merged, m2 / total


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of NCHW input.

    ``train=True`` normalizes with the batch statistics (across the
    process group with ``axis_name="data"``) and moves the running ones,
    ``ra = 0.99 ra + 0.01 batch``, in place (under
    :func:`apply_with_stats` those are the tensors it was given);
    ``train=False`` normalizes with the running statistics."""

    def __init__(self, channels: int, axis_name: Optional[str] = None):
        super().__init__()
        if axis_name not in (None, "data"):
            raise ValueError(f"bn_axis must be None or 'data' (the process "
                             f"group), got {axis_name!r}")
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            mean, var = batch_stats(x, sync=self.axis_name is not None)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


def _norm(m: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    return m(x, train) if isinstance(m, BatchNorm) else m(x)


class ResNetBlock(nn.Module):
    """Basic 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 norm=AdaptiveGroupNorm):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.norm1 = norm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.norm2 = norm(filters)
        self.shortcut = self.shortcut_norm = None
        if stride != 1 or cin != filters:
            self.shortcut = _conv(cin, filters, 1, stride)
            self.shortcut_norm = norm(filters)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = torch.relu(_norm(self.norm1, self.conv1(x), train))
        y = _norm(self.norm2, self.conv2(y), train)
        res = x if self.shortcut is None else _norm(
            self.shortcut_norm, self.shortcut(x), train)
        return torch.relu(y + res)


class BottleneckBlock(nn.Module):
    """1x1-3x3-1x1 bottleneck (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 norm=AdaptiveGroupNorm):
        super().__init__()
        cout = filters * 4
        self.conv1 = _conv(cin, filters, 1)
        self.norm1 = norm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.norm2 = norm(filters)
        self.conv3 = _conv(filters, cout, 1)
        self.norm3 = norm(cout)
        self.shortcut = self.shortcut_norm = None
        if stride != 1 or cin != cout:
            self.shortcut = _conv(cin, cout, 1, stride)
            self.shortcut_norm = norm(cout)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = torch.relu(_norm(self.norm1, self.conv1(x), train))
        y = torch.relu(_norm(self.norm2, self.conv2(y), train))
        y = _norm(self.norm3, self.conv3(y), train)
        res = x if self.shortcut is None else _norm(
            self.shortcut_norm, self.shortcut(x), train)
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
                 in_channels: int = 3, bn_axis: Optional[str] = None, *,
                 seed: int = 0, device: Device = "cuda"):
        super().__init__()
        if norm == "group":
            make_norm = AdaptiveGroupNorm
        elif norm == "batch":
            def make_norm(c):
                return BatchNorm(c, axis_name=bn_axis)
        else:
            raise ValueError(f"norm must be 'group' or 'batch', got {norm!r}")
        self.norm = norm
        self.small_inputs = small_inputs
        if small_inputs:
            self.stem = _conv(in_channels, num_filters, 3)
        else:
            self.stem = _conv(in_channels, num_filters, 7, 2)
        self.stem_norm = make_norm(num_filters)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2 ** i, stride,
                                        make_norm))
                cin = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        init_like_flax(self, seed)
        self.to(resolve_device(device))
        mark_flax_views(self)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """``x``: NHWC images -> float32 logits ``[N, num_classes]``.
        ``train`` is flax's: BatchNorm's batch statistics (and the move
        of its running ones) or its running statistics."""
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(_norm(self.stem_norm, self.stem(x), train))
        if not self.small_inputs:
            x = _max_pool_same(x)
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.mean(dim=(2, 3))).to(torch.float32)


def batch_stats_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of ``model``'s running statistics, ``name -> tensor`` (the
    buffers ``*.mean`` and ``*.var``): the initial ``aux_state`` of
    ``MPI_PS.step``."""
    return {k: b.detach().clone() for k, b in model.named_buffers()}


def apply_with_stats(model: nn.Module, params: Dict[str, torch.Tensor],
                     aux_state: Dict[str, torch.Tensor], x: torch.Tensor,
                     train: bool = True
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(logits, new_aux_state)``: flax's ``model.apply({"params": ...,
    "batch_stats": ...}, x, train=train, mutable=["batch_stats"])``. The
    forward runs on copies of ``aux_state``, which BatchNorm moves in
    place; ``aux_state`` itself is not altered."""
    new = {k: t.clone() for k, t in aux_state.items()}
    logits = functional_call(model, {**params, **new}, (x,),
                             {"train": train})
    return logits, new


def ResNet18(**kwargs) -> ResNet:
    return ResNet([2, 2, 2, 2], ResNetBlock, **kwargs)


def ResNet50(**kwargs) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, **kwargs)

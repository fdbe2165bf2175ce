"""MLP (``pytorch_ps_mpi_tpu/models/mlp.py``): flatten, then Linear
layers with ReLU between them. flax infers the input width at init; a
torch module is built with it (``in_features``, MNIST's 784 by
default)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.models.init import (init_like_flax,
                                                 mark_flax_views)


class MLP(nn.Module):
    def __init__(self, features: Sequence[int] = (128, 10),
                 in_features: int = 784, *, seed: int = 0,
                 device: Device = "cuda"):
        super().__init__()
        widths = [in_features] + list(features)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        init_like_flax(self, seed)
        self.to(resolve_device(device))
        mark_flax_views(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x

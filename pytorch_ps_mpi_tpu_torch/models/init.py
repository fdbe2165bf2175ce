"""Seeded weight initialization shared by the port's models.

flax's defaults, drawn from an explicit ``torch.Generator``: conv and
dense kernels are normal with variance 1/fan_in (flax's lecun_normal,
untruncated here), biases 0, normalization scales 1 and biases 0. The
draws are not flax's numbers; to compute the same function as a JAX
model, load its weights with ``utils.interop.params_from_jax``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_like_flax(module: nn.Module, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def mark_flax_views(module: nn.Module) -> None:
    """Tag each conv and linear kernel of ``module`` with ``codec_view``,
    the permutation of its dims into the layout the JAX package keeps it
    in (OIHW -> HWIO, ``[out, in]`` -> ``[in, out]``). A codec whose result
    depends on the order of a leaf's elements sees a tagged parameter
    through it (``MPI_PS``), so it selects the JAX package's elements. A
    copy of a parameter (``clone``, ``copy.deepcopy``) carries no tag."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.codec_view = (2, 3, 1, 0) if m.weight.dim() == 4 \
                else (1, 0)

"""Synthetic data and the classification loss
(``pytorch_ps_mpi_tpu/data.py``).

``synthetic_images`` and ``synthetic_mlm`` draw from the same numpy
``RandomState`` streams as the JAX package's generators, so both packages
see the same batches for the same seed; only the final copy to a tensor
differs.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device

SHAPES = {
    "mnist": ((28, 28, 1), 10),
    "cifar10": ((32, 32, 3), 10),
    "imagenet": ((224, 224, 3), 1000),
}


def synthetic_images(
    name: str, batch: int, seed: int = 0, *, device: Device = "cuda",
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Endless iterator of ``(images[B, H, W, C] float32, labels[B]
    int64)`` with a learnable class signal (per-class mean offsets)."""
    dev = resolve_device(device)
    shape, classes = SHAPES[name]
    rng = np.random.RandomState(seed)
    class_means = rng.randn(classes, *shape).astype(np.float32) * 0.5
    while True:
        labels = rng.randint(0, classes, size=(batch,))
        x = rng.randn(batch, *shape).astype(np.float32) + class_means[labels]
        yield (torch.from_numpy(x).to(dev),
               torch.from_numpy(labels.astype(np.int64)).to(dev))


def synthetic_mlm(
    batch: int, seq_len: int, vocab_size: int, mask_rate: float = 0.15,
    mask_token: int = 0, seed: int = 0, *, device: Device = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless iterator of MLM batches ``{"tokens", "targets"}`` (int64
    ``[B, L]``) and ``"mask"`` (bool ``[B, L]``)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    while True:
        targets = rng.randint(1, vocab_size, size=(batch, seq_len))
        mask = rng.rand(batch, seq_len) < mask_rate
        tokens = np.where(mask, mask_token, targets)
        yield {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev),
               "targets": torch.from_numpy(targets.astype(np.int64)).to(dev),
               "mask": torch.from_numpy(mask).to(dev)}


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())

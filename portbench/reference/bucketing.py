"""The flat buckets a bucketed step aggregates, worked out from the leaf
order and ``bucket_mb``: leaves grouped by dtype in order of first
appearance, each group's leaves in order, a bucket closed when the next
leaf would take it past ``bucket_mb`` MiB (a leaf larger than that gets
a bucket of its own)."""

from __future__ import annotations

from typing import Dict, List

import torch


def plan(tensors: Dict[str, torch.Tensor], bucket_mb: float
         ) -> List[List[str]]:
    """The leaf names of every bucket, in bucket order."""
    cap = float(bucket_mb) * (1 << 20)
    groups: Dict[torch.dtype, List[str]] = {}
    for name, t in tensors.items():
        groups.setdefault(t.dtype, []).append(name)
    out: List[List[str]] = []
    for dtype, names in groups.items():
        size = None  # no bucket of this dtype open yet
        for name in names:
            n = tensors[name].numel() * dtype.itemsize
            if size is None or (size > 0 and size + n > cap):
                out.append([])
                size = 0
            out[-1].append(name)
            size += n
    return out


def flatten(tensors: Dict[str, torch.Tensor], names: List[str]
            ) -> torch.Tensor:
    return torch.cat([tensors[n].reshape(-1) for n in names])


def unflatten(flat: torch.Tensor, like: Dict[str, torch.Tensor],
              names: List[str]) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for n in names:
        k = like[n].numel()
        out[n] = flat[at:at + k].reshape(like[n].shape)
        at += k
    return out

"""Error feedback (Karimireddy et al. 2019) around top-k at one worker:
each leaf keeps a residual memory, starting at zero; the leaf's gradient
plus its memory is compressed to its ``k = max(1, round(fraction * n))``
largest magnitudes (ties lower index first), that sparse tensor is the
sum, and the memory becomes what was left out."""

from __future__ import annotations

from typing import Dict

import torch


def topk_dense(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` with all but its ``k`` largest |x| set to 0 (a stable
    descending sort: of equal magnitudes the lower index is kept)."""
    flat = x.reshape(-1)
    order = torch.sort(flat.abs(), descending=True, stable=True)[1][:k]
    out = torch.zeros_like(flat)
    out[order] = flat[order]
    return out.reshape(x.shape)


class Reference:
    def __init__(self, args: dict, bucket_mb: float, seed: int, device):
        if args.get("inner_name", "topk") != "topk":
            raise ValueError("the reference has error feedback around top-k "
                             "only")
        self.fraction = float(args["fraction"])
        self.memory: Dict[str, torch.Tensor] = {}

    def k_for(self, n: int) -> int:
        return min(max(1, int(round(n * self.fraction))), n)

    def aggregate(self, grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        out = {}
        for name, g in grads.items():
            corrected = g + self.memory.get(name, torch.zeros_like(g))
            sent = topk_dense(corrected, self.k_for(g.numel()))
            self.memory[name] = corrected - sent
            out[name] = sent
        return out

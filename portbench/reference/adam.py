"""Adam (Kingma & Ba 2015) in the efficient form of their section 2:
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g**2``, ``p -= lr *
sqrt(1 - b2**t) / (1 - b1**t) * m / (sqrt(v) + eps)``."""

from __future__ import annotations

import math
from typing import Dict

import torch


class Reference:
    def __init__(self, params: Dict[str, torch.Tensor], hyper: dict):
        self.lr = float(hyper["lr"])
        self.b1 = float(hyper.get("b1", 0.9))
        self.b2 = float(hyper.get("b2", 0.999))
        self.eps = float(hyper.get("eps", 1e-8))
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        size = (self.lr * math.sqrt(1 - self.b2 ** self.t)
                / (1 - self.b1 ** self.t))
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            p.sub_(size * self.m[k] / (torch.sqrt(self.v[k]) + self.eps))

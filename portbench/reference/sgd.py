"""SGD with heavy-ball momentum, PyTorch's convention: the first step's
buffer is the gradient itself, then ``buf = momentum * buf + g``; ``p -=
lr * buf``."""

from __future__ import annotations

from typing import Dict

import torch


class Reference:
    def __init__(self, params: Dict[str, torch.Tensor], hyper: dict):
        self.lr = float(hyper["lr"])
        self.momentum = float(hyper.get("momentum", 0.0))
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        for k, p in params.items():
            g = grads[k]
            if self.momentum:
                buf = self.buf.get(k)
                self.buf[k] = g.clone() if buf is None else \
                    self.momentum * buf + g
                g = self.buf[k]
            p.sub_(self.lr * g)

"""The identity codec: one worker's gradient is the sum."""

from __future__ import annotations

from typing import Dict

import torch


class Reference:
    def __init__(self, args: dict, bucket_mb: float, seed: int, device):
        pass

    def aggregate(self, grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        return dict(grads)

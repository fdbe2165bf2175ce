"""``pytorch_ps_mpi_tpu_torch.Adam``."""

from __future__ import annotations

from typing import Dict

import torch


def build(params, code, mix: dict, seed: int, device):
    from pytorch_ps_mpi_tpu_torch import Adam

    return Adam(params, code=code, bucket_mb=mix["bucket_mb"], seed=seed,
                device=device, **mix["hyper"])


def first_gradient(opt, mix: dict) -> Dict[str, torch.Tensor]:
    """After one step from zero moments, ``m = (1 - b1) g``."""
    b1 = float(mix["hyper"].get("b1", 0.9))
    return {k: m.float() / (1.0 - b1)
            for k, m in opt.opt_state.exp_avg.items()}

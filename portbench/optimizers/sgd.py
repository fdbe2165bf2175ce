"""``pytorch_ps_mpi_tpu_torch.SGD`` with momentum."""

from __future__ import annotations

from typing import Dict

import torch


def build(params, code, mix: dict, seed: int, device):
    from pytorch_ps_mpi_tpu_torch import SGD

    if not mix["hyper"].get("momentum"):
        raise ValueError("the benchmark reads SGD's first gradient from its "
                         "momentum buffer: give the mix a momentum")
    return SGD(params, code=code, bucket_mb=mix["bucket_mb"], seed=seed,
               device=device, **mix["hyper"])


def first_gradient(opt, mix: dict) -> Dict[str, torch.Tensor]:
    """After the first step the momentum buffer is the gradient."""
    return {k: b.float() for k, b in opt.opt_state.momentum_buf.items()}

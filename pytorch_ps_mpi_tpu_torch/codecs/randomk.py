"""Random-k sparsification codec (``pytorch_ps_mpi_tpu/codecs/randomk.py``):
unbiased, kept entries rescaled so ``E[decode] = grad``.

Sampling is stratified: the flat gradient is split into k strata with
bounds ``(arange(k + 1) * n) // k`` and one index is drawn in each,
``start + floor(u * len)`` in float32, its value scaled by ``len`` when
``unbiased`` (the inclusion probability of an element is 1/len). The
payload is top-k's (values[k], int32 indices[k]), so decode, the sparse
index-merge and the rank-ordered scatter-add are top-k's.

``encode`` draws its k uniforms from the step's ``torch.Generator`` and
hands them to :meth:`RandomKCodec.sample`, a pure function of the
gradient and the uniforms, so a test can feed it the JAX encode's own
draw (``jax.random.uniform(key, (k,))``, ``randomk.py:72``). The strata
are made on the leaf's device, so an encode makes no host copy and no
host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import register_codec
from pytorch_ps_mpi_tpu_torch.codecs.topk import TopKCodec


@register_codec("randomk")
class RandomKCodec(TopKCodec):
    needs_rng = True
    order_dependent = True
    kernel_ops = ()  # a random selection: no top-k kernel

    def __init__(self, k: int = 0, fraction: float = 0.0,
                 unbiased: bool = True):
        # top-k's selection switches are not random-k's settings (the
        # wire fingerprint hashes the public ones)
        if (k <= 0) == (fraction <= 0.0):
            raise ValueError("give exactly one of k>0 or 0<fraction<=1")
        self.k = int(k)
        self.fraction = float(fraction)
        self.unbiased = unbiased

    @property
    def bucketable(self):
        # only the fraction form: k scales with the unit, so a bucket keeps
        # fraction·n of its elements as its leaves would; an absolute k is
        # per unit, and bucketing would shrink the kept set (``:39-49``)
        return self.fraction > 0

    @staticmethod
    def _strata(n: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """int32 (starts[k], lens[k]) of the k strata of n elements, exact
        in int64 arithmetic."""
        bounds = (torch.arange(k + 1, dtype=torch.int64, device=device)
                  * n) // k
        return (bounds[:-1].to(torch.int32),
                (bounds[1:] - bounds[:-1]).to(torch.int32))

    def sample(self, grad: torch.Tensor, uniforms: torch.Tensor) -> dict:
        """The payload of ``grad`` for these k float32 uniforms in [0, 1)."""
        flat = grad.reshape(-1)
        k = self._k_for(tuple(grad.shape))
        starts, lens = self._strata(flat.numel(), k, flat.device)
        indices = starts + torch.floor(
            uniforms.to(torch.float32) * lens.to(torch.float32)
        ).to(torch.int32)
        values = flat[indices.long()]
        if self.unbiased:
            values = values * lens.to(flat.dtype)
        return {"values": values, "indices": indices}

    def encode(self, grad, state=(), rng: Optional[torch.Generator] = None):
        if rng is None:
            raise ValueError("RandomKCodec needs a torch.Generator")
        u = torch.rand(self._k_for(tuple(grad.shape)), generator=rng,
                       dtype=torch.float32, device=grad.device)
        return self.sample(grad, u), state


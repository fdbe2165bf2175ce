"""Threshold sparsification, the ragged codec
(``pytorch_ps_mpi_tpu/codecs/threshold.py``).

Keeps every entry with ``|g| > tau * mean|g|``, so the number of
survivors depends on the data. The payload has a static cap,
``round(n * max_fraction)`` slots, so it rides an all-gather: values[cap],
int32 indices[cap] and an int32 ``length`` sidecar, ``min(kept, cap)``.
The survivors sit first, in index order; the slots past ``length`` are
garbage (index 0 and its value, as the JAX package's ``scatter``
compaction leaves them) and the receiver masks them by the sender's own
length before the scatter-add. More survivors than the cap drop the tail
in index order. The step all-gathers the payload tensor by tensor, the
length with it, as the JAX step gathers the payload tree.

The compaction keeps ``length`` on the device and makes no host sync: a
cumulative sum of the mask gives survivor i its slot, and one scatter
writes the first ``cap`` of them (``torch.nonzero`` would sync on every
call). The JAX package's two compactions (``sort``/``scatter``) differ
only in the garbage tail; the port has one, and checks and ignores the
``compaction``/``chunk`` keywords so that it takes the JAX arguments.

With ``target_fraction`` set, ``tau`` is codec state that a
multiplicative controller moves so the kept fraction tracks the target.
``mean|g|`` is summed in float64 and rounded once to float32, so the
card and the CPU take the same threshold; the JAX package sums in
float32 in XLA's order, so against it the threshold may differ in its
last bit (ROADMAP queue 3 item 11).
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import Codec, numel, register_codec
from pytorch_ps_mpi_tpu_torch.codecs.topk import scatter_add_ranks


@register_codec("threshold")
class ThresholdCodec(Codec):
    # the sparse index-merge, each rank's garbage tail masked by its own
    # length before the concatenation
    supports_aggregate = True
    order_dependent = True

    def __init__(self, tau: float = 2.0, max_fraction: float = 0.25,
                 target_fraction: float = 0.0, eta: float = 0.25,
                 compaction: Optional[str] = None, chunk: int = 1 << 16):
        if not 0.0 < max_fraction <= 1.0:
            raise ValueError(
                f"max_fraction must be in (0, 1], got {max_fraction}")
        if target_fraction and target_fraction > max_fraction:
            raise ValueError("target_fraction must be <= max_fraction")
        if compaction not in (None, "sort", "scatter"):
            raise ValueError(f"compaction must be 'sort' or 'scatter', "
                             f"got {compaction!r}")
        if chunk and (chunk < 1024 or chunk & (chunk - 1)):
            raise ValueError(f"chunk must be 0 or a power of two >= 1024, "
                             f"got {chunk}")
        self.tau = float(tau)
        self.max_fraction = float(max_fraction)
        self.target_fraction = float(target_fraction)
        self.eta = float(eta)

    def _cap(self, shape) -> int:
        return max(1, int(round(numel(shape) * self.max_fraction)))

    def init_state(self, shape, dtype, device=None):
        return {"tau": torch.tensor(self.tau, dtype=torch.float32,
                                    device=device)}

    def encode(self, grad, state=None, rng=None):
        flat = grad.reshape(-1)
        n = flat.numel()
        cap = self._cap(tuple(grad.shape))
        tau = (state["tau"] if state
               else torch.tensor(self.tau, dtype=torch.float32,
                                 device=flat.device))
        mag = flat.abs()
        # the mean in float64, rounded once: the card and the CPU agree
        mean = torch.mean(mag, dtype=torch.float64).to(torch.float32)
        mask = mag > tau * mean
        slot = torch.cumsum(mask, 0, dtype=torch.int32)  # survivor i -> i + 1
        kept = slot[-1]
        # survivors past the cap, and the others, write to a spare slot cap
        slot = torch.where(mask & (slot <= cap), slot - 1, cap)
        idx = torch.zeros(cap + 1, dtype=torch.int32, device=flat.device)
        idx.scatter_(0, slot.long(),
                     torch.arange(n, dtype=torch.int32, device=flat.device))
        idx = idx[:cap]
        payload = {"values": flat[idx.long()], "indices": idx,
                   "length": torch.clamp(kept, max=cap)}
        if self.target_fraction > 0.0:
            ratio = kept.to(torch.float32) / (self.target_fraction * n)
            tau = torch.clamp(tau * ratio ** self.eta, 1e-4, 1e4)
        return payload, {"tau": tau}

    @staticmethod
    def _masked_values(payload, dtype) -> torch.Tensor:
        values = payload["values"]
        valid = (torch.arange(values.shape[-1], device=values.device)
                 < payload["length"][..., None])
        return torch.where(valid, values, 0).to(dtype)

    def decode(self, payload, shape, dtype):
        # a scatter-ADD: the garbage slots repeat index 0 with masked zeros
        return scatter_add_ranks(self._masked_values(payload, dtype),
                                 payload["indices"], 1, numel(shape),
                                 dtype).reshape(shape)

    def decode_sum(self, payloads, shape, dtype):
        agg, meta = self.aggregate(payloads, shape, dtype)
        return self.agg_decode(agg, meta, shape, dtype)

    def aggregate(self, payloads, shape, dtype):
        idx = payloads["indices"]
        return {"values": self._masked_values(payloads, dtype).reshape(-1),
                "indices": idx.reshape(-1)}, {"frames": int(idx.shape[0])}

    def agg_decode(self, agg_payload, meta, shape, dtype):
        return scatter_add_ranks(agg_payload["values"], agg_payload["indices"],
                                 meta["frames"], numel(shape),
                                 dtype).reshape(shape)

    def payload_bits(self, shape, dtype):
        # the static wire size (the cap); true occupancy varies by step
        return self._cap(shape) * (dtype.itemsize * 8 + 32) + 32

"""Error-feedback wrapper (EF-SGD, Karimireddy et al. 2019;
``pytorch_ps_mpi_tpu/codecs/error_feedback.py:39-111``).

Wraps any codec: the compression residual is kept in per-worker memory
and added back before the next encode, which restores convergence for
biased codecs (sign, top-k). The memory is explicit codec state, one
tensor per leaf on the parameter's device; the optimizer threads it
through the step and its ``state_dict`` carries it. The per-hop form
(``HopErrorFeedback``) belongs to the aggregation tree (ROADMAP queue 1
item 5).
"""

from __future__ import annotations

import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import Codec, get_codec, register_codec


@register_codec("ef")
class ErrorFeedback(Codec):
    def __init__(self, inner: Codec = None, inner_name: str = None,
                 **inner_kwargs):
        if inner is None:
            inner = get_codec(inner_name or "topk", **inner_kwargs)
        self.inner = inner
        self.needs_rng = inner.needs_rng

    def init_state(self, shape, dtype, device=None):
        return {"memory": torch.zeros(shape, dtype=dtype, device=device),
                "inner": self.inner.init_state(shape, dtype, device)}

    def encode(self, grad, state=(), rng=None):
        corrected = grad + state["memory"]
        payload, inner_state = self.inner.encode(corrected, state["inner"], rng)
        transmitted = self.inner.decode(payload, tuple(grad.shape), grad.dtype)
        return payload, {"memory": corrected - transmitted,
                         "inner": inner_state}

    def decode(self, payload, shape, dtype):
        return self.inner.decode(payload, shape, dtype)

    def decode_sum(self, payloads, shape, dtype):
        return self.inner.decode_sum(payloads, shape, dtype)

    # aggregation is the inner codec's: EF state lives on the encode side
    @property
    def supports_aggregate(self):
        return self.inner.supports_aggregate

    @property
    def order_dependent(self):
        return self.inner.order_dependent

    @property
    def agg_exact(self):
        return self.inner.agg_exact

    def can_aggregate(self, shape, dtype):
        return self.inner.can_aggregate(shape, dtype)

    def aggregate(self, payloads, shape, dtype):
        return self.inner.aggregate(payloads, shape, dtype)

    def agg_decode(self, agg_payload, meta, shape, dtype):
        return self.inner.agg_decode(agg_payload, meta, shape, dtype)

    def payload_bits(self, shape, dtype):
        return self.inner.payload_bits(shape, dtype)

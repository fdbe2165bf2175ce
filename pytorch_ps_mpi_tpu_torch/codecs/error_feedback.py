"""Error-feedback wrapper (EF-SGD, Karimireddy et al. 2019;
``pytorch_ps_mpi_tpu/codecs/error_feedback.py:39-111``).

Wraps any codec: the compression residual is kept in per-worker memory
and added back before the next encode, which restores convergence for
biased codecs (sign, top-k). The memory is explicit codec state, one
tensor per leaf on the parameter's device; the optimizer threads it
through the step and its ``state_dict`` carries it.

:class:`HopErrorFeedback` is the per-hop form for an aggregation-tree
leader's re-encode (``error_feedback.py:114-176``).
"""

from __future__ import annotations

from typing import List, Optional

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

    @property
    def kernel_ops(self):
        """The inner codec's kernel libraries (not an attribute of the
        instance, whose keywords describe the wire)."""
        return self.inner.kernel_ops

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

    def agg_init(self, shape, dtype):
        return self.inner.agg_init(shape, dtype)

    def agg_fold(self, acc, payload):
        return self.inner.agg_fold(acc, payload)

    def agg_finalize(self, acc, shape, dtype):
        return self.inner.agg_finalize(acc, shape, dtype)

    def payload_bits(self, shape, dtype):
        return self.inner.payload_bits(shape, dtype)

    def fidelity_probe(self, grad, state=(), rng=None):
        """Probe the inner codec on the error-corrected gradient (what
        rides the wire: grad + memory) and add the residual memory's norm
        (``error_feedback.py:95-108``); EF's correctness hinges on that
        residual staying bounded. Read-only, like the base probe."""
        if not state:
            state = self.init_state(tuple(grad.shape), grad.dtype,
                                    grad.device)
        corrected = grad + state["memory"]
        out = self.inner.fidelity_probe(corrected, state["inner"], rng)
        out["ef_residual_norm"] = float(torch.linalg.vector_norm(
            state["memory"].to(torch.float32).reshape(-1)))
        return out


class HopErrorFeedback:
    """Per-hop error feedback for a tree leader's re-encode of its group
    aggregate: the hop's residual is added back before each encode, and
    the new residual is ``corrected - decode(payload)`` for the payload
    that ships. It lives on the wire's device: the correction, the encode
    (the codec's kernels), the decode of the device payload, whose bytes
    are the ones :meth:`CodecWire.pack` copies out, and the subtraction.
    Each is one IEEE float32 operation a element, as the JAX package's
    host numpy, so int8 and identity residuals agree bit for bit. The
    decode-back is not an ingest decode: the leader's ``decodes_done``
    stays 0. ``enabled=False`` is a plain encode."""

    def __init__(self, wire, enabled: bool = True):
        self.wire = wire
        self.enabled = bool(enabled)
        self._residual: Optional[List[torch.Tensor]] = None
        self.residual_norm = 0.0   # ||residual|| after the last hop
        self.last_rel_error = 0.0  # ||residual|| / ||corrected||
        self.rounds = 0

    @property
    def residual(self) -> Optional[List[torch.Tensor]]:
        """The residual's leaves (JAX order and layout), None before the
        first enabled encode."""
        return self._residual

    def encode(self, grad):
        """``grad + residual`` -> payload bytes (one of the wire's two
        ping-pong buffers: ship or seal before the encode after next).
        ``grad``: the wire template's tree or its leaves, as tensors
        (moved to the wire's device) or numpy arrays."""
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import _leaves_of

        dev = self.wire.device
        leaves = [torch.as_tensor(x).to(dev, torch.float32)
                  for x in _leaves_of(grad)]
        if self.enabled and self._residual is not None:
            leaves = [x + r for x, r in zip(leaves, self._residual)]
        payloads = self.wire.encode_payloads(leaves)
        buf = self.wire.pack(payloads)
        if self.enabled:
            sent = self.wire.decode_payloads(payloads)
            self._residual = [c - t.to(torch.float32).reshape(c.shape)
                              for c, t in zip(leaves, sent)]
            res_sq = float(sum(torch.sum(r.double() ** 2)
                               for r in self._residual))
            cor_sq = float(sum(torch.sum(c.double() ** 2) for c in leaves))
            self.residual_norm = res_sq ** 0.5
            self.last_rel_error = res_sq ** 0.5 / max(cor_sq ** 0.5, 1e-30)
        self.rounds += 1
        return buf

    def probe(self) -> dict:
        """The hop's fidelity numbers."""
        return {"hop_ef": self.enabled, "rounds": self.rounds,
                "ef_residual_norm": round(self.residual_norm, 6),
                "hop_rel_error": round(self.last_rel_error, 6)}

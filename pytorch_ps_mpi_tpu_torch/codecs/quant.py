"""Quantization codecs: deterministic int8 and stochastic QSGD
(``pytorch_ps_mpi_tpu/codecs/quant.py``).

Both payloads are an int8 code per element and one float32 scalar, and
both decode as ``f32(q) * scale``: int8's scale is max|g|/127, QSGD's is
norm/levels. The int8 quantize and the rank-ordered dequantize-sum are
the kernels of ``ops/quant.py``. Decodes compute in float32 and cast to
the requested dtype (the JAX ``decode`` multiplies in that dtype; the
two agree for float32).
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import (
    Codec,
    check_nonfinite_mode,
    guard_nonfinite,
    numel,
    register_codec,
)
from pytorch_ps_mpi_tpu_torch.ops import quant as quant_ops


class _ScaleFoldedInt8(Codec):
    """Exact integer-domain aggregation for codecs whose decode is
    ``scale × q`` over an int8 payload (``quant.py:33-98``): ``aggregate``
    sums ``f32(q_w) · s_w`` over the ``[world, n]`` stack in one kernel
    pass, in rank order, without the ``[world, n]`` float intermediate;
    ``decode_sum`` routes through it, so the two are one code path.
    Subclasses give the per-frame scale vector. The streaming
    ``agg_init``/``agg_fold``/``agg_finalize`` forms belong to the async
    wire (ROADMAP queue 1 item 3)."""

    supports_aggregate = True

    def _batch_scales(self, payloads) -> torch.Tensor:
        """Per-frame scale vector, float32[world]."""
        raise NotImplementedError

    def decode_sum(self, payloads, shape, dtype):
        agg, meta = self.aggregate(payloads, shape, dtype)
        return self.agg_decode(agg, meta, shape, dtype)

    def aggregate(self, payloads, shape, dtype):
        q = payloads["q"]  # [world, n] int8
        acc = quant_ops.dequant_sum(q, self._batch_scales(payloads))
        return {"acc": acc}, {"frames": int(q.shape[0])}

    def agg_decode(self, agg_payload, meta, shape, dtype):
        return agg_payload["acc"].to(dtype).reshape(shape)

    def payload_bits(self, shape, dtype):
        return numel(shape) * 8 + 32


@register_codec("int8")
class Int8Codec(_ScaleFoldedInt8):
    """Per-tensor symmetric int8: q = round(g / scale), scale = max|g|/127.

    Every size goes through the quantize kernel: the JAX codec's jnp path
    (its default) and its Pallas path give the same bytes, so the port
    keeps no ``use_pallas`` switch, as ``SignCodec`` keeps none."""

    bucketable = True

    def __init__(self, nonfinite: str = "propagate"):
        self.nonfinite = check_nonfinite_mode(nonfinite)

    def encode(self, grad, state=(), rng=None):
        flat = guard_nonfinite(grad.reshape(-1), self.nonfinite, "Int8Codec")
        q, scale = quant_ops.quantize_int8(flat.to(torch.float32))
        return {"q": q, "scale": scale}, state

    def decode(self, payload, shape, dtype):
        return quant_ops.dequantize_int8(
            payload["q"].reshape(-1), payload["scale"]).to(dtype).reshape(shape)

    def _batch_scales(self, payloads):
        return payloads["scale"].to(torch.float32)


@register_codec("qsgd")
class QSGDCodec(_ScaleFoldedInt8):
    """QSGD (Alistarh et al. 2017): stochastic uniform quantization to
    ``levels`` buckets of the normalized magnitude; unbiased.

    ``encode`` draws its uniforms from the step's ``torch.Generator`` and
    hands them to :meth:`quantize`, a pure function of the gradient and
    the uniforms, so a test can feed it the JAX encode's own draw
    (``jax.random.uniform(key, shape)``, ``quant.py:171``)."""

    needs_rng = True
    bucketable = True

    def __init__(self, levels: int = 16, nonfinite: str = "propagate"):
        if not 1 <= levels <= 127:
            raise ValueError(f"levels must be in [1, 127], got {levels}")
        self.levels = int(levels)
        self.nonfinite = check_nonfinite_mode(nonfinite)

    def quantize(self, flat: torch.Tensor, uniforms: torch.Tensor):
        """The payload of ``flat`` for these uniforms in [0, 1)."""
        flat = guard_nonfinite(flat.reshape(-1), self.nonfinite, "QSGDCodec")
        norm = torch.clamp(torch.linalg.vector_norm(flat), min=1e-12)
        scaled = flat.abs() / norm * self.levels  # in [0, levels]
        lower = torch.floor(scaled)
        up = uniforms < scaled - lower
        q = (lower + up.to(flat.dtype)).to(torch.int8)  # levels <= 127
        # -0.0 takes the negative sign, as jnp.signbit gives
        return {"q": torch.where(torch.signbit(flat), -q, q),
                "norm": norm.to(torch.float32)}

    def encode(self, grad, state=(), rng: Optional[torch.Generator] = None):
        if rng is None:
            raise ValueError("QSGDCodec needs a torch.Generator")
        u = torch.rand(grad.numel(), generator=rng, dtype=torch.float32,
                       device=grad.device)
        return self.quantize(grad, u), state

    def decode(self, payload, shape, dtype):
        return quant_ops.dequantize_int8(
            payload["q"].reshape(-1),
            payload["norm"].to(torch.float32) / self.levels,
        ).to(dtype).reshape(shape)

    def _batch_scales(self, payloads):
        return payloads["norm"].to(torch.float32) / self.levels

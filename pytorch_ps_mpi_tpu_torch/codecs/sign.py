"""SignSGD codec: 1 bit per element plus a mean-|g| scale
(``pytorch_ps_mpi_tpu/codecs/sign.py``).

Two payload layouts, as in the JAX package. A leaf whose size is a
multiple of 1024 goes through the kernels of ``ops/sign.py`` (bit ``s``
of byte ``[r, lane]`` holds element ``r*1024 + s*128 + lane``); any
other leaf packs 8 consecutive elements per byte, little bit order.
Every worker runs the same codec, so payloads only need to agree within
one configuration.
"""

from __future__ import annotations

import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import (
    Codec,
    check_nonfinite_mode,
    guard_nonfinite,
    numel,
    register_codec,
)
from pytorch_ps_mpi_tpu_torch.ops import sign as sign_ops


def _packed_len(n: int) -> int:
    return (n + 7) // 8


def _bit_weights(device) -> torch.Tensor:
    return (1 << torch.arange(8, device=device)).to(torch.uint8)


@register_codec("sign")
class SignCodec(Codec):
    """Sizes divisible by 1024 go through the sign kernels (the JAX
    package's default ``use_pallas=True``).

    The JAX codec's approximate vote-count algebra (``aggregate``,
    ``agg_exact=False``) rides the async host wire and comes with it
    (ROADMAP queue 1 item 5); until then ``supports_aggregate`` keeps the
    base default False and the step always takes ``decode_sum``.
    """

    bucketable = True
    agg_exact = False

    def __init__(self, nonfinite: str = "propagate"):
        self.nonfinite = check_nonfinite_mode(nonfinite)

    @staticmethod
    def _kernel_ok(n: int) -> bool:
        return n > 0 and n % sign_ops.GROUP == 0

    def encode(self, grad, state=(), rng=None):
        flat = guard_nonfinite(grad.reshape(-1), self.nonfinite, "SignCodec")
        n = flat.numel()
        if self._kernel_ok(n):
            # fused: packed bits and the |g| sum in one read
            packed, abs_sum = sign_ops.encode_signs(flat.to(torch.float32))
            scale = abs_sum / n
        else:
            scale = flat.abs().mean()
            bits = (flat >= 0).to(torch.uint8)
            bits = torch.nn.functional.pad(bits, (0, _packed_len(n) * 8 - n))
            packed = (bits.reshape(-1, 8) * _bit_weights(flat.device)).sum(
                dim=1).to(torch.uint8)
        return {"packed": packed, "scale": scale.to(torch.float32)}, state

    def decode(self, payload, shape, dtype):
        n = numel(shape)
        if self._kernel_ok(n):
            # the decode-sum of one rank, as tern_unpack is
            g = sign_ops.unpack_signs_sum(payload["packed"].reshape(1, -1),
                                          payload["scale"].reshape(1))
            return g.to(dtype).reshape(shape)
        bits = (payload["packed"][:, None] & _bit_weights(
            payload["packed"].device)[None, :]) > 0
        scale = payload["scale"]
        g = torch.where(bits.reshape(-1)[:n], scale, -scale).to(dtype)
        return g.reshape(shape)

    def decode_sum(self, payloads, shape, dtype):
        """A float32 kernel-layout leaf: one ``unpack_signs_sum`` launch,
        bit for bit the JAX package's rank-ordered ``lax.scan`` fold,
        subnormals flushed as there. Any other leaf or dtype keeps the
        base class's fold, which casts each rank to ``dtype`` before it
        adds (so a bf16 leaf cannot take the float32 kernel) and keeps
        subnormals (ROADMAP queue 3 item 8)."""
        if self._kernel_ok(numel(shape)) and dtype == torch.float32:
            return sign_ops.unpack_signs_sum(
                payloads["packed"], payloads["scale"]).reshape(shape)
        return super().decode_sum(payloads, shape, dtype)

    def payload_bits(self, shape, dtype):
        return _packed_len(numel(shape)) * 8 + 32

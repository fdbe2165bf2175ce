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

import numpy as np
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
    """With ``use_pallas=True`` (the JAX default) sizes divisible by 1024
    go through the sign kernels; ``use_pallas=False`` packs every leaf in
    the flat layout (the name is the JAX codec's).

    The aggregation is the JAX codec's approximate vote count
    (``sign.py:101-161``): per-element positive votes in an int32
    counter and the summed scale, decoded once as ``mean(s)·(2·votes −
    W)``. It equals the sum of the decodes only where the frames' scales
    agree, so ``agg_exact`` is False: the training step never takes it,
    and the serve loop arms it only under an explicit ``agg="on"``. The
    kernel layout has no host-side unpack, so its units decline
    (:meth:`can_aggregate`) and such a wire decodes every push.
    """

    bucketable = True
    kernel_ops = ("sign",)
    supports_aggregate = True
    agg_exact = False

    def __init__(self, use_pallas: bool = True, nonfinite: str = "propagate"):
        self.use_pallas = use_pallas
        self.nonfinite = check_nonfinite_mode(nonfinite)

    def _kernel_ok(self, n: int) -> bool:
        return self.use_pallas and n > 0 and n % sign_ops.GROUP == 0

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

    # -- the vote-count algebra ---------------------------------------------
    def can_aggregate(self, shape, dtype) -> bool:
        return not self._kernel_ok(numel(shape))

    def aggregate(self, payloads, shape, dtype):
        """Positive-sign votes ``[n]`` int32 and the frames' summed scale,
        added in rank order."""
        n = numel(shape)
        packed = payloads["packed"]
        bits = (packed[..., None] & _bit_weights(packed.device)) > 0
        votes = bits.reshape(packed.shape[0], -1)[:, :n].to(torch.int32) \
            .sum(dim=0, dtype=torch.int32)
        scales = payloads["scale"].to(torch.float32).reshape(-1)
        scale_sum = scales[0]
        for w in range(1, scales.shape[0]):
            scale_sum = scale_sum + scales[w]
        return ({"votes": votes, "scale_sum": scale_sum},
                {"frames": int(packed.shape[0])})

    def agg_decode(self, agg_payload, meta, shape, dtype):
        w = meta["frames"]
        mean_scale = agg_payload["scale_sum"] / w
        out = (2 * agg_payload["votes"] - w).to(dtype) * mean_scale
        return out.to(dtype).reshape(shape)

    def agg_init(self, shape, dtype):
        from pytorch_ps_mpi_tpu_torch.utils import native

        n = numel(tuple(shape))
        return {"frames": 0, "votes": np.zeros(n, np.int32), "scale_sum": 0.0,
                "n": n, "lib": native.fold_lib()}

    def agg_fold(self, acc, payload):
        # integer votes: native (``wc_fold_sign``, little bit order as
        # np.unpackbits) and numpy are identical by construction
        from pytorch_ps_mpi_tpu_torch.utils import native

        packed = np.ascontiguousarray(payload["packed"], np.uint8).reshape(-1)
        if acc["lib"] is not None:
            native.fold_sign(acc["lib"], acc["votes"], packed)
        else:
            acc["votes"] += np.unpackbits(packed, count=acc["n"],
                                          bitorder="little")
        acc["scale_sum"] += float(payload["scale"])
        acc["frames"] += 1

    def agg_finalize(self, acc, shape, dtype):
        w = acc["frames"]
        mean_scale = np.float32(acc["scale_sum"] / w)
        out = (2 * acc["votes"] - w).astype(np.float32) * mean_scale
        return out.reshape(shape)

    def payload_bits(self, shape, dtype):
        return _packed_len(numel(shape)) * 8 + 32

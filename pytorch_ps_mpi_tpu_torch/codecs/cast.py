"""Cast codecs: gradients ride the wire in a narrower float dtype
(``pytorch_ps_mpi_tpu/codecs/cast.py``).

``Bf16Codec.supports_psum`` holds through its ``wire_dtype``: the step's
all_reduce narrows to bf16 and casts back, so the cast that is this
codec's encode is applied to the wire rather than skipped. ``F16Codec``
clips to f16's range before the cast and therefore takes the
all_gather + decode path, where the clip always runs.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import (Codec, dense_agg_finalize,
                                               dense_agg_init, numel,
                                               register_codec)


@register_codec("bf16")
class Bf16Codec(Codec):
    supports_psum = True
    bucketable = True           # a cast is elementwise
    supports_aggregate = True   # cast up, then sum: exact

    wire_dtype = torch.bfloat16

    def encode(self, grad, state=(), rng=None):
        return grad.to(self.wire_dtype), state

    def decode(self, payload, shape, dtype):
        return payload.to(dtype).reshape(shape)

    def decode_sum(self, payloads, shape, dtype):
        # cast up BEFORE the sum, as the all_reduce path does
        return payloads.to(dtype).sum(dim=0).reshape(shape)

    def aggregate(self, payloads, shape, dtype):
        return (payloads.to(dtype).sum(dim=0),
                {"frames": int(payloads.shape[0])})

    def agg_decode(self, agg_payload, meta, shape, dtype):
        return agg_payload.to(dtype).reshape(shape)

    # streaming: each frame cast up to f32 and added, decode_sum's
    # cast-before-sum rule; bf16 has the native fused cast-up + add (a
    # bf16 is the top half of the equal f32), f16 the numpy path
    def agg_init(self, shape, dtype):
        return dense_agg_init(shape,
                              native_fold=self.wire_dtype == torch.bfloat16)

    def agg_fold(self, acc, payload):
        from pytorch_ps_mpi_tpu_torch.utils import native

        x = np.asarray(payload).reshape(-1)
        if self.wire_dtype == torch.bfloat16:
            bits = x.view(np.uint16)
            if acc["lib"] is not None and bits.flags.c_contiguous:
                native.fold_dense_bf16(acc["lib"], acc["acc"], bits)
            else:
                acc["acc"] += (bits.astype(np.uint32) << 16).view(np.float32)
        else:
            acc["acc"] += x.astype(np.float32)
        acc["frames"] += 1

    def agg_finalize(self, acc, shape, dtype):
        return dense_agg_finalize(acc, shape, dtype)

    def payload_bits(self, shape, dtype):
        return numel(shape) * self.wire_dtype.itemsize * 8


@register_codec("f16")
class F16Codec(Bf16Codec):
    """IEEE half. ``encode`` clips to ±65504 in f32 first, so a large
    gradient cannot overflow to inf on the wire."""

    supports_psum = False
    wire_dtype = torch.float16

    def encode(self, grad, state=(), rng=None):
        m = float(torch.finfo(torch.float16).max)
        return grad.to(torch.float32).clamp(-m, m).to(self.wire_dtype), state

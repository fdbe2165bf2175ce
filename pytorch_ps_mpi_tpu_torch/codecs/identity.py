"""Identity codec: gradients ride the wire as they are
(``pytorch_ps_mpi_tpu/codecs/identity.py``). ``supports_psum`` lets the
step sum with one all_reduce instead of all_gather + decode + sum."""

from __future__ import annotations

import numpy as np

from pytorch_ps_mpi_tpu_torch.codecs.base import (Codec, dense_agg_finalize,
                                               dense_agg_init, register_codec)


@register_codec("identity")
class IdentityCodec(Codec):
    supports_psum = True
    bucketable = True
    supports_aggregate = True  # aggregation IS the sum: exact

    def encode(self, grad, state=(), rng=None):
        return grad, state

    def decode(self, payload, shape, dtype):
        return payload.to(dtype).reshape(shape)

    def decode_sum(self, payloads, shape, dtype):
        return payloads.sum(dim=0).to(dtype).reshape(shape)

    def aggregate(self, payloads, shape, dtype):
        return payloads.sum(dim=0), {"frames": int(payloads.shape[0])}

    def agg_decode(self, agg_payload, meta, shape, dtype):
        return agg_payload.to(dtype).reshape(shape)

    # streaming: one running f32 accumulator, the native dense fold
    def agg_init(self, shape, dtype):
        return dense_agg_init(shape)

    def agg_fold(self, acc, payload):
        from pytorch_ps_mpi_tpu_torch.utils import native

        x = np.asarray(payload).reshape(-1)
        if (acc["lib"] is not None and x.dtype == np.float32
                and x.flags.c_contiguous):
            native.fold_dense_f32(acc["lib"], acc["acc"], x)
        else:
            acc["acc"] += x
        acc["frames"] += 1

    def agg_finalize(self, acc, shape, dtype):
        return dense_agg_finalize(acc, shape, dtype)

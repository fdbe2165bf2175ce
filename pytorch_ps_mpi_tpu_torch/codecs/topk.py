"""Top-k sparsification codec (``pytorch_ps_mpi_tpu/codecs/topk.py``).

Keeps the k largest-magnitude entries of the flattened gradient. k is
fixed per leaf, so the payload (values[k], int32 indices[k]) has a static
shape and rides an all-gather with no size exchange.
"""

from __future__ import annotations

import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import Codec, numel, register_codec
from pytorch_ps_mpi_tpu_torch.ops import topk as topk_ops


def scatter_add_ranks(values: torch.Tensor, indices: torch.Tensor,
                      frames: int, span: int, dtype) -> torch.Tensor:
    """The sparse index-merge's decode: ``frames`` ranks' (values, indices)
    pairs, concatenated in rank order, scatter-added into zeros[span].

    A scatter-add folded rank by rank: a rank's indices are unique (or
    carry only zeros where they repeat), so each ``index_add_`` is
    deterministic, and the sum at an index shared by ranks is taken in
    rank order, as the JAX package's one scatter-add over the
    concatenation takes it. One ``index_add_`` over the whole
    concatenation would sum repeated indices with atomics, in an order
    that changes from run to run on the card."""
    values = values.reshape(frames, -1).to(dtype)
    indices = indices.reshape(frames, -1).long()
    flat = torch.zeros(span, dtype=dtype, device=values.device)
    for r in range(frames):
        flat.index_add_(0, indices[r], values[r])
    return flat


@register_codec("topk")
class TopKCodec(Codec):
    """The constructor's keywords and their meanings are the JAX codec's.

    - ``pallas=True`` selects by threshold (``ops/topk.py``: find the
      exact k-th |g|, then a compaction takes the strict survivors and
      the first threshold ties in index order). On the card both are the
      CUDA radix select and compaction; the name ``pallas`` is the JAX
      package's, kept so both packages take the same arguments.
    - Otherwise selection is a full stable sort of |g|: ``lax.top_k``'s
      result, ties lower index first.
    - ``approx=True`` asks for ``lax.approx_max_k``, which gives the exact
      result off the TPU; so it does here: the same sort.

    Both selections give the same value multiset; they differ only in
    which tied elements they take.
    """

    # SparCML index-merge: the aggregate is the ranks' pairs concatenated
    supports_aggregate = True

    def __init__(self, k: int = 0, fraction: float = 0.0, approx: bool = False,
                 pallas: bool = False):
        if (k <= 0) == (fraction <= 0.0):
            raise ValueError("give exactly one of k>0 or 0<fraction<=1")
        if approx and pallas:
            raise ValueError("approx and pallas are alternative selection "
                             "strategies; pick one")
        self.k = int(k)
        self.fraction = float(fraction)
        self.approx = bool(approx)
        self.pallas = bool(pallas)

    def _k_for(self, shape) -> int:
        n = numel(shape)
        k = self.k if self.k > 0 else max(1, int(round(n * self.fraction)))
        return min(k, n)

    def encode(self, grad, state=(), rng=None):
        flat = grad.reshape(-1)
        k = self._k_for(tuple(grad.shape))
        if self.pallas:
            values, indices = topk_ops.exact_topk(flat, k)
        else:
            values, indices = topk_ops.sorted_topk(flat, k)
        return {"values": values, "indices": indices}, state

    def _span(self, n: int) -> int:
        """Length of the buffer decode scatters into: ``n``, or more where
        a payload carries indices past the leaf (block top-k's pad slots),
        which land there and are sliced off, as the JAX scatter's
        ``mode='drop'`` drops them."""
        return n

    def decode(self, payload, shape, dtype):
        # set semantics, as .at[].set: this codec's indices are unique
        n = numel(shape)
        flat = torch.zeros(self._span(n), dtype=dtype,
                           device=payload["values"].device)
        flat[payload["indices"].long()] = payload["values"].to(dtype)
        return flat[:n].reshape(shape)

    def decode_sum(self, payloads, shape, dtype):
        agg, meta = self.aggregate(payloads, shape, dtype)
        return self.agg_decode(agg, meta, shape, dtype)

    def aggregate(self, payloads, shape, dtype):
        # the ranks' (values, indices) pairs concatenated in rank order,
        # sized world * k, never n
        idx = payloads["indices"]
        return {"values": payloads["values"].reshape(-1),
                "indices": idx.reshape(-1)}, {"frames": int(idx.shape[0])}

    def agg_decode(self, agg_payload, meta, shape, dtype):
        n = numel(shape)
        return scatter_add_ranks(agg_payload["values"], agg_payload["indices"],
                                 meta["frames"], self._span(n), dtype)[:n] \
            .reshape(shape)

    def payload_bits(self, shape, dtype):
        k = self._k_for(shape)
        return k * (dtype.itemsize * 8 + 32)

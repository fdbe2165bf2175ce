"""Blockwise top-k sparsification (``pytorch_ps_mpi_tpu/codecs/blocktopk.py``).

The flat gradient is viewed as ``[n_blocks, block_size]`` (the tail block
zero-padded) and each block keeps its own top ``round(block_size *
fraction)`` entries by |g|, so selection is a batched sort over rows with
no cross-block traffic. A leaf no larger than one block takes plain
top-k. The wire format is top-k's (values[k], int32 global indices[k]);
a pick in a pad slot carries an index >= n, which decode scatters past
the leaf and drops, as the JAX scatter's ``mode='drop'`` does.

Selection is ``lax.top_k``'s per row: a stable descending sort of the
|g| keys of each block (``ops.topk.magnitude_keys``), so ties come lower
index first, and the index set is the JAX package's bit for bit.

``blocktopk8`` sends the survivors as int8 codes with one float32 scale
per block, ``max(max|v| * f32(1/127), 1e-12)`` as the jitted JAX encode
computes it (ROADMAP queue 3 item 3), rounding half to even.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import (numel, register_codec,
                                               sparse_agg_fold)
from pytorch_ps_mpi_tpu_torch.codecs.topk import TopKCodec
from pytorch_ps_mpi_tpu_torch.ops import topk as topk_ops


@register_codec("blocktopk")
class BlockTopKCodec(TopKCodec):
    order_dependent = True

    def __init__(self, fraction: float = 0.01, block_size: int = 1024,
                 approx: bool = False):
        """``approx=True`` asks for ``lax.approx_max_k``, which is exact
        off the TPU; so it is here."""
        super().__init__(fraction=fraction, approx=approx)
        if block_size <= 0 or block_size % 128:
            raise ValueError("block_size must be a positive multiple of 128")
        self.block_size = int(block_size)

    def _block_k(self) -> int:
        return max(1, int(round(self.block_size * self.fraction)))

    def _n_blocks(self, n: int) -> int:
        """1 is the single-block plain top-k regime."""
        return 1 if n <= self.block_size else -(-n // self.block_size)

    def _k_for(self, shape) -> int:
        """The payload length: the block k times the blocks, not capped at
        n (a ragged tail block still sends its pad-slot picks)."""
        nb = self._n_blocks(numel(shape))
        return super()._k_for(shape) if nb == 1 else nb * self._block_k()

    def _span(self, n: int) -> int:
        nb = self._n_blocks(n)
        return n if nb == 1 else nb * self.block_size

    def encode(self, grad, state=(), rng=None):
        flat = grad.reshape(-1)
        n = flat.numel()
        nb = self._n_blocks(n)
        if nb == 1:
            return super().encode(grad, state, rng)  # plain top-k
        blocks = torch.nn.functional.pad(
            flat, (0, nb * self.block_size - n)).view(nb, self.block_size)
        _, order = torch.sort(topk_ops.magnitude_keys(blocks), dim=1,
                              descending=True, stable=True)
        local = order[:, :self._block_k()]
        glob = (torch.arange(nb, dtype=torch.int32, device=flat.device)[:, None]
                * self.block_size + local.to(torch.int32))
        return {"values": torch.gather(blocks, 1, local).reshape(-1),
                "indices": glob.reshape(-1)}, state


@register_codec("blocktopk8")
class BlockTopK8Codec(BlockTopKCodec):
    """Block top-k survivors as int8 codes with a per-block scale
    (``blocktopk.py:107-164``)."""

    def encode(self, grad, state=(), rng=None):
        payload, state = super().encode(grad, state, rng)
        v = payload["values"]  # plain top-k's [k] where there is one block
        kb = (v.numel() if self._n_blocks(grad.numel()) == 1
              else self._block_k())
        blocks = v.reshape(-1, kb).to(torch.float32)
        scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) * (1 / 127),
                            min=1e-12)
        r = torch.clamp(torch.round(blocks / scale), -127, 127)
        q = torch.where(torch.isnan(r), 0.0, r).to(torch.int8)
        return {"values": q.reshape(-1), "scale": scale,
                "indices": payload["indices"]}, state

    @staticmethod
    def _dequant(payload, dtype) -> torch.Tensor:
        """int8 [.., k] times scale [.., nb, 1] -> [.., k] (a leading rank
        axis kept)."""
        q = payload["values"]
        nb = payload["scale"].shape[-2]
        blocks = q.reshape(q.shape[:-1] + (nb, -1)).to(torch.float32)
        return (blocks * payload["scale"]).reshape(q.shape).to(dtype)

    def decode(self, payload, shape, dtype):
        return super().decode({"values": self._dequant(payload, dtype),
                               "indices": payload["indices"]}, shape, dtype)

    def aggregate(self, payloads, shape, dtype):
        # dequantize each rank's survivors, then top-k's index-merge
        return super().aggregate({"values": self._dequant(payloads, dtype),
                                  "indices": payloads["indices"]},
                                 shape, dtype)

    def agg_fold(self, acc, payload):
        # the survivors' per-block dequantize and the scatter-add: one
        # native pass (``wc_fold_sparse_q8``), or numpy's dequantize and
        # the shared fold
        from pytorch_ps_mpi_tpu_torch.utils import native

        q = np.asarray(payload["values"])
        scale = np.asarray(payload["scale"], np.float32)
        if acc.get("lib") is not None:
            idx = np.array(payload["indices"], np.int32,
                           copy=True).reshape(-1)
            native.fold_sparse_q8(acc["lib"], acc["acc"],
                                  np.ascontiguousarray(q, np.int8)
                                  .reshape(-1),
                                  np.ascontiguousarray(scale).reshape(-1),
                                  idx, acc_ptr=acc["ptr"])
            acc["touched"].append(idx)
            acc["frames"] += 1
            return
        val = (q.reshape(scale.shape[0], -1).astype(np.float32)
               * scale).reshape(-1)
        sparse_agg_fold(acc, val, payload["indices"])

    def payload_bits(self, shape, dtype):
        return (self._k_for(shape) * (8 + 32)
                + self._n_blocks(numel(shape)) * 32)

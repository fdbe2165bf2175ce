"""PowerSGD: low-rank gradient compression (Vogels et al. 2019;
``pytorch_ps_mpi_tpu/codecs/powersgd.py``).

Each gradient of two or more dims, viewed as a matrix M [n, m] (the first
non-singleton dim by the rest), is approximated as P·Qᵀ of rank r: one
power-iteration step against the warm Q of the previous round,
orthonormalized by a QR. Error feedback is built in: the residual is
codec state, added back next round. Leaves below
``min_compression_elems``, vectors and scalars ride uncompressed.

Two protocols, as in the JAX package:

- ``fused_allreduce``, the paper's all-reduced form, which ``MPI_PS``
  runs: every rank holds the same Q, so ``P = all_reduce(M_w·Q)``, QR,
  ``Q = all_reduce(M_wᵀ·P̂)`` give the rank-r approximation of the summed
  gradient, ``P̂·Qᵀ``, in two all-reduces of rank-sized factors whatever
  the world; each rank keeps ``corrected − P̂·Q_wᵀ`` as its residual;
- ``encode``/``decode_sum``: each rank sends its own (P_w, Q_w) and the
  receiver sums the W approximations through one product of the factors
  concatenated side by side (the async wire's form).

The warm-start Q of a leaf is a standard normal [m, r] drawn on the CPU
from a generator seeded with ``hash((n, m, r)) % 2**31``, the JAX
package's key (Python's hash of a tuple of ints does not depend on
``PYTHONHASHSEED``), then moved to the leaf's device: every rank, and
the card and the CPU, hold the same Q. It is not the JAX package's
draw; ``utils.interop.codec_state_from_jax`` carries that across.

``torch.linalg.qr`` stands for ``jnp.linalg.qr``; the signs of its
columns may differ from LAPACK's, which changes P and Q but not P̂·Qᵀ nor
the residual (ROADMAP queue 3 item 10).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.codecs.base import Codec, numel, register_codec


def _matrix_shape(shape) -> Tuple[int, int]:
    """The matrix view [n, m] of a tensor: its first dim by the rest,
    skipping leading singleton dims (``powersgd.py:44``)."""
    i = 0
    while i < len(shape) - 1 and shape[i] == 1:
        i += 1
    return shape[i], math.prod(shape[i + 1:])


def warm_seed(n: int, m: int, r: int) -> int:
    """The seed of a leaf's warm-start Q, the JAX package's key."""
    return hash((n, m, r)) % 2**31


@register_codec("powersgd")
class PowerSGDCodec(Codec):
    supports_fused_allreduce = True
    # factor-domain aggregation: W rank-r payloads concatenate into one
    # rank-W·r factor pair whose single product is Σ_w P_w Q_wᵀ
    supports_aggregate = True
    order_dependent = True

    def __init__(self, rank: int = 2, min_compression_elems: int = 1024):
        self.rank = int(rank)
        self.min_elems = int(min_compression_elems)

    def _compresses(self, shape) -> bool:
        if len(shape) < 2:
            return False
        n, m = _matrix_shape(shape)
        r = min(self.rank, n, m)
        return n * m >= self.min_elems and r * (n + m) < n * m

    def init_state(self, shape, dtype, device=None):
        if not self._compresses(shape):
            return ()
        n, m = _matrix_shape(shape)
        r = min(self.rank, n, m)
        gen = torch.Generator().manual_seed(warm_seed(n, m, r))
        q = torch.randn((m, r), generator=gen, dtype=dtype)
        return {"Q": q.to(device),
                "memory": torch.zeros(shape, dtype=dtype, device=device)}

    def encode(self, grad, state=(), rng=None):
        if not self._compresses(grad.shape):
            return {"raw": grad}, state
        corrected = grad + state["memory"]
        M = corrected.reshape(_matrix_shape(grad.shape))
        P, _ = torch.linalg.qr(M @ state["Q"])
        Q = M.T @ P
        decoded = (P @ Q.T).reshape(grad.shape)
        return {"P": P, "Q": Q}, {"Q": Q, "memory": corrected - decoded}

    def fused_allreduce(self, grad, state, comm_dtype: Optional[torch.dtype]
                        = None, group=None):
        """``(summed, new_state)``: the rank-r approximation of the sum of
        the ranks' gradients, by two all-reduces of the factors
        (``powersgd.py:106-139``). ``comm_dtype`` narrows the all-reduce
        of an uncompressed leaf; the factors keep their dtype. ``group``:
        the ``mesh.Group`` the sum spans (default: every rank)."""
        if not self._compresses(grad.shape):
            if comm_dtype is not None:
                return comms.allreduce_sum(grad.to(comm_dtype), group).to(
                    grad.dtype), state
            return comms.allreduce_sum(grad, group), state
        corrected = grad + state["memory"]
        M = corrected.reshape(_matrix_shape(grad.shape))
        # Q is the same on every rank, so this is (Σ M_w)·Q
        P, _ = torch.linalg.qr(comms.allreduce_sum(M @ state["Q"], group))
        Qw = M.T @ P
        Q = comms.allreduce_sum(Qw, group)
        summed = (P @ Q.T).reshape(grad.shape)
        # this rank's share of the decode is P̂·Q_wᵀ; the shares sum to it
        return summed, {"Q": Q,
                        "memory": corrected - (P @ Qw.T).reshape(grad.shape)}

    def fused_wire_bits(self, shape, dtype,
                        comm_dtype: Optional[torch.dtype] = None) -> int:
        """Bits a rank sends in one two-all-reduce round, whatever the
        world (``powersgd.py:141-153``)."""
        if not self._compresses(shape):
            return numel(shape) * (comm_dtype or dtype).itemsize * 8
        return self.payload_bits(shape, dtype)

    def decode(self, payload, shape, dtype):
        if "raw" in payload:
            return payload["raw"].to(dtype)
        return (payload["P"] @ payload["Q"].T).reshape(shape).to(dtype)

    def decode_sum(self, payloads, shape, dtype):
        agg, meta = self.aggregate(payloads, shape, dtype)
        return self.agg_decode(agg, meta, shape, dtype)

    def aggregate(self, payloads, shape, dtype):
        if "raw" in payloads:
            raw = payloads["raw"]
            acc = raw[0].clone()
            for w in range(1, raw.shape[0]):  # rank order, as XLA's reduce
                acc.add_(raw[w])
            return {"raw": acc}, {"frames": int(raw.shape[0])}
        w, n, r = payloads["P"].shape
        m = payloads["Q"].shape[1]
        # [w, n, r] -> [n, w·r]: the ranks' factors side by side
        return ({"P": payloads["P"].permute(1, 0, 2).reshape(n, w * r),
                 "Q": payloads["Q"].permute(1, 0, 2).reshape(m, w * r)},
                {"frames": int(w)})

    def agg_decode(self, agg_payload, meta, shape, dtype):
        if "raw" in agg_payload:
            return agg_payload["raw"].to(dtype)
        return (agg_payload["P"] @ agg_payload["Q"].T).reshape(shape).to(dtype)

    def payload_bits(self, shape, dtype):
        if not self._compresses(shape):
            return numel(shape) * dtype.itemsize * 8
        n, m = _matrix_shape(shape)
        return min(self.rank, n, m) * (n + m) * dtype.itemsize * 8

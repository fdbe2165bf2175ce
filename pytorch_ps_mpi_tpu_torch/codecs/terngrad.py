"""TernGrad codec: stochastic ternary gradients, 2 bits an element
(``pytorch_ps_mpi_tpu/codecs/terngrad.py``; Wen et al. 2017).

Each element becomes ``s·sign(g)·b`` with ``b ~ Bernoulli(|g|/s)`` and
``s = max|g|``, an unbiased estimate (``E[decode] = g``). The payload is
``{"packed": uint8[ceil(n/4)], "scale": float32}``, in one of the JAX
codec's two layouts, chosen per leaf by :meth:`TernGradCodec._pallas_ok`:

- the **sublane layout** (``use_pallas=True`` and ``n % 512 == 0``):
  digit ``s`` of byte ``[r, lane]`` holds element ``r*512 + s*128 +
  lane``; packed and unpacked by the kernels of ``ops/tern.py``, fed
  uint32 random bits (``keep = (u >> 8) < |g|·2**24/s``);
- the **flat layout** (every other leaf): four consecutive elements a
  byte, in plain PyTorch ops as the JAX codec uses jnp there, fed f32
  uniforms (``keep = u < |g|/s``).

Leaves of at least ``scan_threshold`` elements encode chunk by chunk
(``terngrad.py:127-186``): the pack runs ``scan_block`` elements at a
time, so no n-sized float temporary exists, and each chunk gets its own
random numbers. The chunks' packs together are the whole-tensor layout.

A sublane-layout leaf in ``nonfinite="propagate"`` (the default) of
float32 or bf16 is read by the kernels in its own type, with no cast:
below ``scan_threshold`` one ``tern_encode`` launch computes the scale
and packs; above it, one ``tern_scale`` launch over the leaf, then one
``tern_pack`` a chunk, each writing its slice of the leaf's payload.
Other types and the ``"zero"``/``"raise"`` modes cast to float32 and
guard first, then take the same kernels.

``encode`` draws its random numbers from the step's ``torch.Generator``
and hands them to :meth:`TernGradCodec.ternarize`, a pure function of
the gradient and the numbers, so a test can feed it the JAX encode's own
draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pytorch_ps_mpi_tpu_torch.codecs.base import (
    Codec,
    check_nonfinite_mode,
    dense_agg_finalize,
    dense_agg_init,
    guard_nonfinite,
    numel,
    register_codec,
)
from pytorch_ps_mpi_tpu_torch.ops import tern as tern_ops

_WEIGHTS = (1, 4, 16, 64)  # base-4 digit weights, 4 ternary digits a byte

#: ``noise(chunk, size)``: the random numbers of one encode, ``chunk`` the
#: chunk's index or None for a whole-tensor encode; int32 bits (uint32
#: patterns) for the sublane layout, f32 uniforms in [0, 1) for the flat
Noise = Callable[[Optional[int], int], torch.Tensor]


def _packed_len(n: int) -> int:
    return (n + 3) // 4


def _pack_flat(g: torch.Tensor, scale: torch.Tensor,
               uniforms: torch.Tensor) -> torch.Tensor:
    """Flat layout: 4 consecutive digits a byte, the tail padded with
    digit 1 (value 0)."""
    keep = uniforms < g.abs() / scale
    digit = torch.where(keep, torch.where(g >= 0, 2, 0), 1).to(torch.int32)
    pad = _packed_len(g.numel()) * 4 - g.numel()
    if pad:
        digit = torch.cat([digit, digit.new_ones(pad)])
    weights = torch.tensor(_WEIGHTS, dtype=torch.int32, device=g.device)
    return (digit.reshape(-1, 4) * weights).sum(dim=1).to(torch.uint8)


def _unpack_flat(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Flat layout -> int32 ternaries ``[n]``."""
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=packed.device)
    digits = (packed.to(torch.int32)[:, None] >> shifts) & 3
    return digits.reshape(-1)[:n] - 1


@register_codec("terngrad")
class TernGradCodec(Codec):
    kernel_ops = ("tern",)
    needs_rng = True
    bucketable = True
    supports_aggregate = True

    def __init__(self, nonfinite: str = "propagate",
                 scan_block: int = 1 << 20, scan_threshold: int = 0,
                 use_pallas: bool = False):
        """``scan_block``/``scan_threshold``: leaves of at least
        ``scan_threshold`` elements (default ``4 * scan_block``) encode
        ``scan_block`` elements at a time. ``use_pallas=True`` puts
        leaves whose size divides by 512 in the sublane layout, packed by
        the kernels of ``ops/tern.py`` (the name is the JAX codec's)."""
        self.nonfinite = check_nonfinite_mode(nonfinite)
        if scan_block <= 0 or scan_block % 4:
            raise ValueError("scan_block must be a positive multiple of 4")
        self.scan_block = int(scan_block)
        self.scan_threshold = (int(scan_threshold) if scan_threshold > 0
                               else 4 * self.scan_block)
        self.use_pallas = bool(use_pallas)

    def _pallas_ok(self, n: int) -> bool:
        # 512 = one packed row (4 sublanes × 128 lanes). Above the scan
        # threshold the chunks must divide into rows too: with
        # scan_block % 512 == 0 every full chunk and the ragged tail
        # inherit n's divisibility, and the per-chunk packs concatenate
        # into exactly the whole-tensor layout
        if not (self.use_pallas and n > 0 and n % 512 == 0):
            return False
        return n < self.scan_threshold or self.scan_block % 512 == 0

    # -- encode -------------------------------------------------------------
    def encode(self, grad, state=(), rng: Optional[torch.Generator] = None):
        if rng is None:
            raise ValueError("TernGradCodec needs a torch.Generator")
        sublane = self._pallas_ok(grad.numel())

        def noise(chunk, size):
            if sublane:
                return torch.randint(-2**31, 2**31, (size,), dtype=torch.int32,
                                     device=grad.device, generator=rng)
            return torch.rand(size, generator=rng, device=grad.device)

        return self.ternarize(grad, noise), state

    def ternarize(self, grad: torch.Tensor, noise: Noise):
        """The payload of ``grad`` for the random numbers ``noise`` gives
        (see :data:`Noise`)."""
        g = grad.reshape(-1)
        n = g.numel()
        sublane = self._pallas_ok(n)
        if not (sublane and self.nonfinite == "propagate"
                and g.dtype in tern_ops.DTYPES):
            g = guard_nonfinite(g.to(torch.float32), self.nonfinite,
                                "TernGradCodec")
        if not sublane:
            return self._ternarize_flat(g, noise)
        if not g.is_contiguous():  # a strided 1-D view: the kernels raise
            g = g.contiguous()
        if n < self.scan_threshold:
            packed, scale = tern_ops.tern_encode(g, noise(None, n))
            return {"packed": packed, "scale": scale}
        scale = tern_ops.tern_scale(g)
        packed = torch.empty(n // 4, dtype=torch.uint8, device=g.device)
        for i, start in enumerate(range(0, n, self.scan_block)):
            stop = min(start + self.scan_block, n)
            tern_ops.tern_pack(g[start:stop], noise(i, stop - start), scale,
                               out=packed[start // 4:stop // 4])
        return {"packed": packed, "scale": scale}

    def _ternarize_flat(self, g: torch.Tensor, noise: Noise):
        n = g.numel()
        if n < self.scan_threshold:
            scale = torch.clamp(g.abs().amax(), min=1e-12)  # NaN propagates
            return {"packed": _pack_flat(g, scale, noise(None, n)),
                    "scale": scale}
        chunks = torch.split(g, self.scan_block)
        scale = torch.full((), 1e-12, device=g.device)
        for c in chunks:
            scale = torch.maximum(scale, c.abs().amax())
        packed = torch.cat([_pack_flat(c, scale, noise(i, c.numel()))
                            for i, c in enumerate(chunks)])
        return {"packed": packed, "scale": scale}

    # -- decode and aggregate ----------------------------------------------
    def decode(self, payload, shape, dtype):
        n = numel(shape)
        if self._pallas_ok(n):
            return tern_ops.tern_unpack(payload["packed"], payload["scale"]) \
                .to(dtype).reshape(shape)
        tern = _unpack_flat(payload["packed"], n)
        return (tern.to(dtype) * payload["scale"].to(dtype)).reshape(shape)

    def decode_sum(self, payloads, shape, dtype):
        agg, meta = self.aggregate(payloads, shape, dtype)
        return self.agg_decode(agg, meta, shape, dtype)

    def aggregate(self, payloads, shape, dtype):
        """Σ_w (digit_w − 1)·s_w over the ``[world, ...]`` stack in rank
        order: one ``tern_unpack_sum`` launch for a sublane-layout leaf,
        plain ops for a flat one."""
        n = numel(shape)
        packed = payloads["packed"]
        scales = payloads["scale"].to(torch.float32).reshape(-1)
        if self._pallas_ok(n):
            acc = tern_ops.tern_unpack_sum(packed, scales)
        else:
            acc = _unpack_flat(packed[0], n).to(torch.float32) * scales[0]
            for w in range(1, packed.shape[0]):
                acc = acc + _unpack_flat(packed[w], n).to(torch.float32) \
                    * scales[w]
        return {"acc": acc}, {"frames": int(packed.shape[0])}

    def agg_decode(self, agg_payload, meta, shape, dtype):
        return agg_payload["acc"].to(dtype).reshape(shape)

    # streaming: scale × ternary folded into one f32 accumulator a push
    # (``terngrad.py:244-295``). The native fold knows the flat layout
    # only, so a sublane-layout unit takes a layout-aware numpy unpack.
    def agg_init(self, shape, dtype):
        return dense_agg_init(shape)

    def agg_fold(self, acc, payload):
        from pytorch_ps_mpi_tpu_torch.utils import native

        packed = np.ascontiguousarray(payload["packed"], np.uint8).reshape(-1)
        scale = np.float32(payload["scale"])
        weights = np.asarray(_WEIGHTS, np.uint8)
        if self._pallas_ok(acc["n"]):
            digits = (packed.reshape(-1, 128)[:, None, :]
                      // weights[None, :, None]) % 4
            tern = digits.reshape(-1)[:acc["n"]].astype(np.int8) - 1
            acc["acc"] = acc["acc"] + tern.astype(np.float32) * scale
        elif acc["lib"] is not None:
            native.fold_tern(acc["lib"], acc["acc"], packed, scale)
        else:
            digits = (packed[:, None] // weights[None, :]) % 4
            tern = digits.reshape(-1)[:acc["n"]].astype(np.int8) - 1
            np.multiply(tern, scale, out=acc["tmp"])
            acc["acc"] += acc["tmp"]
        acc["frames"] += 1

    def agg_finalize(self, acc, shape, dtype):
        return dense_agg_finalize(acc, shape, dtype)

    def payload_bits(self, shape, dtype):
        return _packed_len(numel(shape)) * 8 + 32

"""Int8 symmetric quantize and dequantize-sum: CUDA kernels and their
plain PyTorch versions.

The hot path of ``Int8Codec`` and ``QSGDCodec``. Each wrapper replaces
Pallas TPU kernels of ``pytorch_ps_mpi_tpu/ops/quant_pallas.py``:

===================  ===========================================  =====================
wrapper              replaces                                     kernel
===================  ===========================================  =====================
``quantize_int8``    ``quantize_int8`` (``quant_pallas.py:64``:   ``csrc/quant.cu``
                     ``_absmax_kernel`` ``:84``, ``_quant_kernel``  ``quant_int8``
                     ``:97``), both in one launch
``dequant_sum``      ``dequantize_int8`` (``:118``, ``:130``) at  ``dequant_sum``
                     world 1, and ``_ScaleFoldedInt8``'s
                     ``einsum("wn,w->n")`` (``codecs/quant.py:61``)
``dequantize_int8``  ``dequantize_int8``: ``dequant_sum`` of one  ``dequant_sum``
                     rank
===================  ===========================================  =====================

Semantics, the JAX package's as XLA compiles it (its jitted step, and
its Pallas kernel at every size): ``s = max(max|x| * f32(1/127), 1e-12)``
in float32 with NaN propagating (the source divides by 127.0, which XLA
folds into a product with the reciprocal; run op by op, the JAX codec
divides, and its scale can then differ in the last bit),
``q = clip(round_half_even(x / s), ±127)`` as int8 with NaN
codes 0 (XLA's float-to-int8 conversion), and the dequantize-sum
``Σ_w f32(q_w)·s_w`` taken in rank order. The kernels take every size
n > 0; there is no size at which a plain path takes over on the card.

Bound: memory. Quantize needs 5n + 4 bytes and reads x once, in one
device launch (one block up to the kernel's tile, a cooperative grid
with one grid barrier above it); dequantize-sum needs (W + 4)·n + 4W
bytes. The design notes are in ``csrc/quant.cu``.

A wrapper takes its plain version (``*_ref``) only for a CPU tensor. For
a CUDA tensor it launches its kernel or raises; it never falls back.
Each wrapper's ``launches`` attribute counts its kernel launches;
``dequantize_int8`` launches the ``dequant_sum`` kernel and counts in
``dequant_sum.launches``. A small leaf's call is mostly host cost, so
every wrapper checks by attribute, allocates once and launches through
``_build.launch`` (the raw stream handle, one ctypes call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pytorch_ps_mpi_tpu_torch.ops import _build

_P = ctypes.c_void_p
_SIGNATURES = {
    "quant_int8": (ctypes.c_int, [_P, _P, ctypes.c_longlong, _P]),
    "quant_int8_tile": (ctypes.c_int, []),
    "quant_int8_grid": (ctypes.c_longlong, [ctypes.c_longlong]),
    "dequant_sum": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_longlong,
                                   _P, _P]),
}


# -- plain versions (CPU path, and the yardstick the kernels are held to) ----

def quantize_int8_ref(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32[n] -> (int8[n] codes, float32 scale)."""
    # max|x| * f32(1/127) (a float32 tensor times a Python scalar rounds
    # the scalar to float32 first), floored at 1e-12; NaN propagates
    scale = torch.clamp(flat.abs().amax() * (1 / 127), min=1e-12)
    r = torch.clamp(torch.round(flat / scale), -127, 127)  # half to even
    return torch.where(torch.isnan(r), 0.0, r).to(torch.int8), scale


def dequant_sum_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8[world, n], float32[world] -> float32[n] = Σ_w f32(q_w)·s_w,
    a left fold in rank order."""
    acc = torch.zeros(q.shape[1], dtype=torch.float32, device=q.device)
    for w in range(q.shape[0]):
        acc = acc + q[w].to(torch.float32) * scales[w]
    return acc


# -- kernel wrappers -------------------------------------------------------

def _lib() -> ctypes.CDLL:
    return _build.load("quant", _SIGNATURES)


def _check(x: torch.Tensor, dtype: torch.dtype, dim: int, what: str) -> None:
    if x.dim() != dim or x.dtype != dtype or x.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty {dim}-D {dtype} "
                         f"tensor, got {x.dtype}{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


@functools.lru_cache(maxsize=None)
def _tile() -> int:
    """Floats one block of the quantize kernel holds."""
    return _lib().quant_int8_tile()


def quantize_int8(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32[n] -> (int8[n] codes, float32 scale), the scale computed on
    the device (no host sync). On the card both are views of one buffer:
    the codes, the scale at the next 4-byte boundary, then one int32 slot
    a block where the cooperative grid needs them."""
    # checks by attribute comparison: a small leaf's call is mostly host cost
    if flat.dtype is not torch.float32 or flat.dim() != 1 \
            or flat.shape[0] == 0:
        raise ValueError(f"quantize_int8: expected a non-empty 1-D "
                         f"torch.float32 tensor, got "
                         f"{flat.dtype}{tuple(flat.shape)}")
    if not flat.is_cuda:
        _check(flat, torch.float32, 1, "quantize_int8")
        return quantize_int8_ref(flat)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    n = flat.shape[0]
    tile = _tile()
    words = (n + 3) // 4  # the scale's word
    buf = flat.new_empty(words + 1 + (0 if n <= tile else -(-n // tile)))
    _build.launch(_lib().quant_int8, flat.get_device(), flat.data_ptr(),
                  buf.data_ptr(), n)
    quantize_int8.launches += 1
    return buf.view(torch.int8)[:n], buf[words]


def dequant_sum(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8[world, n], float32[world] -> float32[n] = Σ_w f32(q_w)·s_w in
    rank order, without the ``[world, n]`` float intermediate."""
    # checks by attribute comparison: a small leaf's call is mostly host cost
    if (q.dtype is not torch.int8 or q.dim() != 2 or q.numel() == 0
            or scales.dtype is not torch.float32 or scales.dim() != 1
            or scales.shape[0] != q.shape[0]
            or scales.get_device() != q.get_device()):
        raise ValueError(f"dequant_sum: expected int8[world, n] codes and "
                         f"float32[world] scales on one device, got "
                         f"{q.dtype}{tuple(q.shape)} on {q.device} and "
                         f"{scales.dtype}{tuple(scales.shape)} on "
                         f"{scales.device}")
    if not q.is_cuda:
        _check(q, torch.int8, 2, "dequant_sum")
        return dequant_sum_ref(q, scales)
    if not q.is_contiguous():
        q = q.contiguous()
    if not scales.is_contiguous():
        scales = scales.contiguous()
    world, n = q.shape
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    _build.launch(_lib().dequant_sum, q.get_device(), q.data_ptr(),
                  scales.data_ptr(), world, n, out.data_ptr())
    dequant_sum.launches += 1
    return out


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8[n], float32 scale (one element) -> float32[n] = f32(q)·scale
    (the JAX signature): the ``dequant_sum`` kernel at world 1, counted in
    ``dequant_sum.launches``."""
    if (q.dtype is not torch.int8 or q.dim() != 1 or q.numel() == 0
            or scale.dtype is not torch.float32 or scale.numel() != 1
            or scale.get_device() != q.get_device()):
        raise ValueError(f"dequantize_int8: expected int8[n] codes and a "
                         f"float32 scale on one device, got "
                         f"{q.dtype}{tuple(q.shape)} on {q.device} and "
                         f"{scale.dtype}{tuple(scale.shape)} on "
                         f"{scale.device}")
    if not q.is_cuda:
        _check(q, torch.int8, 1, "dequantize_int8")
        return dequant_sum_ref(q.reshape(1, -1), scale.reshape(1))
    if not q.is_contiguous():
        q = q.contiguous()
    out = torch.empty_like(q, dtype=torch.float32)
    _build.launch(_lib().dequant_sum, q.get_device(), q.data_ptr(),
                  scale.data_ptr(), 1, q.shape[0], out.data_ptr())
    dequant_sum.launches += 1
    return out


quantize_int8.launches = 0
dequant_sum.launches = 0

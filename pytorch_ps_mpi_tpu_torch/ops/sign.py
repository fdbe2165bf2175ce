"""1-bit sign pack/unpack: CUDA kernels and their plain PyTorch versions.

The hot path of ``SignCodec``. Each wrapper replaces one Pallas TPU
kernel of ``pytorch_ps_mpi_tpu/ops/sign_pallas.py``:

==================  ==============================================  ==========
wrapper             replaces                                        kernel
==================  ==============================================  ==========
``encode_signs``    ``encode_signs`` (``sign_pallas.py:68``,        ``csrc/sign.cu`` ``sign_encode``
                    ``_encode_kernel`` ``:46``): pack + Σ|x|         (with sum), one launch
``pack_signs``      ``pack_signs`` (``:104``, ``_pack_kernel``      ``sign_encode``
                    ``:30``)                                         (no sum)
``unpack_signs``    ``unpack_signs`` (``:131``, ``_unpack_kernel``  ``sign_unpack``
                    ``:37``)
==================  ==============================================  ==========

Layout, the TPU kernels' own: the flat float input is viewed as
``[rows, 8, 128]`` and bit ``s`` of packed byte ``[r, lane]`` holds
``x[r*1024 + s*128 + lane] >= 0`` — so −0.0 packs as +, NaN as 0.

Bound: memory. Encode moves 4n + n/8 bytes, unpack m + 32m; at the
H100's 3.35 TB/s every ResNet-18 leaf is a few microseconds of traffic,
so launch overhead dominates (20 encode launches a step). Encode is one
device launch a call, its Σ|x| finished inside it (one block for a small
leaf, a cooperative grid with one grid barrier above that). The design
notes are in ``csrc/sign.cu``.

A wrapper takes its plain version (``*_ref``) only for a CPU tensor. For
a CUDA tensor it launches its kernel or raises; it never falls back.
Each wrapper's ``launches`` attribute counts its kernel launches. A small
leaf's call is mostly host cost, so every wrapper checks by attribute,
allocates once and launches through ``_build.launch`` (the raw stream
handle, one ctypes call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pytorch_ps_mpi_tpu_torch.ops import _build

LANE = 128
GROUP = 8 * LANE  # one packed row of 128 bytes encodes 1024 signs

_P = ctypes.c_void_p
_SIGNATURES = {
    "sign_encode": (ctypes.c_int, [_P, _P, ctypes.c_longlong, ctypes.c_int,
                                   _P]),
    "sign_encode_rows_per_block": (ctypes.c_int, []),
    "sign_encode_grid": (ctypes.c_longlong, [ctypes.c_longlong,
                                             ctypes.c_int]),
    "sign_unpack": (ctypes.c_int, [_P, _P, ctypes.c_longlong, _P]),
}


def _weights(device) -> torch.Tensor:
    return (1 << torch.arange(8, device=device)).to(torch.uint8).view(1, 8, 1)


# -- plain versions (CPU path, and the yardstick the kernels are held to) ----

def pack_signs_ref(flat: torch.Tensor) -> torch.Tensor:
    """float32[n] (n % 1024 == 0) -> uint8[n/8] of packed sign bits."""
    bits = (flat.reshape(-1, 8, LANE) >= 0).to(torch.uint8)
    return (bits * _weights(flat.device)).sum(dim=1).to(torch.uint8).reshape(-1)


def encode_signs_ref(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32[n] -> (packed bits, float32 Σ|x|)."""
    return pack_signs_ref(flat), flat.abs().sum()


def unpack_signs_ref(packed: torch.Tensor) -> torch.Tensor:
    """uint8[m] (m % 128 == 0) -> float32[8m] of ±1."""
    p = packed.reshape(-1, 1, LANE)
    bits = (p & _weights(packed.device)) > 0
    return torch.where(bits, 1.0, -1.0).to(torch.float32).reshape(-1)


# -- kernel wrappers -------------------------------------------------------

def _lib() -> ctypes.CDLL:
    return _build.load("sign", _SIGNATURES)


def _check(x: torch.Tensor, dtype: torch.dtype, multiple: int, what: str):
    # by attribute comparison: a small leaf's call is mostly host cost
    if x.dtype is not dtype or x.dim() != 1 or x.shape[0] == 0 \
            or x.shape[0] % multiple:
        raise ValueError(
            f"{what}: expected a non-empty 1-D {dtype} tensor with a size "
            f"divisible by {multiple}, got {x.dtype}{tuple(x.shape)}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")


@functools.lru_cache(maxsize=None)
def _rows_per_block() -> int:
    """Packed rows one block of the encode kernel covers a pass."""
    return _lib().sign_encode_rows_per_block()


def _encode(flat: torch.Tensor, with_sum: bool) -> torch.Tensor:
    """One buffer of float32 words: the packed bytes, and with the sum the
    total and one slot a block of the cooperative grid."""
    if not flat.is_contiguous():
        flat = flat.contiguous()
    rows = flat.shape[0] // GROUP
    words = rows * (LANE // 4)
    if with_sum:
        words += 1 - (-rows // _rows_per_block())
    buf = flat.new_empty(words)
    _build.launch(_lib().sign_encode, flat.get_device(), flat.data_ptr(),
                  buf.data_ptr(), rows, int(with_sum))
    return buf


def encode_signs(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32[n] (n % 1024 == 0) -> (uint8[n/8] packed bits, float32 Σ|x|)
    in one read of the gradient. The sum is taken per block and then
    over blocks in a fixed order, so it may differ from ``torch.sum`` in
    the last ulps (as the TPU kernel's does, ``sign_pallas.py:73-76``).
    On the card both are views of one buffer."""
    _check(flat, torch.float32, GROUP, "encode_signs")
    if not flat.is_cuda:
        return encode_signs_ref(flat)
    buf = _encode(flat, with_sum=True)
    encode_signs.launches += 1
    m = flat.shape[0] // 8
    return buf.view(torch.uint8)[:m], buf[m // 4]


def pack_signs(flat: torch.Tensor) -> torch.Tensor:
    """float32[n] (n % 1024 == 0) -> uint8[n/8] of packed sign bits."""
    _check(flat, torch.float32, GROUP, "pack_signs")
    if not flat.is_cuda:
        return pack_signs_ref(flat)
    packed = _encode(flat, with_sum=False).view(torch.uint8)
    pack_signs.launches += 1
    return packed


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8[m] (m % 128 == 0) -> float32[8m] of ±1."""
    _check(packed, torch.uint8, LANE, "unpack_signs")
    if not packed.is_cuda:
        return unpack_signs_ref(packed)
    if not packed.is_contiguous():
        packed = packed.contiguous()
    m = packed.shape[0]
    out = packed.new_empty(8 * m, dtype=torch.float32)
    _build.launch(_lib().sign_unpack, packed.get_device(), packed.data_ptr(),
                  out.data_ptr(), m)
    unpack_signs.launches += 1
    return out


encode_signs.launches = 0
pack_signs.launches = 0
unpack_signs.launches = 0

"""TernGrad ternarize + pack and the dequantizing unpack-sum: CUDA kernels
and their plain PyTorch versions.

The hot path of ``TernGradCodec`` for leaves in the sublane layout. Each
wrapper replaces a Pallas TPU kernel of
``pytorch_ps_mpi_tpu/ops/tern_pallas.py``:

===================  ==========================================  ====================
wrapper              replaces                                    kernel
===================  ==========================================  ====================
``tern_pack``        ``tern_pack`` (``tern_pallas.py:61``,       ``csrc/tern.cu``
                     ``pallas_call`` ``:73``)                    ``tern_pack``
``tern_unpack_sum``  ``tern_unpack`` (``:97``, ``:108``) at      ``tern_unpack_sum``
                     world 1, and the codec's
                     ``einsum("wn,w->n")`` (``codecs/terngrad.py:239``)
``tern_unpack``      ``tern_unpack``: ``tern_unpack_sum`` of
                     one rank
===================  ==========================================  ====================

Layout: the flat input is viewed as ``[rows, 4, 128]``; digit ``s``
(weight ``4**s``) of packed byte ``[r, lane]`` holds element
``r*512 + s*128 + lane``, and a digit is 0 (−1), 1 (0) or 2 (+1).

Semantics, the Pallas kernel's bit for bit: ``p24 = |x| * (2**24 / s)``
(a true division, then a product), ``keep = f32(u >> 8) < p24`` with
``u`` the raw uint32 random bits shifted *logically*, ``digit = keep ?
(x >= 0 ? 2 : 0) : 1``. The bits travel as an ``int32`` tensor holding
the uint32 patterns (PyTorch has little uint32 arithmetic): the plain
version shifts arithmetically and masks to 24 bits, which is the logical
shift. The unpack-sum is ``Σ_w f32(digit_w − 1)·s_w`` in rank order,
the first rank's product alone, so one rank equals ``tern_unpack``.

Bound: memory. ``tern_pack`` moves 8.25 bytes an element, the unpack-sum
``W/4 + 4``. The design notes are in ``csrc/tern.cu``.

A wrapper takes its plain version (``*_ref``) only for a CPU tensor. For
a CUDA tensor it launches its kernel or raises; it never falls back.
Each wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_ps_mpi_tpu_torch.ops import _build

LANE = 128
#: elements of one packed row (4 sublanes of 128 lanes): the kernel path
#: takes sizes divisible by it
GROUP = 4 * LANE

_P = ctypes.c_void_p
_SIGNATURES = {
    "tern_pack": (ctypes.c_int, [_P, _P, _P, ctypes.c_longlong, _P, _P]),
    "tern_unpack_sum": (ctypes.c_int, [_P, _P, ctypes.c_int,
                                       ctypes.c_longlong, _P, _P]),
}


# -- plain versions (CPU path, and the yardstick the kernels are held to) ----

def tern_pack_ref(flat: torch.Tensor, bits: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """float32[n] + int32[n] (uint32 bit patterns) + float32 scale ->
    uint8[n/4], sublane layout (n % 512 == 0)."""
    # torch's ``number / tensor`` is reciprocal-then-multiply: divide a
    # tensor instead, as the kernel's true division does
    k = torch.div(torch.full((), 16777216.0, device=flat.device),
                  scale.reshape(()))
    p24 = flat.abs() * k
    u24 = ((bits >> 8) & 0xFFFFFF).to(torch.float32)
    digit = torch.where(u24 < p24,
                        torch.where(flat >= 0, 2, 0), 1).to(torch.int32)
    d = digit.reshape(-1, 4, LANE)
    return (d[:, 0] + 4 * d[:, 1] + 16 * d[:, 2]
            + 64 * d[:, 3]).to(torch.uint8).reshape(-1)


def tern_digits(packed: torch.Tensor) -> torch.Tensor:
    """uint8[..., m] sublane layout -> the int32 ternaries {−1, 0, +1} (or
    +2 for a digit 3), ``[..., 4m]`` in element order."""
    lead = packed.shape[:-1]
    p = packed.reshape(*lead, -1, 1, LANE).to(torch.int32)
    shifts = torch.arange(0, 8, 2, dtype=torch.int32,
                          device=packed.device).reshape(4, 1)
    return (((p >> shifts) & 3) - 1).reshape(*lead, -1)


def tern_unpack_sum_ref(packed: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """uint8[world, m], float32[world] -> float32[4m] = Σ_w
    f32(digit_w − 1)·s_w, a left fold in rank order from the first
    rank's product."""
    tern = tern_digits(packed).to(torch.float32)
    acc = tern[0] * scales[0]
    for w in range(1, packed.shape[0]):
        acc = acc + tern[w] * scales[w]
    return acc


# -- kernel wrappers -------------------------------------------------------

def _lib() -> ctypes.CDLL:
    return _build.load("tern", _SIGNATURES)


def _check(x: torch.Tensor, dtype: torch.dtype, dim: int, what: str) -> None:
    if x.dim() != dim or x.dtype != dtype or x.numel() == 0:
        raise ValueError(f"{what}: expected a non-empty {dim}-D {dtype} "
                         f"tensor, got {x.dtype}{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def tern_pack(flat: torch.Tensor, bits: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """float32[n] (n % 512 == 0) + int32[n] random bits + float32 scale
    (one element, on the same device) -> uint8[n/4]."""
    _check(flat, torch.float32, 1, "tern_pack")
    _check(bits, torch.int32, 1, "tern_pack")
    n = flat.numel()
    if n % GROUP or bits.numel() != n or scale.numel() != 1:
        raise ValueError(f"tern_pack: needs n % {GROUP} == 0 and n bits and "
                         f"one scale, got n={n}, {bits.numel()} bits, "
                         f"{scale.numel()} scales")
    if not (bits.device == scale.device == flat.device):
        raise ValueError("tern_pack: flat, bits and scale must share a device")
    scale = scale.to(torch.float32)
    if flat.device.type == "cpu":
        return tern_pack_ref(flat, bits, scale)
    flat, bits, scale = flat.contiguous(), bits.contiguous(), scale.contiguous()
    out = torch.empty(n // 4, dtype=torch.uint8, device=flat.device)
    with torch.cuda.device(flat.device):
        err = _lib().tern_pack(flat.data_ptr(), bits.data_ptr(),
                               scale.data_ptr(), n, out.data_ptr(),
                               torch.cuda.current_stream(flat.device).cuda_stream)
    _raise_on(err, "tern_pack")
    tern_pack.launches += 1
    return out


def tern_unpack_sum(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """uint8[world, m] (m % 128 == 0), float32[world] -> float32[4m] =
    Σ_w f32(digit_w − 1)·s_w in rank order, without the ``[world, 4m]``
    float intermediate."""
    _check(packed, torch.uint8, 2, "tern_unpack_sum")
    _check(scales, torch.float32, 1, "tern_unpack_sum")
    world, m = packed.shape
    if m % LANE or scales.shape[0] != world or scales.device != packed.device:
        raise ValueError(f"tern_unpack_sum: needs m % {LANE} == 0 and one "
                         f"scale a rank on the same device, got "
                         f"{tuple(packed.shape)} and {tuple(scales.shape)} on "
                         f"{scales.device}")
    if packed.device.type == "cpu":
        return tern_unpack_sum_ref(packed, scales)
    packed, scales = packed.contiguous(), scales.contiguous()
    out = torch.empty(4 * m, dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = _lib().tern_unpack_sum(
            packed.data_ptr(), scales.data_ptr(), world, m, out.data_ptr(),
            torch.cuda.current_stream(packed.device).cuda_stream)
    _raise_on(err, "tern_unpack_sum")
    tern_unpack_sum.launches += 1
    return out


def tern_unpack(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """uint8[m], float32 scale -> float32[4m] = (digit − 1)·scale (the JAX
    signature): ``tern_unpack_sum`` of one rank."""
    return tern_unpack_sum(packed.reshape(1, -1),
                           scale.reshape(1).to(torch.float32))


tern_pack.launches = 0
tern_unpack_sum.launches = 0

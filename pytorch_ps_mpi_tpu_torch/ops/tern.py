"""TernGrad's scale, ternarize + pack, and dequantizing unpack-sum: CUDA
kernels and their plain PyTorch versions.

The hot path of ``TernGradCodec`` for leaves in the sublane layout. Each
wrapper replaces a Pallas TPU kernel of
``pytorch_ps_mpi_tpu/ops/tern_pallas.py``, or the JAX codec's scale
around it:

===================  ==========================================  ====================
wrapper              replaces                                    kernel
===================  ==========================================  ====================
``tern_encode``      ``tern_pack`` (``tern_pallas.py:61``,       ``csrc/tern.cu``
                     ``pallas_call`` ``:73``) with the codec's   ``tern_encode``
                     ``jnp.maximum(jnp.max(jnp.abs(g)), 1e-12)``
                     (``codecs/terngrad.py:187``), one launch
``tern_scale``       the chunked encode's absmax scan            ``tern_scale``
                     (``codecs/terngrad.py:149-155``)
``tern_pack``        ``tern_pack`` with a given scale (a chunk   ``tern_pack``
                     of a chunked leaf; the JAX signature)
``tern_unpack_sum``  ``tern_unpack`` (``:97``, ``:108``) at      ``tern_unpack_sum``
                     world 1, and the codec's
                     ``einsum("wn,w->n")`` (``codecs/terngrad.py:239``)
``tern_unpack``      ``tern_unpack``: ``tern_unpack_sum`` of
                     one rank
===================  ==========================================  ====================

Layout: the flat input is viewed as ``[rows, 4, 128]``; digit ``s``
(weight ``4**s``) of packed byte ``[r, lane]`` holds element
``r*512 + s*128 + lane``, and a digit is 0 (−1), 1 (0) or 2 (+1).

Semantics, the JAX codec's with its Pallas kernel, bit for bit:
``s = max(max|x|, 1e-12)`` in float32 with NaN propagating (a NaN element
makes ``s`` NaN and every digit 1), ``p24 = |x| * (2**24 / s)`` (a true
division, then a product), ``keep = f32(u >> 8) < p24`` with ``u`` the
raw uint32 random bits shifted *logically*, ``digit = keep ? (x >= 0 ?
2 : 0) : 1``. ``x`` is float32 or bfloat16; the kernels read it in its
own type (bf16 → f32 is exact, so the digits are those of the float32
cast the JAX codec makes). The bits travel as an ``int32`` tensor holding
the uint32 patterns (PyTorch has little uint32 arithmetic): the plain
version shifts arithmetically and masks to 24 bits, which is the logical
shift. The unpack-sum is ``Σ_w f32(digit_w − 1)·s_w`` in rank order,
the first rank's product alone, so one rank equals ``tern_unpack``.

Bound: memory. The encode and a given-scale pack move 8.25 bytes an
element from float32 and 6.25 from bf16, the scale 4 or 2, the
unpack-sum ``W/4 + 4``. The design notes are in ``csrc/tern.cu``.

A wrapper takes its plain version (``*_ref``) only for a CPU tensor. For
a CUDA tensor it launches its kernel or raises; it never falls back.
Each wrapper's ``launches`` attribute counts its kernel launches. A
small leaf's call is mostly host cost, so every wrapper checks by
attribute, copies nothing (a non-contiguous CUDA tensor raises),
allocates once and launches through ``_build.launch`` (the raw stream
handle, one ctypes call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from pytorch_ps_mpi_tpu_torch.ops import _build

LANE = 128
#: elements of one packed row (4 sublanes of 128 lanes): the kernels take
#: sizes divisible by it
GROUP = 4 * LANE
#: the gradient types the kernels read, and the flag each passes to them
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_SIGNATURES = {
    "tern_tile": (ctypes.c_int, []),
    "tern_encode": (ctypes.c_int, [_P, ctypes.c_int, _P, _N, _P, _P]),
    "tern_scale": (ctypes.c_int, [_P, ctypes.c_int, _N, _P, _P]),
    "tern_pack": (ctypes.c_int, [_P, ctypes.c_int, _P, _P, _N, _P, _P]),
    "tern_unpack_sum": (ctypes.c_int, [_P, _P, ctypes.c_int, _N, _P, _P]),
}


# -- plain versions (CPU path, and the yardstick the kernels are held to) ----

def tern_scale_ref(flat: torch.Tensor) -> torch.Tensor:
    """float32 or bf16 [n] -> the float32 scale ``max(max|x|, 1e-12)``,
    NaN propagating, taken 2**20 elements at a time as the JAX codec's
    chunked encode takes it (no n-sized float temporary)."""
    scale = torch.full((), 1e-12, device=flat.device)
    for c in torch.split(flat, 1 << 20):
        scale = torch.maximum(scale, c.to(torch.float32).abs().amax())
    return scale


def tern_pack_ref(flat: torch.Tensor, bits: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """float32 or bf16 [n] + int32[n] (uint32 bit patterns) + float32
    scale -> uint8[n/4], sublane layout (n % 512 == 0)."""
    flat = flat.to(torch.float32)
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


def tern_encode_ref(flat: torch.Tensor, bits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 or bf16 [n] + int32[n] bits -> (uint8[n/4], float32
    scale): the scale ``max(max|x|, 1e-12)`` (NaN propagating), and the
    pack with it."""
    scale = torch.clamp(flat.to(torch.float32).abs().amax(), min=1e-12)
    return tern_pack_ref(flat, bits, scale), scale


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


@functools.lru_cache(maxsize=None)
def _tile() -> int:
    """Elements one block of the encode and scale kernels covers."""
    return _lib().tern_tile()


def _slots(n: int) -> int:
    """Int32 slots of the cooperative grid for ``n`` elements."""
    return 0 if n <= _tile() else -(-n // _tile())


def _flat_ok(flat: torch.Tensor) -> bool:
    # by attribute comparison: a small leaf's call is mostly host cost
    n = flat.numel()
    return (flat.dtype in DTYPES and flat.dim() == 1 and n > 0
            and n % GROUP == 0)


def _bits_ok(flat: torch.Tensor, bits: torch.Tensor) -> bool:
    return (bits.dtype is torch.int32 and bits.dim() == 1
            and bits.numel() == flat.numel()
            and bits.get_device() == flat.get_device())


def _refuse(what: str, flat: torch.Tensor, bits=None) -> None:
    """Raise ``ValueError`` for arguments the kernels do not take."""
    if not _flat_ok(flat):
        raise ValueError(f"{what}: expected a 1-D float32 or bfloat16 "
                         f"tensor of n % {GROUP} == 0 elements (n > 0), got "
                         f"{flat.dtype}{tuple(flat.shape)}")
    if bits is not None and not _bits_ok(flat, bits):
        raise ValueError(f"{what}: expected int32[{flat.numel()}] random "
                         f"bits on {flat.device}, got "
                         f"{bits.dtype}{tuple(bits.shape)} on {bits.device}")
    if flat.is_cuda:
        raise ValueError(f"{what}: the kernel takes contiguous tensors")
    raise ValueError(f"{what}: unsupported device {flat.device}")


def tern_encode(flat: torch.Tensor, bits: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 or bf16 [n] (n % 512 == 0) + int32[n] random bits ->
    (uint8[n/4] packed, float32 scale), the scale ``max(max|x|, 1e-12)``
    computed on the device in the same launch (no host sync). On the card
    both are views of one buffer: the packed bytes, the scale, then one
    int32 slot a block where the cooperative grid needs them."""
    if not (_flat_ok(flat) and _bits_ok(flat, bits) and flat.is_cuda
            and flat.is_contiguous() and bits.is_contiguous()):
        if flat.device.type == "cpu" and _flat_ok(flat) \
                and _bits_ok(flat, bits):
            return tern_encode_ref(flat, bits)
        _refuse("tern_encode", flat, bits)
    n = flat.numel()
    words = n // 16  # the scale's word, after the n/4 packed bytes
    buf = torch.empty(words + 1 + _slots(n), dtype=torch.float32,
                      device=flat.device)
    _build.launch(_lib().tern_encode, flat.get_device(), flat.data_ptr(),
                  DTYPES[flat.dtype], bits.data_ptr(), n, buf.data_ptr())
    tern_encode.launches += 1
    return buf.view(torch.uint8)[:n // 4], buf[words]


def tern_scale(flat: torch.Tensor) -> torch.Tensor:
    """float32 or bf16 [n] (n % 512 == 0) -> the float32 scale
    ``max(max|x|, 1e-12)``, NaN propagating, in one launch on the device
    (a view of a buffer that also holds the cooperative grid's slots)."""
    if not (_flat_ok(flat) and flat.is_cuda and flat.is_contiguous()):
        if flat.device.type == "cpu" and _flat_ok(flat):
            return tern_scale_ref(flat)
        _refuse("tern_scale", flat)
    n = flat.numel()
    buf = torch.empty(1 + _slots(n), dtype=torch.float32, device=flat.device)
    _build.launch(_lib().tern_scale, flat.get_device(), flat.data_ptr(),
                  DTYPES[flat.dtype], n, buf.data_ptr())
    tern_scale.launches += 1
    return buf[0]


def tern_pack(flat: torch.Tensor, bits: torch.Tensor, scale: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 or bf16 [n] (n % 512 == 0) + int32[n] random bits + a
    float32 scale (one element, on the same device) -> uint8[n/4], written
    into ``out`` where given (a contiguous uint8[n/4], e.g. a chunk's
    slice of its leaf's payload)."""
    if not (_flat_ok(flat) and _bits_ok(flat, bits)):
        _refuse("tern_pack", flat, bits)
    n = flat.numel()
    if (scale.dtype is not torch.float32 or scale.numel() != 1
            or scale.get_device() != flat.get_device()):
        raise ValueError(f"tern_pack: expected one float32 scale on "
                         f"{flat.device}, got {scale.dtype}"
                         f"{tuple(scale.shape)} on {scale.device}")
    if out is not None and (out.dtype is not torch.uint8 or out.dim() != 1
                            or out.shape[0] != n // 4
                            or out.get_device() != flat.get_device()
                            or not out.is_contiguous()):
        raise ValueError(f"tern_pack: out must be a contiguous uint8"
                         f"[{n // 4}] on {flat.device}, got {out.dtype}"
                         f"{tuple(out.shape)} on {out.device}")
    if not flat.is_cuda:
        if flat.device.type != "cpu":
            _refuse("tern_pack", flat, bits)
        packed = tern_pack_ref(flat, bits, scale)
        return packed if out is None else out.copy_(packed)
    if not (flat.is_contiguous() and bits.is_contiguous()
            and scale.is_contiguous()):
        _refuse("tern_pack", flat, bits)
    if out is None:
        out = torch.empty(n // 4, dtype=torch.uint8, device=flat.device)
    _build.launch(_lib().tern_pack, flat.get_device(), flat.data_ptr(),
                  DTYPES[flat.dtype], bits.data_ptr(), scale.data_ptr(), n,
                  out.data_ptr())
    tern_pack.launches += 1
    return out


def tern_unpack_sum(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """uint8[world, m] (m % 128 == 0), float32[world] -> float32[4m] =
    Σ_w f32(digit_w − 1)·s_w in rank order, without the ``[world, 4m]``
    float intermediate."""
    if (packed.dtype is not torch.uint8 or packed.dim() != 2
            or packed.numel() == 0 or packed.shape[1] % LANE
            or scales.dtype is not torch.float32 or scales.dim() != 1
            or scales.shape[0] != packed.shape[0]
            or scales.get_device() != packed.get_device()):
        raise ValueError(f"tern_unpack_sum: expected uint8[world, m] "
                         f"(m % {LANE} == 0) and float32[world] scales on "
                         f"one device, got {packed.dtype}"
                         f"{tuple(packed.shape)} on {packed.device} and "
                         f"{scales.dtype}{tuple(scales.shape)} on "
                         f"{scales.device}")
    if not packed.is_cuda:
        if packed.device.type != "cpu":
            raise ValueError(f"tern_unpack_sum: unsupported device "
                             f"{packed.device}")
        return tern_unpack_sum_ref(packed, scales)
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("tern_unpack_sum: packed and scales must be "
                         "contiguous")
    world, m = packed.shape
    out = torch.empty(4 * m, dtype=torch.float32, device=packed.device)
    _build.launch(_lib().tern_unpack_sum, packed.get_device(),
                  packed.data_ptr(), scales.data_ptr(), world, m,
                  out.data_ptr())
    tern_unpack_sum.launches += 1
    return out


def tern_unpack(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """uint8[m], float32 scale -> float32[4m] = (digit − 1)·scale (the JAX
    signature): ``tern_unpack_sum`` of one rank."""
    return tern_unpack_sum(packed.reshape(1, -1), scale.reshape(1))


tern_encode.launches = 0
tern_scale.launches = 0
tern_pack.launches = 0
tern_unpack_sum.launches = 0

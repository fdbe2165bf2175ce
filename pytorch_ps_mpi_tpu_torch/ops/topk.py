"""Exact top-k by magnitude: the CUDA radix select and stream compaction,
and the plain PyTorch versions.

The selection of ``TopKCodec(pallas=True)``. ``exact_topk`` replaces
``exact_topk`` of ``pytorch_ps_mpi_tpu/ops/topk_pallas.py:144``, whose
threshold is built by the Pallas kernel ``_counts`` (``:67``,
``pallas_call`` ``:74``), once per bit in ``_kth_threshold`` (``:89``):

====================  ======================================  ==================
function              replaces                                kernels
====================  ======================================  ==================
``radix_threshold``   ``_kth_threshold``: the 31 ``_counts``  ``csrc/topk.cu``
                      passes                                  ``topk_threshold``
``exact_topk``        ``exact_topk``: the threshold and the   ``topk_select``
                      chunked compaction
====================  ======================================  ==================

The function is the JAX package's, bit for bit:

1. **Threshold.** |x| is read as int32 keys (``bits & 0x7fffffff``: −0.0
   is 0, NaN lies above Inf); ``t`` is the k-th largest key. The kernel
   finds it in 4 radix passes over digits of 7, 8, 8 and 8 bits
   (:data:`DIGITS`), each a 256-bin histogram of the keys that carry the
   digits chosen so far; the histograms stay in device memory, so nothing
   waits for the host. ``radix_threshold_ref`` is its plain version, and
   the JAX package's 31 count passes stay as ``kth_threshold`` /
   ``count_pass_ref``.
2. **Compaction.** The strict survivors (key > t) take slots ``0..m-1``
   in index order, then the first ``k - m`` ties (key == t) in index
   order. The kernel gives each block a contiguous range of indices, counts
   it, then scatters by the counts of the blocks before it; ``compact`` is
   the plain version (prefix sums and a scatter).

One host call a leaf: ``exact_topk`` allocates the outputs and one scratch
buffer and makes one ctypes call, which issues :data:`LAUNCHES` launches
(the scratch's memset, 4 histogram passes, the count, the scatter);
``exact_topk.launches`` counts them. Below ``4 * chunk`` elements, for
``k >= n`` and above 2**30 elements it falls back, as the JAX package
does, to a full top-k by a stable descending sort of the keys:
``lax.top_k``'s result, ties lower index first.

Bound: memory. The function needs 4n + 8k bytes; the kernels read x six
times (24n + 8k). ``csrc/topk.cu`` has the design notes.

A wrapper takes its plain version (``*_ref``) only for a CPU tensor. For
a CUDA tensor it launches its kernels or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pytorch_ps_mpi_tpu_torch.ops import _build

PASSES = 31          # the JAX package's count passes (the plain threshold)
MAX_N = 1 << 30
#: (shift, top) of each radix pass's digit: bits [shift, top) of the key
DIGITS = ((24, 31), (16, 24), (8, 16), (0, 8))
BINS = 256
#: launches of one ``exact_topk`` call on the card: the scratch's memset,
#: the 4 histogram passes, the count and the scatter
LAUNCHES = 7
#: launches of one ``radix_threshold`` call: all but the scatter
THRESHOLD_LAUNCHES = 6
#: int32 scratch a call needs (``kScratchInts`` of ``csrc/topk.cu``, which
#: refuses less): the histograms, t and m, two counts for each of 1024 blocks
SCRATCH_INTS = len(DIGITS) * BINS + 4 + 2 * 1024
_T = len(DIGITS) * BINS  # t's slot in the scratch

_P = ctypes.c_void_p
_SIGNATURES = {
    "topk_threshold": (ctypes.c_int, [_P, ctypes.c_longlong, ctypes.c_int,
                                      _P, ctypes.c_int, _P]),
    "topk_select": (ctypes.c_int, [_P, ctypes.c_longlong, ctypes.c_int, _P,
                                   _P, _P, ctypes.c_int, _P]),
}


def magnitude_keys(flat: torch.Tensor) -> torch.Tensor:
    """The int32 keys of |x|: for non-negative floats the bit order is the
    value order (−0.0 -> 0, NaN above Inf)."""
    return flat.to(torch.float32).contiguous().view(torch.int32) & 0x7FFFFFFF


def threshold_from_counts(counts: torch.Tensor, k: int) -> torch.Tensor:
    """The key ``t`` that passes ``0..len(counts)-1`` built: bit ``30 - b``
    is set iff pass b counted at least k keys >= its candidate."""
    shifts = 30 - torch.arange(counts.shape[0], dtype=torch.int32,
                               device=counts.device)
    bits = torch.bitwise_left_shift(torch.ones_like(shifts), shifts)
    return torch.where(counts[:, 0] >= k, bits, 0).sum().to(torch.int32)


# -- plain versions (CPU path, and the yardstick the kernel is held to) ------

def count_pass_ref(flat: torch.Tensor, k: int, b: int,
                   counts: torch.Tensor) -> None:
    """Pass ``b``: adds ``(#key >= cand, #key > cand)`` to ``counts[b]``
    for ``cand = t | 1 << (30 - b)``, ``t`` rebuilt from rows ``0..b-1``."""
    keys = magnitude_keys(flat)
    cand = threshold_from_counts(counts[:b], k) | (1 << (30 - b))
    counts[b, 0] += (keys >= cand).sum(dtype=torch.int32)
    counts[b, 1] += (keys > cand).sum(dtype=torch.int32)


def radix_threshold_ref(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """(t, hist): the k-th largest key and the kernel's histograms,
    int32[4, 256]: row p counts digit p of the keys whose higher bits
    equal the digits of rows 0..p-1 chosen so far. Row p's digit is the
    largest d with at least ``k_p`` keys in bins >= d, and ``k_{p+1}`` is
    ``k_p`` less the keys in the bins above d."""
    keys = magnitude_keys(flat)
    hist = torch.zeros((len(DIGITS), BINS), dtype=torch.int32,
                       device=flat.device)
    prefix, left = 0, k
    for p, (shift, top) in enumerate(DIGITS):
        carry = keys[(keys >> top) == (prefix >> top)]
        row = torch.bincount((carry >> shift) & 0xFF, minlength=BINS)
        hist[p] = row.to(torch.int32)
        suffix = torch.flip(torch.cumsum(torch.flip(row, (0,)), 0), (0,))
        d = int(torch.nonzero(suffix >= left).max())
        left -= int(suffix[d] - row[d])
        prefix |= d << shift
    return torch.tensor(prefix, dtype=torch.int32, device=flat.device), hist


# -- kernel wrappers -------------------------------------------------------

def _lib() -> ctypes.CDLL:
    return _build.load("topk", _SIGNATURES)


def _check(flat: torch.Tensor, k: int, what: str) -> None:
    if flat.dtype != torch.float32 or flat.dim() != 1 or not \
            0 < k <= flat.numel() <= MAX_N:
        raise ValueError(f"{what}: expected float32[n], 0 < k <= n <= 2**30, "
                         f"got k={k} for {flat.dtype}{tuple(flat.shape)}")
    if not flat.is_cuda and flat.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {flat.device}")


def radix_threshold(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """(t, hist) as :func:`radix_threshold_ref` gives them, from the
    kernel's 4 radix passes on the card. ``flat``: float32[n],
    0 < k <= n <= 2**30."""
    _check(flat, k, "radix_threshold")
    if not flat.is_cuda:
        return radix_threshold_ref(flat, k)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    scratch = torch.empty(SCRATCH_INTS, dtype=torch.int32, device=flat.device)
    _build.launch(_lib().topk_threshold, flat.get_device(), flat.data_ptr(),
                  flat.numel(), k, scratch.data_ptr(), SCRATCH_INTS)
    radix_threshold.launches += THRESHOLD_LAUNCHES
    return scratch[_T], scratch[:_T].view(len(DIGITS), BINS)


radix_threshold.launches = 0


# -- the selection -----------------------------------------------------------

def kth_threshold(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(t, counts): the k-th largest key and the counts of the JAX
    package's 31 passes, all on ``flat``'s device."""
    counts = torch.zeros((PASSES, 2), dtype=torch.int32, device=flat.device)
    for b in range(PASSES):
        count_pass_ref(flat, k, b, counts)
    return threshold_from_counts(counts, k), counts


def sorted_topk(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``lax.top_k(|x|, k)``'s selection: a stable descending sort of the
    keys, so ties come lower index first and NaN first of all."""
    _, order = torch.sort(magnitude_keys(flat), descending=True, stable=True)
    idx = order[:k]
    return flat[idx], idx.to(torch.int32)


def compact(flat: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """int32[k] indices: keys > t in index order, then the first k − m
    keys == t in index order (m = #keys > t < k)."""
    n = flat.numel()
    keys = magnitude_keys(flat)
    strict, tie = keys > t, keys == t
    strict_pos = torch.cumsum(strict, 0, dtype=torch.int32)
    tie_pos = torch.cumsum(tie, 0, dtype=torch.int32) + strict_pos[-1]
    slot = torch.where(strict, strict_pos - 1,
                       torch.where(tie, torch.clamp(tie_pos - 1, max=k), k))
    out = torch.empty(k + 1, dtype=torch.int32, device=flat.device)
    out.scatter_(0, slot.long(), torch.arange(n, dtype=torch.int32,
                                              device=flat.device))
    return out[:k]


def _fallback(flat: torch.Tensor, k: int, chunk: int) -> bool:
    if flat.dim() != 1 or not 0 < k <= flat.numel():
        raise ValueError(f"exact_topk: k={k} for shape {tuple(flat.shape)}")
    n = flat.numel()
    return k >= n or n < 4 * chunk or n > MAX_N


def exact_topk_ref(flat: torch.Tensor, k: int,
                   chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exact_topk`` with the JAX package's 31 count passes and the
    compaction in PyTorch ops."""
    if _fallback(flat, k, chunk):
        return sorted_topk(flat, k)
    t, _ = kth_threshold(flat.to(torch.float32), k)
    idx = compact(flat, t, k)
    return flat[idx.long()], idx


def exact_topk(flat: torch.Tensor, k: int,
               chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values[k], int32 indices[k]) of the k largest |x|, exact, ties in
    index order. ``chunk`` (a power of two) sets the fallback size
    ``4 * chunk``, as in the JAX package."""
    if _fallback(flat, k, chunk):
        return sorted_topk(flat, k)
    if not flat.is_cuda:
        if flat.device.type != "cpu":
            raise ValueError(f"exact_topk: unsupported device {flat.device}")
        return exact_topk_ref(flat, k, chunk)
    x = flat if flat.dtype == torch.float32 else flat.to(torch.float32)
    if not x.is_contiguous():
        x = x.contiguous()
    dev = x.device
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    values = (torch.empty(k, dtype=torch.float32, device=dev)
              if flat.dtype == torch.float32 else None)
    scratch = torch.empty(SCRATCH_INTS, dtype=torch.int32, device=dev)
    _build.launch(_lib().topk_select, x.get_device(), x.data_ptr(),
                  x.numel(), k, None if values is None else values.data_ptr(),
                  idx.data_ptr(), scratch.data_ptr(), SCRATCH_INTS)
    exact_topk.launches += LAUNCHES
    return (flat[idx.long()] if values is None else values), idx


exact_topk.launches = 0

"""Exact top-k by magnitude: the CUDA threshold count kernel and the
plain PyTorch versions.

The selection of ``TopKCodec(pallas=True)``. ``exact_topk`` replaces
``exact_topk`` of ``pytorch_ps_mpi_tpu/ops/topk_pallas.py:144``, and its
count pass replaces the Pallas kernel ``_counts`` (``:67``,
``pallas_call`` ``:74``), which ``_kth_threshold`` (``:89``) calls once per
bit:

================  =====================================  ====================
function          replaces                               kernel
================  =====================================  ====================
``count_pass``    ``_counts`` (one pass of                ``csrc/topk.cu``
                  ``_kth_threshold``)                     ``topk_count``
``exact_topk``    ``exact_topk``: 31 ``count_pass``       ``topk_count``
                  launches, then a compaction in          (31 launches)
                  PyTorch ops
================  =====================================  ====================

The design is the JAX package's, ported as it is:

1. **Threshold.** |x| is read as int32 keys (``bits & 0x7fffffff``: −0.0
   is 0, NaN lies above Inf) and the k-th largest key ``t`` is built from
   bit 30 down in 31 count passes, one kernel launch each. The passes keep
   their counts in device memory (``i32[31, 2]``) and each rebuilds ``t``
   from the rows before it, so nothing in the loop waits for the host.
2. **Compaction**, in PyTorch ops with static shapes: the strict
   survivors (key > t) take slots ``0..m-1`` in index order, then the
   first ``k - m`` ties (key == t) in index order; prefix sums give each
   its slot and a scatter drops every other element into a sentinel slot
   ``k``. The result equals the JAX package's index array bit for bit.

Below ``4 * chunk`` elements, for ``k >= n`` and above 2**30 elements it
falls back, as the JAX package does, to a full top-k by a stable
descending sort of the keys: ``lax.top_k``'s result, ties lower index
first.

Bound: memory. The function needs 4n + 8k bytes; the 31 passes read
124n. ``csrc/topk.cu`` has the design notes.

A wrapper takes its plain version (``*_ref``) only for a CPU tensor. For
a CUDA tensor it launches its kernel or raises; it never falls back.
``count_pass.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from pytorch_ps_mpi_tpu_torch.ops import _build

PASSES = 31
MAX_N = 1 << 30

_P = ctypes.c_void_p
_SIGNATURES = {
    "topk_count": (ctypes.c_int, [_P, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, _P, _P]),
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


# -- kernel wrapper --------------------------------------------------------

def _lib() -> ctypes.CDLL:
    return _build.load("topk", _SIGNATURES)


def count_pass(flat: torch.Tensor, k: int, b: int,
               counts: torch.Tensor) -> None:
    """One threshold pass in place on ``counts`` (int32[31, 2], zero
    before pass 0). ``flat``: float32[n], 0 < n <= 2**30."""
    if flat.dim() != 1 or flat.dtype != torch.float32 or not \
            0 < flat.numel() <= MAX_N:
        raise ValueError(f"count_pass: expected float32[n], 0 < n <= 2**30, "
                         f"got {flat.dtype}{tuple(flat.shape)}")
    if counts.shape != (PASSES, 2) or counts.dtype != torch.int32 or \
            counts.device != flat.device or not counts.is_contiguous():
        raise ValueError(f"count_pass: counts must be a contiguous int32"
                         f"[{PASSES}, 2] on {flat.device}")
    if not (0 <= b < PASSES and k > 0):
        raise ValueError(f"count_pass: pass {b}, k {k}")
    if flat.device.type == "cpu":
        count_pass_ref(flat, k, b, counts)
        return
    if flat.device.type != "cuda":
        raise ValueError(f"count_pass: unsupported device {flat.device}")
    flat = flat.contiguous()
    with torch.cuda.device(flat.device):
        err = _lib().topk_count(
            flat.data_ptr(), flat.numel(), k, b, counts.data_ptr(),
            torch.cuda.current_stream(flat.device).cuda_stream)
    if err:
        raise RuntimeError(f"topk_count: CUDA launch failed with error {err}")
    count_pass.launches += 1


count_pass.launches = 0


# -- the selection -----------------------------------------------------------

def kth_threshold(flat: torch.Tensor, k: int,
                  counter: Callable = count_pass) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(t, counts): the k-th largest key and the 31 passes' counts, all on
    ``flat``'s device."""
    counts = torch.zeros((PASSES, 2), dtype=torch.int32, device=flat.device)
    for b in range(PASSES):
        counter(flat, k, b, counts)
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


def _select(flat: torch.Tensor, k: int, chunk: int,
            counter: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    if flat.dim() != 1 or not 0 < k <= flat.numel():
        raise ValueError(f"exact_topk: k={k} for shape {tuple(flat.shape)}")
    n = flat.numel()
    if k >= n or n < 4 * chunk or n > MAX_N:
        return sorted_topk(flat, k)
    t, _ = kth_threshold(flat.to(torch.float32), k, counter)
    idx = compact(flat, t, k)
    return flat[idx.long()], idx


def exact_topk_ref(flat: torch.Tensor, k: int,
                   chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exact_topk`` with the plain count pass."""
    return _select(flat, k, chunk, count_pass_ref)


def exact_topk(flat: torch.Tensor, k: int,
               chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values[k], int32 indices[k]) of the k largest |x|, exact, ties in
    index order. ``chunk`` (a power of two) sets the fallback size
    ``4 * chunk``, as in the JAX package."""
    return _select(flat, k, chunk, count_pass)

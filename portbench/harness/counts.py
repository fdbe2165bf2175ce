"""What a kernel call needs at the least, from the shapes of the call:
its bytes (each input byte read once, each output byte written once) and
its operations, and the H100's published peaks they are held to.

The byte and operation counts are those the port's smoke run gives its
kernels (``chip_smoke.py``), frozen here so that a change to the
program cannot move the yardstick.
"""

from __future__ import annotations

#: H100 SXM device memory, bytes a second (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate, operations a second (data sheet)
BF16_FLOPS = 989e12


def tern_encode_bytes(n: int, itemsize: int) -> int:
    """TernGrad's encode of one unit, as the function needs it: the
    gradient read in its type, the packed 2 bits an element and the
    float32 scale written. The random bits are not counted: a kernel that
    reads them from memory spends bytes that one drawing them in place
    does not need."""
    return n * itemsize + n // 4 + 4


def tern_unpack_sum_bytes(n: int, world: int) -> int:
    """The unpack-sum of ``world`` packed payloads of a unit: the packed
    bytes and scales read, the float32 sum written."""
    return world * (n // 4) + 4 * world + 4 * n


def topk_bytes(n: int, k: int) -> int:
    """Exact top-k of a float32 leaf: the leaf read once, k float32
    values and k int32 indices written."""
    return 4 * n + 8 * k


def flash_fwd(bh: int, l: int, d: int, itemsize: int = 2):
    """(bytes, operations) of one flash forward over ``[bh, l, d]``: q, k,
    v read, o and the float32 log-sum-exp written; q k^T and p v."""
    numel = bh * l * d
    return 4 * numel * itemsize + 4 * bh * l, 4 * bh * l * l * d


def flash_bwd(bh: int, l: int, d: int, itemsize: int = 2):
    """(bytes, operations) of one flash backward: q, k, v, o, do and two
    float32 row vectors read, dq, dk, dv written; the recomputed scores
    and the four gradient products, 2.5 times the forward's."""
    numel = bh * l * d
    return 8 * numel * itemsize + 2 * 4 * bh * l, 2.5 * 4 * bh * l * l * d


def bound_seconds(nbytes: float, flops: float = 0.0,
                  peak_flops: float = BF16_FLOPS):
    """(seconds, what bounds): the larger of bytes over the memory's rate
    and operations over the peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / peak_flops
    return (by_ops, "operations") if by_ops > by_bytes else \
        (by_bytes, "bytes")

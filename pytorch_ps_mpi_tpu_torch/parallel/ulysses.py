"""Ulysses sequence parallelism: an all-to-all between sequence and head
sharding (``pytorch_ps_mpi_tpu/parallel/ulysses.py``; DeepSpeed-Ulysses,
Jacobs et al. 2023, arXiv:2309.14509).

Where ring attention keeps heads whole and rotates K/V blocks, Ulysses
exchanges once each way: sequence-sharded q, k and v become
head-sharded over the whole sequence (:func:`_seq_to_heads`), each rank
runs ordinary attention for its heads (the flash kernels; on CPU
tensors the dense path where the sequence does not tile), and a second exchange restores sequence sharding
(:func:`_heads_to_seq`). q, k and v are stacked on the batch axis, so a
layer makes two ``comms.all_to_all`` calls in all. Needs ``heads %
axis_size == 0``.

Row order: after the first exchange, row block i of the sequence came
from rank i, which held positions ``[i·l, (i+1)·l)``, so the blocks lie
in global token order (``ulysses.py:42-52``).
"""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.mesh import axis_group
from pytorch_ps_mpi_tpu_torch.ops.attention import (attention_ref,
                                                    flash_attention,
                                                    flash_supported)


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """``[b, l_loc, h, d]`` (sequence-sharded) -> ``[b, n·l_loc, h/n, d]``
    (head-sharded, the whole sequence), one all-to-all."""
    n = group.size
    b, l_loc, h, d = x.shape
    # [b, l, n, h_loc, d] -> [n, b, l, h_loc, d]: head group j to rank j
    x = x.reshape(b, l_loc, n, h // n, d).permute(2, 0, 1, 3, 4)
    x = comms.all_to_all(x, group)
    # leading dim: the source rank = the sequence block, in token order
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * l_loc, h // n, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    n = group.size
    b, l_full, h_loc, d = x.shape
    x = x.reshape(b, n, l_full // n, h_loc, d).permute(1, 0, 2, 3, 4)
    x = comms.all_to_all(x, group)
    # leading dim: the head group -> back into the head axis
    return x.permute(1, 2, 0, 3, 4).reshape(b, l_full // n, n * h_loc, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name, *, causal: bool = False,
                      scale: Optional[float] = None,
                      use_flash: Optional[bool] = None,
                      mesh=None) -> torch.Tensor:
    """Full-sequence attention under Ulysses sequence parallelism
    (``ulysses.py:66``): ``q, k, v [batch, seq_local, heads, head_dim]``,
    this rank's sequence shard, with ``heads`` divisible by the axis
    size. ``use_flash`` as in ``ring_attention``: ``None`` takes the
    flash kernels on CUDA tensors, and on CPU tensors where the whole
    sequence tiles; ``True`` (and ``None`` on CUDA) raises where it does
    not. Returns ``[b, seq_local, heads, head_dim]``."""
    g = axis_group(axis_name, mesh)
    if q.shape[2] % g.size != 0:
        raise ValueError(
            f"heads={q.shape[2]} must divide by axis size "
            f"{g.size} for Ulysses SP (use ring "
            "attention when heads are scarce)")
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    b = q.shape[0]
    # one exchange for all of q, k, v: the layer's two collectives
    qkv = _seq_to_heads(torch.cat([q, k, v], dim=0), g)
    qh, kh, vh = qkv[:b], qkv[b:2 * b], qkv[2 * b:]
    l_full = qh.shape[1]
    tiles = flash_supported(l_full, l_full, dtype=q.dtype)
    if use_flash is None:
        # on the card the kernels are the path: no quiet dense fallback
        use_flash = tiles or q.is_cuda
    if use_flash and not tiles:
        raise ValueError(f"ulysses attention: the flash kernels cannot tile "
                         f"seq={l_full}; pass use_flash=False for the dense "
                         "path")
    if use_flash:
        out = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    else:  # the kernels' plain version: float32 scores
        out = attention_ref(qh, kh, vh, 0, 0, causal, scale)[0]
    return _heads_to_seq(out, g)

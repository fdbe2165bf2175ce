"""Ring attention: sequence (context) parallelism over a mesh axis
(``pytorch_ps_mpi_tpu/parallel/ring.py``).

Each rank holds one shard of the sequence. Its q attends to the K/V
block it holds, then the K/V blocks move one rank on around the ring
(``comms.ring_permute``, the send and the receive posted together), n
blocks in all; the blocks' results combine by their logsumexp, the
streaming softmax one level up. A rank's memory holds O(L_local²)
scores, never O(L²).

On the flash path (``use_flash``: the default on CUDA tensors, where a
shard the kernels cannot tile raises, and on CPU tensors wherever the
shard tiles) each block is one call of the port's flash kernels
(``ops.attention.flash_attention``) with the block's global offsets and
``return_lse=True``; the offsets are Python ints, never tensors, so no
call reads the device. :func:`ring_combine` folds a block's normalized
output into the accumulators by its lse (``ring.py:77-102``), its weight
zero where the whole block was masked (``lse <= -1e29``), and the lse's
cotangent carries the gradient through the combine into the kernels'
backward. The dense path (``ring.py:68-75``, ``:103-114``) computes each
block's scores in float32 and is the plain version.

The accumulators are float32 whatever the input type, and start from q
(``isfinite`` selects zeros, so an infinite activation cannot poison
them through 0·inf, ``ring.py:126-133``); the result is cast back to
q's type.

The axis is a mesh axis name of ``mesh=``, or a ``mesh.Group``. Call it with q, k, v sharded
on the sequence axis, as the JAX function is called inside ``shard_map``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.mesh import axis_group
from pytorch_ps_mpi_tpu_torch.ops.attention import (flash_attention,
                                                    flash_supported)

_NEG_BIG = -1e30
#: "this block was masked whole" (the kernels' masked-row lse is ~-1e30)
_MASKED_LSE = -1e29


def ring_combine(num: torch.Tensor, den: torch.Tensor, mx: torch.Tensor,
                 o_blk: torch.Tensor, lse_blk: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one block into the accumulators (the body of the JAX
    ``step``, ``ring.py:91-102``): ``o_blk [b, h, q, d]`` the block's
    normalized output, ``lse_blk [b, h, q]`` its logsumexp; ``num``
    float32 ``[b, h, q, d]``, ``den`` and ``mx`` float32 ``[b, h, q]``.
    Returns the new ``(num, den, mx)``. A block whose lse is at the mask's
    floor weighs zero, even while ``mx`` is still at its own floor (where
    ``exp(lse - mx)`` would be 1)."""
    lse_blk = lse_blk.float()
    new_mx = torch.maximum(mx, lse_blk)
    corr = torch.exp(mx - new_mx)
    w = torch.where(lse_blk > _MASKED_LSE, torch.exp(lse_blk - new_mx),
                    torch.zeros_like(lse_blk))
    num = num * corr[..., None] + o_blk.float() * w[..., None]
    den = den * corr + w
    return num, den, new_mx


def _dense_block(q, k_blk, v_blk, q_pos, src: int, causal: bool,
                 scale: float, num, den, mx):
    """One block on the dense path (``ring.py:68-75``, ``:103-114``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if causal:
        l_k = k_blk.shape[1]
        k_pos = src * l_k + torch.arange(l_k, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask, s, torch.full_like(s, _NEG_BIG))
    new_mx = torch.maximum(mx, s.amax(dim=-1))
    corr = torch.exp(mx - new_mx)
    p = torch.exp(s - new_mx[..., None])
    num = num * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
    den = den * corr + p.sum(dim=-1)
    return num, den, new_mx


def ring_init(q: torch.Tensor):
    """The accumulators ``(num, den, mx)`` in float32 from q
    ``[b, l, h, d]`` (``ring.py:126-133``)."""
    zq = q.transpose(1, 2).float()                     # [b, h, l_q, d]
    z = torch.where(torch.isfinite(zq), zq * 0, torch.zeros_like(zq))
    return z, z[..., 0], z[..., 0] + _NEG_BIG


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name, *, causal: bool = False,
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None,
                   mesh=None) -> torch.Tensor:
    """Ring attention over sequence shards (``ring.py:28``).

    ``q, k, v [batch, seq_local, heads, head_dim]`` are this rank's shard
    (the global sequence is ``seq_local`` times the axis size, shard i
    holding positions ``[i·l, (i+1)·l)``); ``causal`` masks in global
    coordinates; ``scale`` defaults to ``head_dim ** -0.5``. ``use_flash``:
    ``None`` takes the flash kernels on CUDA tensors, and on CPU tensors
    where the local shard tiles (the dense path elsewhere); ``True`` (and
    ``None`` on CUDA) raises where the shard does not tile. Returns
    this shard's rows of full-sequence attention, ``[b, l_q, h, d]`` in
    q's type."""
    g = axis_group(axis_name, mesh)
    n, me = g.size, g.index
    b, l_q, h, d = q.shape
    l_k = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    tiles = flash_supported(l_q, l_k, dtype=q.dtype)
    if use_flash is None:
        # on the card the kernels are the path: no quiet dense fallback
        use_flash = tiles or q.is_cuda
    if use_flash and not tiles:
        raise ValueError(f"ring attention: the flash kernels cannot tile "
                         f"local shards of q {l_q} and k {l_k} tokens; pass "
                         "use_flash=False for the dense path")
    q_pos = me * l_q + torch.arange(l_q, device=q.device)
    num, den, mx = ring_init(q)
    k_cur, v_cur, src = k, v, me
    for step in range(n):
        if use_flash:
            o_blk, lse = flash_attention(
                q, k_cur, v_cur, causal=causal, scale=scale,
                q_offset=me * l_q, k_offset=src * l_k, return_lse=True)
            num, den, mx = ring_combine(num, den, mx, o_blk.transpose(1, 2),
                                        lse)
        else:
            num, den, mx = _dense_block(q, k_cur, v_cur, q_pos, src, causal,
                                        scale, num, den, mx)
        if step < n - 1:
            # rotate: we now hold the previous rank's block
            k_cur = comms.ring_permute(k_cur, g)
            v_cur = comms.ring_permute(v_cur, g)
            src = (src - 1) % n
    out = num / torch.clamp(den, min=1e-30)[..., None]  # [b, h, q, d]
    return out.transpose(1, 2).to(q.dtype)

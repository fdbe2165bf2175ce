"""Flash attention (forward and backward): CUDA kernels and their plain
PyTorch versions.

The attention of ``BertMLM`` with ``attention="flash"``. The wrappers
replace the Pallas TPU kernels of
``pytorch_ps_mpi_tpu/ops/attention_pallas.py``:

=================  =================================================  =================
wrapper            replaces                                           kernel
=================  =================================================  =================
``flash_fwd``      ``_fwd`` (``attention_pallas.py:143``, the         ``csrc/attention.cu``
                   ``pallas_call`` at ``:150``)                       ``flash_fwd``
``flash_bwd``      ``_bwd`` (``:267``): the dq ``pallas_call``        ``flash_bwd_dq``,
                   (``:281``) and the dk/dv one (``:301``)            ``flash_bwd_dkv``
=================  =================================================  =================

:func:`flash_attention` is the public function on ``[b, l, h, d]``
tensors (``attention_pallas.py:405-446``); a ``torch.autograd.Function``
joins the forward and backward kernels on ``[b·h, l, d]`` tensors, and
the backward takes a cotangent for the returned logsumexp too
(``dm = rowsum(g_out·out) − g_lse``), which ring attention needs.

Semantics, the Pallas kernels': scores in float32, a causal mask in
global coordinates from the runtime offsets (``k_off + col <= q_off +
row``), the mask value −1e30 with ``p`` zeroed below −1e29 (a row with no
visible key gives ``o = 0`` and ``lse = −1e30 + log(1e−30)``), ``p`` and
``ds`` rounded to the input type before their products, ``lse`` in
float32 as ``[b·h, l]``. The kernels' own tiles are 64 rows of q by 64
of k for every length; ``block_q``/``block_k`` keep the JAX function's
meaning for when a shape tiles (``_pick_block``): a length that is not
a multiple of the type's minimal tile (8 for float32, 16 for bf16) takes
the dense plain path, as in the JAX package.

Bound and design: see ``csrc/attention.cu``. A wrapper takes its plain
version (``*_ref``) only for CPU tensors. For CUDA tensors it launches
its kernels or raises; it never falls back. ``flash_fwd.launches``
counts forward launches, ``flash_bwd.launches`` the dq and dk/dv
launches (two a backward).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pytorch_ps_mpi_tpu_torch.ops import _build

_MASKED = -1e30       # additive mask value
_MASK_THRESH = -1e29  # "this score was masked"

#: the kernels' q and k tile (rows of each)
BLOCK = 64
#: head dims the kernels are built for
HEAD_DIMS = (8, 16, 32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "flash_fwd": (_I, [_P] * 5 + [_I] * 7 + [_F, _I, _P]),
    "flash_bwd_dq": (_I, [_P] * 7 + [_I] * 7 + [_F, _I, _P]),
    "flash_bwd_dkv": (_I, [_P] * 8 + [_I] * 7 + [_F, _I, _P]),
}


# -- tiling rules (the JAX package's) ------------------------------------------

def _pick_block(length: int, target: int, min_block: int = 8) -> Optional[int]:
    """Largest power-of-two block <= target that divides ``length``
    (>= ``min_block``); None if the length cannot tile."""
    b = 1
    while b * 2 <= min(target, length) and length % (b * 2) == 0:
        b *= 2
    return b if b >= min_block and length % b == 0 else None


def _min_block_for(dtype: torch.dtype) -> int:
    """Minimal tile for the dtype (float32: 8, bf16/f16: 16)."""
    return 16 if dtype.itemsize < 4 else 8


def flash_supported(lq: int, lk: int, block_q: int = 128, block_k: int = 128,
                    dtype: torch.dtype = torch.float32) -> bool:
    """Can the tiled kernel serve these sequence lengths (at this dtype's
    minimal tile)?"""
    mb = _min_block_for(dtype)
    return (_pick_block(lq, block_q, mb) is not None
            and _pick_block(lk, block_k, mb) is not None)


# -- plain versions --------------------------------------------------------------

def attention_ref(q, k, v, q_offset, k_offset, causal: bool, scale: float):
    """Dense attention with the kernels' semantics on ``[b, l, h, d]``
    (``_attention_jnp``, ``attention_pallas.py:370-387``): returns
    ``(out, lse[b, h, q])``; differentiable. The path for shapes that do
    not tile."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = q_offset + torch.arange(q.shape[1], device=q.device)
        cols = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(cols[None, :] <= rows[:, None], s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > _MASK_THRESH, torch.exp(s - m), 0.0)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float()).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def _scores(q3, k3, q_off: int, k_off: int, causal: bool, scale: float):
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        rows = q_off + torch.arange(q3.shape[1], device=q3.device)
        cols = k_off + torch.arange(k3.shape[1], device=q3.device)
        s = torch.where(cols[None, :] <= rows[:, None], s, _MASKED)
    return s


def flash_fwd_ref(q3, k3, v3, q_off: int, k_off: int, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[bh, l, d]`` -> ``(o[bh, lq, d]`` in the input type,
    ``lse[bh, lq]`` float32): the forward kernel's function in one dense
    pass, ``p`` rounded to the input type before ``p @ v``."""
    s = _scores(q3, k3, q_off, k_off, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > _MASK_THRESH, torch.exp(s - m), 0.0)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v3.dtype).float(), v3.float())
    return (acc / l_safe).to(q3.dtype), (m + torch.log(l_safe))[..., 0]


def _dm(out3, g_out3, g_lse) -> torch.Tensor:
    """rowsum(g_out·out) − g_lse in float32, ``[bh, lq]``."""
    return (g_out3.float() * out3.float()).sum(dim=-1) - g_lse.float()


def flash_bwd_ref(q3, k3, v3, out3, lse, g_out3, g_lse, q_off: int,
                  k_off: int, causal: bool, scale: float):
    """``(dq, dk, dv)`` in the input type: the backward kernels' function
    in dense passes, ``p`` and ``ds`` rounded to the input type before
    their products."""
    dt = q3.dtype
    s = _scores(q3, k3, q_off, k_off, causal, scale)
    p = torch.where(s > _MASK_THRESH, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(g_out3.float(), v3.float().transpose(1, 2))
    ds = (p * (dp - _dm(out3, g_out3, g_lse)[..., None])).to(dt).float()
    dq = torch.matmul(ds, k3.float()) * scale
    dk = torch.matmul(ds.transpose(1, 2), q3.float()) * scale
    dv = torch.matmul(p.to(dt).float().transpose(1, 2), g_out3.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


# -- kernel wrappers -------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    return _build.load("attention", _SIGNATURES)


def _check_qkv(q3, k3, v3, what: str) -> None:
    if not (q3.dim() == k3.dim() == v3.dim() == 3):
        raise ValueError(f"{what}: expected [bh, l, d] tensors")
    if q3.dtype not in (torch.float32, torch.bfloat16) or not (
            q3.dtype == k3.dtype == v3.dtype):
        raise ValueError(f"{what}: q, k, v must all be float32 or bfloat16, "
                         f"got {q3.dtype}, {k3.dtype}, {v3.dtype}")
    bh, _, d = q3.shape
    if k3.shape != v3.shape or k3.shape[0] != bh or k3.shape[2] != d:
        raise ValueError(f"{what}: q {tuple(q3.shape)}, k {tuple(k3.shape)}, "
                         f"v {tuple(v3.shape)} do not fit")
    if not (q3.device == k3.device == v3.device):
        raise ValueError(f"{what}: q, k, v must share a device")
    if q3.device.type == "cuda" and d not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernels take head dims {HEAD_DIMS}, "
                         f"got {d}")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_fwd(q3, k3, v3, q_off: int, k_off: int, causal: bool,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[bh, l, d]`` q, k, v -> ``(o, lse[bh, lq])``."""
    _check_qkv(q3, k3, v3, "flash_fwd")
    if q3.device.type == "cpu":
        return flash_fwd_ref(q3, k3, v3, q_off, k_off, causal, scale)
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    bh, lq, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty(bh, lq, dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        err = _lib().flash_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, lq, k3.shape[1], d, int(q_off), int(k_off),
            int(causal), float(scale), int(q3.dtype == torch.bfloat16),
            _stream(q3.device))
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd(q3, k3, v3, out3, lse, g_out3, g_lse, q_off: int, k_off: int,
              causal: bool, scale: float):
    """``(dq, dk, dv)`` for the cotangents ``g_out3`` of ``out3`` and
    ``g_lse`` of ``lse``: the dq kernel, then the dk/dv kernel."""
    _check_qkv(q3, k3, v3, "flash_bwd")
    if q3.device.type == "cpu":
        return flash_bwd_ref(q3, k3, v3, out3, lse, g_out3, g_lse, q_off,
                             k_off, causal, scale)
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    g_out3 = g_out3.to(q3.dtype).contiguous()
    lse = lse.contiguous()
    dm = _dm(out3, g_out3, g_lse).contiguous()
    bh, lq, d = q3.shape
    lk = k3.shape[1]
    dq = torch.empty_like(q3)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    tail = (bh, lq, lk, d, int(q_off), int(k_off), int(causal), float(scale),
            int(q3.dtype == torch.bfloat16), _stream(q3.device))
    with torch.cuda.device(q3.device):
        lib = _lib()
        err = lib.flash_bwd_dq(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                               g_out3.data_ptr(), lse.data_ptr(),
                               dm.data_ptr(), dq.data_ptr(), *tail)
        _raise_on(err, "flash_bwd_dq")
        flash_bwd.launches += 1
        err = lib.flash_bwd_dkv(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                                g_out3.data_ptr(), lse.data_ptr(),
                                dm.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                *tail)
        _raise_on(err, "flash_bwd_dkv")
        flash_bwd.launches += 1
    return dq, dk, dv


flash_fwd.launches = 0
flash_bwd.launches = 0


class _Flash(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, q3, k3, v3, q_off, k_off, causal, scale):
        out, lse = flash_fwd(q3, k3, v3, q_off, k_off, causal, scale)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.args = (q_off, k_off, causal, scale)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q3, k3, v3, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q3, k3, v3, out, lse, g_out, g_lse, *ctx.args)
        return dq, dk, dv, None, None, None, None


# -- public API on [b, l, h, d] (the models' layout) --------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset=None, k_offset=None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None, return_lse: bool = False):
    """Tiled attention over ``[batch, seq, heads, head_dim]`` tensors.

    ``q_offset``/``k_offset`` (ints, or one-element tensors read once on
    the host) place the q and k blocks in global sequence coordinates for
    the causal mask. With ``return_lse=True`` also returns the per-row
    logsumexp ``[b, h, q]`` (differentiable)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    q_offset = 0 if q_offset is None else int(q_offset)
    k_offset = 0 if k_offset is None else int(k_offset)
    mb = _min_block_for(q.dtype)
    bq = _pick_block(lq, block_q if block_q is not None else BLOCK, mb)
    bk = _pick_block(lk, block_k if block_k is not None else BLOCK, mb)
    if bq is None or bk is None:
        out, lse = attention_ref(q, k, v, q_offset, k_offset, causal, scale)
        return (out, lse) if return_lse else out

    def to3(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d)

    out3, lse3 = _Flash.apply(to3(q), to3(k), to3(v), q_offset, k_offset,
                              bool(causal), float(scale))
    out = out3.reshape(b, h, lq, d).transpose(1, 2)
    return (out, lse3.reshape(b, h, lq)) if return_lse else out

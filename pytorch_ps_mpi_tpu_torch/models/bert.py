"""BERT-style encoder with an MLM head (``pytorch_ps_mpi_tpu/models/bert.py``),
BASELINE config 5: BERT-base masked-LM, a large flat gradient.

flax's parameter names and layouts are kept, so a leaf flattens to the
same element order in both packages (and a TernGrad payload of it is the
same array): ``tok_emb.embedding`` ``[V, H]``, per layer
``layer_{i}.SelfAttention_0.qkv.kernel`` ``[H, 3, h, d]`` (bias
``[3, h, d]``), ``...out.kernel`` ``[h, d, H]``, ``Dense_{0,1}.kernel``
``[in, out]``, ``LayerNorm_{0,1}.{scale,bias}``, and at the top
``LayerNorm_0`` and ``mlm_head``. The products are matmuls over those
layouts.

With ``dtype=torch.bfloat16`` the model computes as flax does with
``dtype=jnp.bfloat16`` and float32 parameters: embeddings, Dense inputs,
kernels and biases are cast to bf16 (the bias add in bf16); LayerNorm
takes its statistics and affine in float32 and returns bf16 (flax's
``epsilon=1e-6``; PyTorch's two-pass variance where flax takes
``E[x²] − E[x]²``); GELU is the tanh form (flax's ``nn.gelu`` default);
the logits are cast to float32 (``f32_logits``).

Attention: ``"flash"`` is the kernel of ``ops/attention.py`` (it raises
where the sequence does not tile); ``"full"`` and ``"einsum"`` the dense
path, as the JAX package runs ``"full"`` off the TPU. ``"ring"`` and
``"ulysses"`` are sequence parallel over the mesh axis ``seq_axis``
(``parallel/ring.py``, ``parallel/ulysses.py``; build the model with
``mesh=`` and call it with this rank's shard of the tokens and
``position_offset`` its first position), each block or local attention
on the flash kernels (on CUDA tensors a shard they cannot tile raises;
on CPU tensors it takes the dense path).

``scan_layers=True`` keeps the L layers as one stacked parameter set
under ``layers.EncoderLayer_0`` (each leaf ``[L, ...]``, flax's
``nn.scan`` layout, ``bert.py:162-196``), looped over by one layer
body; :func:`stack_layer_params` converts the loop layout. A scanned
model from a seed equals the loop model from that seed, stacked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.ops.attention import (flash_attention,
                                                    flash_supported)
from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_attention
from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

#: flax's LayerNorm epsilon
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    dtype: torch.dtype = torch.float32
    attention: str = "full"       # 'full', 'flash', 'einsum', 'ring', 'ulysses'
    seq_axis: str = "seq"         # mesh axis for ring/ulysses attention
    causal: bool = False          # decoder-only masking (GPT family)
    remat: bool = False           # recompute each layer in the backward
    scan_layers: bool = False     # stacked [L, ...] layer parameters
    f32_logits: bool = True       # cast the logits to float32

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        defaults = dict(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=128,
        )
        defaults.update(kw)
        return BertConfig(**defaults)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: ``kernel [*in, *out]``, ``bias
    [*out]``; input, kernel and bias cast to ``dtype``."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.empty(self.out_shape))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = torch.matmul(x.to(self.dtype).reshape(*lead, n_in),
                         self.kernel.to(self.dtype).reshape(n_in, n_out))
        y = y + self.bias.to(self.dtype).reshape(n_out)
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``Embed``: ``embedding [num, features]``, cast to ``dtype``
    before the lookup."""

    def __init__(self, num: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))
        self.dtype = dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.embedding.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: statistics and affine in float32, the result in
    ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, LN_EPS).to(self.dtype)


def dense_attention(q, k, v, causal: bool) -> torch.Tensor:
    """The dense path of ``attention="full"`` (``bert.py:117-123``), in
    the input type."""
    l, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    if causal:
        mask = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype,
                                              device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class SelfAttention(nn.Module):
    """``mesh``: the mesh whose ``cfg.seq_axis`` the ring and Ulysses
    collectives run over (None: a world of one rank)."""

    def __init__(self, cfg: BertConfig, mesh=None):
        super().__init__()
        c = cfg
        self.cfg = c
        self.mesh = mesh
        head_dim = c.hidden_size // c.num_heads
        self.qkv = Dense((c.hidden_size,), (3, c.num_heads, head_dim), c.dtype)
        self.out = Dense((c.num_heads, head_dim), (c.hidden_size,), c.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        qkv = self.qkv(x)                      # [b, l, 3, h, d]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if c.attention == "ring":
            out = ring_attention(q, k, v, c.seq_axis, causal=c.causal,
                                 mesh=self.mesh)
        elif c.attention == "ulysses":
            out = ulysses_attention(q, k, v, c.seq_axis, causal=c.causal,
                                    mesh=self.mesh)
        elif c.attention == "flash":
            l = q.shape[1]
            if not flash_supported(l, l, dtype=c.dtype):
                raise ValueError(
                    f"attention='flash' cannot tile seq={l} (needs a "
                    "power-of-two block >= 8 dividing it); use 'full' "
                    "for the dense path")
            out = flash_attention(q, k, v, causal=c.causal)
        elif c.attention in ("full", "einsum"):
            out = dense_attention(q, k, v, c.causal)
        else:
            raise ValueError(
                f"unknown attention={c.attention!r}: expected 'full', "
                "'flash', 'einsum', 'ring', or 'ulysses'")
        return self.out(out)


class EncoderLayer(nn.Module):
    """Pre-norm encoder layer; submodule names are flax's auto-names."""

    def __init__(self, cfg: BertConfig, mesh=None):
        super().__init__()
        c = cfg
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype)
        self.SelfAttention_0 = SelfAttention(c, mesh)
        self.LayerNorm_1 = LayerNorm(c.hidden_size, c.dtype)
        self.Dense_0 = Dense((c.hidden_size,), (c.intermediate_size,), c.dtype)
        self.Dense_1 = Dense((c.intermediate_size,), (c.hidden_size,), c.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        y = self.Dense_0(self.LayerNorm_1(x))
        y = self.Dense_1(F.gelu(y, approximate="tanh"))
        return x + y


def _stacked(template: nn.Module, n: int) -> nn.Module:
    """A module tree named as ``template``'s, each parameter ``[n, ...]``."""
    m = nn.Module()
    for name, p in template.named_parameters(recurse=False):
        m.register_parameter(name, nn.Parameter(
            torch.empty((n,) + tuple(p.shape))))
    for name, child in template.named_children():
        m.add_module(name, _stacked(child, n))
    return m


class ScannedLayers(nn.Module):
    """The ``scan_layers`` trunk: one :class:`EncoderLayer` body (a
    template on the meta device, holding no parameters of its own) run L
    times over a stacked parameter set, ``EncoderLayer_0`` with every
    leaf ``[L, ...]`` (flax's ``layers/EncoderLayer_0``)."""

    def __init__(self, cfg: BertConfig, mesh=None):
        super().__init__()
        with torch.device("meta"):
            body = EncoderLayer(cfg, mesh)
        self._body = (body,)  # a tuple: not a registered submodule
        self.cfg = cfg
        self.EncoderLayer_0 = _stacked(body, cfg.num_layers)

    def _layer(self, x: torch.Tensor, *leaves: torch.Tensor) -> torch.Tensor:
        return functional_call(self._body[0], dict(zip(self._names, leaves)),
                               (x,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        named = dict(self.EncoderLayer_0.named_parameters())
        self._names = list(named)
        for i in range(self.cfg.num_layers):
            leaves = [p[i] for p in named.values()]
            if self.cfg.remat:
                x = checkpoint(self._layer, x, *leaves,
                               use_reentrant=False)
            else:
                x = self._layer(x, *leaves)
        return x


def encoder_stack(cfg: BertConfig, layers: Sequence[nn.Module],
                  x: torch.Tensor) -> torch.Tensor:
    """The L-layer trunk: the named layers in order, each recomputed in
    the backward under ``remat`` (a :class:`ScannedLayers` is the whole
    trunk)."""
    for layer in layers:
        if cfg.remat and not isinstance(layer, ScannedLayers):
            x = checkpoint(layer, x, use_reentrant=False)
        else:
            x = layer(x)
    return x


def add_layers(module: nn.Module, cfg: BertConfig, mesh=None) -> None:
    """Give ``module`` its trunk: ``layer_{i}`` (the loop layout) or
    ``layers`` (:class:`ScannedLayers`), their attention over ``mesh``."""
    if cfg.scan_layers:
        module.layers = ScannedLayers(cfg, mesh)
    else:
        for i in range(cfg.num_layers):
            module.add_module(f"layer_{i}", EncoderLayer(cfg, mesh))


def trunk(module: nn.Module, cfg: BertConfig) -> list:
    """The modules :func:`encoder_stack` runs for ``module``."""
    if cfg.scan_layers:
        return [module.layers]
    return [getattr(module, f"layer_{i}") for i in range(cfg.num_layers)]


def stack_layer_params(params: dict, num_layers: int) -> dict:
    """Loop-layout parameters (``layer_{i}.*``) in the ``scan_layers``
    layout (``layers.EncoderLayer_0.*``, each leaf the layers' stack),
    the rest unchanged (``bert.py:182``). ``params``: ``name -> tensor``."""
    out = {k: v for k, v in params.items() if not k.startswith("layer_")}
    rest = sorted({k.split(".", 1)[1] for k in params
                   if k.startswith("layer_0.")})
    for r in rest:
        out[f"layers.EncoderLayer_0.{r}"] = torch.stack(
            [params[f"layer_{i}.{r}"] for i in range(num_layers)])
    return out


@torch.no_grad()
def init_like_flax(module: nn.Module, seed: int) -> None:
    """flax's initializer shapes from ``seed``, in module order: normal
    with variance 1/fan_in for Dense kernels and embeddings, biases 0
    (LayerNorm scales stay 1)."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, Dense):
            fan_in = math.prod(m.in_shape)
            m.kernel.copy_(torch.randn(m.kernel.shape, generator=gen)
                           / math.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, Embed):
            m.embedding.copy_(torch.randn(m.embedding.shape, generator=gen)
                              / math.sqrt(m.embedding.shape[0]))


@torch.no_grad()
def init_scanned(module: nn.Module, loop_twin: nn.Module) -> None:
    """Set a ``scan_layers`` model's parameters to its loop-layout twin's,
    stacked."""
    stacked = stack_layer_params(dict(loop_twin.named_parameters()),
                                 module.cfg.num_layers)
    for name, p in module.named_parameters():
        p.copy_(stacked[name])


class BertMLM(nn.Module):
    """Token-in, vocab-logits-out masked-LM model (pre-norm encoder).

    Parameters are float32, drawn from ``seed`` with flax's initializer
    shapes (normal with variance 1/fan_in for kernels and embeddings,
    biases 0, LayerNorm scales 1); to compute a JAX model's function, load
    its weights with ``utils.interop.params_from_jax``. ``mesh``: the mesh
    of ``attention="ring"|"ulysses"`` (None: a world of one rank)."""

    def __init__(self, cfg: BertConfig, *, seed: int = 0,
                 device: Device = "cuda", mesh=None):
        super().__init__()
        c = self.cfg = cfg
        self.tok_emb = Embed(c.vocab_size, c.hidden_size, c.dtype)
        self.pos_emb = Embed(c.max_position, c.hidden_size, c.dtype)
        add_layers(self, c, mesh)
        self.LayerNorm_0 = LayerNorm(c.hidden_size, c.dtype)
        self.mlm_head = Dense((c.hidden_size,), (c.vocab_size,), c.dtype)
        if c.scan_layers:
            init_scanned(self, BertMLM(dataclasses.replace(
                c, scan_layers=False), seed=seed, device="cpu"))
        else:
            init_like_flax(self, seed)
        self.to(resolve_device(device))

    def trunk(self):
        return trunk(self, self.cfg)

    def forward(self, tokens: torch.Tensor,
                position_offset: int = 0) -> torch.Tensor:
        """``tokens [B, L]`` -> logits ``[B, L, V]`` (float32 under
        ``f32_logits``)."""
        c = self.cfg
        positions = position_offset + torch.arange(tokens.shape[-1],
                                                   device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(positions)[None]
        x = encoder_stack(c, self.trunk(), x)
        logits = self.mlm_head(self.LayerNorm_0(x))
        return logits.float() if c.f32_logits else logits


def target_log_likelihood(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Per-position ``log p(target)`` with float32 reductions for any
    logits dtype; the max is a constant of the gradient (``bert.py:220``)."""
    m = logits.detach().amax(dim=-1).float()
    z = torch.exp(logits.float() - m[..., None])
    lse = m + torch.log(z.sum(dim=-1))
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0].float()
    return tgt - lse


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the masked positions only."""
    ll = target_log_likelihood(logits, targets)
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

"""The precision of the references' products, and the switch that keeps
float32 products in float32.

``product(name)`` gives the function a reference wraps around every
matrix product and convolution, ``product(fn, a, b)``:

- ``"fp32"``: the product as it is (the reference proper, TF32 off);
- ``"bf16"``: both operands rounded to bfloat16, and in the backward the
  product's incoming gradient too, with float32 accumulation (the
  control of a configuration that states float32 with TF32
  convolutions: bf16 products, as mixed precision runs them);
- ``"fp8"``: the operands rounded to float8 e4m3 and the incoming
  gradient to e5m2, each tensor scaled so its largest magnitude is the
  format's largest finite value and scaled back (the control of a
  configuration that states bf16 products: fp8 products as the hybrid
  recipe runs them).

Everything else (sums, norms, softmax, the loss) stays in float32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch


@contextlib.contextmanager
def highest() -> Iterator[None]:
    """Products in true float32 inside the block: no TF32 in matmuls or
    cuDNN convolutions. The settings before it are restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _scaled(fmt: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    top = torch.finfo(fmt).max

    def cast(x: torch.Tensor) -> torch.Tensor:
        scale = top / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(fmt).to(x.dtype) / scale
    return cast


#: (operand rounding, incoming-gradient rounding) of each precision
FORMATS = {"bf16": (_bf16, _bf16),
           "fp8": (_scaled(torch.float8_e4m3fn), _scaled(torch.float8_e5m2))}


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded; backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x, rnd):
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Output(torch.autograd.Function):
    """Forward: the product's result as it is; backward: its incoming
    gradient rounded, before the product's own backward takes it."""

    @staticmethod
    def forward(ctx, y, rnd):
        ctx.rnd = rnd
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def _plain(fn, a, b, **kw):
    return fn(a, b, **kw)


def product(name: str) -> Callable:
    """``call(fn, a, b, **kw)``: ``fn(a, b, **kw)`` in precision ``name``."""
    if name == "fp32":
        return _plain
    if name not in FORMATS:
        raise ValueError(f"unknown precision {name!r}: fp32 or one of "
                         f"{sorted(FORMATS)}")
    fwd, bwd = FORMATS[name]

    def call(fn, a, b, **kw):
        y = fn(_Operand.apply(a, fwd), _Operand.apply(b, fwd), **kw)
        return _Output.apply(y, bwd)
    return call

"""Fused optimizer update rules: SGD, Adam and Adafactor, plus the
learning-rate schedules.

The counterpart of ``pytorch_ps_mpi_tpu/optim.py``; the math mirrors the
reference's ``SGD.optim_step`` (``ps.py:195-214``) and
``Adam.optim_step`` (``ps.py:217-261``). Parameters, gradients and
optimizer state are ``name -> tensor`` dicts. **Every update runs in
place** under ``torch.no_grad()``: the parameter and state tensors given
are overwritten and returned again, so the step holds one copy of
each. The arithmetic keeps the JAX package's operation order (no fused
multiply-adds), so SGD agrees with it bit for bit in float32.

Reference quirk kept: the momentum buffer starts as the first ``d_p``
(``ps.py:203-205``, torch semantics), not as zero.

``lr`` may be a float or a schedule ``step -> scalar`` from
:data:`SCHEDULES`, evaluated on the optimizer's 0-based step counter in
float32, as the JAX package evaluates it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
LR = Union[float, Callable[[int], torch.Tensor], None]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _lr_at(lr: LR, step: int):
    """Resolve a constant-or-schedule lr at a 0-based step."""
    return lr(step) if callable(lr) else lr


# -- schedules (each returns step -> float32 scalar tensor) ------------------

def constant_lr(base: float) -> Callable[[int], torch.Tensor]:
    return lambda step: _f32(base)


def warmup_cosine(base: float, total_steps: int, warmup_steps: int = 0,
                  final_scale: float = 0.0) -> Callable[[int], torch.Tensor]:
    """Linear warmup 0 -> base over ``warmup_steps``, then cosine decay to
    ``final_scale * base`` at ``total_steps`` (flat afterwards)."""
    if total_steps <= warmup_steps:
        raise ValueError("total_steps must exceed warmup_steps")

    def f(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / (total_steps - warmup_steps),
                        0.0, 1.0)
        cos = final_scale + (1.0 - final_scale) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return _f32(base) * torch.where(s < warmup_steps, warm, cos)

    return f


def step_decay(base: float, boundaries: Tuple[int, ...],
               scale: float = 0.1) -> Callable[[int], torch.Tensor]:
    """Multiply by ``scale`` at each boundary step (torch MultiStepLR)."""
    bounds = torch.tensor(boundaries, dtype=torch.int32)

    def f(step):
        k = (step >= bounds).sum().to(torch.float32)
        return _f32(base) * _f32(scale) ** k

    return f


SCHEDULES: Dict[str, Callable[..., Callable]] = {
    "constant": constant_lr,
    "warmup_cosine": warmup_cosine,
    "step_decay": step_decay,
}


class SGDHyper(NamedTuple):
    lr: LR = 0.01
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False


class AdamHyper(NamedTuple):
    lr: LR = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    amsgrad: bool = False
    # False: torch.optim.Adam's coupled L2 (the reference's semantics);
    # True: AdamW, decay applied to the params outside the rescaling
    decoupled_weight_decay: bool = False


class SGDState(NamedTuple):
    step: int
    momentum_buf: Params     # zeros when momentum == 0


class AdamState(NamedTuple):
    step: int
    exp_avg: Params
    exp_avg_sq: Params
    max_exp_avg_sq: Params   # used only when amsgrad


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def init_sgd_state(params: Params) -> SGDState:
    return SGDState(0, _zeros_like(params))


def init_adam_state(params: Params) -> AdamState:
    return AdamState(0, _zeros_like(params), _zeros_like(params),
                     _zeros_like(params))


@torch.no_grad()
def sgd_update(params: Params, grads: Params, state: SGDState,
               h: SGDHyper) -> Tuple[Params, SGDState]:
    """One SGD step on the aggregated gradient (reference
    ``ps.py:197-214``), in place."""
    first = state.step == 0
    lr = _lr_at(h.lr, state.step)
    for k, p in params.items():
        g, buf = grads[k], state.momentum_buf[k]
        d_p = g + h.weight_decay * p if h.weight_decay else g
        if h.momentum:
            if first:
                buf.copy_(d_p)
            else:
                buf.mul_(h.momentum).add_((1.0 - h.dampening) * d_p)
            d_p = d_p + h.momentum * buf if h.nesterov else buf
        p.sub_(lr * d_p)
    return params, SGDState(state.step + 1, state.momentum_buf)


@torch.no_grad()
def adam_update(params: Params, grads: Params, state: AdamState,
                h: AdamHyper) -> Tuple[Params, AdamState]:
    """One Adam step (reference ``ps.py:218-261``): moment updates,
    optional amsgrad max-denominator, bias-corrected update; in place."""
    step = state.step + 1
    lr = _lr_at(h.lr, state.step)
    t = _f32(step)
    bias1 = 1.0 - h.b1 ** t
    bias2 = 1.0 - h.b2 ** t
    step_size = lr * torch.sqrt(bias2) / bias1
    for k, p in params.items():
        g = grads[k]
        m, v = state.exp_avg[k], state.exp_avg_sq[k]
        vmax = state.max_exp_avg_sq[k]
        if h.weight_decay and not h.decoupled_weight_decay:
            g = g + h.weight_decay * p  # coupled L2 (torch Adam)
        m.mul_(h.b1).add_((1.0 - h.b1) * g)
        v.mul_(h.b2).add_((1.0 - h.b2) * (g * g))
        if h.amsgrad:
            torch.maximum(vmax, v, out=vmax)
            denom = torch.sqrt(vmax) + h.eps
        else:
            denom = torch.sqrt(v) + h.eps
        decay = (lr * h.weight_decay * p
                 if h.weight_decay and h.decoupled_weight_decay else None)
        p.sub_(step_size * m / denom)
        if decay is not None:
            p.sub_(decay)  # AdamW
    return params, AdamState(step, state.exp_avg, state.exp_avg_sq,
                             state.max_exp_avg_sq)


# -- Adafactor (Shazeer & Stern 2018): second moments of [n, m] leaves kept
#    factored as a row and a column vector; the no-momentum form, with the
#    JAX package's one deliberate divergence from optax kept: lr=None is
#    the paper's relative step min(1e-2, 1/sqrt(t)) (optim.py:206-215). ---

_FACTOR_MIN = 128


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """The two largest axes (d1, d0), or None when the second-largest is
    below the factoring threshold (optax's rule)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < _FACTOR_MIN:
        return None
    return order[-2], order[-1]


class AdafactorHyper(NamedTuple):
    lr: LR = None                 # None -> relative step min(1e-2, t^-0.5)
    decay_rate: float = 0.8       # beta2_t = 1 - t^-decay_rate
    eps1: float = 1e-30           # squared-gradient regularizer
    eps2: float = 1e-3            # parameter-scale floor
    clip_threshold: float = 1.0   # update block-RMS clip
    weight_decay: float = 0.0     # added to the update, not lr-scaled
    multiply_by_parameter_scale: bool = True


class AdafactorState(NamedTuple):
    step: int
    v_row: Params   # factored leaves: shape minus the largest dim
    v_col: Params   # shape minus the second-largest; zeros((1,)) sentinel
    v_full: Params  # unfactored leaves: full shape; sentinel otherwise


def init_adafactor_state(params: Params) -> AdafactorState:
    v_row, v_col, v_full = {}, {}, {}
    for k, p in params.items():
        dims = _factored_dims(p.shape)
        sentinel = lambda: p.new_zeros((1,))  # noqa: E731
        if dims is None:
            v_row[k], v_col[k], v_full[k] = sentinel(), sentinel(), \
                torch.zeros_like(p)
        else:
            shape = list(p.shape)
            v_row[k] = p.new_zeros(shape[:dims[1]] + shape[dims[1] + 1:])
            v_col[k] = p.new_zeros(shape[:dims[0]] + shape[dims[0] + 1:])
            v_full[k] = sentinel()
    return AdafactorState(0, v_row, v_col, v_full)


@torch.no_grad()
def adafactor_update(params: Params, grads: Params, state: AdafactorState,
                     h: AdafactorHyper, scalar_mean=None
                     ) -> Tuple[Params, AdafactorState]:
    """One Adafactor step on the aggregated gradient, in place.

    ``scalar_mean`` turns the two per-leaf scalar means (the update's
    clip RMS and the parameter scale) into means over a leaf's shards
    under model parallelism (``optim.py:275``): the mean over the model
    axes of the shards' means, which for shards of equal size is the
    global mean (and a replicated leaf's own). The factored row and
    column means never span shards (:func:`adafactor_check_sharding`)."""
    mean_sq = scalar_mean if scalar_mean is not None else (lambda x: x)
    step = state.step + 1
    t = _f32(step)
    beta2t = 1.0 - t ** (-h.decay_rate)
    lr = (torch.minimum(_f32(1e-2), 1.0 / torch.sqrt(t)) if h.lr is None
          else _lr_at(h.lr, state.step))
    for k, p in params.items():
        g = grads[k]
        vr, vc, vf = state.v_row[k], state.v_col[k], state.v_full[k]
        dims = _factored_dims(p.shape)
        g2 = g * g + h.eps1
        if dims is not None:
            d1, d0 = dims
            vr.copy_(beta2t * vr + (1.0 - beta2t) * g2.mean(dim=d0))
            vc.copy_(beta2t * vc + (1.0 - beta2t) * g2.mean(dim=d1))
            # the per-row mean normalizer lives in the row factor
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = vr.mean(dim=reduced_d1, keepdim=True)
            u = (g * ((vr / row_mean) ** -0.5).unsqueeze(d0)
                 * (vc ** -0.5).unsqueeze(d1))
        else:
            vf.copy_(beta2t * vf + (1.0 - beta2t) * g2)
            u = g * vf ** -0.5
        rms_u = torch.sqrt(mean_sq(torch.mean(u * u)))
        u = u / torch.clamp(rms_u / h.clip_threshold, min=1.0)
        scale = lr
        if h.multiply_by_parameter_scale:
            scale = scale * torch.clamp(
                torch.sqrt(mean_sq(torch.mean(p.to(torch.float32) ** 2))),
                min=h.eps2)
        decay = h.weight_decay * p if h.weight_decay else None
        p.sub_(scale * u)
        if decay is not None:
            p.sub_(decay)
    return params, AdafactorState(step, state.v_row, state.v_col,
                                  state.v_full)


def _shape_of(p) -> Tuple[int, ...]:
    return tuple(p) if isinstance(p, (tuple, list)) else tuple(p.shape)


def adafactor_check_sharding(params, param_specs) -> None:
    """Reject a leaf whose global factored dims are sharded
    (``optim.py:338``): its row and column means would span ranks.
    ``params``: ``name -> `` a tensor or shape, global; ``param_specs``:
    ``name -> spec`` (missing: replicated). Any other dim may be
    sharded."""
    for k, p in params.items():
        shape = _shape_of(p)
        dims = _factored_dims(shape)
        if dims is None:
            continue  # v_full mirrors the leaf: elementwise, any sharding
        sp = param_specs.get(k)
        entries = tuple(sp) if sp is not None else ()
        sharded = {i for i, e in enumerate(entries) if e is not None}
        if sharded & set(dims):
            raise NotImplementedError(
                "optim='adafactor': leaf with global shape "
                f"{shape} factors over dims {dims}, but spec {sp} "
                "shards one of them — the row/col second-moment means "
                "would span devices. Shard a non-factored axis (e.g. a "
                "leading stack axis) or use optim='adam'/'sgd'")


def _delete_spec_dim(sp, ndim: int, d: int):
    from pytorch_ps_mpi_tpu_torch.mesh import P

    entries = ((tuple(sp) if sp is not None else ()) + (None,) * ndim)[:ndim]
    return P(*(entries[:d] + entries[d + 1:]))


def adafactor_state_specs(params, param_specs) -> AdafactorState:
    """The spec of each :class:`AdafactorState` leaf under model-parallel
    ``param_specs`` (``optim.py:369``): ``v_row``/``v_col`` take the
    leaf's spec without the factored dim they drop (unsharded, by
    :func:`adafactor_check_sharding`); ``v_full`` mirrors an unfactored
    leaf's spec; sentinels and the step are replicated. ``params``:
    ``name -> `` a tensor or global shape."""
    from pytorch_ps_mpi_tpu_torch.mesh import P

    v_row, v_col, v_full = {}, {}, {}
    for k, p in params.items():
        shape, sp = _shape_of(p), param_specs.get(k)
        dims = _factored_dims(shape)
        if dims is None:
            v_row[k], v_col[k] = P(), P()
            v_full[k] = sp if sp is not None else P()
        else:
            v_row[k] = _delete_spec_dim(sp, len(shape), dims[1])
            v_col[k] = _delete_spec_dim(sp, len(shape), dims[0])
            v_full[k] = P()
    return AdafactorState(P(), v_row, v_col, v_full)


OPTIMIZERS = {
    "sgd": (SGDHyper, init_sgd_state, sgd_update),
    "adam": (AdamHyper, init_adam_state, adam_update),
    "adafactor": (AdafactorHyper, init_adafactor_state, adafactor_update),
}

"""AsySG-InCon in one program: asynchronous SGD with inconsistent reads
(``pytorch_ps_mpi_tpu/parallel/async_ps.py``; Lian et al. 2015,
arXiv:1506.08272).

Workers compute gradients against stale parameter versions (each may
hold a different one) and the server applies their updates one at a
time. Staleness is explicit data: a ring of the last ``max_staleness +
1`` parameter versions lives on the device; every round worker ``i``
takes its gradient at ``history[lag_i]``, the gradient goes through the
codec (encode, then decode: the wire the multi-process form really
crosses, ``ps.py:94,166`` of the reference), and the updates run in
worker order, update ``i`` seeing the parameters update ``i-1`` made.
The lags are fixed (a schedule, for tests) or sampled every round from a
distribution, uniform by default or a measured arrival histogram of a
multi-process run (:func:`staleness_probs_from_histogram`).

The JAX package batches the workers' backward passes with ``vmap`` in
one XLA program; here they run one after another, each worker's
leaves encoded and decoded on the card with the codec's kernels. What
asynchrony buys on the wall clock (fast workers streaming past a
straggler) is the multi-process form's to show
(``parallel/async_train.py``); ``chip_smoke.py`` prints the card's
updates a second of an async fleet over a sync-barrier one there.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch.codecs import Codec, IdentityCodec
from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device
from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
from pytorch_ps_mpi_tpu_torch.ps import _inverse

Params = Dict[str, torch.Tensor]


def staleness_probs_from_histogram(hist: Dict[int, int],
                                   max_staleness: int) -> np.ndarray:
    """A measured ``{staleness: count}`` histogram (a server's
    ``staleness_seen``) as the sampling distribution of :class:`AsyncPS`
    over lags ``0..max_staleness``; lags past it were dropped by the
    server and are excluded."""
    probs = np.zeros(max_staleness + 1, np.float64)
    for lag, count in hist.items():
        if 0 <= int(lag) <= max_staleness:
            probs[int(lag)] = float(count)
    if probs.sum() <= 0:
        raise ValueError(
            f"histogram has no mass in 0..{max_staleness}: {hist}")
    return probs / probs.sum()


class AsyncPS:
    """Bounded-staleness asynchronous parameter server (``async_ps.py:79``).

    Args:
      params: an ``nn.Module`` or a ``name -> tensor`` dict (for the JAX
        package's leaf order, ``utils.interop.params_from_jax``'s dict);
        updated in place.
      loss_fn: ``loss_fn(params, batch) -> scalar`` over a params dict.
      num_workers: the workers a round.
      optim: ``"sgd"``, ``"adam"`` or ``"adafactor"``.
      code: the codec of the simulated wire; default identity.
      max_staleness: the ring's depth; every lag is at most this.
      staleness: fixed lags, one a worker (a schedule).
      staleness_probs: the distribution over ``0..max_staleness`` the
        sampled lags are drawn from every round; default uniform.
      seed: seeds the lag sampling and a stochastic codec's generator.
      device: where the parameters live; the card unless the caller
        asks for the CPU.
      **hyper: the optimizer's hyperparameters.

    ``staleness_hist`` counts the lags used, ``{lag: count}``, as a
    multi-process server's ``staleness_seen`` does.
    """

    def __init__(self, params: Union[nn.Module, Params], loss_fn: Callable,
                 *, num_workers: int, optim: str = "sgd",
                 code: Optional[Codec] = None, max_staleness: int = 2,
                 staleness: Optional[Sequence[int]] = None,
                 staleness_probs: Optional[Sequence[float]] = None,
                 seed: int = 0, device: Device = "cuda", **hyper):
        hyper_cls, init_state, self._update_fn = OPTIMIZERS[optim]
        self.hyper = hyper_cls(**hyper)
        self.loss_fn = loss_fn
        self.num_workers = int(num_workers)
        self.code = code if code is not None else IdentityCodec()
        self.max_staleness = int(max_staleness)
        self.device = resolve_device(device)
        if staleness is not None and staleness_probs is not None:
            raise ValueError(
                "give staleness (fixed) OR staleness_probs, not both")
        self.staleness = None
        self._probs = None
        if staleness is not None:
            if (len(staleness) != num_workers
                    or max(staleness) > self.max_staleness
                    or min(staleness) < 0):
                raise ValueError(
                    "need num_workers staleness values in 0..max_staleness")
            self.staleness = [int(s) for s in staleness]
        else:
            if staleness_probs is None:
                staleness_probs = [1.0] * (self.max_staleness + 1)
            probs = np.asarray(staleness_probs, np.float64)
            if (probs.shape != (self.max_staleness + 1,) or probs.min() < 0
                    or probs.sum() <= 0):
                raise ValueError(
                    "staleness_probs must be max_staleness+1 nonnegative "
                    "weights with positive sum")
            self._probs = torch.from_numpy(probs / probs.sum())
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        self.params: Params = dict(params)
        for k, p in self.params.items():
            if p.device.type != self.device.type:
                raise ValueError(f"parameter {k!r} lives on {p.device}, the "
                                 f"server on {self.device}")
        self._views = ({k: p.codec_view for k, p in self.params.items()
                        if hasattr(p, "codec_view")}
                       if self.code.order_dependent else {})
        self.opt_state = init_state(self.params)
        # history[0] is the newest version, history[-1] the oldest
        snap = {k: p.detach().clone() for k, p in self.params.items()}
        self.history = [snap] + [{k: v.clone() for k, v in snap.items()}
                                 for _ in range(self.max_staleness)]
        self.codec_state = [
            {k: self.code.init_state(self._view_shape(k), p.dtype, p.device)
             for k, p in self.params.items()}
            for _ in range(self.num_workers)]
        self._lag_gen = torch.Generator().manual_seed(seed)
        self._gen = None
        if self.code.needs_rng:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(seed)
        self.staleness_hist: Dict[int, int] = {}
        self.step_count = 0

    def _view_shape(self, k: str) -> Tuple[int, ...]:
        shape = tuple(self.params[k].shape)
        perm = self._views.get(k)
        return tuple(shape[i] for i in perm) if perm else shape

    def _lags(self):
        if self.staleness is not None:
            return list(self.staleness)
        return torch.multinomial(self._probs, self.num_workers,
                                 replacement=True,
                                 generator=self._lag_gen).tolist()

    def _grads(self, version: Params, batch) -> Params:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in version.items()}
        loss = self.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads))

    @torch.no_grad()
    def _wire(self, grads: Params, w: int) -> Params:
        """Encode, then decode, every leaf of worker ``w``'s gradient
        (``async_ps.py:174``), in the codec's view of an order-dependent
        leaf; the worker's codec state moves on."""
        out = {}
        states = self.codec_state[w]
        for k, g in grads.items():
            perm = self._views.get(k)
            unit = g.permute(perm).contiguous() if perm else g
            payload, states[k] = self.code.encode(unit, states[k], self._gen)
            dec = self.code.decode(payload, tuple(unit.shape), unit.dtype)
            out[k] = dec.permute(_inverse(perm)) if perm else dec
        return out

    def step(self, batches) -> Tuple[None, Dict[str, float]]:
        """One round: every worker contributes one stale gradient.
        ``batches`` is a tensor, or a tuple, list or dict of tensors,
        with a leading ``[num_workers]`` axis. Returns ``(None, data)``
        in the reference's ``(loss, data)`` shape."""
        t0 = time.perf_counter()
        lags = self._lags()
        decoded = []
        for w, lag in enumerate(lags):
            batch = comms.tree_map(lambda t: t[w], batches)
            decoded.append(self._wire(self._grads(self.history[lag], batch),
                                      w))
        state = self.opt_state
        for g in decoded:  # arrival order: update i sees update i-1
            _, state = self._update_fn(self.params, g, state, self.hyper)
        self.opt_state = state
        with torch.no_grad():
            oldest = self.history.pop()
            for k, p in self.params.items():
                oldest[k].copy_(p)
            self.history.insert(0, oldest)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for lag in lags:
            self.staleness_hist[lag] = self.staleness_hist.get(lag, 0) + 1
        self.step_count += 1
        return None, {"step_time": time.perf_counter() - t0,
                      "updates_applied": float(self.num_workers),
                      "lags": lags}

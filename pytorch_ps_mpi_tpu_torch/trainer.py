"""Trainer: the training loop around an ``MPI_PS`` optimizer
(``pytorch_ps_mpi_tpu/trainer.py``).

It draws batches, runs the optimizer's steps (``scan_chunk`` of them at a
time through ``run_steps``, or ``accum_steps`` microbatches a step
through ``step_accumulate``), averages the per-step metrics dicts, and
checkpoints and resumes the optimizer's whole state (parameters,
optimizer and codec state, aux state, generator state, step counters)
through :class:`~pytorch_ps_mpi_tpu_torch.utils.checkpoint.CheckpointManager`.

A model with mutable state (BatchNorm's running statistics) passes its
initial ``aux_state``; ``loss_fn(params, aux_state, batch)`` then returns
``(loss, new_aux)`` and the loop threads the optimizer's averaged
``aux_state`` from step to step.
"""

from __future__ import annotations

import pickle
import sys
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from pytorch_ps_mpi_tpu_torch.ps import MPI_PS
from pytorch_ps_mpi_tpu_torch.telemetry.recorder import get_recorder
from pytorch_ps_mpi_tpu_torch.utils.checkpoint import CheckpointManager
from pytorch_ps_mpi_tpu_torch.utils.metrics import MetricsAccumulator

Tree = Any


def stack_batches(batches: List[Tree]) -> Tree:
    """Batches of one structure stacked leaf by leaf on a new leading axis
    (the ``[N, ...]`` input of ``run_steps`` and ``step_accumulate``)."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: stack_batches([b[k] for b in batches]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_batches([b[i] for b in batches])
                           for i in range(len(first)))
    return torch.stack(batches)


class Trainer:
    """Drive an :class:`MPI_PS` optimizer over a batch iterator.

    Args:
      optimizer: a constructed ``MPI_PS`` (or ``SGD``/``Adam``/...).
      loss_fn: ``loss_fn(params, batch) -> loss``, or with ``aux_state``
        ``loss_fn(params, aux_state, batch) -> (loss, new_aux)``.
      checkpoint_dir: enables :meth:`save` and :meth:`maybe_restore`.
      checkpoint_every: steps between checkpoints, counted as interval
        crossings (``scan_chunk`` need not divide it).
      scan_chunk: > 1 runs that many steps a call through ``run_steps``.
      accum_steps: > 1 sums the gradients of that many batches into one
        step through ``step_accumulate`` (not with ``scan_chunk`` or
        ``aux_state``).
      aux_state: the model's initial mutable state
        (``models.resnet.batch_stats_of``), unless the optimizer already
        holds one.
    """

    def __init__(self, optimizer: MPI_PS, loss_fn: Callable, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 100, scan_chunk: int = 1,
                 accum_steps: int = 1, aux_state: Any = None):
        self.opt = optimizer
        self.loss_fn = loss_fn
        self.metrics = MetricsAccumulator()
        self.step_count = 0
        self.scan_chunk = max(1, int(scan_chunk))
        self.accum_steps = max(1, int(accum_steps))
        if self.accum_steps > 1 and self.scan_chunk > 1:
            raise ValueError("accum_steps and scan_chunk do not combine: "
                             "run_steps takes one batch a step")
        if aux_state is not None and self.opt.aux_state is None:
            self.opt.aux_state = aux_state
        self.has_aux = self.opt.aux_state is not None
        if self.has_aux and self.accum_steps > 1:
            raise ValueError("accum_steps does not take aux_state "
                             "(step_accumulate has no aux state)")
        self.checkpoint_every = checkpoint_every
        self._last_saved_step = 0
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)

    # -- checkpoint / resume ------------------------------------------------
    def _state(self) -> Dict[str, Tree]:
        """The optimizer's own ``state_dict`` (generator, codec and aux
        state included) and the trainer's step."""
        sd = dict(self.opt.state_dict())
        sd["trainer_step"] = self.step_count
        if sd.get("aux_state") is None:
            sd.pop("aux_state")
        return sd

    def save(self) -> None:
        if self.ckpt is None:
            raise RuntimeError("no checkpoint_dir configured")
        rec = get_recorder()
        if rec is None:
            self.ckpt.save(self.step_count, self._state())
        else:
            with rec.span("trainer.checkpoint", step=self.step_count):
                self.ckpt.save(self.step_count, self._state())
        self._last_saved_step = self.step_count

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint if there is one. A checkpoint
        whose tree does not match the current schema is reported on
        stderr and skipped: training starts fresh."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        try:
            state = self.ckpt.restore(self._state())
        except (ValueError, RuntimeError, pickle.UnpicklingError) as e:
            print(f"checkpoint restore failed (incompatible schema?): {e}; "
                  "starting fresh", file=sys.stderr)
            return False
        self.step_count = int(state.pop("trainer_step"))
        self._last_saved_step = self.step_count
        state.setdefault("aux_state", None)
        self.opt.load_state_dict(state)
        return True

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, batches: Iterator[Tree], num_batches: int,
                 eval_fn: Optional[Callable] = None) -> float:
        """Mean of ``eval_fn(params, batch)`` over ``num_batches`` batches
        (default: the training loss, with the optimizer's aux state),
        without touching the optimizer's state."""
        if eval_fn is None:
            if self.has_aux:
                def eval_fn(p, b):
                    return self.loss_fn(p, self.opt.aux_state, b)[0]
            else:
                eval_fn = self.loss_fn
        total = 0.0
        for _ in range(num_batches):
            total += float(eval_fn(self.opt.params, next(batches)))
        return total / max(1, num_batches)

    # -- training -----------------------------------------------------------
    def _aux(self):
        return self.opt.aux_state if self.has_aux else None

    def fit(self, batches: Iterator[Tree], num_steps: int,
            log_every: int = 0) -> Dict[str, float]:
        """Train for ``num_steps`` steps; returns the mean of the step
        metrics with ``final_loss``, ``first_loss`` (the first call's loss
        of this fit), ``wall_time`` and ``steps_per_sec_overall``."""
        t0 = time.perf_counter()
        last_loss = first_loss = None
        done = 0
        while done < num_steps:
            rec = get_recorder()  # one attribute read a step when off
            span_t0 = time.monotonic()
            if self.scan_chunk > 1 and num_steps - done >= self.scan_chunk:
                chunk = stack_batches([next(batches)
                                       for _ in range(self.scan_chunk)])
                losses, data = self.opt.run_steps(self.loss_fn, chunk,
                                                  aux_state=self._aux())
                last_loss = float(losses[-1])
                n = self.scan_chunk
            elif self.accum_steps > 1:
                micro = stack_batches([next(batches)
                                       for _ in range(self.accum_steps)])
                loss, data = self.opt.step_accumulate(self.loss_fn, micro)
                last_loss, n = float(loss), 1
            else:
                loss, data = self.opt.step(loss_fn=self.loss_fn,
                                           batch=next(batches),
                                           aux_state=self._aux())
                last_loss, n = float(loss), 1
            self.metrics.add(data)
            if first_loss is None:
                first_loss = (float(losses[0]) if n > 1 else last_loss)
            done += n
            self.step_count += n
            if rec is not None:
                if n > 1:
                    rec.event("trainer.step_chunk", kind="span", ts=span_t0,
                              dur=time.monotonic() - span_t0,
                              step=self.step_count, loss=last_loss,
                              n_steps=n)
                else:
                    rec.event("trainer.step", kind="span", ts=span_t0,
                              dur=time.monotonic() - span_t0,
                              step=self.step_count, loss=last_loss)
            if log_every and done % log_every == 0:
                rate = done / (time.perf_counter() - t0)
                print(f"step {self.step_count}: loss={last_loss:.4f} "
                      f"({rate:.1f} steps/s)")
            # interval crossing, not modulo: scan_chunk may not divide
            # checkpoint_every
            if (self.ckpt is not None and self.step_count
                    - self._last_saved_step >= self.checkpoint_every):
                self.save()
        if self.ckpt is not None and self.step_count != self._last_saved_step:
            self.save()
        out = self.metrics.mean()
        out["final_loss"] = last_loss
        out["first_loss"] = first_loss
        out["wall_time"] = time.perf_counter() - t0
        out["steps_per_sec_overall"] = num_steps / out["wall_time"]
        return out

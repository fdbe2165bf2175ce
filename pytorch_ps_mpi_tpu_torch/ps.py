"""The drop-in distributed optimizer step (``pytorch_ps_mpi_tpu/ps.py``).

Each ``step`` runs the reference's pipeline (``ps.py:94-191``) on
``torch.distributed``: encode every gradient leaf with the codec, gather
the payloads from every rank, decode and sum them (a left fold in rank
order), then apply the fused SGD/Adam/Adafactor update. Identity-like
codecs (``supports_psum``) sum with one ``all_reduce`` instead, narrowed
to ``comm_dtype`` or the codec's ``wire_dtype``.

Every rank is its own process, so where the JAX package runs one program
over a device mesh, here each rank runs this step on its own batch and
the collectives join them. With no process group the world is one rank.

This slice ports ``mode="allgather"`` on the fused path. The options the
JAX constructor also accepts (``mode="leader"``, ``bucket_mb``,
``numerics``, ``param_specs``, ``instrument``, ``mesh``, ``axis_name``,
``batch_spec``) and the ``profile``/``aux_state`` step arguments,
``step_accumulate`` and ``run_steps`` raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch import comms, mesh
from pytorch_ps_mpi_tpu_torch.codecs import Codec, IdentityCodec
from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
from pytorch_ps_mpi_tpu_torch.utils.metrics import schema_dict

Params = Dict[str, torch.Tensor]

#: constructor option -> (its default, where its port is planned)
_UNPORTED = {
    "instrument": (False, "ROADMAP queue 1 item 5 (the staged, host-timed "
                          "pipeline)"),
    "bucket_mb": (0.0, "ROADMAP queue 1 item 4 (bucketing.py)"),
    "numerics": (False, "ROADMAP queue 1 item 10 (telemetry/numerics.py)"),
    "param_specs": (None, "ROADMAP queue 1 item 11 (model-parallel "
                          "composition)"),
    "mesh": (None, "ROADMAP queue 1 item 11 (the process group stands for "
                   "the mesh until then)"),
    "axis_name": ("data", "ROADMAP queue 1 item 11 (tuple aggregation axes)"),
    "batch_spec": (None, "ROADMAP queue 1 item 11 (model-parallel batch "
                         "layouts)"),
}


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {where}")


def clip_by_global_norm(grads: Params, clip_norm: float) -> Params:
    """Scale ``grads`` so their global L2 norm is at most ``clip_norm``
    (torch ``clip_grad_norm_`` semantics on the aggregated gradient,
    reference ``pytorch_ps_mpi_tpu/ps.py:267``)."""
    sumsq = sum(torch.sum(torch.square(g.to(torch.float32)))
                for g in grads.values())
    scale = torch.clamp(clip_norm / torch.clamp(torch.sqrt(sumsq), min=1e-12),
                        max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}


def decode_sum_payloads(code: Codec, gathered, shape, dtype) -> torch.Tensor:
    """Sum a ``[world, ...]`` payload stack: through the codec's exact
    compressed-domain algebra where it has one, else ``decode_sum``
    (reference ``pytorch_ps_mpi_tpu/ps.py:421``). Approximate algebras
    (sign's vote counts) never enter the training step."""
    if (code.supports_aggregate and code.agg_exact
            and code.can_aggregate(shape, dtype)):
        agg, meta = code.aggregate(gathered, shape, dtype)
        return code.agg_decode(agg, meta, shape, dtype)
    return code.decode_sum(gathered, shape, dtype)


class MPI_PS:
    """Distributed parameter-server optimizer on ``torch.distributed``.

    Args:
      params: an ``nn.Module`` or a ``name -> tensor`` dict. The update
        runs **in place** on these tensors (under ``torch.no_grad()``),
        so a module passed in, or whose ``named_parameters()`` were
        passed, trains as with any torch optimizer.
      optim: ``"sgd"``, ``"adam"`` or ``"adafactor"``.
      code: a :class:`~pytorch_ps_mpi_tpu_torch.codecs.Codec`; default
        identity.
      mode: ``"allgather"`` only in this slice.
      average: average the ranks' gradients instead of summing them.
      comm_dtype: narrow the ``all_reduce`` of psum-capable codecs to
        this dtype and cast back.
      seed: seeds the per-rank ``torch.Generator`` of codecs that draw
        random numbers.
      clip_norm: if > 0, clip the aggregated gradient to this global L2
        norm before the update.
      loss_reduction: ``"pmean"`` (default: the mean of the ranks'
        losses) or ``"psum"``.
      device: where the parameters live; ``"cuda"`` by default, and it
        raises when no GPU is present. Pass ``device="cpu"`` to run on
        the CPU.
      **hyper: the optimizer's hyperparameters (``lr``, ``momentum``, ...).
    """

    def __init__(
        self,
        params: Union[nn.Module, Params],
        *,
        optim: str = "sgd",
        code: Optional[Codec] = None,
        mode: str = "allgather",
        average: bool = False,
        comm_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        clip_norm: float = 0.0,
        loss_reduction: Optional[str] = None,
        device: mesh.Device = "cuda",
        **hyper,
    ):
        for opt, (default, where) in _UNPORTED.items():
            if opt in hyper:
                if hyper.pop(opt) != default:
                    raise _unported(f"MPI_PS({opt}=...)", where)
        if mode == "leader":
            raise _unported("mode='leader' (ZeRO-1)",
                            "ROADMAP queue 1 item 5")
        if mode != "allgather":
            raise ValueError("mode must be 'allgather' or 'leader'")
        if optim not in OPTIMIZERS:
            raise ValueError(f"optim must be one of {sorted(OPTIMIZERS)}")
        if clip_norm < 0:
            raise ValueError(f"clip_norm must be >= 0, got {clip_norm}")
        if loss_reduction not in (None, "pmean", "psum"):
            raise ValueError(
                f"loss_reduction must be 'pmean', 'psum', or None, got "
                f"{loss_reduction!r}")
        self.device = mesh.resolve_device(device)
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        self.params: Params = dict(params)
        for k, p in self.params.items():
            if p.device.type != self.device.type:
                raise ValueError(f"parameter {k!r} lives on {p.device}, the "
                                 f"optimizer on {self.device}")
        hyper_cls, init_state, self._update_fn = OPTIMIZERS[optim]
        self.hyper = hyper_cls(**hyper)
        self.opt_state = init_state(self.params)
        self.code = code if code is not None else IdentityCodec()
        self.mode = mode
        self.average = average
        self.comm_dtype = comm_dtype
        self.clip_norm = float(clip_norm)
        self._loss_reduction = loss_reduction or "pmean"
        self.rank = mesh.rank()
        self.size = mesh.world_size()
        self.codec_state = {k: self.code.init_state(tuple(p.shape), p.dtype,
                                                    p.device)
                            for k, p in self.params.items()}
        self._gen = None
        if self.code.needs_rng:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(seed * 1_000_003 + self.rank)
        self._step_count = 0
        self._metrics = self._static_metrics()

    # -- accounting ---------------------------------------------------------
    def _static_metrics(self) -> Dict[str, Any]:
        """The byte fields of the metrics dict, fixed per optimizer."""
        w = self.size
        msg = sum(p.numel() * p.element_size() for p in self.params.values())
        payload = sum(self.code.payload_bits(tuple(p.shape), p.dtype) // 8
                      for p in self.params.values())
        if self.code.supports_psum:
            wire = self.comm_dtype or getattr(self.code, "wire_dtype", None)
            wire_bytes = sum(
                p.numel() * (wire.itemsize if wire is not None
                             else p.element_size())
                for p in self.params.values())
            lowering, recv = "psum", 2 * (w - 1) / w * wire_bytes
        else:
            lowering, recv = "allgather", (w - 1) * payload
        return dict(msg_bytes=msg, packaged_bytes=payload,
                    wire_lowering=lowering, wire_bytes_per_worker=recv,
                    agg_launches=len(self.params))

    # -- the pipeline -------------------------------------------------------
    def _aggregate(self, grads: Params) -> Params:
        """encode -> collective -> decode_sum for every leaf (reference
        ``pytorch_ps_mpi_tpu/ps.py:438``)."""
        code, summed = self.code, {}
        if code.supports_psum:
            wire = self.comm_dtype or getattr(code, "wire_dtype", None)
            for k, g in grads.items():
                summed[k] = (comms.allreduce_sum(g.to(wire)).to(g.dtype)
                             if wire is not None else comms.allreduce_sum(g))
        else:
            for k, g in grads.items():
                payload, self.codec_state[k] = code.encode(
                    g, self.codec_state[k], self._gen)
                gathered = comms.all_gather_tree(payload)
                summed[k] = decode_sum_payloads(code, gathered,
                                                tuple(g.shape), g.dtype)
        if self.average:
            summed = {k: s / self.size for k, s in summed.items()}
        return summed

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        total = comms.allreduce_sum(loss)
        return total / self.size if self._loss_reduction == "pmean" else total

    def _local_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        if g.shape[0] != self.size:
            raise ValueError(
                f"grads[{name!r}] must be stacked on a leading "
                f"[world={self.size}] axis, got shape {tuple(g.shape)}")
        return g[self.rank]

    # -- public API ---------------------------------------------------------
    def step(
        self,
        grads: Optional[Params] = None,
        *,
        loss_fn: Optional[Callable[[Params, Any], torch.Tensor]] = None,
        batch: Any = None,
        aux_state: Any = None,
        closure: Optional[Callable[[], Any]] = None,
        profile: bool = False,
    ) -> Tuple[Optional[torch.Tensor], Dict[str, Any]]:
        """One distributed step; returns ``(loss, data)`` like the
        reference (``ps.py:193``).

        Either ``loss_fn(params, batch)`` and this rank's ``batch``: the
        loss must be computed from the ``params`` dict it is given (for a
        module, ``torch.func.functional_call(model, params, x)``), and the
        returned loss is the mean over ranks. Or ``grads``: a ``name ->
        tensor`` dict stacked on a leading ``[world]`` axis (this rank's
        gradient is row ``rank``).
        """
        if profile:
            raise _unported("step(profile=True)",
                            "ROADMAP queue 1 item 10 (telemetry)")
        if aux_state is not None:
            raise _unported("step(aux_state=...) (BatchNorm state)",
                            "ROADMAP queue 1 item 6")
        t0 = time.perf_counter()
        data = schema_dict(**self._metrics)
        loss = None
        if loss_fn is not None:
            if batch is None:
                raise ValueError("loss_fn requires batch")
            leaves = {k: p.detach().requires_grad_()
                      for k, p in self.params.items()}
            with torch.enable_grad():
                local_loss = loss_fn(leaves, batch)
                g = torch.autograd.grad(local_loss, list(leaves.values()))
            local = dict(zip(leaves, g))
            loss = self._reduce_loss(local_loss.detach())
        elif grads is not None:
            local = {k: self._local_grad(k, grads[k]) for k in self.params}
        else:
            raise ValueError("pass grads or loss_fn+batch")
        summed = self._aggregate(local)
        if self.clip_norm:
            summed = clip_by_global_norm(summed, self.clip_norm)
        self.params, self.opt_state = self._update_fn(
            self.params, summed, self.opt_state, self.hyper)
        if closure is not None:
            loss = closure()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        data["step_time"] = time.perf_counter() - t0
        self._step_count += 1
        return loss, data

    def step_accumulate(self, *args, **kwargs):
        raise _unported("step_accumulate", "ROADMAP queue 1 item 5")

    def run_steps(self, *args, **kwargs):
        raise _unported("run_steps", "ROADMAP queue 1 item 5")

    def state_dict(self) -> Dict[str, Any]:
        """Checkpointable state in the JAX package's schema (params,
        opt_state, codec_state, step_count, rng); live references, not
        copies."""
        return {
            "params": self.params,
            "opt_state": tuple(self.opt_state),
            "codec_state": self.codec_state,
            "aux_state": None,
            "step_count": self._step_count,
            "rng_state": (self._gen.get_state() if self._gen is not None
                          else None),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict`. Parameters are copied into the
        existing tensors, so a module being trained sees the restore;
        codec state (error feedback's memory) is copied onto each
        parameter's device."""
        for k, p in self.params.items():
            p.copy_(sd["params"][k])
        self.opt_state = type(self.opt_state)(*sd["opt_state"])
        self.codec_state = {}
        for k, state in sd["codec_state"].items():
            device = self.params[k].device
            self.codec_state[k] = comms.tree_map(
                lambda t: t.to(device, copy=True), state)
        self._step_count = int(sd["step_count"])
        if self._gen is not None and sd.get("rng_state") is not None:
            self._gen.set_state(sd["rng_state"])


class SGD(MPI_PS):
    """PS-fused SGD (reference ``ps.py:195-214``)."""

    def __init__(self, params, **kwargs):
        kwargs.setdefault("optim", "sgd")
        super().__init__(params, **kwargs)


class Adam(MPI_PS):
    """PS-fused Adam with amsgrad (reference ``ps.py:217-261``)."""

    def __init__(self, params, **kwargs):
        kwargs.setdefault("optim", "adam")
        super().__init__(params, **kwargs)


class Adafactor(MPI_PS):
    """PS-fused Adafactor; ``lr=None`` is the paper's relative step."""

    def __init__(self, params, **kwargs):
        kwargs.setdefault("optim", "adafactor")
        kwargs.setdefault("lr", None)
        super().__init__(params, **kwargs)

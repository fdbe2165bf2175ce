"""The drop-in distributed optimizer step (``pytorch_ps_mpi_tpu/ps.py``).

Each ``step`` runs the reference's pipeline (``ps.py:94-191``) on
``torch.distributed``: encode every gradient leaf with the codec, gather
the payloads from every rank, decode and sum them (a left fold in rank
order), then apply the fused SGD/Adam/Adafactor update. Identity-like
codecs (``supports_psum``) sum with one ``all_reduce`` instead, narrowed
to ``comm_dtype`` or the codec's ``wire_dtype``. A codec whose
aggregation is a collective protocol (``supports_fused_allreduce``,
PowerSGD's two all-reduces of low-rank factors) skips encode and gather
and gives the summed gradient itself (``fused_allreduce_tree``,
``ps.py:568-598``). A ragged payload (threshold's) is gathered as any
other, its int32 true-length sidecar one more tensor of the tree.

A codec whose result depends on the order of a leaf's elements
(``Codec.order_dependent``: random-k's strata, block top-k's blocks,
threshold's cap, PowerSGD's matrix view) sees a parameter tagged
``codec_view`` through that permutation of its dims, the JAX package's
layout, and its decoded sum is permuted back. ResNet and MLP tag their
kernels (``models.init.mark_flax_views``), so the port keeps PyTorch
layouts (OIHW convolutions, ``[out, in]`` linear weights) and selects
the elements the JAX package selects. Its codec state (PowerSGD's Q and
residual, error feedback's memory) is kept in that view.

Two topologies, as in the JAX package:

- ``mode="allgather"``: every rank sums the whole gradient and runs the
  whole update;
- ``mode="leader"``: the reference's rank-0 parameter server (gather,
  step, broadcast; ``mpi_comms.py:60-133``) lowered as ZeRO-1, so every
  rank leads a 1/world shard of every parameter: a reduce-scatter (or the
  payload gather and decode-sum of a strongly compressing codec), a
  shard-local update and an all-gather back into the parameters. The
  master copy and the optimizer state live in :class:`LeaderState`.

``bucket_mb > 0`` fuses the per-leaf collectives of both modes into
dtype-grouped flat buckets (``bucketing.py``) for bucketable stateless
codecs; in leader mode the master copy and optimizer state are then kept
a bucket at a time.

Every rank is its own process, so where the JAX package runs one program
over a device mesh, here each rank runs this step on its own batch and
the collectives join them. With no process group the world is one rank.

The options the JAX constructor also accepts and the port does not have
yet (``numerics``, ``param_specs``, ``instrument``, ``mesh``,
``axis_name``, ``batch_spec``), the ``profile``/``aux_state`` step
arguments, ``step_accumulate`` and ``run_steps`` raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch import comms, mesh
from pytorch_ps_mpi_tpu_torch.bucketing import (BucketPlan,
                                                flatten_into_buckets,
                                                plan_buckets,
                                                unflatten_from_buckets)
from pytorch_ps_mpi_tpu_torch.codecs import Codec, IdentityCodec
from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
from pytorch_ps_mpi_tpu_torch.utils.metrics import schema_dict

Params = Dict[str, torch.Tensor]
#: ``name -> tensor``, or ``bucket index -> tensor`` with a bucket plan
Leaves = Dict[Any, torch.Tensor]

#: constructor option -> (its default, where its port is planned)
_UNPORTED = {
    "instrument": (False, "ROADMAP queue 1 item 2 (the staged, host-timed "
                          "pipeline)"),
    "numerics": (False, "ROADMAP queue 1 item 8 (telemetry/numerics.py)"),
    "param_specs": (None, "ROADMAP queue 1 item 9 (model-parallel "
                          "composition)"),
    "mesh": (None, "ROADMAP queue 1 item 9 (the process group stands for "
                   "the mesh until then)"),
    "axis_name": ("data", "ROADMAP queue 1 item 9 (tuple aggregation "
                          "axes)"),
    "batch_spec": (None, "ROADMAP queue 1 item 9 (model-parallel batch "
                         "layouts)"),
}


def _unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {where}")


def clip_by_global_norm(grads: Leaves, clip_norm: float,
                        across_ranks: bool = False) -> Leaves:
    """Scale ``grads`` so their global L2 norm is at most ``clip_norm``
    (torch ``clip_grad_norm_`` semantics on the aggregated gradient,
    reference ``pytorch_ps_mpi_tpu/ps.py:267``). ``across_ranks``: the
    tensors are this rank's shards of the gradient (leader mode), so the
    sum of squares is summed across ranks first and every rank clips
    alike."""
    scale = _clip_scale(grads.values(), clip_norm, across_ranks)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}


def _clip_scale(tensors, clip_norm: float,
                across_ranks: bool = False) -> torch.Tensor:
    """The factor :func:`clip_by_global_norm` scales by: ``clip_norm``
    over the L2 norm of ``tensors``, at most 1."""
    sumsq = sum(torch.sum(torch.square(g.to(torch.float32)))
                for g in tensors)
    if across_ranks:
        sumsq = comms.allreduce_sum(sumsq)
    return torch.clamp(clip_norm / torch.clamp(torch.sqrt(sumsq), min=1e-12),
                       max=1.0)


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


def _inverse(perm: Tuple[int, ...]) -> Tuple[int, ...]:
    out = [0] * len(perm)
    for i, d in enumerate(perm):
        out[d] = i
    return tuple(out)


def _encode_buckets(code: Codec, buckets, gen: Optional[torch.Generator]):
    """Per-bucket encode (stateless by the ``bucketable`` contract,
    ``ps.py:509``); a codec that draws random numbers takes them from this
    rank's generator in bucket order."""
    return [code.encode(b, (), gen)[0] for b in buckets]


def bucketed_aggregate(code: Codec, grads: Params, plan: BucketPlan,
                       average: bool, size: int,
                       comm_dtype: Optional[torch.dtype] = None,
                       gen: Optional[torch.Generator] = None
                       ) -> List[torch.Tensor]:
    """Flat-bucket form of the aggregate (``ps.py:524``): one collective a
    bucket instead of one a leaf. Returns the summed buckets, which the
    leader mode shards as they are; ``unflatten_from_buckets`` gives the
    summed gradient as views of them.

    psum codecs all-reduce each bucket, narrowed to the wire dtype as the
    per-leaf path narrows each leaf, so the sums are the same bit for
    bit. Bucketable non-psum codecs encode each bucket as one leaf,
    all-gather its payload and decode-sum it, so their per-input
    statistics (sign's mean|g|, int8's absmax, TernGrad's max|g|) are taken
    per bucket: the JAX package's documented semantics."""
    buckets = flatten_into_buckets(plan, grads)
    if code.supports_psum:
        wire = comm_dtype or getattr(code, "wire_dtype", None)
        summed = comms.allreduce_sum_buckets(buckets, wire)
    else:
        summed = [decode_sum_payloads(code, comms.all_gather_tree(payload),
                                      tuple(b.shape), b.dtype)
                  for b, payload in zip(buckets,
                                        _encode_buckets(code, buckets, gen))]
    if average:
        summed = [x / size for x in summed]
    return summed


# -- leader mode (ZeRO-1) ---------------------------------------------------------

class LeaderState(NamedTuple):
    """Optimizer state of ``mode="leader"`` (``ps.py:119``): this rank's
    shard of the master parameters, ``param_shards`` (``name -> [1,
    shard_len]``, or ``bucket index -> [1, shard_len]`` with a bucket
    plan), and the inner optimizer's state over those shards. Rank ``r``'s
    rows are row ``r`` of the JAX package's ``[world, shard_len]`` arrays.
    ``MPI_PS.params`` is the working copy, rewritten from the gathered
    shards every step, so restore through ``load_state_dict``."""

    param_shards: Leaves
    inner: Any


def _to_shards(x: torch.Tensor, world: int) -> torch.Tensor:
    """``x`` flattened, zero-padded to a multiple of ``world`` and viewed
    ``[world, shard_len]``, so row r is rank r's shard (``ps.py:133``; the
    layout of the tiled reduce-scatter and all-gather)."""
    flat = x.reshape(-1)
    ss = -(-flat.numel() // world)
    pad = ss * world - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.view(world, ss)


def leader_init_state(params: Leaves, init_state: Callable, world: int,
                      rank: int) -> LeaderState:
    """This rank's :class:`LeaderState`: its ``[1, shard_len]`` row of
    every leaf (a copy) and the inner optimizer state over those rows
    (``ps.py:142``, pure data parallel)."""
    shards = {k: _to_shards(p.detach(), world)[rank:rank + 1].clone()
              for k, p in params.items()}
    return LeaderState(shards, init_state(shards))


def leader_scatter_shards(grads: Leaves, world: int,
                          comm_dtype: Optional[torch.dtype] = None,
                          average: bool = False) -> Leaves:
    """A reduce-scatter a leaf of the local gradients (``ps.py:239``): each
    rank receives only its shard's sum across ranks, ``[1, shard_len]``,
    narrowed to ``comm_dtype`` on the wire."""
    out = {}
    for k, g in grads.items():
        rows = _to_shards(g, world).reshape(-1)
        if comm_dtype is not None:
            rows = rows.to(comm_dtype)
        sh = comms.reduce_scatter_tiled(rows).to(g.dtype).view(1, -1)
        out[k] = sh / world if average else sh
    return out


def leader_slice_shards(summed: Leaves, world: int, rank: int) -> Leaves:
    """This rank's ``[1, shard_len]`` row of every leaf, when every rank
    already holds the whole summed gradient (the payload-gather lowering,
    ``ps.py:258``)."""
    return {k: _to_shards(g, world)[rank:rank + 1] for k, g in summed.items()}


def leader_shard_update(targets: Leaves, opt_state: LeaderState,
                        grad_shards: Leaves, update_fn: Callable,
                        hyper) -> Tuple[Leaves, LeaderState]:
    """The shard-local optimizer step, in place on this rank's rows, then
    a tiled all-gather a leaf back to whole tensors (``ps.py:297``).
    ``targets``: ``key -> tensor`` whose shapes the gathered values take
    (meta tensors do). Returns the gathered values and the new state."""
    shards, inner = update_fn(opt_state.param_shards, grad_shards,
                              opt_state.inner, hyper)
    gathered = {}
    for k, sh in shards.items():
        t = targets[k]
        gathered[k] = comms.all_gather_tiled(sh.reshape(-1))[:t.numel()] \
            .view(t.shape)
    return gathered, LeaderState(shards, inner)


def _has_tensors(tree) -> bool:
    found = []
    comms.tree_map(lambda x: found.append(torch.is_tensor(x)), tree)
    return any(found)


class MPI_PS:
    """Distributed parameter-server optimizer on ``torch.distributed``.

    Args:
      params: an ``nn.Module`` or a ``name -> tensor`` dict. The update
        runs **in place** on these tensors (under ``torch.no_grad()``),
        so a module passed in, or whose ``named_parameters()`` were
        passed, trains as with any torch optimizer. The dict's order is
        the leaf order (bucket membership follows it).
      optim: ``"sgd"``, ``"adam"`` or ``"adafactor"``.
      code: a :class:`~pytorch_ps_mpi_tpu_torch.codecs.Codec`; default
        identity.
      mode: ``"allgather"`` (every rank runs the whole update) or
        ``"leader"`` (ZeRO-1: each rank owns a 1/world shard of every
        parameter and of the optimizer state; not with Adafactor, whose
        factored moments need each leaf's whole shape).
      average: average the ranks' gradients instead of summing them.
      comm_dtype: narrow the ``all_reduce`` (or leader reduce-scatter) of
        psum-capable codecs to this dtype and cast back.
      seed: seeds the per-rank ``torch.Generator`` of codecs that draw
        random numbers.
      clip_norm: if > 0, clip the aggregated gradient to this global L2
        norm before the update (in leader mode over every rank's shards).
      bucket_mb: if > 0, aggregate in dtype-grouped flat buckets of about
        this many megabytes, one collective a bucket, for bucketable
        stateless codecs (identity, casts, sign, int8, qsgd, terngrad,
        random-k by fraction); per-tensor codecs (top-k, block top-k,
        threshold, PowerSGD, error feedback) keep the per-leaf path.
        Sign, int8, qsgd and terngrad then take their statistics per
        bucket.
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
        bucket_mb: float = 0.0,
        loss_reduction: Optional[str] = None,
        device: mesh.Device = "cuda",
        **hyper,
    ):
        for opt, (default, where) in _UNPORTED.items():
            if opt in hyper:
                if hyper.pop(opt) != default:
                    raise _unported(f"MPI_PS({opt}=...)", where)
        if mode not in ("allgather", "leader"):
            raise ValueError("mode must be 'allgather' or 'leader'")
        if optim not in OPTIMIZERS:
            raise ValueError(f"optim must be one of {sorted(OPTIMIZERS)}")
        if optim == "adafactor" and mode == "leader":
            raise NotImplementedError(
                "optim='adafactor' does not support mode='leader': ZeRO-1's "
                "1-D shards destroy the leaf shapes the factored second "
                "moments are defined over. Use mode='allgather'")
        if clip_norm < 0:
            raise ValueError(f"clip_norm must be >= 0, got {clip_norm}")
        if bucket_mb < 0:
            raise ValueError(f"bucket_mb must be >= 0, got {bucket_mb}")
        if loss_reduction not in (None, "pmean", "psum"):
            raise ValueError(
                f"loss_reduction must be 'pmean', 'psum', or None, got "
                f"{loss_reduction!r}")
        self.device = mesh.resolve_device(device)
        self.code = code if code is not None else IdentityCodec()
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        self.params: Params = dict(params)
        #: the permutations order-dependent codecs see the leaves through
        self._views = ({k: p.codec_view for k, p in self.params.items()
                        if hasattr(p, "codec_view")}
                       if self.code.order_dependent else {})
        for k, p in self.params.items():
            if p.device.type != self.device.type:
                raise ValueError(f"parameter {k!r} lives on {p.device}, the "
                                 f"optimizer on {self.device}")
        hyper_cls, init_state, self._update_fn = OPTIMIZERS[optim]
        self.hyper = hyper_cls(**hyper)
        self.mode = mode
        self.average = average
        self.comm_dtype = comm_dtype
        self.clip_norm = float(clip_norm)
        self._loss_reduction = loss_reduction or "pmean"
        self.rank = mesh.rank()
        self.size = mesh.world_size()
        self.bucket_mb = float(bucket_mb)
        self._bucket_plan: Optional[BucketPlan] = None
        if (self.bucket_mb > 0 and self.code.bucketable
                and not self.code.supports_fused_allreduce):
            if _has_tensors(self.code.init_state((1,), torch.float32,
                                                 torch.device("meta"))):
                raise TypeError(
                    f"{type(self.code).__name__}.bucketable=True but "
                    "init_state is non-empty: bucketable codecs must be "
                    "stateless (see codecs.base.Codec.bucketable)")
            self._bucket_plan = plan_buckets(self._to_view(self.params),
                                             self.bucket_mb)
        # else: a per-tensor codec keeps the per-leaf path, no error
        if mode == "leader":
            # with a plan the master copy and optimizer state are kept a
            # bucket at a time, so a bucket's reduce-scatter lands on the
            # shard its update owns; SGD and Adam are elementwise, so
            # per-bucket state updates as per-leaf state does
            self.opt_state = leader_init_state(
                self._leader_leaves({k: p.detach()
                                     for k, p in self.params.items()}),
                init_state, self.size, self.rank)
            self._leader_targets = (
                dict(enumerate(self._bucket_plan.bucket_templates()))
                if self._bucket_plan is not None else self.params)
        else:
            self.opt_state = init_state(self.params)
        self.codec_state = {k: self.code.init_state(self._view_shape(k),
                                                    p.dtype, p.device)
                            for k, p in self.params.items()}
        self._gen = None
        if self.code.needs_rng:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(seed * 1_000_003 + self.rank)
        self._step_count = 0
        self._metrics = self._static_metrics()

    # -- accounting ---------------------------------------------------------
    def _psum_wire(self) -> Optional[torch.dtype]:
        """The wire dtype of a psum-capable codec's collectives."""
        return self.comm_dtype or getattr(self.code, "wire_dtype", None)

    def _static_metrics(self) -> Dict[str, Any]:
        """The byte fields of the metrics dict, fixed per optimizer
        (``ps.py:926-958``), and the aggregation lowering with the bytes
        each rank receives a step (``_init_wire_accounting``,
        ``ps.py:1135-1215``). Leader mode takes the lowering that receives
        fewest bytes: ``psum_scatter`` for psum codecs, else
        ``dense_scatter`` (decode the own payload, reduce-scatter it) or
        ``payload_gather`` (all-gather the payloads and decode-sum)."""
        w, plan = self.size, self._bucket_plan
        frac = (w - 1) / w
        leaves = list(self.params.values())
        n = float(sum(p.numel() * p.element_size() for p in leaves))
        if plan is not None:
            payload = float(sum(self.code.payload_bits((b.size,), b.dtype) // 8
                                for b in plan.buckets))
        else:
            payload = float(sum(
                self.code.payload_bits(self._view_shape(k), p.dtype) // 8
                for k, p in self.params.items()))

        def wire_bytes(dtype: Optional[torch.dtype]) -> float:
            return float(sum(p.numel() * (dtype.itemsize if dtype is not None
                                          else p.element_size())
                             for p in leaves))

        if self.code.supports_fused_allreduce:
            # two rank-sized all-reduces a compressed leaf, one plain one an
            # uncompressed leaf: the payload term does not grow with the
            # world (``ps.py:1174-1189``)
            fused = float(sum(
                self.code.fused_wire_bits(self._view_shape(k), p.dtype,
                                          comm_dtype=self.comm_dtype) // 8
                for k, p in self.params.items()))
            lowering, recv = "two_psum_lowrank", 2 * frac * fused
            if self.mode == "leader":
                recv += frac * n  # the sharded update's parameter all-gather
        elif self.mode == "leader":
            if self.code.supports_psum:
                lowering = "psum_scatter"
                recv = frac * (wire_bytes(self._psum_wire()) + n)
            else:
                dense = frac * wire_bytes(self.comm_dtype)
                gather = (w - 1) * payload
                lowering, recv = (("dense_scatter", dense + frac * n)
                                  if dense < gather
                                  else ("payload_gather", gather + frac * n))
        elif self.code.supports_psum:
            lowering, recv = "psum", 2 * frac * wire_bytes(self._psum_wire())
        else:
            lowering, recv = "allgather", (w - 1) * payload
        return dict(
            msg_bytes=n, packaged_bytes=payload, wire_lowering=lowering,
            wire_bytes_per_worker=recv,
            bucket_count=plan.num_buckets if plan is not None else 0,
            bucket_bytes_total=plan.total_bytes if plan is not None else 0,
            agg_launches=(plan.num_buckets if plan is not None
                          else len(leaves)))

    def _leader_lowering(self) -> str:
        return self._metrics["wire_lowering"] if self.mode == "leader" else ""

    # -- the codec's view of a leaf -----------------------------------------
    def _view(self, key, t: torch.Tensor) -> torch.Tensor:
        perm = self._views.get(key)
        return t if perm is None else t.permute(perm)

    def _unview(self, key, t: torch.Tensor) -> torch.Tensor:
        perm = self._views.get(key)
        return t if perm is None else t.permute(_inverse(perm))

    def _view_shape(self, key) -> Tuple[int, ...]:
        return tuple(self._view(key, self.params[key]).shape)

    def _to_view(self, tree: Leaves) -> Leaves:
        return {k: self._view(k, t) for k, t in tree.items()}

    def _from_view(self, tree: Leaves) -> Leaves:
        return {k: self._unview(k, t) for k, t in tree.items()}

    # -- the pipeline -------------------------------------------------------
    def _encode(self, key, x: torch.Tensor):
        """One unit's payload: a leaf threads its codec state, a bucket
        takes none (bucketable codecs are stateless). A codec that draws
        random numbers takes them from this rank's generator in unit
        order."""
        if self._bucket_plan is not None:
            return self.code.encode(x, (), self._gen)[0]
        payload, self.codec_state[key] = self.code.encode(
            x, self.codec_state[key], self._gen)
        return payload

    def _own_decoded(self, key, x: torch.Tensor) -> torch.Tensor:
        """A unit's own payload decoded: the codec-filtered gradient."""
        v = self._view(key, x)
        return self._unview(key, self.code.decode(
            self._encode(key, v), tuple(v.shape), v.dtype))

    def _aggregate(self, grads: Params) -> Params:
        """encode -> collective -> decode_sum for every leaf (reference
        ``pytorch_ps_mpi_tpu/ps.py:438``), or the codec's collective
        protocol (``ps.py:1274-1284``)."""
        code, summed = self.code, {}
        if code.supports_fused_allreduce:
            for k, g in grads.items():
                s, self.codec_state[k] = code.fused_allreduce(
                    self._view(k, g), self.codec_state[k],
                    comm_dtype=self.comm_dtype)
                summed[k] = self._unview(k, s)
        elif code.supports_psum:
            wire = self._psum_wire()
            for k, g in grads.items():
                summed[k] = (comms.allreduce_sum(g.to(wire)).to(g.dtype)
                             if wire is not None else comms.allreduce_sum(g))
        else:
            for k, g in grads.items():
                v = self._view(k, g)
                gathered = comms.all_gather_tree(self._encode(k, v))
                summed[k] = self._unview(k, decode_sum_payloads(
                    code, gathered, tuple(v.shape), v.dtype))
        if self.average:
            summed = {k: s / self.size for k, s in summed.items()}
        return summed

    def _leader_leaves(self, tree: Params) -> Leaves:
        """The units leader mode shards: the leaves, or the buckets (of
        the codec's views)."""
        if self._bucket_plan is None:
            return tree
        return dict(enumerate(flatten_into_buckets(self._bucket_plan,
                                                   self._to_view(tree))))

    def _leader_scatter(self, to_scatter: Leaves,
                        wire: Optional[torch.dtype]) -> Leaves:
        shards = leader_scatter_shards(to_scatter, self.size, wire,
                                       self.average)
        if self.clip_norm:
            # shards partition the aggregated gradient (padding is zeros),
            # so the sum of the ranks' shard norms is the global norm
            shards = clip_by_global_norm(shards, self.clip_norm,
                                         across_ranks=True)
        return shards

    @torch.no_grad()
    def _leader_update(self, grad_shards: Leaves) -> None:
        """The shard-local step, the all-gather, and the gathered values
        copied into the parameters in one call (``ps.py:1061``)."""
        gathered, self.opt_state = leader_shard_update(
            self._leader_targets, self.opt_state, grad_shards,
            self._update_fn, self.hyper)
        plan = self._bucket_plan
        if plan is not None:
            gathered = self._from_view(unflatten_from_buckets(
                plan, [gathered[i] for i in range(plan.num_buckets)]))
        torch._foreach_copy_(list(self.params.values()),
                             [gathered[k] for k in self.params])

    def _aggregate_update(self, grads: Params) -> None:
        """Aggregate, clip and update in the lowering of the mode, over
        the units: the leaves, or the buckets with a plan (the JAX
        package's ``_aggregate_update``, ``_bucketed_encode_aggregate_update``
        and ``_update``, ``ps.py:1220``, ``:1073``, ``:1039``)."""
        lowering = self._leader_lowering()
        if lowering in ("psum_scatter", "dense_scatter"):
            units, wire = self._leader_leaves(grads), self._psum_wire()
            if lowering == "dense_scatter":
                # the own payload decoded to the codec-filtered gradient;
                # the reduce-scatter sums those, as decode_sum of the
                # gathered payloads would
                units = {k: self._own_decoded(k, u) for k, u in units.items()}
                wire = self.comm_dtype
            self._leader_update(self._leader_scatter(units, wire))
            return
        # allgather mode, or the leader payload_gather lowering: every rank
        # holds the whole summed gradient
        plan = self._bucket_plan
        if plan is None:
            units = summed = self._aggregate(grads)
        else:
            buckets = bucketed_aggregate(self.code, self._to_view(grads),
                                         plan, self.average, self.size,
                                         self.comm_dtype, self._gen)
            units = dict(enumerate(buckets))
            summed = self._from_view(unflatten_from_buckets(plan, buckets))
        if self.clip_norm:
            # the norm over the leaves (views of the buckets), so that a
            # bucketed step clips exactly as the per-leaf one does
            scale = _clip_scale(summed.values(), self.clip_norm)
            units = {k: u * scale.to(u.dtype) for k, u in units.items()}
        if self.mode == "leader":
            self._leader_update(leader_slice_shards(units, self.size,
                                                    self.rank))
            return
        if plan is not None:
            units = self._from_view(unflatten_from_buckets(
                plan, [units[i] for i in range(plan.num_buckets)]))
        self.params, self.opt_state = self._update_fn(
            self.params, units, self.opt_state, self.hyper)

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
                            "ROADMAP queue 1 item 8 (telemetry)")
        if aux_state is not None:
            raise _unported("step(aux_state=...) (BatchNorm state)",
                            "ROADMAP queue 1 item 3")
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
        self._aggregate_update(local)
        if closure is not None:
            loss = closure()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        data["step_time"] = time.perf_counter() - t0
        self._step_count += 1
        return loss, data

    def step_accumulate(self, *args, **kwargs):
        raise _unported("step_accumulate", "ROADMAP queue 1 item 2")

    def run_steps(self, *args, **kwargs):
        raise _unported("run_steps", "ROADMAP queue 1 item 2")

    def state_dict(self) -> Dict[str, Any]:
        """Checkpointable state in the JAX package's schema (params,
        opt_state, codec_state, step_count, rng); live references, not
        copies. In leader mode ``opt_state`` is this rank's
        ``(param_shards, inner)``."""
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
        if isinstance(self.opt_state, LeaderState):
            shards, inner = sd["opt_state"]
            self.opt_state = LeaderState(dict(shards),
                                         type(self.opt_state.inner)(*inner))
        else:
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

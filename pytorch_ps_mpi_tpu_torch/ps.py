"""The drop-in distributed optimizer step (``pytorch_ps_mpi_tpu/ps.py``).

Each ``step`` runs the reference's pipeline (``ps.py:94-191``) on
``torch.distributed``: encode every gradient leaf with the codec, gather
the payloads from every rank, decode and sum them (a left fold in rank
order), then apply the fused SGD/Adam/Adafactor update. Identity-like
codecs (``supports_psum``) sum with one ``all_reduce`` instead, narrowed
to ``comm_dtype`` or the codec's ``wire_dtype``. A codec whose
aggregation is a collective protocol (``supports_fused_allreduce``,
PowerSGD's two all-reduces of low-rank factors) skips encode and gather
and gives the summed gradient itself (``ps.py:568-598``). A ragged
payload (threshold's) is gathered as any other, its int32 true-length
sidecar one more tensor of the tree.

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

Beside ``step``: ``step(aux_state=...)`` threads a model's mutable state
(BatchNorm's running statistics), averaged over ranks every step;
``step_accumulate`` sums the gradients of microbatches before one
aggregate; ``run_steps`` runs N steps with the losses kept on the device
and one host sync at the end; ``instrument=True`` runs the pipeline as
separately timed stages (grad, encode, gather or psum, decode, update).
The aggregate and update of every step is one module-level function,
:func:`aggregate_update`, over explicit state and a :class:`Pipeline`
that fixes the codec, the optimizer, the topology and its lowering;
``MPI_PS`` and ``parallel.dp.make_sync_train_step`` both call it, and
the staged pipeline ends in its tail, :func:`update_summed`.

The options the JAX constructor also accepts and the port does not have
yet (``numerics``, ``param_specs``, ``mesh``, ``axis_name``,
``batch_spec``) and the ``profile`` step argument raise
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
    "numerics": (False, "ROADMAP queue 1 item 7 (telemetry/numerics.py)"),
    "param_specs": (None, "ROADMAP queue 1 item 8 (model-parallel "
                          "composition)"),
    "mesh": (None, "ROADMAP queue 1 item 8 (the process group stands for "
                   "the mesh until then)"),
    "axis_name": ("data", "ROADMAP queue 1 item 8 (tuple aggregation "
                          "axes)"),
    "batch_spec": (None, "ROADMAP queue 1 item 8 (model-parallel batch "
                         "layouts)"),
}
_PROFILE = "ROADMAP queue 1 item 7 (telemetry)"


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


def _view(views, key, t: torch.Tensor) -> torch.Tensor:
    perm = views.get(key) if views else None
    return t if perm is None else t.permute(perm)


def _unview(views, key, t: torch.Tensor) -> torch.Tensor:
    perm = views.get(key) if views else None
    return t if perm is None else t.permute(_inverse(perm))


def encode_tree(code: Codec, grads: Params, codec_state: Dict[str, Any],
                gen: Optional[torch.Generator] = None,
                views: Optional[Dict[str, Tuple[int, ...]]] = None):
    """Every leaf's payload and new codec state, in leaf order (reference
    ``pytorch_ps_mpi_tpu/ps.py:377``). A codec that draws random numbers
    takes them from ``gen`` in that order. ``views``: ``name ->
    permutation`` an order-dependent codec sees a leaf through (its
    ``codec_view``)."""
    payloads, new_state = {}, {}
    for k, g in grads.items():
        payloads[k], new_state[k] = code.encode(_view(views, k, g),
                                                codec_state[k], gen)
    return payloads, new_state


def _psum_wire(code: Codec, comm_dtype: Optional[torch.dtype]
               ) -> Optional[torch.dtype]:
    """The wire dtype of a psum-capable codec's collectives."""
    return comm_dtype or getattr(code, "wire_dtype", None)


def aggregate(code: Codec, grads: Params, codec_state: Dict[str, Any],
              gen: Optional[torch.Generator] = None,
              views: Optional[Dict[str, Tuple[int, ...]]] = None,
              comm_dtype: Optional[torch.dtype] = None):
    """The sum across ranks of every leaf, a leaf at a time (reference
    ``ps.py:438``): ``(summed, new_codec_state)``. psum codecs all-reduce
    the leaf, narrowed to ``comm_dtype`` or the codec's ``wire_dtype``; a
    codec whose aggregation is a collective protocol runs it (PowerSGD's
    two all-reduces, ``ps.py:568-598``); any other encodes the leaf (a
    codec that draws random numbers takes them from ``gen`` in leaf
    order), all-gathers its payload and decode-sums it."""
    summed, new_state = {}, dict(codec_state)
    if code.supports_psum:
        wire = _psum_wire(code, comm_dtype)
        for k, g in grads.items():
            summed[k] = (comms.allreduce_sum(g.to(wire)).to(g.dtype)
                         if wire is not None else comms.allreduce_sum(g))
        return summed, new_state
    for k, g in grads.items():
        v = _view(views, k, g)
        if code.supports_fused_allreduce:
            s, new_state[k] = code.fused_allreduce(v, codec_state[k],
                                                   comm_dtype=comm_dtype)
        else:
            payload, new_state[k] = code.encode(v, codec_state[k], gen)
            s = decode_sum_payloads(code, comms.all_gather_tree(payload),
                                    tuple(v.shape), v.dtype)
        summed[k] = _unview(views, k, s)
    return summed, new_state


def _encode_buckets(code: Codec, buckets, gen: Optional[torch.Generator]):
    """Per-bucket encode (stateless by the ``bucketable`` contract,
    ``ps.py:509``); a codec that draws random numbers takes them from this
    rank's generator in bucket order."""
    return [code.encode(b, (), gen)[0] for b in buckets]


def bucketed_aggregate(code: Codec, grads: Params, plan: BucketPlan,
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
        return comms.allreduce_sum_buckets(buckets,
                                           _psum_wire(code, comm_dtype))
    return [decode_sum_payloads(code, comms.all_gather_tree(payload),
                                tuple(b.shape), b.dtype)
            for b, payload in zip(buckets, _encode_buckets(code, buckets, gen))]


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


class Pipeline(NamedTuple):
    """What fixes a step's aggregate and update, apart from the state it
    threads: the codec, the optimizer's update and hyperparameters, the
    topology (``mode``; ``lowering``, leader mode's wire lowering:
    ``psum_scatter``, ``dense_scatter`` or one where every rank holds the
    whole sum), ``average`` over ``size`` ranks, this ``rank``, the psum
    wire's ``comm_dtype``, ``clip_norm``, the bucket plan (``None``: a
    leaf at a time) and the ``codec_view`` permutations."""

    code: Codec
    update_fn: Callable
    hyper: Any
    mode: str = "allgather"
    lowering: str = ""
    average: bool = False
    size: int = 1
    rank: int = 0
    comm_dtype: Optional[torch.dtype] = None
    clip_norm: float = 0.0
    plan: Optional[BucketPlan] = None
    views: Optional[Dict[str, Tuple[int, ...]]] = None


def _units_of(p: Pipeline, tree: Params) -> Leaves:
    """The units a step aggregates and leader mode shards: the leaves, or
    with a bucket plan the buckets of the codec's views."""
    if p.plan is None:
        return tree
    return dict(enumerate(flatten_into_buckets(
        p.plan, {k: _view(p.views, k, t) for k, t in tree.items()})))


def _leaves_of(p: Pipeline, units: Leaves) -> Params:
    """The leaves of :func:`_units_of`'s units (views of the buckets)."""
    if p.plan is None:
        return units
    leaves = unflatten_from_buckets(
        p.plan, [units[i] for i in range(p.plan.num_buckets)])
    return {k: _unview(p.views, k, t) for k, t in leaves.items()}


def _own_decoded(p: Pipeline, units: Leaves, codec_state: Dict[str, Any],
                 gen: Optional[torch.Generator]):
    """Each unit's own payload decoded, the codec-filtered gradient (the
    ``dense_scatter`` lowering): ``(decoded, new_codec_state)``. A leaf
    threads its codec state; a bucket takes none (bucketable codecs are
    stateless)."""
    out, new_state = {}, dict(codec_state)
    for k, u in units.items():
        v = _view(p.views, k, u)
        if p.plan is not None:
            payload = p.code.encode(v, (), gen)[0]
        else:
            payload, new_state[k] = p.code.encode(v, codec_state[k], gen)
        out[k] = _unview(p.views, k, p.code.decode(payload, tuple(v.shape),
                                                   v.dtype))
    return out, new_state


def _leader_step(p: Pipeline, params: Params, opt_state: LeaderState,
                 grad_shards: Leaves) -> Tuple[Params, LeaderState]:
    """The shard-local update and the all-gather back into whole leaves
    (new tensors, shaped as ``params``)."""
    targets = (dict(enumerate(p.plan.bucket_templates()))
               if p.plan is not None else params)
    gathered, opt_state = leader_shard_update(targets, opt_state,
                                              grad_shards, p.update_fn,
                                              p.hyper)
    return _leaves_of(p, gathered), opt_state


def update_summed(p: Pipeline, params: Params, summed: Leaves, opt_state):
    """Average, clip and update from the whole summed gradient, given as
    :func:`_units_of`'s units: ``(params, opt_state)``. Leader mode slices
    this rank's shard of each unit, steps it and all-gathers the new
    parameters (new tensors); allgather mode updates ``params`` in
    place."""
    if p.average:
        summed = {k: s / p.size for k, s in summed.items()}
    if p.clip_norm:
        # the norm over the leaves (views of the buckets), so that a
        # bucketed step clips exactly as the per-leaf one does
        scale = _clip_scale(_leaves_of(p, summed).values(), p.clip_norm)
        summed = {k: s * scale.to(s.dtype) for k, s in summed.items()}
    if p.mode == "leader":
        return _leader_step(p, params, opt_state,
                            leader_slice_shards(summed, p.size, p.rank))
    return p.update_fn(params, _leaves_of(p, summed), opt_state, p.hyper)


def aggregate_update(p: Pipeline, params: Params, grads: Params, opt_state,
                     codec_state: Dict[str, Any],
                     gen: Optional[torch.Generator] = None):
    """Aggregate this rank's gradient across ranks, clip and update, in
    the lowering of the mode (the JAX package's ``_aggregate_update``,
    ``_bucketed_encode_aggregate_update`` and ``_update``, ``ps.py:1220``,
    ``:1073``, ``:1039``): ``(params, opt_state, codec_state)``."""
    if p.lowering in ("psum_scatter", "dense_scatter"):
        units, wire = _units_of(p, grads), _psum_wire(p.code, p.comm_dtype)
        if p.lowering == "dense_scatter":
            # the own payload decoded to the codec-filtered gradient; the
            # reduce-scatter sums those, as decode_sum of the gathered
            # payloads would
            units, codec_state = _own_decoded(p, units, codec_state, gen)
            wire = p.comm_dtype
        shards = leader_scatter_shards(units, p.size, wire, p.average)
        if p.clip_norm:
            # shards partition the aggregated gradient (padding is zeros),
            # so the sum of the ranks' shard norms is the global norm
            shards = clip_by_global_norm(shards, p.clip_norm,
                                         across_ranks=True)
        params, opt_state = _leader_step(p, params, opt_state, shards)
        return params, opt_state, codec_state
    # allgather mode, or a leader lowering where every rank holds the
    # whole summed gradient
    if p.plan is not None:
        summed = dict(enumerate(bucketed_aggregate(
            p.code, {k: _view(p.views, k, g) for k, g in grads.items()},
            p.plan, p.comm_dtype, gen)))
    else:
        summed, codec_state = aggregate(p.code, grads, codec_state, gen,
                                        p.views, p.comm_dtype)
    params, opt_state = update_summed(p, params, summed, opt_state)
    return params, opt_state, codec_state


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
      instrument: run every step as separately timed stages and fill the
        metrics' per-stage keys with host wall times, each stage ended by
        a device sync: for measurement (``grad_time``, ``code_wait``,
        ``isend_time``, ``comm_wait``, ``decode_time``,
        ``optim_step_time``). The stages always all-reduce or
        gather-and-decode-sum a leaf at a time (a psum codec's all-reduce
        keeps its buckets), so ``wire_lowering`` reads ``psum_staged`` or
        ``payload_gather_staged``.
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
        instrument: bool = False,
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
        self.instrument = bool(instrument)
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
            self._bucket_plan = plan_buckets(
                {k: self._view(k, p) for k, p in self.params.items()},
                self.bucket_mb)
        # else: a per-tensor codec keeps the per-leaf path, no error
        self._metrics = self._static_metrics()
        if mode == "leader":
            # with a plan the master copy and optimizer state are kept a
            # bucket at a time, so a bucket's reduce-scatter lands on the
            # shard its update owns; SGD and Adam are elementwise, so
            # per-bucket state updates as per-leaf state does
            self.opt_state = leader_init_state(
                _units_of(self._pipe, {k: p.detach()
                                       for k, p in self.params.items()}),
                init_state, self.size, self.rank)
        else:
            self.opt_state = init_state(self.params)
        self.codec_state = {k: self.code.init_state(self._view_shape(k),
                                                    p.dtype, p.device)
                            for k, p in self.params.items()}
        self._gen = None
        if self.code.needs_rng:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(seed * 1_000_003 + self.rank)
        #: the model's mutable state (BatchNorm's running statistics) after
        #: the last ``step(aux_state=...)``, averaged over ranks
        self.aux_state: Any = None
        self._step_count = 0

    # -- accounting ---------------------------------------------------------
    def _wire_bytes(self, dtype: Optional[torch.dtype]) -> float:
        """The parameters' bytes, each element ``dtype`` wide (its own
        width for ``None``)."""
        return float(sum(p.numel() * (dtype.itemsize if dtype is not None
                                      else p.element_size())
                         for p in self.params.values()))

    def _leaf_payload_bytes(self) -> float:
        """One rank's payload bytes a step, a leaf at a time."""
        return float(sum(
            self.code.payload_bits(self._view_shape(k), p.dtype) // 8
            for k, p in self.params.items()))

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
        n = self._wire_bytes(None)
        if plan is not None:
            payload = float(sum(self.code.payload_bits((b.size,), b.dtype) // 8
                                for b in plan.buckets))
        else:
            payload = self._leaf_payload_bytes()

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
                recv = frac * (self._wire_bytes(
                    _psum_wire(self.code, self.comm_dtype)) + n)
            else:
                dense = frac * self._wire_bytes(self.comm_dtype)
                gather = (w - 1) * payload
                lowering, recv = (("dense_scatter", dense + frac * n)
                                  if dense < gather
                                  else ("payload_gather", gather + frac * n))
        elif self.code.supports_psum:
            lowering = "psum"
            recv = 2 * frac * self._wire_bytes(
                _psum_wire(self.code, self.comm_dtype))
        else:
            lowering, recv = "allgather", (w - 1) * payload
        return dict(
            msg_bytes=n, packaged_bytes=payload, wire_lowering=lowering,
            wire_bytes_per_worker=recv,
            bucket_count=plan.num_buckets if plan is not None else 0,
            bucket_bytes_total=plan.total_bytes if plan is not None else 0,
            agg_launches=(plan.num_buckets if plan is not None
                          else len(self.params)))

    # -- the codec's view of a leaf -----------------------------------------
    def _view(self, key, t: torch.Tensor) -> torch.Tensor:
        return _view(self._views, key, t)

    def _unview(self, key, t: torch.Tensor) -> torch.Tensor:
        return _unview(self._views, key, t)

    def _view_shape(self, key) -> Tuple[int, ...]:
        return tuple(self._view(key, self.params[key]).shape)

    # -- the pipeline -------------------------------------------------------
    @property
    def _pipe(self) -> Pipeline:
        """The step's :class:`Pipeline`, from the optimizer's attributes
        as they are now."""
        return Pipeline(
            self.code, self._update_fn, self.hyper, self.mode,
            self._metrics["wire_lowering"] if self.mode == "leader" else "",
            self.average, self.size, self.rank, self.comm_dtype,
            self.clip_norm, self._bucket_plan, self._views)

    @torch.no_grad()
    def _set_params(self, params: Params) -> None:
        """Take the step's new parameters: leader mode's gathered tensors
        are copied into the parameters, so a module being trained sees
        them; allgather mode's are these tensors, updated in place."""
        if self.mode == "leader":
            torch._foreach_copy_(list(self.params.values()),
                                 [params[k] for k in self.params])
        else:
            self.params = params

    def _aggregate_update(self, grads: Params) -> None:
        params, self.opt_state, self.codec_state = aggregate_update(
            self._pipe, self.params, grads, self.opt_state, self.codec_state,
            self._gen)
        self._set_params(params)

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        total = comms.allreduce_sum(loss)
        return total / self.size if self._loss_reduction == "pmean" else total

    def _local_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        if g.shape[0] != self.size:
            raise ValueError(
                f"grads[{name!r}] must be stacked on a leading "
                f"[world={self.size}] axis, got shape {tuple(g.shape)}")
        return g[self.rank]

    def _loss_and_grads(self, loss_fn: Callable, batch, aux_state=None):
        """This rank's loss, its gradient and (with ``aux_state``) the new
        aux state. ``loss_fn(params, batch) -> loss``, or with
        ``aux_state`` ``loss_fn(params, aux_state, batch) -> (loss,
        new_aux)``."""
        leaves = {k: p.detach().requires_grad_()
                  for k, p in self.params.items()}
        new_aux = None
        with torch.enable_grad():
            if aux_state is None:
                loss = loss_fn(leaves, batch)
            else:
                loss, new_aux = loss_fn(leaves, aux_state, batch)
            g = torch.autograd.grad(loss, list(leaves.values()))
        if new_aux is not None:
            new_aux = comms.tree_map(torch.Tensor.detach, new_aux)
        return loss.detach(), dict(zip(leaves, g)), new_aux

    def _grad_stage(self, loss_fn: Callable, batch, aux_state=None,
                    accum_steps: int = 0):
        """The reduced loss and this rank's gradient. ``accum_steps`` > 0:
        ``batch`` holds that many microbatches on its leading axis; their
        gradients are summed from zero in order and divided by
        ``accum_steps``, the loss is their mean (``ps.py:402``). With
        ``aux_state`` the new aux state is averaged over ranks (``lax.pmean``,
        ``ps.py:1665``) into :attr:`aux_state`."""
        if accum_steps:
            acc = {k: torch.zeros_like(p) for k, p in self.params.items()}
            losses = []
            for i in range(accum_steps):
                loss, g, _ = self._loss_and_grads(loss_fn, _index(batch, i))
                for k, a in acc.items():
                    a.add_(g[k])
                losses.append(loss)
                del g
            grads = {k: a / accum_steps for k, a in acc.items()}
            return self._reduce_loss(torch.stack(losses).mean()), grads
        loss, grads, new_aux = self._loss_and_grads(loss_fn, batch, aux_state)
        if aux_state is not None:
            self.aux_state = comms.allreduce_mean_tree(new_aux)
        return self._reduce_loss(loss), grads

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_step_args(self, grads, loss_fn, batch, aux_state) -> None:
        if loss_fn is None and grads is None:
            raise ValueError("pass grads or loss_fn+batch")
        if loss_fn is not None and batch is None:
            raise ValueError("loss_fn requires batch")
        if loss_fn is None and aux_state is not None:
            raise NotImplementedError(
                "aux_state requires the loss_fn path (grads-only steps have "
                "no forward pass to produce new aux state)")

    # -- the staged pipeline (instrument=True) ------------------------------
    def _relabel_staged(self, data: Dict[str, Any]) -> None:
        """The staged pipeline's collectives are not the fused step's
        (``ps.py:1573-1607``): a psum codec's full all-reduce, or the
        payload gather and decode-sum a leaf at a time even under a bucket
        plan; in leader mode the update stage's all-gather of the
        parameters is counted too."""
        w = self.size
        frac = (w - 1) / w
        if self.code.supports_psum:
            data["wire_lowering"] = "psum_staged"
            data["wire_bytes_per_worker"] = 2 * frac * self._wire_bytes(
                _psum_wire(self.code, self.comm_dtype))
        else:
            per_leaf = self._leaf_payload_bytes()
            data["wire_lowering"] = "payload_gather_staged"
            data["wire_bytes_per_worker"] = (w - 1) * per_leaf
            data["packaged_bytes"] = per_leaf
            data["bucket_count"] = 0.0
            data["agg_launches"] = float(len(self.params))
        if self.mode == "leader":
            data["wire_bytes_per_worker"] += frac * data["msg_bytes"]

    def _step_instrumented(self, data: Dict[str, Any], local: Optional[Params],
                           loss_fn=None, batch=None, aux_state=None,
                           accum_steps: int = 0):
        """grad -> encode -> gather or psum -> decode -> update, each stage
        ended by a device sync (the JAX package's ``block_until_ready``) and
        timed on the host (reference schema, ``ps.py:116-148``; JAX
        ``ps.py:1552-1641``). ``local``: this rank's gradient of a
        grads-only step."""
        timer, code = time.perf_counter, self.code
        self._relabel_staged(data)
        loss = None
        if loss_fn is not None:
            t0 = timer()
            loss, local = self._grad_stage(loss_fn, batch, aux_state,
                                           accum_steps)
            self._sync()
            data["grad_time"] = timer() - t0
            if accum_steps:
                data["grad_time_per_microbatch"] = (data["grad_time"]
                                                    / accum_steps)
        t0 = timer()
        payloads, new_codec_state = encode_tree(
            code, local, self.codec_state, self._gen, self._views)
        self._sync()
        data["code_wait"] = timer() - t0                 # reference :138
        if code.supports_psum:
            t0 = timer()
            if self._bucket_plan is not None:
                summed = dict(enumerate(bucketed_aggregate(
                    code, {k: self._view(k, g) for k, g in local.items()},
                    self._bucket_plan, self.comm_dtype)))
            else:
                summed = aggregate(code, local, self.codec_state,
                                   comm_dtype=self.comm_dtype)[0]
            self._sync()
            data["comm_wait"] = timer() - t0             # reference :162
        else:
            t0 = timer()
            gathered = {k: comms.all_gather_tree(pl)
                        for k, pl in payloads.items()}
            data["isend_time"] = timer() - t0            # dispatch, :148
            self._sync()
            data["comm_wait"] = timer() - t0
            t0 = timer()
            summed = _units_of(self._pipe, {
                k: self._unview(k, decode_sum_payloads(
                    code, gathered[k], self._view_shape(k), g.dtype))
                for k, g in local.items()})
            self._sync()
            data["decode_time"] = timer() - t0           # reference :168
        t0 = timer()
        params, self.opt_state = update_summed(self._pipe, self.params,
                                               summed, self.opt_state)
        self._set_params(params)
        self._sync()
        data["optim_step_time"] = timer() - t0           # reference :191
        self.codec_state = new_codec_state
        return loss

    # -- public API ---------------------------------------------------------
    def step(
        self,
        grads: Optional[Params] = None,
        *,
        loss_fn: Optional[Callable] = None,
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

        ``aux_state``: a model's mutable state (BatchNorm's running
        statistics, ``models.resnet.batch_stats_of``); ``loss_fn(params,
        aux_state, batch)`` then returns ``(loss, new_aux)``, and
        ``new_aux`` averaged over ranks is kept in :attr:`aux_state` (pass
        that to the next step) and in :meth:`state_dict`.
        """
        if profile:
            raise _unported("step(profile=True)", _PROFILE)
        self._check_step_args(grads, loss_fn, batch, aux_state)
        t0 = time.perf_counter()
        data = schema_dict(**self._metrics)
        local = None
        if loss_fn is None:
            local = {k: self._local_grad(k, grads[k]) for k in self.params}
        if self.instrument:
            loss = self._step_instrumented(data, local, loss_fn, batch,
                                           aux_state)
        elif loss_fn is not None:
            loss = self._fused_step(loss_fn, batch, aux_state)
        else:
            loss = None
            self._aggregate_update(local)
        if closure is not None:
            loss = closure()
        self._sync()
        data["step_time"] = time.perf_counter() - t0
        self._step_count += 1
        return loss, data

    def _fused_step(self, loss_fn: Callable, batch, aux_state=None,
                    accum_steps: int = 0) -> torch.Tensor:
        loss, local = self._grad_stage(loss_fn, batch, aux_state, accum_steps)
        self._aggregate_update(local)
        return loss

    def step_accumulate(self, loss_fn: Callable, microbatches, *,
                        profile: bool = False
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One optimizer step over ``accum_steps`` microbatches (JAX
        ``ps.py:1797``): every leaf of ``microbatches`` is ``[accum_steps,
        local_batch, ...]``, this rank's own. The microbatches' gradients
        are summed from zero in order and divided by ``accum_steps``, then
        aggregated and applied once; returns ``(mean_loss, data)``, the
        microbatches' mean loss reduced across ranks. Under
        ``instrument=True`` the accumulation is the grad stage, with
        ``grad_time_per_microbatch`` its mean a microbatch."""
        if profile:
            raise _unported("step_accumulate(profile=True)", _PROFILE)
        accum_steps = _leading(microbatches)
        t0 = time.perf_counter()
        data = schema_dict(**self._metrics)
        data["accum_steps"] = float(accum_steps)
        if self.instrument:
            loss = self._step_instrumented(data, None, loss_fn, microbatches,
                                           accum_steps=accum_steps)
        else:
            loss = self._fused_step(loss_fn, microbatches,
                                    accum_steps=accum_steps)
        self._sync()
        self._step_count += 1
        data["step_time"] = time.perf_counter() - t0
        return loss, data

    def run_steps(self, loss_fn: Callable, batches, *,
                  aux_state: Any = None
                  ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """N training steps with the losses kept on the device as one
        ``[N]`` tensor and one host sync at the end (JAX ``ps.py:2167``,
        whose steps are one ``lax.scan`` program). Every leaf of
        ``batches`` is ``[N, local_batch, ...]``. The steps are those of
        N :meth:`step` calls, bit for bit: the same kernels, and a codec's
        random numbers drawn in the same order. ``aux_state`` threads a
        model's mutable state through the N steps as ``step`` does.
        Returns ``(losses, {"step_time", "steps_per_sec", "n_steps"})``."""
        n_steps = _leading(batches)
        t0 = time.perf_counter()
        losses = []
        for i in range(n_steps):
            losses.append(self._fused_step(loss_fn, _index(batches, i),
                                           aux_state))
            if aux_state is not None:
                aux_state = self.aux_state
            self._step_count += 1
        losses = torch.stack(losses)
        self._sync()
        wall = time.perf_counter() - t0
        return losses, {"step_time": wall / n_steps,
                        "steps_per_sec": n_steps / wall,
                        "n_steps": float(n_steps)}

    def state_dict(self) -> Dict[str, Any]:
        """Checkpointable state in the JAX package's schema (params,
        opt_state, codec_state, aux_state, step_count, rng); live
        references, not copies. In leader mode ``opt_state`` is this
        rank's ``(param_shards, inner)``."""
        return {
            "params": self.params,
            "opt_state": tuple(self.opt_state),
            "codec_state": self.codec_state,
            "aux_state": self.aux_state,
            "step_count": self._step_count,
            "rng_state": (self._gen.get_state() if self._gen is not None
                          else None),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict`. Parameters are copied into the
        existing tensors, so a module being trained sees the restore;
        codec state (error feedback's memory) and aux state are copied
        onto the parameters' device."""
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
        aux = sd.get("aux_state")
        self.aux_state = None if aux is None else comms.tree_map(
            lambda t: t.to(self.device, copy=True), aux)
        self._step_count = int(sd["step_count"])
        if self._gen is not None and sd.get("rng_state") is not None:
            self._gen.set_state(sd["rng_state"])


def _index(tree, i: int):
    """Row ``i`` of every tensor of ``tree`` (one microbatch or step)."""
    return comms.tree_map(lambda t: t[i], tree)


def _leading(tree) -> int:
    """The common leading size of every tensor of ``tree``."""
    sizes = set()
    comms.tree_map(lambda t: sizes.add(int(t.shape[0])), tree)
    if len(sizes) != 1:
        raise ValueError(f"every leaf must share its leading (step or "
                         f"microbatch) axis, got sizes {sorted(sizes)}")
    return sizes.pop()


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

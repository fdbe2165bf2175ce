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

``numerics=True`` takes the JAX package's on-device gradient statistics
inside every ``step`` and ``step_accumulate`` (one device-to-host copy of
one float32 vector a step); ``step(profile=True)`` traces the step with
``torch.profiler`` and fills ``comm_wait`` with its NCCL kernel time
(``utils.tracing.profiled_device_split``). With a flight recorder
installed (``telemetry.configure``) every step is a span there.

A step's stages are spans (``utils.tracing.annotate``, the names of
``utils.tracing.STEP_SPANS``): ``ps.step`` the whole call, ``ps.grad``
the forward and backward, ``ps.aggregate`` every encode, the exchange
and the decode-sum, ``ps.update`` the update and the new parameters
taken, ``ps.numerics`` the statistics, ``ps.wait`` the host waiting for
the card at the end. Under the profiler they are ``record_function``
ranges on the clock of the device rows; with a recorder installed the
stages are its spans too, with the step's number. With neither they
cost two checks each, and no sync is added.

Model-parallel composition (JAX ``ps.py:699-968``): ``mesh=`` a named
``mesh.Mesh``, ``axis_name=`` the axis (or tuple of axes) gradients
aggregate over, ``param_specs=`` a ``name -> mesh.P`` spec of each leaf.
Every rank holds its own shard of each leaf (``Mesh.shard``); a leaf
aggregates over the aggregation axes its spec does not shard (an expert
stack sharded over an aggregation axis sums over the others only), each
through its ``mesh.Group``. Under ``param_specs`` or tuple axes the loss
is the local loss with a static global normalizer, so the reported loss
is its sum over the aggregation axes; a model-sharded leaf's clip norm
spans its shards; leader mode shards each rank's shard of every leaf
over the aggregation axes, so the state is sharded jointly over the
data and model axes (``leader_state_spec``, ``ps.py:205``).
``batch_spec=`` makes ``batch`` the global batch, of which each rank
takes its block.
"""

from __future__ import annotations

import functools
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn

from pytorch_ps_mpi_tpu_torch import comms
from pytorch_ps_mpi_tpu_torch import mesh as meshlib
from pytorch_ps_mpi_tpu_torch.bucketing import (BucketPlan,
                                                flatten_into_buckets,
                                                plan_buckets,
                                                unflatten_from_buckets)
from pytorch_ps_mpi_tpu_torch.codecs import (Codec, ErrorFeedback,
                                             IdentityCodec)
from pytorch_ps_mpi_tpu_torch.optim import (OPTIMIZERS,
                                            adafactor_check_sharding,
                                            adafactor_update)
from pytorch_ps_mpi_tpu_torch.telemetry.numerics import flat_f32, leaf_sums
from pytorch_ps_mpi_tpu_torch.telemetry.recorder import get_recorder
from pytorch_ps_mpi_tpu_torch.utils.metrics import schema_dict
from pytorch_ps_mpi_tpu_torch.utils.tracing import annotate

Params = Dict[str, torch.Tensor]
#: ``name -> tensor``, or ``bucket index -> tensor`` with a bucket plan
Leaves = Dict[Any, torch.Tensor]

_PROFILE_INSTRUMENT = (
    "profile=True and instrument=True are mutually exclusive: instrument "
    "runs a staged pipeline (host walls per stage) while profile traces "
    "the fused step — construct the optimizer without instrument=True to "
    "use profile")


def clip_by_global_norm(grads: Leaves, clip_norm: float,
                        across_ranks: bool = False, group=None,
                        leaf_groups: Optional[Dict[Any, Any]] = None
                        ) -> Leaves:
    """Scale ``grads`` so their global L2 norm is at most ``clip_norm``
    (torch ``clip_grad_norm_`` semantics on the aggregated gradient,
    reference ``pytorch_ps_mpi_tpu/ps.py:267``). ``across_ranks``: the
    tensors are this rank's shards of the gradient (leader mode), so the
    sum of squares is summed across ``group``'s ranks (default: all)
    first and every rank clips alike. ``leaf_groups``: ``key ->
    mesh.Group`` of a model-sharded leaf's shards, over which its sum of
    squares is summed first (``leaf_extra_axes``, ``ps.py:277``)."""
    scale = _clip_scale(grads, clip_norm, across_ranks, group, leaf_groups)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}


def _clip_scale(tensors: Leaves, clip_norm: float,
                across_ranks: bool = False, group=None,
                leaf_groups: Optional[Dict[Any, Any]] = None
                ) -> torch.Tensor:
    """The factor :func:`clip_by_global_norm` scales by: ``clip_norm``
    over the L2 norm of ``tensors``, at most 1."""
    sumsq = 0.0
    for k, g in tensors.items():
        s = torch.sum(torch.square(g.to(torch.float32)))
        if leaf_groups and leaf_groups.get(k) is not None:
            s = comms.allreduce_sum(s, leaf_groups[k])
        sumsq = sumsq + s
    if across_ranks:
        sumsq = comms.allreduce_sum(sumsq, group)
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
              comm_dtype: Optional[torch.dtype] = None,
              groups: Optional[Dict[str, Any]] = None):
    """The sum across ranks of every leaf, a leaf at a time (reference
    ``ps.py:438``): ``(summed, new_codec_state)``. psum codecs all-reduce
    the leaf, narrowed to ``comm_dtype`` or the codec's ``wire_dtype``; a
    codec whose aggregation is a collective protocol runs it (PowerSGD's
    two all-reduces, ``ps.py:568-598``); any other encodes the leaf (a
    codec that draws random numbers takes them from ``gen`` in leaf
    order), all-gathers its payload and decode-sums it. ``groups``:
    ``name -> mesh.Group`` each leaf sums over (``leaf_axes``,
    ``ps.py:446``); default every rank."""
    summed, new_state = {}, dict(codec_state)
    groups = groups or {}
    if code.supports_psum:
        wire = _psum_wire(code, comm_dtype)
        for k, g in grads.items():
            grp = groups.get(k)
            summed[k] = (comms.allreduce_sum(g.to(wire), grp).to(g.dtype)
                         if wire is not None else comms.allreduce_sum(g, grp))
        return summed, new_state
    for k, g in grads.items():
        v = _view(views, k, g)
        grp = groups.get(k)
        if code.supports_fused_allreduce:
            s, new_state[k] = code.fused_allreduce(v, codec_state[k],
                                                   comm_dtype=comm_dtype,
                                                   group=grp)
        else:
            payload, new_state[k] = code.encode(v, codec_state[k], gen)
            s = decode_sum_payloads(code, comms.all_gather_tree(payload, grp),
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
                       gen: Optional[torch.Generator] = None, group=None
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
                                           _psum_wire(code, comm_dtype), group)
    return [decode_sum_payloads(code, comms.all_gather_tree(payload, group),
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
                          average: bool = False, group=None) -> Leaves:
    """A reduce-scatter a leaf of the local gradients (``ps.py:239``): each
    rank receives only its shard's sum across ranks (``group``'s, default
    all), ``[1, shard_len]``, narrowed to ``comm_dtype`` on the wire."""
    out = {}
    for k, g in grads.items():
        rows = _to_shards(g, world).reshape(-1)
        if comm_dtype is not None:
            rows = rows.to(comm_dtype)
        sh = comms.reduce_scatter_tiled(rows, group).to(g.dtype).view(1, -1)
        out[k] = sh / world if average else sh
    return out


def leader_slice_shards(summed: Leaves, world: int, rank: int) -> Leaves:
    """This rank's ``[1, shard_len]`` row of every leaf, when every rank
    already holds the whole summed gradient (the payload-gather lowering,
    ``ps.py:258``)."""
    return {k: _to_shards(g, world)[rank:rank + 1] for k, g in summed.items()}


def leader_shard_update(targets: Leaves, opt_state: LeaderState,
                        grad_shards: Leaves, update_fn: Callable,
                        hyper, group=None) -> Tuple[Leaves, LeaderState]:
    """The shard-local optimizer step, in place on this rank's rows, then
    a tiled all-gather a leaf (over ``group``, default all) back to whole
    tensors (``ps.py:297``). ``targets``: ``key -> tensor`` whose shapes
    the gathered values take (meta tensors do). Returns the gathered
    values and the new state."""
    shards, inner = update_fn(opt_state.param_shards, grad_shards,
                              opt_state.inner, hyper)
    gathered = {}
    for k, sh in shards.items():
        t = targets[k]
        gathered[k] = comms.all_gather_tiled(sh.reshape(-1), group)[
            :t.numel()].view(t.shape)
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
    #: the mesh's aggregation ``mesh.Group`` (None: every rank)
    group: Any = None
    #: ``name -> mesh.Group`` each leaf sums over (None: every rank)
    leaf_groups: Optional[Dict[str, Any]] = None
    #: ``name -> mesh.Group`` of a model-sharded leaf's shards (its clip
    #: norm spans them)
    clip_groups: Optional[Dict[str, Any]] = None


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
                                              p.hyper, p.group)
    return _leaves_of(p, gathered), opt_state


def update_summed(p: Pipeline, params: Params, summed: Leaves, opt_state):
    """Average, clip and update from the whole summed gradient, given as
    :func:`_units_of`'s units: ``(params, opt_state)``. Leader mode slices
    this rank's shard of each unit, steps it and all-gathers the new
    parameters (new tensors); allgather mode updates ``params`` in
    place."""
    if p.average:
        summed = {k: s / _leaf_size(p, k) for k, s in summed.items()}
    if p.clip_norm:
        # the norm over the leaves (views of the buckets), so that a
        # bucketed step clips exactly as the per-leaf one does
        scale = _clip_scale(_leaves_of(p, summed), p.clip_norm,
                            leaf_groups=p.clip_groups)
        summed = {k: s * scale.to(s.dtype) for k, s in summed.items()}
    if p.mode == "leader":
        return _leader_step(p, params, opt_state,
                            leader_slice_shards(summed, p.size, p.rank))
    return p.update_fn(params, _leaves_of(p, summed), opt_state, p.hyper)


def _leaf_size(p: Pipeline, key) -> int:
    """The ranks leaf ``key`` is summed over (``leaf_sizes``,
    ``ps.py:447``)."""
    if p.leaf_groups and key in p.leaf_groups:
        return p.leaf_groups[key].size
    return p.size


def aggregate_update(p: Pipeline, params: Params, grads: Params, opt_state,
                     codec_state: Dict[str, Any],
                     gen: Optional[torch.Generator] = None, *,
                     step: Optional[int] = None,
                     take: Optional[Callable[[Params], None]] = None):
    """Aggregate this rank's gradient across ranks, clip and update, in
    the lowering of the mode (the JAX package's ``_aggregate_update``,
    ``_bucketed_encode_aggregate_update`` and ``_update``, ``ps.py:1220``,
    ``:1073``, ``:1039``): ``(params, opt_state, codec_state)``. The
    aggregate, up to the summed units or leader mode's shards, is the
    span ``ps.aggregate``; the rest, with ``take(params)`` where the
    caller takes the new parameters, is ``ps.update``; both carry
    ``step``."""
    scatter = p.lowering in ("psum_scatter", "dense_scatter")
    with annotate("ps.aggregate", step):
        if scatter:
            units = _units_of(p, grads)
            wire = _psum_wire(p.code, p.comm_dtype)
            if p.lowering == "dense_scatter":
                # the own payload decoded to the codec-filtered gradient;
                # the reduce-scatter sums those, as decode_sum of the
                # gathered payloads would
                units, codec_state = _own_decoded(p, units, codec_state,
                                                  gen)
                wire = p.comm_dtype
            shards = leader_scatter_shards(units, p.size, wire, p.average,
                                           p.group)
        # allgather mode, or a leader lowering where every rank holds the
        # whole summed gradient
        elif p.plan is not None:
            summed = dict(enumerate(bucketed_aggregate(
                p.code, {k: _view(p.views, k, g) for k, g in grads.items()},
                p.plan, p.comm_dtype, gen, p.group)))
        else:
            summed, codec_state = aggregate(p.code, grads, codec_state, gen,
                                            p.views, p.comm_dtype,
                                            p.leaf_groups)
    with annotate("ps.update", step):
        if scatter:
            if p.clip_norm:
                # shards partition the aggregated gradient (padding is
                # zeros), so the sum of the ranks' shard norms is the
                # global norm (a model-sharded leaf's summed over its
                # shards too)
                shards = clip_by_global_norm(shards, p.clip_norm,
                                             across_ranks=True,
                                             group=p.group,
                                             leaf_groups=p.clip_groups)
            params, opt_state = _leader_step(p, params, opt_state, shards)
        else:
            params, opt_state = update_summed(p, params, summed, opt_state)
        if take is not None:
            take(params)
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
      numerics: take on-device gradient statistics inside every fused
        ``step`` and ``step_accumulate`` (JAX ``ps.py:662``): the global
        finite gradient norm (``grad_norm``), the NaN/Inf element count
        (``nonfinite_total``), the update-to-weight ratio ``||dp||/||p||``
        (``update_ratio``), the per-bucket gradient norms under a bucket
        plan (``bucket_grad_norms``) and the error-feedback residual norm
        under :class:`~pytorch_ps_mpi_tpu_torch.codecs.ErrorFeedback`
        (``ef_residual_norm``). The reductions run on the tensors' device
        and one float32 vector is copied to the host a step;
        ``instrument=True`` stages and ``run_steps`` skip them, as in the
        JAX package.
      device: where the parameters live; ``"cuda"`` by default, and it
        raises when no GPU is present. Pass ``device="cpu"`` to run on
        the CPU.
      donate_buffers: accepted for the JAX signature and a no-op: the
        update already runs in place on the parameters and the optimizer
        state (JAX donates them to its jitted step).
      mesh: a named ``mesh.Mesh``; default: every rank on the one axis
        ``axis_name`` (a tuple ``axis_name`` makes a mesh of its axes,
        every rank on the first).
      axis_name: the mesh axis, or tuple of axes, gradients aggregate
        over; under a tuple the loss is reduced with ``psum``.
      param_specs: ``name -> mesh.P``, each leaf's sharding over the mesh
        (missing names are replicated); ``params`` are then this rank's
        shards. A leaf aggregates over the aggregation axes its spec does
        not name; a model-sharded leaf's clip norm spans its shards;
        leader mode needs every leaf to aggregate over all the
        aggregation axes; Adafactor's factored dims must be unsharded
        (``optim.adafactor_check_sharding``). Not with ``bucket_mb``,
        ``numerics`` or ``instrument``.
      batch_spec: ``batch`` is the global batch and each rank takes its
        block under this spec (``mesh.P``, e.g. ``P("data", "seq")``);
        default: ``batch`` is this rank's own.
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
        numerics: bool = False,
        device: meshlib.Device = "cuda",
        donate_buffers: bool = False,
        mesh: Optional[meshlib.Mesh] = None,
        axis_name=meshlib.DATA_AXIS,
        param_specs: Optional[Dict[str, Any]] = None,
        batch_spec=None,
        **hyper,
    ):
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
        self.device = meshlib.resolve_device(device)
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
        self.numerics = bool(numerics)
        #: the last ``profile=True`` step's split (``device_busy_s``,
        #: ``comm_s``, ``compute_s``, ``devices``, ``top_ops``)
        self.profile_split: Optional[Dict[str, Any]] = None
        self._nvec: Optional[torch.Tensor] = None
        self._bucket_of_leaf: Optional[torch.Tensor] = None
        self._setup_mesh(mesh, axis_name, param_specs, batch_spec, mode,
                         optim, loss_reduction, instrument)
        self.bucket_mb = float(bucket_mb)
        self._bucket_plan: Optional[BucketPlan] = None
        if self.bucket_mb > 0 and (self._model_parallel
                                   or not self._uniform_agg):
            raise NotImplementedError(
                "bucket_mb > 0 requires pure-DP layouts: model-sharded "
                "or expert-parallel leaves aggregate over per-leaf axis "
                "sets that one flat bucket cannot represent. Drop "
                "param_specs or set bucket_mb=0")
        if self.numerics and self._model_parallel:
            raise NotImplementedError(
                "numerics=True requires pure-DP layouts: model-sharded "
                "leaves would need per-leaf reduction axis sets for the "
                "global norms. Drop param_specs or set numerics=False")
        if self._model_parallel and instrument:
            raise NotImplementedError(
                "instrument=True (the staged host-timed pipeline) is not "
                "supported with param_specs — use profile=True on the "
                "fused step for the trace-derived comm/compute split")
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
            self._gen.manual_seed(seed * 1_000_003 + meshlib.rank())
        #: the model's mutable state (BatchNorm's running statistics) after
        #: the last ``step(aux_state=...)``, averaged over ranks
        self.aux_state: Any = None
        self._step_count = 0

    # -- the mesh (model-parallel composition) ------------------------------
    def _setup_mesh(self, mesh, axis_name, param_specs, batch_spec,
                    mode: str, optim: str, loss_reduction, instrument
                    ) -> None:
        """The aggregation groups, per leaf, and the JAX constructor's
        checks of a model-parallel layout (``ps.py:752-874``)."""
        self.axis_name = axis_name
        self._agg_axes = ((axis_name,) if isinstance(axis_name, str)
                          else tuple(axis_name))
        if mesh is None and (not isinstance(axis_name, str)
                             or param_specs is not None
                             or batch_spec is not None):
            mesh = meshlib.make_mesh(axis_names=self._agg_axes)
        self.mesh = mesh
        specs = dict(param_specs or {})
        unknown = sorted(set(specs) - set(self.params))
        if unknown:
            raise ValueError(f"param_specs names {unknown}, which are not "
                             "parameters")
        self.param_specs = {k: specs.get(k, meshlib.P())
                            for k in self.params}
        shard_axes = {k: meshlib.spec_axes(sp)
                      for k, sp in self.param_specs.items()}
        self._model_parallel = any(shard_axes.values())
        # a leaf sharded over an aggregation axis (an expert stack) sums
        # over the other aggregation axes only
        leaf_axes = {k: tuple(a for a in self._agg_axes if a not in ax)
                     for k, ax in shard_axes.items()}
        self._uniform_agg = all(a == self._agg_axes
                                for a in leaf_axes.values())
        self.batch_spec = batch_spec
        if loss_reduction is None:
            loss_reduction = ("psum" if self._model_parallel
                              or not isinstance(axis_name, str) else "pmean")
        self._loss_reduction = loss_reduction
        self._group = self._leaf_groups = self._clip_groups = None
        if mesh is None:
            self.rank, self.size = meshlib.rank(), meshlib.world_size()
        else:
            self._group = mesh.group(self._agg_axes)
            self.rank, self.size = self._group.index, self._group.size
            self._leaf_groups = {k: mesh.group(a)
                                 for k, a in leaf_axes.items()}
            if self._model_parallel:
                self._clip_groups = {k: mesh.group(a)
                                     for k, a in shard_axes.items() if a}
        if mode == "leader" and not self._uniform_agg:
            raise ValueError(
                "leader (ZeRO-1) mode requires every leaf to aggregate "
                "over the full data axes — param_specs must not shard "
                "over the aggregation axes; use mode='allgather' for "
                "expert-parallel layouts")
        if optim == "adafactor" and self._model_parallel:
            if not self._uniform_agg:
                raise NotImplementedError(
                    "optim='adafactor' with expert-parallel layouts "
                    "(leaves sharded over a data axis) is unsupported: "
                    "the per-leaf scalar reductions would need per-leaf "
                    "axis sets. Use optim='adam'/'sgd' for EP")
            adafactor_check_sharding(self._global_shapes(),
                                     self.param_specs)
            model = mesh.group(tuple(a for a in mesh.axis_names
                                     if a not in self._agg_axes))

            def scalar_mean(x):
                return comms.allreduce_sum(x, model) / model.size

            self._update_fn = functools.partial(adafactor_update,
                                                scalar_mean=scalar_mean)
        if self._model_parallel and mode == "leader":
            for k, sp in self.param_specs.items():
                sharded = [i for i, e in enumerate(tuple(sp))
                           if e is not None]
                if sharded and sharded != [0]:
                    raise ValueError(
                        "leader mode requires model-sharded leaves to use "
                        "the leading-shard-axis convention (spec P(axis) on "
                        f"dim 0 only); got {sp} for shape "
                        f"{self._global_shapes()[k]}")

    def _global_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each leaf's global shape (its shard's, times its spec's axis
        sizes)."""
        if self.mesh is None:
            return {k: tuple(p.shape) for k, p in self.params.items()}
        return {k: self.mesh.global_shape(p.shape, self.param_specs[k])
                for k, p in self.params.items()}

    def _local_batch(self, batch, lead: int = 0):
        """This rank's block of a global ``batch`` under ``batch_spec``
        (after ``lead`` leading step or microbatch axes); ``batch`` as it
        is without a ``batch_spec``."""
        if self.batch_spec is None or batch is None:
            return batch
        spec = meshlib.P(*((None,) * lead + tuple(self.batch_spec)))
        return comms.tree_map(lambda t: self.mesh.shard(t, spec), batch)

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
            self.clip_norm, self._bucket_plan, self._views, self._group,
            self._leaf_groups, self._clip_groups)

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

    def _aggregate_update(self, grads: Params, stats: bool = False) -> None:
        """Aggregate, update and take the new parameters; ``stats``: keep
        the numerics vector of this step in ``_nvec``."""
        step, old = self._step_count + 1, None
        if stats:
            # a copy, outside any autograd graph
            with annotate("ps.numerics", step), torch.no_grad():
                old = flat_f32(self.params.values())
        _, self.opt_state, self.codec_state = aggregate_update(
            self._pipe, self.params, grads, self.opt_state, self.codec_state,
            self._gen, step=step, take=self._set_params)
        if stats:
            with annotate("ps.numerics", step):
                self._nvec = self._numerics_vec(old, grads)

    @torch.no_grad()
    def _numerics_vec(self, old: torch.Tensor, grads: Params
                      ) -> torch.Tensor:
        """The step's statistics as one float32 vector on the device (JAX
        ``ps.py:1295``)::

            [grad_sumsq, nonfinite, update_sumsq, param_sumsq,
             ef_residual_sumsq, *per_bucket_sumsq]

        The gradient terms are this rank's, finite-masked and summed over
        ranks in one all-reduce: the global gradient energy and NaN/Inf
        count (counted in float32, as the JAX package does). The update
        and parameter terms read the replicated parameters, before
        (``old``, flattened) and after the step. Each term reduces the
        leaves as one vector, a few launches a step whatever the leaf
        count."""
        g = flat_f32(grads.values())
        finite = torch.isfinite(g)
        clean = torch.where(finite, g, torch.zeros_like(g))
        ranked = [torch.sum(torch.square(clean)),
                  torch.sum(~finite).to(torch.float32)]
        if isinstance(self.code, ErrorFeedback):
            ranked.append(torch.sum(torch.square(flat_f32(
                st["memory"] for st in self.codec_state.values()))))
        else:
            ranked.append(torch.zeros((), device=g.device))
        ranked = torch.stack(ranked)
        plan = self._bucket_plan
        if plan is not None:
            # each leaf's finite energy summed into its bucket
            leaves = torch.square(leaf_sums(
                clean, [t.numel() for t in grads.values()], 2))
            if self._bucket_of_leaf is None:  # one copy to the device
                self._bucket_of_leaf = torch.tensor(
                    [s.bucket for s in plan.leaf_slots], device=g.device)
            ranked = torch.cat([ranked, torch.zeros(
                plan.num_buckets, device=g.device).index_add_(
                    0, self._bucket_of_leaf, leaves)])
        ranked = comms.allreduce_sum(ranked, self._group)
        new = flat_f32(self.params.values())
        upd = torch.stack([torch.sum(torch.square(new - old)),
                           torch.sum(torch.square(old))])
        return torch.cat([ranked[:2], upd, ranked[2:]])

    def _fill_numerics(self, data: Dict[str, Any]) -> None:
        """Unpack the step's statistics into its metrics dict (JAX
        ``ps.py:1348``): the one device-to-host copy numerics costs a
        step."""
        v = self._nvec.cpu().numpy()
        self._nvec = None
        data["grad_norm"] = float(np.sqrt(v[0]))
        data["nonfinite_total"] = float(v[1])
        data["update_ratio"] = float(np.sqrt(v[2])) / max(
            float(np.sqrt(v[3])), 1e-30)
        if isinstance(self.code, ErrorFeedback):
            data["ef_residual_norm"] = float(np.sqrt(v[4]))
        if self._bucket_plan is not None:
            data["bucket_grad_norms"] = [float(np.sqrt(x)) for x in v[5:]]

    def _profiled_call(self, call: Callable[[], Any],
                       data: Dict[str, Any]) -> Any:
        """Run one fused step under ``torch.profiler`` and fill the
        reference's ``comm_wait`` (``ps.py:162``) with the step's NCCL
        kernel time, and ``profile_device_busy``, ``profile_compute`` and
        ``profile_devices`` with the rest of the split (JAX ``ps.py:2085``);
        the whole split, with its ``top_ops``, is :attr:`profile_split`.
        On the card a trace that lost device rows is taken again from the
        state the step began with (by every rank together), and fails
        after a few takes."""
        from pytorch_ps_mpi_tpu_torch.utils import tracing

        reset = agree = None
        if tracing.on_card(self.device):
            def clone(t):
                return t.detach().clone() if torch.is_tensor(t) else t

            saved = comms.tree_map(clone, self.state_dict())

            def reset():
                # the optimizer steps its state in place and
                # load_state_dict keeps the tensors it is given: each
                # retake starts from a copy of ``saved``, never ``saved``
                self.load_state_dict(comms.tree_map(clone, saved))

            if self.size > 1:
                # a retake runs the step's collectives: every rank
                # retakes, or none does
                def agree(whole: bool) -> bool:
                    short = torch.tensor(0.0 if whole else 1.0,
                                         device=self.device)
                    return float(comms.allreduce_sum(short)) == 0.0
        out, split = tracing.profiled_device_split(
            call, device=self.device, reset=reset, agree=agree)
        data["comm_wait"] = split["comm_s"]
        data["profile_device_busy"] = split["device_busy_s"]
        data["profile_compute"] = split["compute_s"]
        data["profile_devices"] = float(split["devices"])
        self.profile_split = split
        return out

    def _record_step(self, name: str, data: Dict[str, Any],
                     start: float) -> None:
        """Mirror one step's metrics dict into the run-wide flight
        recorder as a span from ``start`` (``time.monotonic()`` as the
        step began; JAX ``ps.py:1932``); a disabled recorder costs this
        method's None-check."""
        rec = get_recorder()
        if rec is None:
            return
        dur = float(data.get("step_time", 0.0))
        rec.event(name, kind="span", ts=start, dur=dur,
                  step=self._step_count,
                  **{k: v for k, v in data.items()
                     if isinstance(v, (int, float, str))})

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        total = comms.allreduce_sum(loss, self._group)
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
        ``ps.py:1665``) into :attr:`aux_state`. The span ``ps.grad``."""
        with annotate("ps.grad", self._step_count + 1):
            if accum_steps:
                acc = {k: torch.zeros_like(p)
                       for k, p in self.params.items()}
                losses = []
                for i in range(accum_steps):
                    loss, g, _ = self._loss_and_grads(loss_fn,
                                                      _index(batch, i))
                    for k, a in acc.items():
                        a.add_(g[k])
                    losses.append(loss)
                    del g
                grads = {k: a / accum_steps for k, a in acc.items()}
                return self._reduce_loss(torch.stack(losses).mean()), grads
            loss, grads, new_aux = self._loss_and_grads(loss_fn, batch,
                                                        aux_state)
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
        grads-only step. The spans are the fused step's: ``ps.grad``,
        ``ps.aggregate`` from the encode through the decode-sum, and
        ``ps.update``."""
        timer, code = time.perf_counter, self.code
        step = self._step_count + 1
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
        with annotate("ps.aggregate", step):
            t0 = timer()
            payloads, new_codec_state = encode_tree(
                code, local, self.codec_state, self._gen, self._views)
            self._sync()
            data["code_wait"] = timer() - t0             # reference :138
            if code.supports_psum:
                t0 = timer()
                if self._bucket_plan is not None:
                    summed = dict(enumerate(bucketed_aggregate(
                        code, {k: self._view(k, g) for k, g in local.items()},
                        self._bucket_plan, self.comm_dtype,
                        group=self._group)))
                else:
                    summed = aggregate(code, local, self.codec_state,
                                       comm_dtype=self.comm_dtype,
                                       groups=self._leaf_groups)[0]
                self._sync()
                data["comm_wait"] = timer() - t0         # reference :162
            else:
                t0 = timer()
                gathered = {k: comms.all_gather_tree(pl, self._group)
                            for k, pl in payloads.items()}
                data["isend_time"] = timer() - t0        # dispatch, :148
                self._sync()
                data["comm_wait"] = timer() - t0
                t0 = timer()
                summed = _units_of(self._pipe, {
                    k: self._unview(k, decode_sum_payloads(
                        code, gathered[k], self._view_shape(k), g.dtype))
                    for k, g in local.items()})
                self._sync()
                data["decode_time"] = timer() - t0       # reference :168
        with annotate("ps.update", step):
            t0 = timer()
            params, self.opt_state = update_summed(self._pipe, self.params,
                                                   summed, self.opt_state)
            self._set_params(params)
            self._sync()
            data["optim_step_time"] = timer() - t0       # reference :191
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

        ``profile=True`` traces this step with ``torch.profiler`` and fills
        ``comm_wait`` with its NCCL kernel time, and
        ``profile_device_busy``/``profile_compute``/``profile_devices``
        with the rest of the split (:attr:`profile_split` keeps it whole,
        ``top_ops`` included); not with ``instrument=True``.
        """
        step = self._step_count + 1
        with annotate("ps.step", step, record=False):
            if profile and self.instrument:
                raise ValueError(_PROFILE_INSTRUMENT)
            self._check_step_args(grads, loss_fn, batch, aux_state)
            batch = self._local_batch(batch)
            start, t0 = time.monotonic(), time.perf_counter()
            data = schema_dict(**self._metrics)
            local = None
            if loss_fn is None:
                local = {k: self._local_grad(k, grads[k])
                         for k in self.params}
            if self.instrument:
                loss = self._step_instrumented(data, local, loss_fn, batch,
                                               aux_state)
            else:
                if loss_fn is not None:
                    def call():
                        return self._fused_step(loss_fn, batch, aux_state,
                                                stats=self.numerics)
                else:
                    def call():
                        self._aggregate_update(local, stats=self.numerics)
                loss = (self._profiled_call(call, data) if profile
                        else call())
                if self.numerics:
                    with annotate("ps.numerics", step):
                        self._fill_numerics(data)
            if closure is not None:
                loss = closure()
            with annotate("ps.wait", step):
                self._sync()
            data["step_time"] = time.perf_counter() - t0
            self._step_count += 1
            self._record_step("ps.step", data, start)
            return loss, data

    def _fused_step(self, loss_fn: Callable, batch, aux_state=None,
                    accum_steps: int = 0, stats: bool = False
                    ) -> torch.Tensor:
        loss, local = self._grad_stage(loss_fn, batch, aux_state, accum_steps)
        self._aggregate_update(local, stats)
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
        ``grad_time_per_microbatch`` its mean a microbatch.
        ``profile=True`` traces the fused step as :meth:`step` does."""
        step = self._step_count + 1
        with annotate("ps.step", step, record=False):
            if profile and self.instrument:
                raise ValueError(_PROFILE_INSTRUMENT)
            microbatches = self._local_batch(microbatches, lead=1)
            accum_steps = _leading(microbatches)
            start, t0 = time.monotonic(), time.perf_counter()
            data = schema_dict(**self._metrics)
            data["accum_steps"] = float(accum_steps)
            if self.instrument:
                loss = self._step_instrumented(data, None, loss_fn,
                                               microbatches,
                                               accum_steps=accum_steps)
            else:
                def call():
                    return self._fused_step(loss_fn, microbatches,
                                            accum_steps=accum_steps,
                                            stats=self.numerics)
                loss = (self._profiled_call(call, data) if profile
                        else call())
                if self.numerics:
                    with annotate("ps.numerics", step):
                        self._fill_numerics(data)
            with annotate("ps.wait", step):
                self._sync()
            self._step_count += 1
            data["step_time"] = time.perf_counter() - t0
            self._record_step("ps.step_accumulate", data, start)
            return loss, data

    def run_steps(self, loss_fn: Callable, batches, *, unroll: int = 1,
                  aux_state: Any = None
                  ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """N training steps with the losses kept on the device as one
        ``[N]`` tensor and one host sync at the end (JAX ``ps.py:2167``,
        whose steps are one ``lax.scan`` program). Every leaf of
        ``batches`` is ``[N, local_batch, ...]``. The steps are those of
        N :meth:`step` calls, bit for bit: the same kernels, and a codec's
        random numbers drawn in the same order. ``aux_state`` threads a
        model's mutable state through the N steps as ``step`` does.
        ``unroll`` is the JAX ``lax.scan``'s and a no-op here: a Python
        loop has nothing to unroll. Returns ``(losses, {"step_time",
        "steps_per_sec", "n_steps"})``."""
        batches = self._local_batch(batches, lead=1)
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
        data = {"step_time": wall / n_steps, "steps_per_sec": n_steps / wall,
                "n_steps": float(n_steps)}
        rec = get_recorder()
        if rec is not None:
            # one span for the N steps (JAX ``ps.py:2233``)
            rec.event("ps.run_steps", kind="span",
                      ts=time.monotonic() - wall, dur=wall,
                      step=self._step_count, **data)
        return losses, data

    def step_memory_analysis(self, loss_fn: Callable, batch, rng=None,
                             aux_state: Any = None) -> Dict[str, int]:
        """The device memory of one step (JAX ``ps.py:1746``, which reads
        XLA's buffer assignment): ``estimated_peak_bytes`` is the peak that
        ``torch.cuda.max_memory_allocated`` reads over one fused step,
        ``argument_size_in_bytes`` what was allocated when it began (the
        parameters, the optimizer and codec state, the batch). The step
        runs on copies: the optimizer's state is restored afterwards.
        ``rng`` is the JAX signature's and unused (a codec draws from the
        optimizer's generator, whose state is restored too). On the CPU
        it raises ``NotImplementedError``: PyTorch keeps no allocator
        statistics there."""
        if self.device.type != "cuda":
            raise NotImplementedError(
                "step_memory_analysis reads torch.cuda.max_memory_allocated; "
                "the CPU allocator keeps no peak statistics")
        torch.cuda.synchronize(self.device)
        before = torch.cuda.memory_allocated(self.device)
        saved = comms.tree_map(
            lambda t: t.detach().clone() if torch.is_tensor(t) else t,
            self.state_dict())
        copies = torch.cuda.memory_allocated(self.device) - before
        torch.cuda.reset_peak_memory_stats(self.device)
        try:
            self._fused_step(loss_fn, batch, aux_state)
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device) - copies
        finally:
            self.load_state_dict(saved)
        return {"argument_size_in_bytes": int(before),
                "estimated_peak_bytes": int(peak)}

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

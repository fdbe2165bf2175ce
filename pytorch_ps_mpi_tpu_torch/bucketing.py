"""Flat-bucket gradient aggregation: fuse per-leaf collectives into
dtype-grouped flat buffers (``pytorch_ps_mpi_tpu/bucketing.py``).

A :class:`BucketPlan` groups a ``name -> tensor`` dict's leaves **by
dtype** (a bucket is one flat tensor, so its dtype is uniform) into
contiguous ~``bucket_mb``-MB buffers, with exact offsets for every leaf,
0-d scalars included. The step then runs one collective a bucket instead
of one a leaf.

The leaf order is the dict's order (for a module, ``named_parameters()``),
the counterpart of ``jax.tree.flatten``'s order in the JAX package;
``utils.interop.params_from_jax`` returns a dict in the JAX leaf order,
so a plan over it has the JAX package's bucket membership. Packing is
one ``torch.cat`` a bucket; unpacking returns views of the buckets, so
it copies nothing.

``MPI_PS(bucket_mb=...)`` builds a plan for shape-agnostic stateless
codecs (``Codec.bucketable``); per-tensor codecs keep the per-leaf path.
``bucket_mb=0`` gives no plan: the per-leaf path. The JAX package's
``count_collectives`` reads lowered HLO; its counterpart here is the
exact count of collective calls that ``comms.calls`` keeps.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class LeafSlot(NamedTuple):
    """Where one leaf lives inside the bucket set (0-d leaves occupy one
    element; ``shape=()`` restores them on unpack)."""

    bucket: int            # index into BucketPlan.buckets
    offset: int            # element offset inside that bucket
    size: int              # element count (1 for 0-d scalars)
    shape: Tuple[int, ...]
    dtype: torch.dtype


class BucketSpec(NamedTuple):
    """One flat bucket: uniform dtype, ``size`` elements."""

    dtype: torch.dtype
    size: int

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


class BucketPlan:
    """Bucketing plan for one dict of leaves, built from shapes and dtypes
    only (meta tensors work). ``pack_leaves`` and ``unpack_leaves`` are
    exact inverses: a bucket is a concatenation of leaves, no
    arithmetic."""

    def __init__(self, names: List[str], leaf_slots: List[LeafSlot],
                 buckets: List[BucketSpec], bucket_mb: float):
        self.names = names
        self.leaf_slots = leaf_slots
        self.buckets = buckets
        self.bucket_mb = float(bucket_mb)

    # -- accounting -------------------------------------------------------
    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_slots)

    @property
    def bucket_bytes(self) -> List[int]:
        return [b.nbytes for b in self.buckets]

    @property
    def total_bytes(self) -> int:
        return sum(self.bucket_bytes)

    def __repr__(self) -> str:
        return (f"BucketPlan(leaves={self.num_leaves}, "
                f"buckets={self.num_buckets}, bytes={self.bucket_bytes})")

    # -- transforms -------------------------------------------------------
    def pack_leaves(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The leaves, in plan order, as one flat tensor a bucket."""
        if len(leaves) != self.num_leaves:
            raise ValueError(
                f"plan built for {self.num_leaves} leaves, got {len(leaves)}")
        parts: List[List[torch.Tensor]] = [[] for _ in self.buckets]
        for slot, leaf in zip(self.leaf_slots, leaves):
            if leaf.dtype != slot.dtype:
                raise TypeError(
                    f"leaf dtype {leaf.dtype} != planned {slot.dtype} "
                    "(tree changed since the plan was built?)")
            parts[slot.bucket].append(leaf.reshape(-1))
        # slots were assigned in leaf order, so in-order concatenation
        # reproduces exactly the planned offsets
        return [torch.cat(p) if len(p) > 1 else p[0] for p in parts]

    def unpack_leaves(self, buckets: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Views of ``buckets``, one a leaf, in the leaves' shapes."""
        if len(buckets) != self.num_buckets:
            raise ValueError(
                f"plan has {self.num_buckets} buckets, got {len(buckets)}")
        return [buckets[s.bucket].narrow(0, s.offset, s.size).view(s.shape)
                for s in self.leaf_slots]

    def bucket_templates(self) -> List[torch.Tensor]:
        """Shape-and-dtype-only ``(size,)`` tensors on the meta device, one
        a bucket: the bucketed leader update's gather targets, without a
        second copy of the parameters."""
        return [torch.empty((b.size,), dtype=b.dtype, device="meta")
                for b in self.buckets]


def plan_buckets(tree: Tree, bucket_mb: float) -> Optional[BucketPlan]:
    """Group ``tree``'s leaves by dtype into ~``bucket_mb``-MB flat buckets
    (``bucketing.py:164``).

    dtype groups come in first-appearance order, leaf order kept within
    each. A bucket is closed when the next leaf would pass the cap; a
    leaf larger than the cap gets a bucket of its own. ``bucket_mb <= 0``
    returns ``None``: the per-leaf path.
    """
    if bucket_mb is None or bucket_mb <= 0:
        return None
    cap_bytes = float(bucket_mb) * (1 << 20)
    names = list(tree)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, name in enumerate(names):
        groups.setdefault(tree[name].dtype, []).append(i)

    buckets: List[BucketSpec] = []
    slots: List[Optional[LeafSlot]] = [None] * len(names)
    for dt, idxs in groups.items():
        cur_size, cur_bucket = 0, -1
        for i in idxs:
            shape = tuple(tree[names[i]].shape)
            size = tree[names[i]].numel()
            if cur_bucket < 0 or (
                    cur_size > 0
                    and cur_size * dt.itemsize + size * dt.itemsize > cap_bytes):
                buckets.append(BucketSpec(dt, 0))
                cur_bucket, cur_size = len(buckets) - 1, 0
            slots[i] = LeafSlot(cur_bucket, cur_size, size, shape, dt)
            cur_size += size
            buckets[cur_bucket] = BucketSpec(dt, cur_size)
    return BucketPlan(names, slots, buckets, bucket_mb)


def flatten_into_buckets(plan: BucketPlan, tree: Tree) -> List[torch.Tensor]:
    """``tree`` -> its flat dtype-uniform buckets (inverse:
    :func:`unflatten_from_buckets`; bit-exact round trip)."""
    return plan.pack_leaves([tree[n] for n in plan.names])


def unflatten_from_buckets(plan: BucketPlan,
                           buckets: Sequence[torch.Tensor]) -> Tree:
    """Buckets -> the ``name -> tensor`` dict, as views of the buckets."""
    return dict(zip(plan.names, plan.unpack_leaves(buckets)))


__all__ = [
    "LeafSlot", "BucketSpec", "BucketPlan", "plan_buckets",
    "flatten_into_buckets", "unflatten_from_buckets",
]

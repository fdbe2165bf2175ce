"""Process-group bootstrap and device selection.

The torch counterpart of ``pytorch_ps_mpi_tpu/mesh.py``. A JAX mesh is a
set of devices driven by one program; here every rank is its own process.
The synchronous data-parallel step's "mesh" is the default
``torch.distributed`` process group; the model-parallel and long-context
layers take a named :class:`Mesh` (:func:`make_mesh`), one process group
a set of axes. With no group initialized the world is one rank, the same
as the JAX package's one-device mesh.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is
    asked for and no GPU is present (entry points default to ``"cuda"``
    and never fall back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group (reference ``mpi_comms.py:6-13``,
    JAX ``mesh.py:24``). No-op without ``init_method`` (single process)
    or when a group already exists. ``backend`` defaults to NCCL when a
    GPU is present and gloo otherwise. The caller gives the address
    (``tcp://localhost:<port>`` or ``file://<path>``), the world size and
    this process's rank: nothing here discovers a cluster."""
    if init_method is None or dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def world_size() -> int:
    """Number of ranks (reference ``ps.py:73``); 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (reference ``ps.py:71-72``); 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


# -- named meshes (``make_mesh``, ``mesh.py:43``) ----------------------------------

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart: one
    entry a dimension, each ``None`` (whole), an axis name or a tuple of
    axis names; ``P()`` is a replicated leaf."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self) -> str:
        # JAX's spelling, so the layouts' error messages read as its
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes ``spec`` shards over, in spec order (``_spec_axes``,
    ``ps.py:86``); ``()`` for a replicated leaf."""
    out = []
    for entry in tuple(spec or ()):
        if entry is None:
            continue
        out.extend(entry if isinstance(entry, (tuple, list)) else (entry,))
    return tuple(out)


class Group(NamedTuple):
    """The ranks that share this rank's coordinates on every mesh axis but
    ``axes``: ``size`` of them, this rank ``index`` among them (row-major
    over ``axes``), their global ``ranks`` in that order, and ``pg``, the
    process group a collective over them takes (``None``: the default
    group, when they are the whole world)."""

    axes: Tuple[str, ...]
    size: int
    index: int
    ranks: Tuple[int, ...]
    pg: Any


class Mesh:
    """A named mesh of ranks (``make_mesh``, ``mesh.py:43``): rank ``r``
    sits at ``numpy.unravel_index(r, shape)``, as device ``r`` of the JAX
    package's ``make_mesh(shape, axis_names)``, so rank ``r`` holds the
    shard that device does. One process group a set of axes and a slice
    of the others is made, on every rank in one order, when the mesh is
    built (``torch.distributed.new_group`` is collective); a set of axes
    whose ranks are the whole world takes the default group, and a set of
    size 1 within a larger world none (its collectives are the identity).
    Without a process group the world is one rank and every axis has size
    1."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if len(self.shape) != len(tuple(shape)):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{self.axis_names} differ in length")
        n = math.prod(self.shape.values())
        if n != world_size():
            raise ValueError(f"mesh shape {tuple(shape)} needs {n} ranks, "
                             f"have {world_size()}")
        self.rank = rank()
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, sizes))))
        self._groups: Dict[Tuple[str, ...], Group] = {}
        grid = np.arange(n).reshape(sizes)
        for k in range(1, len(sizes) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[axes] = self._make_groups(grid, axes)

    def _make_groups(self, grid: np.ndarray, axes: Tuple[str, ...]) -> Group:
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(grid.ndim) if i not in idx]
        m = math.prod(grid.shape[i] for i in idx)
        # every slice of the other axes, its ranks row-major over ``axes``
        slices = grid.transpose(rest + idx).reshape(-1, m)
        mine = next(s for s in slices if self.rank in s)
        ranks = tuple(int(r) for r in mine)
        pg = None
        if 1 < m < grid.size:
            for s in slices:  # collective: every rank makes every group
                g = dist.new_group([int(r) for r in s])
                if self.rank in s:
                    pg = g
        return Group(axes, m, ranks.index(self.rank), ranks, pg)

    def group(self, axes) -> Group:
        """The :class:`Group` over ``axes`` (a name or a tuple of names, in
        any order: the group's ranks follow the mesh's axis order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh "
                             f"{self.axis_names}")
        if not axes:
            return Group((), 1, 0, (self.rank,), None)
        return self._groups[tuple(a for a in self.axis_names if a in axes)]

    def axis_size(self, axes) -> int:
        """The number of ranks along ``axes`` (``lax.axis_size``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (``lax.axis_index``),
        row-major over them in the mesh's order."""
        return self.group(axes).index

    def shard(self, x, spec):
        """This rank's block of the global array ``x`` under ``spec``
        (shard_map's in_spec): each dimension split over its axes, in
        spec order. ``x`` is a tensor or a numpy array."""
        for d, entry in enumerate(tuple(spec or ())):
            if entry is None:
                continue
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            n = self.axis_size(axes)
            # row-major over the entry's axes in the order it names them
            i = 0
            for a in axes:
                i = i * self.shape[a] + self.coords[a]
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of shape {tuple(x.shape)} is not "
                                 f"divisible by mesh axes {axes} (size {n})")
            step = x.shape[d] // n
            x = x[(slice(None),) * d + (slice(i * step, (i + 1) * step),)]
        return x

    def local_shape(self, shape, spec) -> Tuple[int, ...]:
        """The shard shape of a leaf of global ``shape`` under ``spec``
        (``_local_shape``, ``ps.py:100``)."""
        shape = list(shape)
        for d, entry in enumerate(tuple(spec or ())):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
                if shape[d] % self.shape[a]:
                    raise ValueError(
                        f"dim {d} of shape {tuple(shape)} is not divisible "
                        f"by mesh axis {a!r} (size {self.shape[a]})")
                shape[d] //= self.shape[a]
        return tuple(shape)

    def global_shape(self, local_shape, spec) -> Tuple[int, ...]:
        """The global shape whose shard under ``spec`` is ``local_shape``."""
        shape = list(local_shape)
        for d, entry in enumerate(tuple(spec or ())):
            if entry is not None:
                shape[d] *= self.axis_size(
                    entry if isinstance(entry, (tuple, list)) else (entry,))
        return tuple(shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def axis_group(axis, mesh: Optional[Mesh] = None) -> Group:
    """The :class:`Group` a layer's collective over ``axis`` takes:
    ``axis`` itself when it is one, else ``axis`` (a name or a tuple of
    names) of ``mesh``. Without a mesh, a world of one rank is an axis of
    size 1; a larger world raises, as a JAX collective outside
    ``shard_map`` does."""
    if isinstance(axis, Group):
        return axis
    if mesh is not None:
        return mesh.group(axis)
    if world_size() > 1:
        raise ValueError(f"axis {axis!r}: no mesh given; build one with "
                         "make_mesh and pass it as mesh=")
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return Group(names, 1, 0, (rank(),), None)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,)) -> Mesh:
    """A :class:`Mesh` over the default process group (``make_mesh``,
    ``mesh.py:43``); ``shape`` defaults to every rank on the first axis.
    Every rank calls it, with the same arguments, in the same order."""
    if shape is None:
        shape = (world_size(),) + (1,) * (len(tuple(axis_names)) - 1)
    return Mesh(shape, axis_names)

"""Host-side wire format: typed tree pack and unpack
(``pytorch_ps_mpi_tpu/utils/serialization.py``).

A tree of arrays travels as (one flat byte buffer, a static spec): each
array's bytes copied once to its offset, no pickling. The JAX package
flattens its trees with ``jax.tree.flatten``; the port does the same
walk itself (:func:`tree_flatten`: dict keys sorted, lists and tuples in
order), and :class:`TreeDef` renders the structure as JAX's
``PyTreeDef(...)`` string, so both packages write the same spec and the
same bytes for the same numpy arrays, and a wire's fingerprint
(``resilience/frames.py``) agrees across them.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Tuple

import numpy as np

Tree = Any


class TreeDef:
    """The structure of a tree of dicts, lists, tuples and None, whose
    other nodes are leaves. ``str()`` is JAX's ``PyTreeDef`` text."""

    def __init__(self, node):
        self._node = node  # ("dict", keys, kids) | ("list"/"tuple", kids)
        #                    | ("none",) | ("leaf",)

    @property
    def num_leaves(self) -> int:
        return _count(self._node)

    def unflatten(self, leaves) -> Tree:
        it = iter(leaves)
        out = _build(self._node, it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree structure holds")
        return out

    def __str__(self) -> str:
        return f"PyTreeDef({_render(self._node)})"

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))


_END = object()


def _structure(tree) -> tuple:
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys, [_structure(tree[k]) for k in keys])
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, [_structure(v) for v in tree])
    if tree is None:
        return ("none",)
    return ("leaf",)


def _count(node) -> int:
    if node[0] == "leaf":
        return 1
    if node[0] == "none":
        return 0
    return sum(_count(k) for k in node[-1])


def _build(node, it):
    kind = node[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(node[1], node[2])}
    kids = [_build(c, it) for c in node[1]]
    return kids if kind == "list" else tuple(kids)


def _render(node) -> str:
    kind = node[0]
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_render(c)}"
                               for k, c in zip(node[1], node[2])) + "}"
    body = ", ".join(_render(c) for c in node[1])
    if kind == "list":
        return f"[{body}]"
    return f"({body},)" if len(node[1]) == 1 else f"({body})"


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)


def tree_flatten(tree: Tree) -> Tuple[list, TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s order."""
    out: list = []
    _leaves(tree, out)
    return out, TreeDef(_structure(tree))


def _spec_of(leaves: List[np.ndarray]) -> List[dict]:
    return [{"shape": list(x.shape), "dtype": str(x.dtype)} for x in leaves]


def pack_arrays_into(out_u8: np.ndarray, arrays, offset: int = 0) -> int:
    """Copy each array's bytes into the uint8 buffer ``out_u8`` at
    sequential offsets, one memcpy an array. Returns the end offset."""
    for x in arrays:
        x = np.asarray(x)
        n = x.nbytes
        out_u8[offset:offset + n] = (
            np.ascontiguousarray(x).reshape(-1).view(np.uint8))
        offset += n
    return offset


def read_arrays(buf, specs, copy: bool = True, offset: int = 0):
    """Read ``[(shape, dtype), ...]`` sequentially from a bytes-like
    buffer through one ``memoryview``. ``copy=False`` returns zero-copy
    views, valid while ``buf`` lives. Raises ``ValueError`` naming both
    sizes when the buffer is shorter than the specs."""
    dims = []
    needed = offset
    for shape, dtype in specs:
        dtype = np.dtype(dtype)
        shape = tuple(shape)
        count = int(np.prod(shape)) if shape else 1
        dims.append((dtype, shape, count))
        needed += count * dtype.itemsize
    mv = memoryview(buf)
    if mv.nbytes < needed:
        raise ValueError(
            f"truncated buffer: specs describe {needed} bytes "
            f"({len(dims)} arrays), got {mv.nbytes}")
    out = []
    for dtype, shape, count in dims:
        arr = np.frombuffer(mv, dtype=dtype, count=count,
                            offset=offset).reshape(shape)
        out.append(arr.copy() if copy else arr)
        offset += count * dtype.itemsize
    return out


def pack_pytree(tree: Tree) -> Tuple[bytearray, str]:
    """One contiguous byte buffer plus a JSON spec (shapes, dtypes and
    the treedef); inverse :func:`unpack_pytree`."""
    leaves, treedef = tree_flatten(tree)
    np_leaves = [np.asarray(x) for x in leaves]
    total = sum(x.nbytes for x in np_leaves)
    buf = bytearray(total)
    spec = json.dumps({"leaves": _spec_of(np_leaves), "treedef": str(treedef)})
    if total:
        pack_arrays_into(np.frombuffer(buf, np.uint8), np_leaves)
    return buf, spec


def unpack_pytree(buf, spec: str, treedef: Optional[TreeDef] = None,
                  template: Tree = None, copy: bool = True) -> Tree:
    """Rebuild the arrays of :func:`pack_pytree` output into ``treedef``'s
    (or ``template``'s) structure. ``copy=False`` gives zero-copy views
    into ``buf``. A short buffer raises ``ValueError``."""
    meta = json.loads(spec)
    leaves = read_arrays(buf, [(m["shape"], m["dtype"])
                               for m in meta["leaves"]], copy=copy)
    if treedef is None:
        if template is None:
            raise ValueError("need treedef or template")
        treedef = tree_flatten(template)[1]
    return treedef.unflatten(leaves)


def save_pytree(path: str, tree: Tree, compress: bool = False) -> None:
    """Write a tree of arrays to ``path`` (``.npz``); ``compress=True``
    runs each leaf's bytes through the native wire codec
    (``utils/native.compress``). The file is the JAX package's."""
    leaves, treedef = tree_flatten(tree)
    if compress:
        from pytorch_ps_mpi_tpu_torch.utils import native

        arrays = {}
        for i, x in enumerate(leaves):
            arr = np.asarray(x)
            blob = native.compress(arr.tobytes(), elem_size=arr.dtype.itemsize)
            arrays[f"leaf_{i}"] = np.frombuffer(blob, np.uint8)
        arrays["__compressed__"] = np.ones(1, np.uint8)
    else:
        arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    np.savez(path, __treedef__=np.frombuffer(str(treedef).encode(),
                                             dtype=np.uint8), **arrays)


def load_pytree(path: str, template: Tree) -> Tree:
    """Read a :func:`save_pytree` file into ``template``'s structure,
    decompressing where it was saved with ``compress=True``."""
    tmpl_leaves, treedef = tree_flatten(template)
    with np.load(path) as data:
        compressed = "__compressed__" in data.files
        n = len(data.files) - (2 if compressed else 1)
        if treedef.num_leaves != n:
            raise ValueError(
                f"template has {treedef.num_leaves} leaves, file has {n}")
        if compressed:
            from pytorch_ps_mpi_tpu_torch.utils import native

            leaves = []
            for i, t in enumerate(tmpl_leaves):
                raw = native.decompress(data[f"leaf_{i}"].tobytes())
                t = np.asarray(t)
                leaves.append(np.frombuffer(raw, t.dtype).reshape(t.shape))
        else:
            leaves = [data[f"leaf_{i}"] for i in range(n)]
    return treedef.unflatten(leaves)

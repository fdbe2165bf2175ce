"""The ``Codec`` contract and registry.

The counterpart of ``pytorch_ps_mpi_tpu/codecs/base.py``:

- ``encode(grad, state, rng) -> (payload, new_state)`` per parameter on
  each worker's local gradient; the payload is a tensor or a dict of
  tensors of fixed shapes, so it can ride an all-gather;
- ``decode(payload, shape, dtype) -> grad``;
- ``decode_sum(payloads, shape, dtype) -> grad``: decode a ``[world,
  ...]`` stack and sum over ranks. The default is a **sequential left
  fold** over ranks (one decoded tensor plus the accumulator in memory),
  and the fold order is what makes the sum bit-exact against the JAX
  package's ``lax.scan`` fold;
- ``aggregate``/``agg_decode``: the compressed-domain sum of a ``[world,
  ...]`` payload stack, decoded once; ``agg_exact`` says whether it
  equals ``decode_sum`` bit for bit (sign's vote counts do not);
- ``agg_init``/``agg_fold``/``agg_finalize``: the streaming form of the
  same algebra, host numpy over the wire's payload bytes, which the sync
  serve loop folds one push at a time (``parallel.dcn.WireAggregator``)
  and decodes once a published version. The folds take the repo's
  native ``wc_fold_*`` kernels (``utils/native.py``) unless
  ``PS_NO_NATIVE`` is set; the two paths fold in the same order (push
  order, then element order) and agree bit for bit, as in the JAX
  package;
- ``init_state(shape, dtype, device)``: per-leaf codec state (error
  feedback's residual memory), made on the leaf's device;
- ``payload_bits(shape, dtype)``.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

Payload = Any

#: accepted values of the lossy codecs' ``nonfinite=`` constructor kwarg
NONFINITE_MODES = ("propagate", "zero", "raise")


def check_nonfinite_mode(mode: str) -> str:
    """Constructor-time validation of the ``nonfinite=`` kwarg."""
    if mode not in NONFINITE_MODES:
        raise ValueError(
            f"nonfinite must be one of {NONFINITE_MODES}, got {mode!r}"
        )
    return mode


def guard_nonfinite(flat: torch.Tensor, mode: str,
                    codec_name: str) -> torch.Tensor:
    """The non-finite input guard the lossy codecs share
    (``pytorch_ps_mpi_tpu/codecs/base.py:78-110``): ``"propagate"`` lets
    NaN/Inf through, ``"zero"`` replaces them with 0 before any statistic,
    ``"raise"`` raises ``FloatingPointError`` on any. PyTorch runs
    eagerly, so ``"raise"`` always checks (the JAX package degrades it to
    ``"zero"`` under tracing)."""
    if mode == "propagate":
        return flat
    check_nonfinite_mode(mode)
    finite = torch.isfinite(flat)
    if mode == "raise":
        bad = int((~finite).sum())
        if bad:
            raise FloatingPointError(
                f"{codec_name}.encode: {bad} non-finite gradient "
                "element(s) in input (nonfinite='raise')"
            )
        return flat
    return torch.where(finite, flat, torch.zeros_like(flat))


def numel(shape: Tuple[int, ...]) -> int:
    return math.prod(shape) if shape else 1


def _payload_leaves(payload: Payload):
    if isinstance(payload, dict):
        return list(payload.values())
    return [payload]


def _has_tensors(tree) -> bool:
    if torch.is_tensor(tree):
        return True
    if isinstance(tree, dict):
        return any(_has_tensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_tensors(v) for v in tree)
    return False


class Codec:
    """Base codec: subclasses override encode/decode (and optionally
    decode_sum, init_state, payload_bits)."""

    #: identity-like codecs: the step sums with one all_reduce instead of
    #: all_gather + decode + sum
    supports_psum: bool = False
    #: codecs that consume randomness (random-k, QSGD)
    needs_rng: bool = False
    #: shape-agnostic and stateless: flat-bucket aggregation
    #: (``MPI_PS(bucket_mb=...)``) encodes one bucket instead of many leaves
    bucketable: bool = False
    #: codecs whose aggregation is a collective protocol (PowerSGD): the
    #: step calls ``fused_allreduce(grad, state, comm_dtype)`` instead of
    #: encode, gather and decode-sum
    supports_fused_allreduce: bool = False
    #: codecs whose result depends on the order of a leaf's elements
    #: (blocks, strata, a matrix view, an index-ordered cap): the step
    #: encodes a leaf tagged ``codec_view`` in the JAX package's layout
    #: (``models.init.mark_flax_views``), so both packages select the
    #: same elements
    order_dependent: bool = False
    #: codecs with a compressed-domain aggregation algebra
    supports_aggregate: bool = False
    #: True when ``aggregate`` equals ``decode_sum`` bit for bit; False
    #: for approximations (sign's vote counts), which the training step
    #: never uses
    agg_exact: bool = True
    #: the ``pytorch_ps_mpi_tpu_torch.ops`` modules whose kernels encode
    #: and decode launch on a card (``CodecWire.load_kernels`` loads them
    #: before a wire switches to this codec)
    kernel_ops: Tuple[str, ...] = ()

    def init_state(self, shape: Tuple[int, ...], dtype,
                   device: Optional[torch.device] = None) -> Any:
        return ()

    def encode(self, grad: torch.Tensor, state: Any = (),
               rng: Optional[torch.Generator] = None) -> Tuple[Payload, Any]:
        raise NotImplementedError

    def decode(self, payload: Payload, shape: Tuple[int, ...],
               dtype) -> torch.Tensor:
        raise NotImplementedError

    def decode_sum(self, payloads: Payload, shape: Tuple[int, ...],
                   dtype) -> torch.Tensor:
        """Decode a ``[world, ...]``-stacked payload and sum over ranks:
        a left fold in rank order, as the JAX package's ``lax.scan``
        (``base.py:170-186``)."""
        first = _payload_leaves(payloads)[0]
        acc = torch.zeros(shape, dtype=dtype, device=first.device)
        for r in range(first.shape[0]):
            p = ({k: v[r] for k, v in payloads.items()}
                 if isinstance(payloads, dict) else payloads[r])
            acc.add_(self.decode(p, shape, dtype).to(dtype))
        return acc

    def can_aggregate(self, shape: Tuple[int, ...], dtype) -> bool:
        return self.supports_aggregate

    def aggregate(self, payloads: Payload, shape: Tuple[int, ...],
                  dtype) -> Tuple[Payload, Dict[str, Any]]:
        raise NotImplementedError(
            f"{type(self).__name__} has no compressed-domain aggregation "
            "in the port yet; use decode_sum"
        )

    def agg_decode(self, agg_payload: Payload, meta: Dict[str, Any],
                   shape: Tuple[int, ...], dtype) -> torch.Tensor:
        raise NotImplementedError

    # -- the streaming form (host numpy; the sync serve loop's fold) ------
    def agg_init(self, shape, dtype) -> Dict[str, Any]:
        """A fresh accumulator for one wire unit. The default keeps the
        payloads and runs :meth:`aggregate` at finalize (PowerSGD's
        factor concatenation); codecs with a smaller accumulator
        override the three methods."""
        return {"frames": 0, "payloads": []}

    def agg_fold(self, acc: Dict[str, Any], payload) -> None:
        """Fold one push's payload (numpy views of the receive buffer:
        what is kept is copied) into ``acc``."""
        acc["payloads"].append({k: np.copy(v) for k, v in payload.items()}
                               if isinstance(payload, dict)
                               else np.copy(payload))
        acc["frames"] += 1

    def agg_finalize(self, acc: Dict[str, Any], shape, dtype) -> np.ndarray:
        """The one decode of the accumulated state: the summed gradient
        as a numpy array of ``shape``."""
        ps = acc["payloads"]
        if isinstance(ps[0], dict):
            stacked = {k: torch.from_numpy(np.stack([p[k] for p in ps]))
                       for k in ps[0]}
        else:
            stacked = torch.from_numpy(np.stack(ps))
        tdtype = torch_dtype(dtype)
        agg, meta = self.aggregate(stacked, tuple(shape), tdtype)
        return self.agg_decode(agg, meta, tuple(shape), tdtype).numpy()

    def payload_bits(self, shape: Tuple[int, ...], dtype) -> int:
        """Encoded wire size in bits per gradient. The default encodes a
        tensor on the ``meta`` device, which has shapes and no data."""
        grad = torch.zeros(shape, dtype=dtype, device="meta")
        payload, _ = self.encode(grad, self.init_state(shape, dtype, "meta"))
        return sum(t.numel() * t.element_size() * 8
                   for t in _payload_leaves(payload))


    def fidelity_probe(self, grad: torch.Tensor, state: Any = (),
                       rng: Optional[torch.Generator] = None
                       ) -> Dict[str, float]:
        """Decode-after-encode fidelity of this codec on a real gradient
        (``base.py:249``): relative L2 reconstruction error, cosine
        similarity and achieved bits-per-parameter, with the gradient's
        norm. The encode and decode run on the gradient's device (on the
        card, the codec's kernels) and the four numbers come back in one
        copy. Read-only: codec state is consulted (error feedback probes
        through its residual memory) but never updated, so a probe is
        safe mid-training at any cadence.

        ``state`` defaults to a fresh ``init_state``; a stochastic codec
        draws from ``rng``, a generator seeded 0 on the gradient's device
        when omitted. Identity-like codecs report ~0 error and ~1
        cosine."""
        grad = torch.as_tensor(grad)
        shape = tuple(grad.shape)
        if not _has_tensors(state):
            state = self.init_state(shape, grad.dtype, grad.device)
        if rng is None and self.needs_rng:
            rng = torch.Generator(device=grad.device).manual_seed(0)
        with torch.no_grad():
            payload, _ = self.encode(grad, state, rng)
            rec = self.decode(payload, shape, grad.dtype)
            g = grad.to(torch.float32).reshape(-1)
            r = rec.to(torch.float32).reshape(-1)
            gn = torch.linalg.vector_norm(g)
            rel = torch.linalg.vector_norm(r - g) / torch.clamp(gn, min=1e-30)
            cos = torch.dot(r, g) / torch.clamp(
                torch.linalg.vector_norm(r) * gn, min=1e-30)
            v = torch.stack([rel, cos, gn]).cpu().tolist()
        n = math.prod(shape) if shape else 1
        return {"rel_error": v[0], "cosine": v[1],
                "bits_per_param": self.payload_bits(shape, grad.dtype) / n,
                "grad_norm": v[2]}

#: the wire's dtype names (numpy's, as the JAX package writes them) and
#: the numpy dtype a host buffer holds each in (bf16 as its bit pattern)
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}
_HOST_DTYPES = {"bfloat16": np.dtype(np.uint16)}


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return _DTYPE_NAMES[dtype] if isinstance(dtype, torch.dtype) \
        else str(np.dtype(dtype))


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype that holds ``dtype``'s bytes on the host."""
    name = dtype_name(dtype)
    # not .get(name, np.dtype(name)): numpy knows "bfloat16" only where
    # ml_dtypes (JAX) registered it, and the default is built eagerly
    return _HOST_DTYPES[name] if name in _HOST_DTYPES else np.dtype(name)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch dtype or a numpy dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return getattr(torch, name)


# -- the sparse index-merge family's streaming accumulator ------------------
# (top-k, block top-k, random-k, threshold; ``base.py:316-402`` of the
# JAX package). With the native folds the accumulator is the dense f32
# gradient and each fold is one C++ scatter-add over the payload; without
# them it is the concatenated (values, indices) list and finalize runs one
# ``np.add.at``. Both add in push order, then element order, so they agree
# bit for bit. The dense buffers are pooled across rounds: a round notes
# the indices its folds touched, and the next user of the buffer zeroes
# only those (O(world * k), flat in the model's size). A buffer is handed
# out again only once the pool holds two, so a finalize's returned view
# stays valid until a later round begins.

_SPARSE_POOL: Dict[int, Any] = {}
_SPARSE_POOL_LOCK = threading.Lock()
_SPARSE_POOL_MIN_READY = 2
_SPARSE_POOL_MAX = 4


def _sparse_pool_take(n: int):
    with _SPARSE_POOL_LOCK:
        q = _SPARSE_POOL.get(n)
        if not q or len(q) < _SPARSE_POOL_MIN_READY:
            return None
        return q.pop(0)


def _sparse_pool_give(n: int, buf: np.ndarray, touched) -> None:
    with _SPARSE_POOL_LOCK:
        q = _SPARSE_POOL.setdefault(n, [])
        if len(q) < _SPARSE_POOL_MAX:
            q.append((buf, list(touched)))


def sparse_agg_release(acc: Dict[str, Any]) -> None:
    """Return a native sparse accumulator's buffer to the pool
    (idempotent): at finalize, and when a round is dropped."""
    if acc.get("lib") is not None and "touched" in acc:
        buf = acc.pop("acc", None)
        if buf is not None:
            _sparse_pool_give(acc["n"], buf, acc.pop("touched"))


def sparse_agg_init(shape) -> Dict[str, Any]:
    from pytorch_ps_mpi_tpu_torch.utils import native

    lib = native.fold_lib()
    if lib is None:
        return {"frames": 0, "values": [], "indices": []}
    n = numel(tuple(shape))
    taken = _sparse_pool_take(n)
    if taken is None:
        buf = np.zeros(n, np.float32)
        ptr = native.f32(buf)
    else:
        buf, dirty = taken
        ptr = native.f32(buf)
        for idx in dirty:
            if idx.size:
                native.zero_sparse(lib, buf, idx, acc_ptr=ptr)
    return {"frames": 0, "acc": buf, "n": n, "lib": lib, "touched": [],
            "ptr": ptr}


def sparse_agg_fold(acc: Dict[str, Any], values, indices) -> None:
    lib = acc.get("lib")
    if lib is not None:
        from pytorch_ps_mpi_tpu_torch.utils import native

        # the index copy is both the C++ argument and the pool's record
        idx = np.array(indices, np.int32, copy=True).reshape(-1)
        native.fold_sparse(lib, acc["acc"],
                           np.ascontiguousarray(values, np.float32)
                           .reshape(-1), idx, acc_ptr=acc["ptr"])
        acc["touched"].append(idx)
    else:
        acc["values"].append(np.array(values, np.float32,
                                      copy=True).reshape(-1))
        acc["indices"].append(np.array(indices, copy=True).reshape(-1))
    acc["frames"] += 1


def sparse_agg_finalize(acc: Dict[str, Any], shape, dtype) -> np.ndarray:
    dtype = host_dtype(dtype)
    if acc.get("lib") is not None and "touched" in acc:
        out = acc["acc"].astype(dtype, copy=False).reshape(shape)
        sparse_agg_release(acc)
        return out
    n = numel(tuple(shape))
    idx = np.concatenate(acc["indices"]).astype(np.int64)
    val = np.concatenate(acc["values"])
    keep = (idx >= 0) & (idx < n)  # block top-k's pad-slot picks drop
    flat = np.zeros(n, np.float32)
    np.add.at(flat, idx[keep], val[keep])
    return flat.astype(dtype, copy=False).reshape(shape)


# -- the dense family (identity, bf16, f16) and the scale-folded integer
# family (int8, qsgd, terngrad): one running f32 accumulator a unit ---------

def dense_agg_init(shape, native_fold: bool = True) -> Dict[str, Any]:
    from pytorch_ps_mpi_tpu_torch.utils import native

    n = numel(tuple(shape))
    acc = {"frames": 0, "acc": np.zeros(n, np.float32), "n": n,
           "lib": native.fold_lib() if native_fold else None}
    if acc["lib"] is None:
        acc["tmp"] = np.empty(n, np.float32)
    return acc


def dense_agg_finalize(acc: Dict[str, Any], shape, dtype) -> np.ndarray:
    return acc["acc"].astype(host_dtype(dtype), copy=False).reshape(shape)


_REGISTRY: Dict[str, Type[Codec]] = {}


def register_codec(name: str) -> Callable[[Type[Codec]], Type[Codec]]:
    def deco(cls: Type[Codec]) -> Type[Codec]:
        _REGISTRY[name] = cls
        return cls
    return deco


def get_codec(name: str, **kwargs) -> Codec:
    """Instantiate a registered codec by name (``get_codec('sign')``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)

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
- ``aggregate``/``agg_decode``: the compressed-domain sum for codecs whose
  algebra is exact (identity, casts). The streaming host-side forms
  (``agg_init``/``agg_fold``/``agg_finalize``) belong to the async wire
  and come with it (ROADMAP queue 1 item 3);
- ``init_state(shape, dtype, device)``: per-leaf codec state (error
  feedback's residual memory), made on the leaf's device;
- ``payload_bits(shape, dtype)``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Type

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

    def _streaming(self, what: str) -> NotImplementedError:
        return NotImplementedError(
            f"{type(self).__name__}.{what} (the streaming host-side fold) is "
            "not ported yet: ROADMAP queue 1 item 3 (the async wire)")

    def agg_init(self, shape, dtype):
        raise self._streaming("agg_init")

    def agg_fold(self, acc, payload):
        raise self._streaming("agg_fold")

    def agg_finalize(self, acc, shape, dtype):
        raise self._streaming("agg_finalize")

    def payload_bits(self, shape: Tuple[int, ...], dtype) -> int:
        """Encoded wire size in bits per gradient. The default encodes a
        tensor on the ``meta`` device, which has shapes and no data."""
        grad = torch.zeros(shape, dtype=dtype, device="meta")
        payload, _ = self.encode(grad, self.init_state(shape, dtype, "meta"))
        return sum(t.numel() * t.element_size() * 8
                   for t in _payload_leaves(payload))


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

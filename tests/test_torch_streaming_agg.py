"""The codecs' compressed-domain aggregation in the port against the JAX
package: payloads made by the JAX codec (through the JAX ``CodecWire``)
are folded by both packages' ``WireAggregator`` (the streaming
``agg_init``/``agg_fold``/``agg_finalize``), at worlds 1, 3 and 4, with
the native folds and with ``PS_NO_NATIVE=1`` (the numpy folds); the sums
agree bit for bit. The batch ``aggregate``/``agg_decode`` agrees with
the JAX codec's on the same stacked payloads, and sign's approximate
vote count is exact when the frames' scales agree.

One exception, a semantic of the JAX package (ROADMAP queue 3 item 15):
its numpy mode folds a scale-folded unit of 65536 elements or more with
a jitted ``acc + q * scale`` (``codecs/quant.py:30``), which XLA
contracts into an FMA, and its batch ``aggregate`` of int8 and QSGD is
an XLA dot; its native fold rounds the product and the sum apart. The
port rounds them apart everywhere, so there it equals the JAX native
fold bit for bit and the XLA paths to rtol 1e-6 (with an atol of 1e-6
of the unit's largest magnitude, where the sum cancels)."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.parallel import dcn as jdcn
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import dcn as tdcn
from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

#: every registered name whose JAX codec aggregates, with its settings
#: (sign in the flat layout: its kernel layout has no host unpack)
AGG_CODECS = [
    ("identity", {}), ("bf16", {}), ("f16", {}),
    ("sign", {"use_pallas": False}), ("int8", {}), ("qsgd", {}),
    ("topk", {"fraction": 0.05}), ("ef", {"inner_name": "int8"}),
    ("terngrad", {}), ("terngrad", {"use_pallas": True}),
    ("randomk", {"fraction": 0.05}), ("blocktopk", {"fraction": 0.05}),
    ("blocktopk8", {"fraction": 0.05}), ("threshold", {}),
    ("powersgd", {"rank": 2}),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
       for n, kw in AGG_CODECS]
MAX_WORLD = 4


def _template():
    """Leaves of several sizes: one above the JAX fold's 65536-element
    jit crossover, one ragged, one small."""
    rng = np.random.RandomState(0)
    return {"params": {
        "Dense_0": {"kernel": rng.randn(8, 1024).astype(np.float32),
                    "bias": rng.randn(1024).astype(np.float32)},
        "Dense_1": {"kernel": rng.randn(300, 256).astype(np.float32),
                    "bias": rng.randn(300).astype(np.float32)},
        "Dense_2": {"kernel": rng.randn(37, 10).astype(np.float32)}}}


@functools.lru_cache(maxsize=None)
def _jax_frames_cached(name, kw_items, bucket_mb):
    tmpl = _template()
    frames = []
    for w in range(MAX_WORLD):
        wire = jdcn.CodecWire(jax_codec(name, **dict(kw_items)), tmpl,
                              seed=w, bucket_mb=bucket_mb)
        rng = np.random.RandomState(100 + w)
        grads = jax.tree.map(
            lambda x: (rng.randn(*x.shape) * 1e-2).astype(np.float32), tmpl)
        frames.append(np.array(wire.encode_to_bytes(grads)))
    return tmpl, tuple(frames)


def _jax_frames(name, kw, world, bucket_mb=0.0):
    """``world`` pushes' wire bytes, each worker's own JAX wire (its own
    seed, as the fleet's); made once a codec, the first ``world`` of
    them handed out."""
    tmpl, frames = _jax_frames_cached(name, tuple(sorted(kw.items())),
                                      bucket_mb)
    return tmpl, list(frames[:world])


#: JAX's numpy mode jit-folds scale-folded units from this size
#: (``pytorch_ps_mpi_tpu/codecs/base.py`` ``FOLD_JIT_MIN``)
FOLD_JIT_MIN = 1 << 16
SCALE_FOLDED = ("int8", "qsgd", "terngrad", "ef")


def _jax_fold(name, kw, tmpl, frames, native, monkeypatch):
    monkeypatch.setenv("PS_NO_NATIVE", "0" if native else "1")
    jwire = jdcn.CodecWire(jax_codec(name, **kw), tmpl)
    jagg = jwire.agg_begin()
    for f in frames:
        jagg.fold(f)
    return jwire, [np.asarray(x) for x in jax.tree.leaves(jagg.finalize())]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("world", [1, 3, 4])
@pytest.mark.parametrize("name,kw", AGG_CODECS, ids=IDS)
def test_streaming_fold_matches_jax_wire_aggregator(name, kw, world, native,
                                                    monkeypatch):
    tmpl, frames = _jax_frames(name, kw, world)
    jwire, want = _jax_fold(name, kw, tmpl, frames, native, monkeypatch)
    twire = tdcn.CodecWire(get_codec(name, **kw), tmpl, device="cpu")
    assert twire.agg_supported == jwire.agg_supported
    if not jwire.agg_supported:
        return
    tagg = twire.agg_begin()
    for f in frames:
        tagg.fold(f)
    got = tree_flatten(tagg.finalize())[0]
    assert tagg.frames == world
    jit_folded = not native and name in SCALE_FOLDED
    if jit_folded:
        _, native_want = _jax_fold(name, kw, tmpl, frames, True, monkeypatch)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if jit_folded and w.size >= FOLD_JIT_MIN:
            # one rounding of a product apart, where the sum may cancel
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()))
            w = native_want[i]
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,kw", [("int8", {}), ("identity", {}),
                                     ("terngrad", {})])
def test_bucketed_fold_matches_jax(name, kw):
    tmpl, frames = _jax_frames(name, kw, 3, bucket_mb=16.0)
    jwire = jdcn.CodecWire(jax_codec(name, **kw), tmpl, bucket_mb=16.0)
    twire = tdcn.CodecWire(get_codec(name, **kw), tmpl, bucket_mb=16.0,
                           device="cpu")
    assert twire.shapes == [tuple(s) for s in jwire.shapes]
    jagg, tagg = jwire.agg_begin(), twire.agg_begin()
    for f in frames:
        jagg.fold(f)
        tagg.fold(f)
    for g, w in zip(tree_flatten(tagg.finalize())[0],
                    jax.tree.leaves(jagg.finalize())):
        np.testing.assert_array_equal(g, np.asarray(w))


def _to_torch(p):
    if isinstance(p, dict):
        return {k: _to_torch(v) for k, v in p.items()}
    a = np.asarray(p)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16) \
            .view(torch.float32).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,kw", AGG_CODECS, ids=IDS)
def test_batch_aggregate_matches_jax(name, kw):
    """``aggregate`` + ``agg_decode`` over a ``[3, ...]`` stack of the JAX
    codec's payloads, unit by unit."""
    tmpl, frames = _jax_frames(name, kw, 3)
    jwire = jdcn.CodecWire(jax_codec(name, **kw), tmpl)
    jcode, tcode = jwire.code, get_codec(name, **kw)
    per_frame = [jwire.payloads_from_bytes(f) for f in frames]
    for u, (shape, dtype) in enumerate(zip(jwire.shapes, jwire.dtypes)):
        if not jcode.can_aggregate(shape, dtype):
            assert not tcode.can_aggregate(shape, torch.float32)
            continue
        stacked = jax.tree.map(lambda *xs: np.stack(xs),
                               *[p[u] for p in per_frame])
        jagg, jmeta = jcode.aggregate(stacked, shape, dtype)
        want = np.asarray(jcode.agg_decode(jagg, jmeta, shape, dtype))
        tagg, tmeta = tcode.aggregate(_to_torch(stacked), shape,
                                      torch.float32)
        got = tcode.agg_decode(tagg, tmeta, shape, torch.float32).numpy()
        if name in ("powersgd", "int8", "qsgd", "ef"):
            # XLA's dots (the factor product; int8's and QSGD's scale
            # contraction, with FMAs) against two roundings an element
            # (ROADMAP queue 3 item 15)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_sign_vote_count_is_exact_when_the_scales_agree(native, monkeypatch):
    monkeypatch.setenv("PS_NO_NATIVE", "0" if native else "1")
    code = get_codec("sign", use_pallas=False)
    n, world = 3000, 4
    rng = np.random.RandomState(3)
    payloads = []
    for w in range(world):
        p, _ = code.encode(torch.from_numpy(rng.randn(n).astype(np.float32)))
        p["scale"] = torch.tensor(0.75)  # every frame's scale the same
        payloads.append(p)
    acc = code.agg_init((n,), torch.float32)
    for p in payloads:
        code.agg_fold(acc, {k: v.numpy() for k, v in p.items()})
    stacked = {k: torch.stack([p[k] for p in payloads]) for k in payloads[0]}
    exact = code.decode_sum(stacked, (n,), torch.float32).numpy()
    np.testing.assert_array_equal(code.agg_finalize(acc, (n,),
                                                    torch.float32), exact)
    agg, meta = code.aggregate(stacked, (n,), torch.float32)
    np.testing.assert_array_equal(
        code.agg_decode(agg, meta, (n,), torch.float32).numpy(), exact)
    assert code.supports_aggregate and not code.agg_exact


def test_dropped_sparse_round_returns_its_pooled_buffer(monkeypatch):
    """A round folded and then dropped hands its dense buffer back to the
    pool (``dcn.py:389-401``), and a recycled buffer sums as a fresh one."""
    from pytorch_ps_mpi_tpu_torch.codecs import base

    monkeypatch.setenv("PS_NO_NATIVE", "0")
    tmpl, frames = _jax_frames("threshold", {}, 2)
    wire = tdcn.CodecWire(get_codec("threshold"), tmpl, device="cpu")
    n = int(np.prod(wire.shapes[0]))
    base._SPARSE_POOL.pop(n, None)
    for _ in range(3):
        agg = wire.agg_begin()
        agg.fold(frames[0])
        agg.release()  # the round was dropped
    assert len(base._SPARSE_POOL[n]) >= 2
    fresh = None
    for _ in range(2):
        agg = wire.agg_begin()  # takes recycled buffers
        for f in frames:
            agg.fold(f)
        out = [np.copy(x) for x in agg.finalize_leaves()]
        fresh = fresh or out
        for a, b in zip(out, fresh):
            np.testing.assert_array_equal(a, b)

"""The port's codecs against the JAX package's, on the same numpy inputs.

Sign payload bytes are bit-exact on both layouts (kernel layout for
sizes divisible by 1024, eight consecutive elements per byte otherwise);
the scale is a float sum taken in another order, so it agrees to rtol
1e-6, and decode_sum of the same payloads agrees to 1 ulp.

Int8 payloads equal the JAX encode as its jitted step runs it, byte for
byte; QSGD's codes are bit-exact for the same uniforms and its norm (a
float sum) agrees to rtol 1e-6; top-k payloads are bit-exact for every
selection (threshold refine, sort, "approx"). decode_sum and aggregate
are bit-exact at world 1 and for top-k at any world; the int8/QSGD sum
over 3 ranks agrees to 1e-6 of the largest element (XLA's einsum fuses
the multiply-adds). Error feedback's payloads and memory are bit-exact
over 3 steps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.codecs.base import check_nonfinite_mode

SIZES = [1000, 1024, 5120, 36864]


def _grads(n: int, world: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + n + world).randn(world, n).astype(
        np.float32)


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


@pytest.mark.parametrize("n", SIZES)
def test_sign_encode_matches_jax(n):
    g = _grads(n, 1)[0]
    p, _ = get_codec("sign").encode(torch.from_numpy(g))
    jp, _ = jax_codec("sign").encode(jnp.asarray(g))
    np.testing.assert_array_equal(p["packed"].numpy(), np.asarray(jp["packed"]))
    assert p["scale"].dtype == torch.float32
    np.testing.assert_allclose(float(p["scale"]), float(jp["scale"]),
                               rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_sign_decode_of_jax_payload_is_exact(n):
    jp, _ = jax_codec("sign").encode(jnp.asarray(_grads(n, 1)[0]))
    got = get_codec("sign").decode(
        {k: torch.from_numpy(v) for k, v in _np(jp).items()}, (n,),
        torch.float32)
    want = jax_codec("sign").decode(jp, (n,), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("world", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_sign_decode_sum_matches_jax(n, world):
    jc = jax_codec("sign")
    payloads = [_np(jc.encode(jnp.asarray(g))[0]) for g in _grads(n, world)]
    stacked = {k: np.stack([p[k] for p in payloads]) for k in payloads[0]}
    want = np.asarray(jc.decode_sum(
        {k: jnp.asarray(v) for k, v in stacked.items()}, (n,), jnp.float32))
    got = get_codec("sign").decode_sum(
        {k: torch.from_numpy(v) for k, v in stacked.items()}, (n,),
        torch.float32).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _topk_kwargs(variant: str) -> dict:
    return {"pallas": dict(fraction=0.01, pallas=True),
            "sort": dict(k=37), "approx": dict(fraction=0.02, approx=True),
            "ef": dict(fraction=0.01, pallas=True)}[variant]


@pytest.mark.parametrize("shape", [(1000,), (32, 32), (3, 3, 16, 8), ()])
def test_payload_bits_match_jax(shape):
    for name in ("sign", "identity", "bf16", "f16", "int8", "qsgd"):
        assert get_codec(name).payload_bits(shape, torch.float32) == \
            jax_codec(name).payload_bits(shape, jnp.float32), name
    for variant in ("pallas", "sort", "approx"):
        kw = _topk_kwargs(variant)
        assert get_codec("topk", **kw).payload_bits(shape, torch.float32) == \
            jax_codec("topk", **kw).payload_bits(shape, jnp.float32), variant
    ef = get_codec("ef", inner=get_codec("topk", fraction=0.01))
    jef = jax_codec("ef", inner=jax_codec("topk", fraction=0.01))
    assert ef.payload_bits(shape, torch.float32) == \
        jef.payload_bits(shape, jnp.float32)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_payload_equal(p, jp):
    assert set(p) == set(jp)
    for key in jp:
        want = np.asarray(jp[key]).reshape(-1)
        got = p[key].numpy().reshape(-1)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=key)


def _qsgd_pair(x: np.ndarray, seed: int):
    """The JAX QSGD payload for a key, and the port's for the uniforms
    that encode draws."""
    key = jax.random.key(seed)
    jp, _ = jax_codec("qsgd").encode(jnp.asarray(x), rng=key)
    u = np.array(jax.random.uniform(key, x.shape))
    p = get_codec("qsgd").quantize(torch.from_numpy(x), torch.from_numpy(u))
    return p, jp


@pytest.mark.parametrize("n", [1000, 1024, 36864])
def test_int8_and_qsgd_payloads_match_jax(n):
    x = _grads(n, 1)[0]
    x[3] = -0.0
    # the JAX encode as its jitted step runs it (test_torch_quant_ops.py)
    p, _ = get_codec("int8").encode(torch.from_numpy(x))
    jc = jax_codec("int8")
    jp = jax.jit(lambda g: jc.encode(g)[0])(jnp.asarray(x))
    _assert_payload_equal(p, jp)
    # QSGD's norm is a float sum taken in another order on each side (as
    # sign's scale is), so it agrees to rtol 1e-6; the codes are bit-exact
    p, jp = _qsgd_pair(x, n)
    np.testing.assert_array_equal(p["q"].numpy(), np.asarray(jp["q"]))
    assert p["norm"].dtype == torch.float32
    np.testing.assert_allclose(float(p["norm"]), float(jp["norm"]), rtol=1e-6)


def test_qsgd_encode_draws_from_the_generator():
    x = torch.from_numpy(_grads(4096, 1)[0])
    code = get_codec("qsgd", levels=4)
    a, _ = code.encode(x, rng=torch.Generator().manual_seed(7))
    b, _ = code.encode(x, rng=torch.Generator().manual_seed(7))
    c, _ = code.encode(x, rng=torch.Generator().manual_seed(8))
    assert torch.equal(a["q"], b["q"]) and not torch.equal(a["q"], c["q"])
    with pytest.raises(ValueError):
        code.encode(x)
    with pytest.raises(ValueError):
        get_codec("qsgd", levels=128)


@pytest.mark.parametrize("world", [1, 3])
@pytest.mark.parametrize("name", ["int8", "qsgd"])
def test_quant_decode_sum_and_aggregate_match_jax(name, world):
    n = 5000
    if name == "int8":
        jc = jax_codec("int8")
        payloads = [jc.encode(jnp.asarray(g))[0] for g in _grads(n, world)]
    else:
        jc = jax_codec("qsgd")
        payloads = [_qsgd_pair(g, s)[1] for s, g in enumerate(_grads(n, world))]
    stacked = {k: np.stack([np.asarray(p[k]) for p in payloads])
               for k in payloads[0]}
    code = get_codec(name)
    got = code.decode_sum(_torch_tree(stacked), (50, 100), torch.float32)
    want = np.asarray(jc.decode_sum({k: jnp.asarray(v)
                                     for k, v in stacked.items()},
                                    (50, 100), jnp.float32))
    if world == 1:
        # one product per element: bit-exact
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        # XLA's einsum fuses the ranks' multiply-adds, so an element can
        # differ by the rounding of one product: rtol 1e-6 of the largest
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    agg, meta = code.aggregate(_torch_tree(stacked), (50, 100), torch.float32)
    assert meta == {"frames": world}
    assert torch.equal(code.agg_decode(agg, meta, (50, 100), torch.float32),
                       got)
    one = {k: torch.from_numpy(np.array(v[0])) for k, v in stacked.items()}
    np.testing.assert_array_equal(
        code.decode(one, (50, 100), torch.float32).numpy(),
        np.asarray(jc.decode({k: jnp.asarray(v[0]) for k, v in stacked.items()},
                             (50, 100), jnp.float32)))


@pytest.mark.parametrize("variant", ["pallas", "sort", "approx"])
@pytest.mark.parametrize("n", [1000, 9216, 36864])
def test_topk_payloads_match_jax(n, variant):
    x = _grads(n, 1)[0]
    kw = _topk_kwargs(variant)
    p, _ = get_codec("topk", **kw).encode(torch.from_numpy(x))
    jp, _ = jax_codec("topk", **kw).encode(jnp.asarray(x))
    _assert_payload_equal(p, jp)


@pytest.mark.parametrize("world", [1, 3])
@pytest.mark.parametrize("n", [1000, 36864])
def test_topk_decode_sum_and_aggregate_match_jax(n, world):
    jc = jax_codec("topk", fraction=0.05, pallas=True)
    g = _grads(n, world)
    g[:, :64] = 10.0 + np.arange(64)  # indices every rank sends
    payloads = [jc.encode(jnp.asarray(x))[0] for x in g]
    stacked = {k: np.stack([np.asarray(p[k]) for p in payloads])
               for k in payloads[0]}
    code = get_codec("topk", fraction=0.05, pallas=True)
    got = code.decode_sum(_torch_tree(stacked), (n,), torch.float32).numpy()
    want = np.asarray(jc.decode_sum({k: jnp.asarray(v)
                                     for k, v in stacked.items()},
                                    (n,), jnp.float32))
    np.testing.assert_array_equal(got, want)
    agg, meta = code.aggregate(_torch_tree(stacked), (n,), torch.float32)
    jagg, jmeta = jc.aggregate({k: jnp.asarray(v) for k, v in stacked.items()},
                               (n,), jnp.float32)
    assert meta == jmeta
    _assert_payload_equal(agg, jagg)
    np.testing.assert_array_equal(
        code.decode({k: torch.from_numpy(v[0]) for k, v in stacked.items()},
                    (n,), torch.float32).numpy(),
        np.asarray(jc.decode(payloads[0], (n,), jnp.float32)))


def test_error_feedback_matches_jax_over_steps():
    n, shape = 36864, (192, 192)
    code = get_codec("ef", inner=get_codec("topk", fraction=0.01,
                                           pallas=True))
    jc = jax_codec("ef", inner=jax_codec("topk", fraction=0.01, pallas=True))
    state = code.init_state(shape, torch.float32, torch.device("cpu"))
    jstate = jc.init_state(shape, jnp.float32)
    assert state["memory"].device.type == "cpu" and state["inner"] == ()
    for step in range(3):
        g = _grads(n, 1, seed=step)[0].reshape(shape)
        p, state = code.encode(torch.from_numpy(g), state)
        jp, jstate = jc.encode(jnp.asarray(g), jstate)
        _assert_payload_equal(p, jp)
        np.testing.assert_array_equal(state["memory"].numpy(),
                                      np.asarray(jstate["memory"]))
    assert code.supports_aggregate and code.agg_exact and not code.needs_rng
    assert get_codec("ef", inner_name="qsgd").needs_rng


def test_sign_kernel_layout_has_no_host_aggregate():
    # the vote-count algebra (approximate) aggregates flat-layout units
    # only: the kernel layout has no host-side unpack (JAX sign.py:101-106)
    code = get_codec("sign")
    assert not code.can_aggregate((1024,), torch.float32)
    assert code.can_aggregate((1000,), torch.float32)
    assert code.supports_aggregate and not code.agg_exact
    assert get_codec("sign", use_pallas=False).can_aggregate((1024,),
                                                             torch.float32)


@pytest.mark.parametrize("mode", ["zero", "raise", "propagate"])
def test_sign_nonfinite_guard_matches_jax(mode):
    g = _grads(2048, 1)[0]
    g[7] = np.inf
    code, jc = get_codec("sign", nonfinite=mode), jax_codec("sign",
                                                            nonfinite=mode)
    if mode == "raise":
        with pytest.raises(FloatingPointError):
            code.encode(torch.from_numpy(g))
        return
    p, _ = code.encode(torch.from_numpy(g))
    jp, _ = jc.encode(jnp.asarray(g))
    np.testing.assert_array_equal(p["packed"].numpy(), np.asarray(jp["packed"]))
    np.testing.assert_allclose(float(p["scale"]), float(jp["scale"]),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        check_nonfinite_mode("clip")


@pytest.mark.parametrize("name", ["identity", "bf16", "f16"])
@pytest.mark.parametrize("world", [1, 3])
def test_dense_codecs_match_jax(name, world):
    g = _grads(777, world) * 1e3
    g[0, 0] = 1e6  # beyond f16's range: the f16 codec clips it
    code, jc = get_codec(name), jax_codec(name)
    payloads = [code.encode(torch.from_numpy(x))[0] for x in g]
    jpayloads = [jc.encode(jnp.asarray(x))[0] for x in g]
    for p, jp in zip(payloads, jpayloads):
        np.testing.assert_array_equal(p.to(torch.float32).numpy(),
                                      np.asarray(jp).astype(np.float32))
    got = code.decode_sum(torch.stack(payloads), (777,), torch.float32)
    want = jc.decode_sum(jnp.stack(jpayloads), (777,), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert code.supports_psum == jc.supports_psum
    agg, meta = code.aggregate(torch.stack(payloads), (777,), torch.float32)
    np.testing.assert_array_equal(
        code.agg_decode(agg, meta, (777,), torch.float32).numpy(), got.numpy())


def test_unknown_codec_raises():
    with pytest.raises(KeyError):
        get_codec("no-such-codec")


# -- TernGrad -------------------------------------------------------------------
#
# Payload bytes and scales are bit-exact against the JAX codec when both
# get the same random numbers: the port's ``ternarize`` is handed the
# JAX encode's own draws (``jax.random.bits``/``uniform`` from the key,
# from ``fold_in(key, i)`` for chunk i of a chunked leaf).

_TERN_CASES = {
    # name: (n, codec kwargs)
    "flat": (1000, dict(use_pallas=True)),
    "sublane": (36864, dict(use_pallas=True)),
    "flat_no_pallas": (36864, dict(use_pallas=False)),
    "chunked_sublane": (11264, dict(use_pallas=True, scan_block=2048)),
    "chunked_flat": (10001, dict(use_pallas=True, scan_block=2048,
                                 scan_threshold=8192)),
}


def _jax_noise(key, sublane: bool):
    """The port's ``noise(chunk, size)`` giving the JAX encode's draws."""
    def noise(chunk, size):
        k = key if chunk is None else jax.random.fold_in(key, chunk)
        if sublane:
            bits = np.array(jax.random.bits(k, (size,), jnp.uint32))
            return torch.from_numpy(bits.view(np.int32))
        return torch.from_numpy(np.array(jax.random.uniform(k, (size,))))
    return noise


def _tern_pair(x: np.ndarray, kw: dict, seed: int):
    code, jc = get_codec("terngrad", **kw), jax_codec("terngrad", **kw)
    key = jax.random.key(seed)
    jp, _ = jc.encode(jnp.asarray(x), rng=key)
    p = code.ternarize(torch.from_numpy(x),
                       _jax_noise(key, code._pallas_ok(x.size)))
    return p, jp, code, jc


@pytest.mark.parametrize("case", sorted(_TERN_CASES))
def test_terngrad_payload_matches_jax(case):
    n, kw = _TERN_CASES[case]
    x = _grads(n, 1)[0]
    x[3] = -0.0
    p, jp, code, _ = _tern_pair(x, kw, seed=n)
    _assert_payload_equal(p, jp)
    assert code._pallas_ok(n) == (case in ("sublane", "chunked_sublane"))
    assert (n >= code.scan_threshold) == case.startswith("chunked")


@pytest.mark.parametrize("case", ["plain", "nan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4096, 10240, 11264])
def test_terngrad_sublane_payload_matches_jax_in_the_gradient_dtype(
        n, dtype, case):
    # a whole leaf (one encode launch on the card) and chunked ones at
    # scan_block 2048, threshold 8192 (a scale launch, then a pack a chunk
    # into its slice; 11,264 has a tail of 1,024): the JAX codec casts to
    # float32 first, the port reads the gradient in its own type
    kw = dict(use_pallas=True, scan_block=2048, scan_threshold=8192)
    x = _grads(n, 1)[0]
    x[3] = -0.0
    if case == "nan":
        x[n - 7] = np.nan
    jx = jnp.asarray(x).astype(dtype)
    code, jc = get_codec("terngrad", **kw), jax_codec("terngrad", **kw)
    assert code._pallas_ok(n) and (n >= code.scan_threshold) == (n > 4096)
    key = jax.random.key(n)
    jp, _ = jc.encode(jx, rng=key)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    p = code.ternarize(tx, _jax_noise(key, True))
    _assert_payload_equal(p, jp)
    if case == "nan":
        assert bool(torch.isnan(p["scale"])) and (p["packed"] == 0x55).all()


@pytest.mark.parametrize("mode", ["propagate", "zero", "raise"])
@pytest.mark.parametrize("n", [1000, 36864])
def test_terngrad_nonfinite_modes_match_jax(n, mode):
    x = _grads(n, 1)[0]
    x[[5, 9]] = [np.inf, np.nan]
    kw = dict(use_pallas=True, nonfinite=mode)
    if mode == "raise":
        with pytest.raises(FloatingPointError):
            get_codec("terngrad", **kw).encode(
                torch.from_numpy(x), rng=torch.Generator().manual_seed(0))
        return
    p, jp, _, _ = _tern_pair(x, kw, seed=1)
    _assert_payload_equal(p, jp)


@pytest.mark.parametrize("shape", [(1000,), (32, 32), (3, 3, 16, 8), (),
                                   (4 * 1024 + 1,)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_terngrad_payload_bits_match_jax(shape, use_pallas):
    kw = dict(use_pallas=use_pallas, scan_block=1024)
    assert get_codec("terngrad", **kw).payload_bits(shape, torch.float32) == \
        jax_codec("terngrad", **kw).payload_bits(shape, jnp.float32)


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("case", ["flat", "sublane", "chunked_sublane"])
def test_terngrad_decode_and_aggregate_match_jax(case, world):
    n, kw = _TERN_CASES[case]
    pairs = [_tern_pair(g, kw, seed=s)
             for s, g in enumerate(_grads(n, world, seed=7))]
    code, jc = pairs[0][2], pairs[0][3]
    for p, jp, _, _ in pairs:
        _assert_payload_equal(p, jp)
    stacked = {k: torch.stack([p[k] for p, *_ in pairs]) for k in pairs[0][0]}
    jstacked = {k: jnp.stack([jp[k] for _, jp, *_ in pairs])
                for k in pairs[0][1]}
    agg, meta = code.aggregate(stacked, (n,), torch.float32)
    jagg, jmeta = jc.aggregate(jstacked, (n,), jnp.float32)
    assert meta == jmeta == {"frames": world}
    got = code.agg_decode(agg, meta, (n,), torch.float32).numpy()
    want = np.asarray(jc.agg_decode(jagg, jmeta, (n,), jnp.float32))
    if world == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        code.decode_sum(stacked, (n,), torch.float32).numpy(), got)
    np.testing.assert_array_equal(
        code.decode(pairs[0][0], (n,), torch.float32).numpy(),
        np.asarray(jc.decode(pairs[0][1], (n,), jnp.float32)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_terngrad_decode_is_unbiased(use_pallas):
    # E[decode] = g: each element's draw has variance s|g| - g² <= s²/4,
    # so the mean of N draws is within 5·s/(2√N) of g (a 5-sigma bound)
    n, draws = 1024, 1000
    g = torch.from_numpy(_grads(n, 1)[0])
    code = get_codec("terngrad", use_pallas=use_pallas)
    gen = torch.Generator().manual_seed(0)
    total = torch.zeros(n)
    for _ in range(draws):
        p, _ = code.encode(g, rng=gen)
        total += code.decode(p, (n,), torch.float32)
    s = float(g.abs().max())
    assert float((total / draws - g).abs().max()) < 5 * s / (2 * draws ** 0.5)


def test_terngrad_encode_draws_from_the_generator_and_streams_wait():
    x = torch.from_numpy(_grads(4096, 1)[0])
    code = get_codec("terngrad", use_pallas=True)
    a, _ = code.encode(x, rng=torch.Generator().manual_seed(7))
    b, _ = code.encode(x, rng=torch.Generator().manual_seed(7))
    c, _ = code.encode(x, rng=torch.Generator().manual_seed(8))
    assert torch.equal(a["packed"], b["packed"])
    assert not torch.equal(a["packed"], c["packed"])
    assert code.needs_rng and code.bucketable and code.supports_aggregate
    with pytest.raises(ValueError):
        code.encode(x)
    with pytest.raises(ValueError):
        get_codec("terngrad", scan_block=1022)
    with pytest.raises(ValueError):
        get_codec("terngrad", nonfinite="clip")
    # the streaming fold (host numpy) sums what decode gives
    acc = code.agg_init((4096,), torch.float32)
    for p in (a, c):
        code.agg_fold(acc, {k: v.numpy() for k, v in p.items()})
    want = (code.decode(a, (4096,), torch.float32)
            + code.decode(c, (4096,), torch.float32))
    np.testing.assert_array_equal(
        code.agg_finalize(acc, (4096,), torch.float32), want.numpy())

"""The port's sign kernels' plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU). The CUDA kernels are held to
these plain versions in ``test_torch_cuda_kernels.py``.

Packed bytes and unpacked floats are bit-exact; the |x| sum agrees to
rtol 1e-6, since the two sides add in another order. The unpack-sum
and the codec's decode_sum are bit-exact against the JAX codec's
``decode_sum`` (Pallas ``unpack_signs`` in interpret mode, then the
``lax.scan`` fold), NaN compared by position: with zero, subnormal,
infinite and NaN scales, and with sums that fall below the smallest
normal float, which the JAX side flushes to a zero of their sign.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_ps_mpi_tpu.codecs.sign import SignCodec as JaxSignCodec
from pytorch_ps_mpi_tpu.ops import sign_pallas
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.ops import sign as S


def _grad(n: int, planted: bool, seed: int = 0) -> np.ndarray:
    x = np.random.RandomState(seed + n).randn(n).astype(np.float32)
    if planted:
        x[0], x[1], x[128], x[n - 1] = -0.0, np.nan, 0.0, np.nan
    return x


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("n", [1024, 4096, 9216, 13 * 1024, 300 * 1024])
def test_encode_and_pack_match_pallas(n, planted):
    x = _grad(n, planted)
    packed, total = S.encode_signs_ref(torch.from_numpy(x))
    jpacked, jtotal = sign_pallas.encode_signs(jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(S.pack_signs_ref(torch.from_numpy(x))
                                  .numpy(),
                                  np.asarray(sign_pallas.pack_signs(
                                      jnp.asarray(x))))
    if planted:
        assert np.isnan(float(total)) and np.isnan(float(jtotal))
        assert packed[0] & 1 == 1          # -0.0 packs as +
        assert packed[1] & 1 == 0          # NaN packs as 0
        assert (packed[0] >> 1) & 1 == 1   # +0.0 (element 128) packs as +
    else:
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)


# The encode kernel's edges (``csrc/sign.cu``), in packed rows of 1024:
# one block sums up to ONE_BLOCK_ROWS rows, a cooperative grid above that,
# looping past its co-resident blocks' first pass (GRID_ROWS on the
# H100). The card tests hold the kernel to the plain version there.
ONE_BLOCK_ROWS = 8
GRID_ROWS = 1056 * 8
EDGE_ROWS = [ONE_BLOCK_ROWS - 1, ONE_BLOCK_ROWS, ONE_BLOCK_ROWS + 1, 2304,
             GRID_ROWS + 3]


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_encode_matches_pallas_at_the_kernels_edges(rows, planted):
    x = _grad(rows * 1024, planted)
    packed, total = S.encode_signs_ref(torch.from_numpy(x))
    jpacked, jtotal = sign_pallas.encode_signs(jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    if planted:
        assert np.isnan(float(total)) and np.isnan(float(jtotal))
    else:
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)


@pytest.mark.parametrize("m", [128, 1152, 128 * 13])
def test_unpack_matches_pallas(m):
    p = np.random.RandomState(m).randint(0, 256, size=m).astype(np.uint8)
    out = S.unpack_signs_ref(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(out, np.asarray(
        sign_pallas.unpack_signs(jnp.asarray(p))))
    roundtrip = S.pack_signs_ref(torch.from_numpy(out))
    np.testing.assert_array_equal(roundtrip.numpy(), p)


def _launches():
    return (S.encode_signs.launches, S.pack_signs.launches,
            S.unpack_signs.launches, S.unpack_signs_sum.launches)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    x = torch.from_numpy(_grad(2048, False))
    before = _launches()
    packed, total = S.encode_signs(x)
    torch.testing.assert_close(total, x.abs().sum(), rtol=0, atol=0)
    assert torch.equal(S.pack_signs(x), packed)
    assert torch.equal(S.unpack_signs(packed), torch.where(x >= 0, 1.0, -1.0))
    scales = torch.tensor([0.5, 2.0])
    stacked = torch.stack([packed, packed.flip(0)])
    assert torch.equal(S.unpack_signs_sum(stacked, scales),
                       S.unpack_signs_sum_ref(stacked, scales))
    assert _launches() == before


@pytest.mark.parametrize("bad", [
    torch.zeros(1000), torch.zeros(1024, dtype=torch.float64),
    torch.zeros(2, 1024), torch.zeros(0)])
def test_encode_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        S.encode_signs(bad)


def test_unpack_rejects_ragged_rows():
    with pytest.raises(ValueError):
        S.unpack_signs(torch.zeros(100, dtype=torch.uint8))


# -- the unpack-sum and the codec's decode_sum ----------------------------------

TINY = float(np.finfo(np.float32).tiny)
SCALE_CASES = ["plain", "zero", "subnormal", "inf", "nan", "underflow"]


def _unpack_sum_inputs(world: int, m: int, case: str):
    """Packed bits and float32 scales for ``world`` ranks from a seed; one
    rank's scale planted (0.0: every -0 product must fold to +0; a
    subnormal; +Inf; NaN), or every scale within [1, 2) x the smallest
    normal float, so that partial sums fall below it."""
    rs = np.random.RandomState(1000 * world + m)
    packed = rs.randint(0, 256, size=(world, m)).astype(np.uint8)
    scales = rs.uniform(0.1, 2.0, size=world).astype(np.float32)
    planted = {"zero": 0.0, "subnormal": 3e-39, "inf": np.inf,
               "nan": np.nan}
    if case in planted:
        scales[world // 2] = planted[case]
    elif case == "underflow":  # distinct, so that +s_0 - s_1 is subnormal
        scales = (TINY * (1 + rs.permutation(world + 1)[:world] / 16)
                  ).astype(np.float32)
    return packed, scales


def _jax_decode_sum(packed, scales, shape, dtype=jnp.float32):
    return np.asarray(JaxSignCodec(use_pallas=True).decode_sum(
        {"packed": jnp.asarray(packed), "scale": jnp.asarray(scales)},
        shape, dtype))


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """NaN at the same places, every other element bit for bit."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


@pytest.mark.parametrize("case", SCALE_CASES)
@pytest.mark.parametrize("m", [128, 384, 4608])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_unpack_sum_matches_the_jax_fold_bit_for_bit(world, m, case):
    packed, scales = _unpack_sum_inputs(world, m, case)
    got = S.unpack_signs_sum_ref(torch.from_numpy(packed),
                                 torch.from_numpy(scales)).numpy()
    want = _jax_decode_sum(packed, scales, (8 * m,))
    _same_bits(got, want)
    if case == "zero" and world == 1:  # +0 + (-0): no -0 survives
        assert not np.signbit(got).any()
    if case == "underflow" and world > 1:  # some partial sums were flushed
        signs = np.where(np.unpackbits(packed.reshape(world, -1, 1, 128),
                                       axis=2, bitorder="little"), 1.0, -1.0)
        exact = (signs * scales.astype(np.float64)[:, None, None, None]
                 ).sum(axis=0).reshape(-1)
        assert (got != exact).any()


def _codec_payloads(world: int, shape) -> dict:
    """The JAX codec's payloads of ``world`` gradients, stacked."""
    jc = JaxSignCodec(use_pallas=True)
    g = np.random.RandomState(world).randn(world, *shape).astype(np.float32)
    payloads = [jc.encode(jnp.asarray(x))[0] for x in g]
    return {k: np.stack([np.asarray(p[k]) for p in payloads])
            for k in ("packed", "scale")}


@pytest.mark.parametrize("shape", [(4, 1024), (1000,)])
@pytest.mark.parametrize("world", [1, 4])
def test_codec_decode_sum_matches_jax_on_both_layouts(shape, world):
    # (4, 1024): the kernel layout, one unpack-sum, where a subnormal scale
    # decodes to zeros as in the JAX fold; (1000,): eight consecutive
    # elements a byte, the base class's fold. Both fold a zero scale's -0
    # to +0.
    stacked = _codec_payloads(world, shape)
    planted = [3e-39] if world == 1 else [0.0, 3e-39]
    if shape == (1000,):
        planted = [0.0]
    stacked["scale"][:len(planted)] = planted
    want = _jax_decode_sum(stacked["packed"], stacked["scale"], shape)
    got = get_codec("sign").decode_sum(
        {k: torch.from_numpy(v) for k, v in stacked.items()}, shape,
        torch.float32)
    assert got.shape == shape
    _same_bits(got.numpy(), want)


def test_flat_layout_fold_keeps_the_subnormals_jax_flushes():
    # the documented difference of ROADMAP queue 3 item 8: the base
    # class's fold in PyTorch keeps a subnormal scale's values, where the
    # JAX fold (XLA's CPU runtime, denormals off) adds zeros
    stacked = _codec_payloads(1, (1000,))
    stacked["scale"][0] = 3e-39
    want = _jax_decode_sum(stacked["packed"], stacked["scale"], (1000,))
    got = get_codec("sign").decode_sum(
        {k: torch.from_numpy(v) for k, v in stacked.items()}, (1000,),
        torch.float32).numpy()
    assert not want.any()
    np.testing.assert_array_equal(np.abs(got), np.float32(3e-39))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_kernel_leaf_keeps_the_fold(monkeypatch, dtype):
    world, m = 3, 384
    packed, scales = _unpack_sum_inputs(world, m, "plain")
    worlds = []

    def spy(p, s):
        worlds.append(p.shape[0])
        return S.unpack_signs_sum_ref(p, s)

    monkeypatch.setattr(S, "unpack_signs_sum", spy)
    got = get_codec("sign").decode_sum(
        {"packed": torch.from_numpy(packed), "scale": torch.from_numpy(scales)},
        (8 * m,), dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _jax_decode_sum(packed, scales, (8 * m,), jdtype)
    assert got.dtype == dtype
    # float32: one unpack-sum of every rank; bf16: one a rank, each cast
    # to bf16 before the fold adds it, as the JAX fold does
    assert worlds == ([world] if dtype == torch.float32 else [1] * world)
    assert torch.equal(got.to(torch.float32),
                       torch.tensor(np.asarray(want, np.float32)))


@pytest.mark.parametrize("packed,scales", [
    (torch.zeros(2, 100, dtype=torch.uint8), torch.ones(2)),
    (torch.zeros(2, 128, dtype=torch.uint8), torch.ones(3)),
    (torch.zeros(2, 128, dtype=torch.uint8), torch.ones(1)),
    (torch.zeros(2, 128, dtype=torch.int8), torch.ones(2)),
    (torch.zeros(2, 128, dtype=torch.uint8), torch.ones(2, dtype=torch.float64)),
    (torch.zeros(256, dtype=torch.uint8), torch.ones(1)),
    (torch.zeros(0, 128, dtype=torch.uint8), torch.ones(0)),
], ids=["ragged-m", "scales-past-world", "scales-short-of-world",
        "int8-bits", "float64-scales", "1-d-bits", "no-rank"])
def test_unpack_sum_rejects_what_the_kernel_does_not_take(packed, scales):
    with pytest.raises(ValueError):
        S.unpack_signs_sum(packed, scales)

"""The port's int8 quantize / dequantize plain versions against the JAX
package's ``quantize_int8`` and ``dequantize_int8`` (Pallas interpret mode
on the CPU for sizes divisible by 1024, its jnp path otherwise) and its
int8 codec's default jnp encode as its jitted step runs it. Codes, scales
and dequantized floats are bit-exact.

Jitted, XLA computes the scale ``max|x| / 127.0`` as ``max|x| *
f32(1/127)``; the port computes that product. Run op by op, the JAX codec
divides, and its scale then differs from the port's by at most one ulp
(``test_eager_jax_scale_divides``). The CUDA kernels are held to these
plain versions in ``test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.ops import quant_pallas
from pytorch_ps_mpi_tpu_torch.ops import quant as Q

SIZES = [1024, 13 * 1024, 1000, 300 * 1024]


def _grad(n: int, case: str, seed: int = 0) -> np.ndarray:
    x = np.random.RandomState(seed + n).randn(n).astype(np.float32)
    if case == "ties":
        # absmax 127 makes the scale 1.0, so x / s lands on exact .5 ties
        x[0] = 127.0
        x[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    elif case == "signed_zero":
        x[0], x[1] = -0.0, 0.0
    elif case == "nan":
        x[0], x[n // 2] = -0.0, np.nan
    elif case == "inf":
        x[0], x[n - 1] = np.inf, -2.5
    elif case == "neg_inf":
        x[n // 3] = -np.inf
    elif case == "zeros":
        x[:] = 0.0
    return x


def _jit_encode_fn():
    code = jax_codec("int8")
    return jax.jit(lambda x: code.encode(x)[0])


_jit_encode = _jit_encode_fn()

CASES = ["plain", "ties", "signed_zero", "nan", "inf", "neg_inf", "zeros"]


def _same_floats(a: np.ndarray, b: np.ndarray) -> None:
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_quantize_matches_jax(n, case):
    x = _grad(n, case)
    q, s = Q.quantize_int8(torch.from_numpy(x))
    jq, js = quant_pallas.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _same_floats(np.asarray(s.numpy()), np.asarray(js, np.float32))
    # the JAX codec's default (jnp) encode, jitted, gives the same bytes
    p = _jit_encode(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(p["q"]))
    _same_floats(np.asarray(s.numpy()), np.asarray(p["scale"], np.float32))
    if case == "ties":
        assert float(s) == 1.0
        np.testing.assert_array_equal(q.numpy()[1:9],
                                      [0, 2, 2, 0, -2, -2, 126, -126])
    if case in ("nan", "inf"):
        # a NaN or Inf scale: the codes hold what XLA's conversion gives
        assert not np.isfinite(float(s))
        assert not q.numpy().any()


# The quantize kernel's edges (``csrc/quant.cu``): one block up to its tile
# of TILE floats, a cooperative grid above it, and past the grid's
# co-resident tiles (GRID_TILES on the H100) a second read. The card tests
# hold the kernel to the plain version at the same sizes.
TILE = 4096
GRID_TILES = 660
EDGE_SIZES = [TILE - 1, TILE, TILE + 1, 100_003, GRID_TILES * TILE + 4099]


@pytest.mark.parametrize("case", ["plain", "ties", "nan", "inf", "zeros"])
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_quantize_matches_jax_at_the_kernels_edges(n, case):
    x = _grad(n, case)
    q, s = Q.quantize_int8(torch.from_numpy(x))
    jq, js = quant_pallas.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _same_floats(np.asarray(s.numpy()), np.asarray(js, np.float32))
    p = _jit_encode(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(p["q"]))
    _same_floats(np.asarray(s.numpy()), np.asarray(p["scale"], np.float32))


def test_scale_matches_jax_over_magnitudes():
    # 400 gradients whose max|x| spans 1e-14..1e8: the scale and the
    # codes equal the jitted JAX encode's, the floor 1e-12 included
    rng = np.random.RandomState(0)
    for _ in range(400):
        x = (rng.randn(1000) * 10.0 ** rng.uniform(-14, 8)).astype(np.float32)
        q, s = Q.quantize_int8(torch.from_numpy(x))
        p = _jit_encode(jnp.asarray(x))
        _same_floats(np.asarray(s.numpy()), np.asarray(p["scale"]))
        np.testing.assert_array_equal(q.numpy(), np.asarray(p["q"]))


def test_eager_jax_scale_divides():
    # op by op the JAX codec divides by 127: its scale is within one ulp
    # of the port's product with the reciprocal, and equal to a division
    rng = np.random.RandomState(1)
    for _ in range(200):
        x = (rng.randn(1000) * 10.0 ** rng.uniform(-6, 6)).astype(np.float32)
        _, s = Q.quantize_int8(torch.from_numpy(x))
        p, _ = jax_codec("int8").encode(jnp.asarray(x))
        eager = np.asarray(p["scale"])
        assert eager == np.abs(x).max() / np.float32(127)
        np.testing.assert_array_max_ulp(np.asarray(s.numpy()), eager, 1)


@pytest.mark.parametrize("case", ["plain", "nan", "inf"])
@pytest.mark.parametrize("n", SIZES)
def test_dequantize_matches_jax(n, case):
    q = np.random.RandomState(n).randint(-127, 128, size=n).astype(np.int8)
    s = {"plain": np.float32(0.0123), "nan": np.float32(np.nan),
         "inf": np.float32(np.inf)}[case]
    got = Q.dequantize_int8(torch.from_numpy(q), torch.tensor(s)).numpy()
    want = np.asarray(quant_pallas.dequantize_int8(jnp.asarray(q),
                                                   jnp.asarray(s)))
    _same_floats(got, want)


@pytest.mark.parametrize("world", [1, 3, 8])
def test_dequant_sum_is_the_rank_ordered_fold(world):
    n = 4099
    rng = np.random.RandomState(world)
    q = rng.randint(-127, 128, size=(world, n)).astype(np.int8)
    s = rng.rand(world).astype(np.float32)
    got = Q.dequant_sum(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    want = np.zeros(n, np.float32)
    for w in range(world):
        want = want + q[w].astype(np.float32) * s[w]
    _same_floats(got, want)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    x = torch.from_numpy(_grad(2048, "plain"))
    before = (Q.quantize_int8.launches, Q.dequant_sum.launches)
    q, s = Q.quantize_int8(x)
    Q.dequant_sum(q.reshape(1, -1), s.reshape(1))
    assert (Q.quantize_int8.launches, Q.dequant_sum.launches) == before


@pytest.mark.parametrize("bad", [
    torch.zeros(0), torch.zeros(16, dtype=torch.float64), torch.zeros(2, 8)])
def test_quantize_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        Q.quantize_int8(bad)


def test_dequant_sum_rejects_mismatched_scales():
    with pytest.raises(ValueError):
        Q.dequant_sum(torch.zeros((2, 8), dtype=torch.int8), torch.ones(3))

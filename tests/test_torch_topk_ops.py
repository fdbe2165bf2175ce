"""The port's exact top-k (plain versions) against the JAX package's
``exact_topk`` (Pallas count kernel in interpret mode on the CPU) and,
below the kernel's size, against ``lax.top_k``. Values and index arrays
are bit-exact, ties included. The plain radix threshold, the CUDA
kernel's algorithm, is held to the JAX package's ``_kth_threshold``; the
CUDA kernels are held to the plain versions in
``test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu.ops import topk_pallas
from pytorch_ps_mpi_tpu_torch.ops import topk as T


def _check_equal(flat: np.ndarray, got, want) -> None:
    v, i = got
    jv, ji = want
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


# the JAX package's own cases (tests/test_pallas_codecs.py:30-36)
@pytest.mark.parametrize("n,k", [
    (16_384, 64), (100_000, 1024), (8_192 + 7, 100), (40_000, 1),
    (9_000, 3000)])
def test_exact_topk_matches_jax(n, k):
    x = np.random.RandomState(n % 97).randn(n).astype(np.float32)
    _check_equal(x, T.exact_topk(torch.from_numpy(x), k),
                 topk_pallas.exact_topk(jnp.asarray(x), k, chunk=2048))


def test_exact_topk_heavy_ties_match_jax():
    # tests/test_pallas_codecs.py:52-63: strict survivors first, then
    # exactly enough ties, in index order; -0.5 ties with 0.5
    x = np.full(20_000, 0.5, np.float32)
    x[::7] = 2.0
    x[3::11] = -0.5
    x[10] = -0.0
    k = 4000
    got = T.exact_topk(torch.from_numpy(x), k)
    _check_equal(x, got, topk_pallas.exact_topk(jnp.asarray(x), k))
    idx = got[1].numpy()
    assert (np.abs(x[idx]) == 2.0).sum() == (x == 2.0).sum()


def test_exact_topk_nan_inf_and_signed_zero_match_jax():
    n, k = 12_288, 40
    x = np.random.RandomState(5).randn(n).astype(np.float32)
    x[[7, 300]] = np.nan
    x[[11, 900]] = [np.inf, -np.inf]
    x[:4] = [-0.0, 0.0, -0.0, 0.0]
    got = T.exact_topk(torch.from_numpy(x), k)
    _check_equal(x, got, topk_pallas.exact_topk(jnp.asarray(x), k))
    assert {7, 11, 300, 900} <= set(got[1].tolist())  # NaN and ±Inf


def _padded_keys(x: np.ndarray):
    """The JAX package's key plane: |x|'s bits, padded with -1 to whole
    count tiles of 1024 x 128."""
    keys = jax.lax.bitcast_convert_type(jnp.abs(jnp.asarray(x)), jnp.int32)
    return jnp.concatenate([keys, jnp.full((-len(x) % (1024 * 128),), -1,
                                           jnp.int32)]).reshape(-1, 128)


def test_count_passes_match_the_pallas_count_kernel():
    n, k = 100_000, 1000
    x = np.random.RandomState(1).randn(n).astype(np.float32)
    flat = torch.from_numpy(x)
    t, counts = T.kth_threshold(flat, k)
    keys = _padded_keys(x)
    jt = 0
    for b in range(T.PASSES):
        cand = jt | (1 << (30 - b))
        ge, gt = topk_pallas._counts(keys, jnp.int32(cand))
        assert counts[b].tolist() == [int(ge), int(gt)], b
        jt = cand if int(ge) >= k else jt
    assert int(t) == jt == int(topk_pallas._kth_threshold(keys, k))


def _radix_case(case: str):
    """(x, k) of the planted cases ``chip_smoke.py`` runs on the card."""
    rng = np.random.RandomState(len(case))
    n = 20_000
    x = rng.randn(n).astype(np.float32)
    k = 200
    if case == "heavy_ties":
        x = (0.25 * rng.randint(0, 4, n)).astype(np.float32)
        x[::5] *= -1
        k = 4000
    elif case == "nan_inf_signed_zero":
        x[[3, 70, 900, 901, 5, 6]] = [np.nan, np.inf, -np.inf, np.nan, -0.0,
                                      0.0]
    elif case == "all_ties":
        x[:] = -1.5
    elif case == "all_zeros":
        x[:] = 0.0
    elif case == "k_is_1":
        k = 1
    elif case == "k_is_n_minus_1":
        k = n - 1
    elif case == "more_nans_than_k":
        # several NaN bit patterns (quiet, signalling, negative, payloads)
        nans = np.array([0x7FC00000, 0x7F800001, 0xFFC00000, 0x7FFFFFFF,
                         0x7FA00000], np.uint32).view(np.float32)
        x[::40] = np.resize(nans, x[::40].shape)
        x[7] = np.inf
    return x, k


RADIX_CASES = ["random", "heavy_ties", "nan_inf_signed_zero", "all_ties",
               "all_zeros", "k_is_1", "k_is_n_minus_1", "more_nans_than_k"]


@pytest.mark.parametrize("case", RADIX_CASES)
def test_radix_threshold_matches_the_pallas_threshold(case):
    x, k = _radix_case(case)
    flat = torch.from_numpy(x)
    t, hist = T.radix_threshold_ref(flat, k)
    assert hist.shape == (4, 256) and hist.dtype == torch.int32
    assert int(t) == int(topk_pallas._kth_threshold(_padded_keys(x), k))
    assert int(t) == int(T.kth_threshold(flat, k)[0])
    # row p counts exactly the keys that carry t's digits above digit p
    keys = T.magnitude_keys(flat)
    for p, (shift, top) in enumerate(T.DIGITS):
        carry = int(((keys >> top) == (int(t) >> top)).sum())
        assert int(hist[p].sum()) == carry, p
        assert int(hist[p, (int(t) >> shift) & 0xFF]) > 0, p
    assert not hist[0, 128:].any()  # the first digit has 7 bits


@pytest.mark.parametrize("n,k", [(1000, 10), (8191, 300), (500, 500)])
def test_fallback_matches_lax_top_k_with_ties_and_nan(n, k):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    x[::9] = 1.25
    x[1::9] = -1.25
    x[[3, 50]] = np.nan
    x[4] = -np.inf
    x[5:8] = [-0.0, 0.0, -0.0]
    flat = torch.from_numpy(x)
    jv, ji = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    for got in (T.exact_topk(flat, k), T.sorted_topk(flat, k)):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(np.abs(got[0].numpy()).view(np.int32),
                                      np.asarray(jv).view(np.int32))
    _check_equal(x, T.exact_topk(flat, k),
                 topk_pallas.exact_topk(jnp.asarray(x), k))


def test_wrapper_takes_the_plain_count_on_cpu_without_counting():
    x = torch.from_numpy(np.random.RandomState(0).randn(10_000)
                         .astype(np.float32))
    before = (T.exact_topk.launches, T.radix_threshold.launches)
    got = T.exact_topk(x, 50)
    want = T.exact_topk_ref(x, 50)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    t, hist = T.radix_threshold(x, 50)
    rt, rhist = T.radix_threshold_ref(x, 50)
    assert torch.equal(t, rt) and torch.equal(hist, rhist)
    assert (T.exact_topk.launches, T.radix_threshold.launches) == before


def test_count_pass_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        T.radix_threshold(torch.zeros(10, dtype=torch.float64), 1)
    with pytest.raises(ValueError):
        T.radix_threshold(torch.zeros(10), 0)
    with pytest.raises(ValueError):
        T.radix_threshold(torch.zeros(10), 11)
    with pytest.raises(ValueError):
        T.radix_threshold(torch.zeros(2, 5), 1)
    with pytest.raises(ValueError):
        T.exact_topk(torch.zeros(10), 11)

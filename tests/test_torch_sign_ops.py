"""The port's sign kernels' plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU). The CUDA kernels are held to
these plain versions in ``test_torch_cuda_kernels.py``.

Packed bytes and unpacked floats are bit-exact; the |x| sum agrees to
rtol 1e-6, since the two sides add in another order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_ps_mpi_tpu.ops import sign_pallas
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


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    x = torch.from_numpy(_grad(2048, False))
    before = (S.encode_signs.launches, S.pack_signs.launches,
              S.unpack_signs.launches)
    packed, total = S.encode_signs(x)
    torch.testing.assert_close(total, x.abs().sum(), rtol=0, atol=0)
    assert torch.equal(S.pack_signs(x), packed)
    assert torch.equal(S.unpack_signs(packed), torch.where(x >= 0, 1.0, -1.0))
    assert (S.encode_signs.launches, S.pack_signs.launches,
            S.unpack_signs.launches) == before


@pytest.mark.parametrize("bad", [
    torch.zeros(1000), torch.zeros(1024, dtype=torch.float64),
    torch.zeros(2, 1024), torch.zeros(0)])
def test_encode_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        S.encode_signs(bad)


def test_unpack_rejects_ragged_rows():
    with pytest.raises(ValueError):
        S.unpack_signs(torch.zeros(100, dtype=torch.uint8))

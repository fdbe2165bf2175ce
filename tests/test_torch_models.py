"""The port's models compute the JAX package's functions once the flax
weights are carried across with ``utils.interop``.

Forwards agree to rtol 1e-4, atol 1e-5: convolutions and GroupNorm's
statistics sum in another order in the two frameworks. ResNet-50 is
three times as deep, and the port's float64 forward differs from the JAX
float32 one by as much as its float32 forward does (5e-5), so it is held
to atol 1e-4. The weight round trip is exact.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.utils.interop import (flax_path, jax_leaf_order,
                                                    params_from_jax,
                                                    params_to_jax)


def _images(n: int, hw: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_case(case: str):
    """The JAX model, its initialized variables (numpy) and its logits on
    ``_images(4, hw)``; computed once per case."""
    make_j, _, hw = CASES[case]
    jmodel = make_j()
    x = jnp.asarray(_images(4, hw))
    variables = jax.tree.map(np.asarray,
                             jax.jit(jmodel.init)(jax.random.key(0), x))
    return variables, np.asarray(jax.jit(jmodel.apply)(variables, x))


CASES = {
    "resnet18_w32": (lambda: jm.ResNet18(num_classes=10, num_filters=32,
                                         small_inputs=True),
                     lambda: tm.ResNet18(num_classes=10, num_filters=32,
                                         small_inputs=True, device="cpu"),
                     8),
    "resnet18_imagenet_stem": (lambda: jm.ResNet18(num_classes=7,
                                                   num_filters=8),
                               lambda: tm.ResNet18(num_classes=7,
                                                   num_filters=8,
                                                   device="cpu"),
                               30),
    # 16x16: at 1x1 the last stage's GroupNorm would normalize 8 values,
    # whose variance is too ill-conditioned to compare across frameworks
    "resnet50_w8": (lambda: jm.ResNet50(num_classes=5, num_filters=8,
                                        small_inputs=True),
                    lambda: tm.ResNet50(num_classes=5, num_filters=8,
                                        small_inputs=True, device="cpu"),
                    16),
}
ATOL = {"resnet50_w8": 1e-4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resnet_forward_matches_jax(case):
    _, make_t, hw = CASES[case]
    variables, want = _jax_case(case)
    tmodel = make_t()
    params_from_jax(variables, tmodel)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(_images(4, hw))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=ATOL.get(case, 1e-5))


def test_mlp_forward_matches_jax():
    x = np.random.RandomState(1).randn(4, 28, 28, 1).astype(np.float32)
    jmodel = jm.MLP(features=(64, 10))
    tmodel = tm.MLP(features=(64, 10), in_features=784, device="cpu")
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0),
                                                     jnp.asarray(x)))
    params_from_jax(variables, tmodel)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_weight_round_trip_is_exact(case):
    variables, _ = _jax_case(case)
    tmodel = CASES[case][1]()
    params_from_jax(variables, tmodel)
    back = params_to_jax(tmodel)
    flat, tree = jax.tree.flatten(variables)
    back_flat, back_tree = jax.tree.flatten(back)
    assert tree == back_tree
    for a, b in zip(flat, back_flat):
        np.testing.assert_array_equal(a, b)


def test_leaf_order_is_the_jax_flatten_order():
    jmodel = jm.ResNet50(num_classes=5, num_filters=8, small_inputs=True)
    tmodel = tm.ResNet50(num_classes=5, num_filters=8, small_inputs=True,
                         device="cpu")
    variables = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                   jnp.zeros((1, 8, 8, 3))))
    jax_paths = [tuple(k.key for k in path[1:]) for path, _ in
                 jax.tree_util.tree_flatten_with_path(variables)[0]]
    # 16 blocks: "BottleneckBlock_10" sorts before "BottleneckBlock_2"
    assert [flax_path(tmodel, n) for n in jax_leaf_order(tmodel)] == jax_paths
    got = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                       variables), tmodel)
    assert list(got) == jax_leaf_order(tmodel)


def test_parameter_count_matches_jax_resnet18():
    tmodel = tm.ResNet18(num_classes=10, small_inputs=True, device="cpu")
    variables = jax.eval_shape(
        lambda: jm.ResNet18(num_classes=10, small_inputs=True).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    leaves = jax.tree.leaves(variables)
    assert sum(p.numel() for p in tmodel.parameters()) == \
        sum(int(np.prod(s.shape)) for s in leaves) == 11_173_962
    assert len(list(tmodel.parameters())) == len(leaves) == 62
    assert sum(p.numel() % 1024 == 0 for p in tmodel.parameters()) == 20


def test_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.MLP()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.ResNet18(norm="batch", bn_axis="data")

"""Shared inputs of the port's step parity tests (``test_torch_ps*.py``):
the width-32 ResNet-18 and a small MLP on both sides, seeded numpy
gradients in both layouts, the codecs the step tests use, and the JAX
package's grads-only runs."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.utils.interop import (flax_path, params_from_jax,
                                                    params_to_jax,
                                                    torch_layout)

ROOT = Path(__file__).resolve().parent.parent
STEPS = 3
HYPER = dict(lr=0.01, momentum=0.9)


@functools.lru_cache(maxsize=None)
def jax_resnet():
    jmodel = jm.ResNet18(num_classes=10, num_filters=32, small_inputs=True)
    variables = jax.jit(jmodel.init)(jax.random.key(0),
                                     jnp.zeros((1, 32, 32, 3)))
    return jmodel, jax.tree.map(np.asarray, variables)


def torch_resnet():
    model = tm.ResNet18(num_classes=10, num_filters=32, small_inputs=True,
                        device="cpu")
    params_from_jax(jax_resnet()[1], model)
    return model


def mlp_pair(seed: int = 0, features=(48, 10)):
    jmodel = jm.MLP(features=features)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(seed), jnp.zeros((1, 28, 28, 1))))
    model = tm.MLP(features=features, in_features=784, device="cpu")
    params_from_jax(variables, model)
    return variables, model


def stacked_grads(variables, world: int, step: int):
    """Per-leaf ``[world, *flax_shape]`` gradients from a seed."""
    rng = np.random.RandomState(1000 * world + step)
    return jax.tree.map(
        lambda p: (1e-2 * rng.randn(world, *p.shape)).astype(np.float32),
        variables)


def torch_grads(model, jgrads):
    """``stacked_grads`` as the port's ``name -> [world, ...]`` dict."""
    out = {}
    for name, _ in model.named_parameters():
        node = jgrads["params"]
        for key in flax_path(model, name):
            node = node[key]
        out[name] = torch.from_numpy(np.ascontiguousarray(np.stack(
            [torch_layout(flax_path(model, name), g) for g in node])))
    return out


def assert_params_close(model, jparams, rtol, atol):
    got = jax.tree.leaves(params_to_jax(model))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def make_codec(name: str, get_codec):
    """A codec of the step parity tests from either package's registry:
    ``sign``, ``int8``, or ``ef_topk`` (error feedback around the exact
    top-k of 1% of each leaf, threshold-refine selection)."""
    if name == "ef_topk":
        return get_codec("ef", inner=get_codec("topk", fraction=0.01,
                                               pallas=True))
    return get_codec(name)


@functools.lru_cache(maxsize=None)
def jax_grads_only(world: int, codec: str = "sign"):
    """The JAX package's parameters after ``STEPS`` grads-only
    ``SGD(code=codec)`` steps of the width-32 ResNet-18 on a
    ``world``-device mesh."""
    _, variables = jax_resnet()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=make_codec(codec, jax_codec),
                mesh=make_mesh(devices=jax.devices()[:world]), **HYPER)
    for s in range(STEPS):
        jopt.step(grads=jax.tree.map(jnp.asarray,
                                     stacked_grads(variables, world, s)))
    return jopt.params

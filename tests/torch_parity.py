"""Shared inputs of the port's step parity tests (``test_torch_ps*.py``):
the width-32 ResNet-18, a small MLP and the tiny BERT on both sides,
seeded numpy gradients in both layouts, the codecs the step tests use,
the JAX package's grads-only runs, the JAX aggregate-and-Adam replay
of the port's TernGrad payloads, and the launcher of the gloo spawns."""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu import optim as jax_optim
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import data as tdata
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


def spawn_ranks(script: str, world: int, args) -> None:
    """Run ``script`` (``python -c``) in ``world`` processes on the CPU,
    each given ``rank world port *args``, with the repo and ``tests/`` on
    the path; every one must exit 0 within 120 s."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(port),
         *map(str, args)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, outs


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


# -- the tiny BERT ----------------------------------------------------------------

BERT_SEQ = 32
#: TernGrad on the tiny BERT's step: the sublane layout where a leaf's
#: size divides by 512, chunks of 2,560 elements from 10,240 (tok_emb,
#: mlm_head and the qkv kernels, with ragged tails)
TERN_KW = dict(use_pallas=True, scan_block=2560)
ADAM = dict(lr=1e-3)


@functools.lru_cache(maxsize=None)
def jax_bert(dtype: str = "float32", attention: str = "flash"):
    """The JAX ``BertMLM`` and its weights, from the dense twin's init
    (the same parameters, without running the interpret-mode kernel)."""
    def make(att):
        return jm.BertMLM(jm.BertConfig.tiny(attention=att,
                                             dtype=getattr(jnp, dtype)))
    variables = jax.jit(make("full").init)(
        jax.random.key(0), jnp.zeros((1, BERT_SEQ), jnp.int32))
    return make(attention), jax.tree.map(np.asarray, variables)


def torch_bert(dtype: str = "float32", attention: str = "flash"):
    model = tm.BertMLM(tm.BertConfig.tiny(attention=attention,
                                          dtype=getattr(torch, dtype)),
                       device="cpu")
    params_from_jax(jax_bert(dtype, attention)[1], model)
    return model


def bert_batch(seed: int = 0, batch: int = 2):
    return next(tdata.synthetic_mlm(batch, BERT_SEQ, 1024, seed=seed,
                                    device="cpu"))


def bert_loss_fn(model):
    """``loss_fn(params, batch)`` of the port's step: ``mlm_loss`` of the
    model called with ``params``."""
    def loss_fn(params, b):
        logits = torch.func.functional_call(model, params, (b["tokens"],))
        return tm.mlm_loss(logits, b["targets"], b["mask"])
    return loss_fn


def record_payloads(code, sink: list):
    """Wrap ``code.encode`` so every payload it returns is appended to
    ``sink`` (as numpy arrays), in the optimizer's leaf order."""
    encode = code.encode

    def recording(grad, state=(), rng=None):
        payload, state = encode(grad, state, rng)
        sink.append({k: v.detach().cpu().numpy().copy()
                     for k, v in payload.items()})
        return payload, state

    code.encode = recording
    return code


def jax_replay_terngrad_adam(variables, names, steps, hyper=ADAM):
    """The JAX package's parameters after running the port's TernGrad
    payloads through the JAX codec's ``aggregate``/``agg_decode`` and the
    JAX ``adam_update``. ``steps``: per step, per rank, the payloads of
    the leaves ``names`` (port names, flax paths joined by dots) in
    order."""
    jc = jax_codec("terngrad", **TERN_KW)
    hyper_cls, init, update = jax_optim.OPTIMIZERS["adam"]
    params = jax.tree.map(jnp.asarray, variables)
    state, h = init(params), hyper_cls(**hyper)
    paths = [name.split(".") for name in names]
    shapes = [np.shape(_get(variables["params"], p)) for p in paths]

    @jax.jit
    def aggregate(stacked):
        grads = {}
        for path, shape, st in zip(paths, shapes, stacked):
            agg, meta = jc.aggregate(st, shape, jnp.float32)
            _set(grads, path, jc.agg_decode(agg, meta, shape, jnp.float32))
        return {"params": grads}

    update = jax.jit(update, static_argnums=3)
    for ranks in steps:
        stacked = [{k: jnp.stack([jnp.asarray(r[i][k]) for r in ranks])
                    for k in ranks[0][i]} for i in range(len(names))]
        params, state = update(params, aggregate(stacked), state, h)
    return params


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value

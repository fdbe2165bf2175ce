"""The port's ``step(loss_fn=..., batch=...)`` against the JAX package's,
on the width-32 ResNet-18 at world 1 (same weights, same batches).

(b) With the identity codec: parameters to rtol 1e-4 after 3 steps; the
    two frameworks' convolution gradients sum in another order. A
    parameter near zero carries the update's absolute error instead,
    hence atol 1e-5 (parameters are ~5e-2).
(c) With the sign codec. A gradient element near 0 can take the other
    sign in the other framework and move its parameter by 2·lr·scale, so
    the losses are held to 1e-3 and at most 0.1% of the parameter
    elements may differ by more than rtol 1e-4 after a step. On the
    ResNet each step starts from the JAX optimizer's state: free-running,
    flax's GroupNorm drift flips signs at the third step and moves the
    trajectories apart. The MLP, which has no GroupNorm, runs free for 3
    steps under the same bound.
(d) With error feedback around the exact top-k on the MLP, free-running
    for 3 steps: the same elements are sent at every step, losses agree
    to 1e-6 and parameters to rtol 1e-6 (not bit-exact: the frameworks'
    matmul gradients differ in the last ulps).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import data as jdata
from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch import data as tdata
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.utils.interop import (flax_path, params_from_jax,
                                                    params_to_jax,
                                                    torch_layout)
from torch_parity import (HYPER, STEPS, assert_params_close, jax_resnet,
                          make_codec, mlp_pair, torch_resnet)


def _off_fraction(model, jparams) -> float:
    """Share of parameter elements further apart than rtol 1e-4 (+1e-6)."""
    got = np.concatenate([a.ravel() for a in
                          jax.tree.leaves(params_to_jax(model))])
    want = np.concatenate([np.asarray(b).ravel()
                           for b in jax.tree.leaves(jparams)])
    return float(np.mean(np.abs(got - want) > 1e-4 * np.abs(want) + 1e-6))


@torch.no_grad()
def _resync(model, opt, jopt) -> None:
    """Start the port's next step from the JAX optimizer's parameters and
    momentum buffers."""
    params_from_jax(jax.tree.map(np.asarray, jopt.params), model)
    bufs = jax.tree.map(np.asarray, jopt.opt_state.momentum_buf)["params"]
    for name, buf in opt.opt_state.momentum_buf.items():
        node = bufs
        for key in flax_path(model, name):
            node = node[key]
        buf.copy_(torch.from_numpy(np.array(
            torch_layout(flax_path(model, name), node), order="C")))


@contextlib.contextmanager
def _flax_two_pass_variance(enabled: bool = True):
    """While active, flax's GroupNorm takes the two-pass variance instead
    of its default E[x^2] - E[x]^2 (``use_fast_variance=True``). A jitted
    JAX step keeps what it traced under it."""
    import flax.linen.normalization as flax_norm

    compute_stats = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        return compute_stats(*args, **{**kwargs, "use_fast_variance": False})

    if enabled:
        flax_norm._compute_stats = two_pass
    try:
        yield
    finally:
        flax_norm._compute_stats = compute_stats


def _loss_fn_run(code_name: str, resync: bool = False, steps: int = STEPS):
    jmodel, variables = jax_resnet()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=jax_codec(code_name),
                mesh=make_mesh(devices=jax.devices()[:1]), **HYPER)

    def jloss(p, b):
        return jdata.cross_entropy_loss(jmodel.apply(p, b[0]), b[1])

    model = torch_resnet()
    opt = SGD(model, code=get_codec(code_name), device="cpu", **HYPER)

    def tloss(p, b):
        return tdata.cross_entropy_loss(functional_call(model, p, (b[0],)),
                                        b[1])

    jit, tit = (jdata.synthetic_images("cifar10", 4),
                tdata.synthetic_images("cifar10", 4, device="cpu"))
    losses, off = [], []
    for s in range(steps):
        if resync and s:
            _resync(model, opt, jopt)
        jl, _ = jopt.step(loss_fn=jloss, batch=next(jit))
        tl, _ = opt.step(loss_fn=tloss, batch=next(tit))
        losses.append((float(tl), float(jl)))
        off.append(_off_fraction(model, jopt.params))
    return model, jopt, losses, off, next(jit)


@functools.lru_cache(maxsize=None)
def _sign_run():
    return _loss_fn_run("sign", resync=True, steps=2)


def test_loss_fn_identity_step_matches_jax():
    model, jopt, losses, _, _ = _loss_fn_run("identity")
    jparams = jopt.params
    for tl, jl in losses:
        assert abs(tl - jl) <= 1e-4 * abs(jl)
    assert_params_close(model, jparams, rtol=1e-4, atol=1e-5)


def test_loss_fn_sign_step_tracks_jax():
    # Each step starts from the JAX optimizer's state, so the bound holds
    # per step. Two steps, not three: at the third step's state flax's
    # GroupNorm variance, E[x^2] - E[x]^2 in float32, loses most of its
    # digits in the last stage, the JAX gradient drifts from a float64
    # evaluation (test_port_gradient_holds_where_jax_drifts), and the
    # sign of 0.2% of the elements follows that drift.
    _, _, losses, off, _ = _sign_run()
    for tl, jl in losses:
        assert abs(tl - jl) <= 1e-3
    assert max(off) <= 1e-3, off


def test_loss_fn_sign_free_run_tracks_jax_mlp():
    # Free-running for 3 steps, no resync, on an MLP whose first kernel
    # (784 x 64) takes the sign kernel layout and whose other leaves take
    # the plain one. A gradient element near 0 may still take the other
    # sign in the other framework, hence the 0.1% share of elements
    # allowed past rtol 1e-4 after each step.
    variables, model = mlp_pair(features=(64, 10))
    jmodel = jm.MLP(features=(64, 10))
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=jax_codec("sign"),
                mesh=make_mesh(devices=jax.devices()[:1]), **HYPER)
    opt = SGD(model, code=get_codec("sign"), device="cpu", **HYPER)

    def jloss(p, b):
        return jdata.cross_entropy_loss(jmodel.apply(p, b[0]), b[1])

    def tloss(p, b):
        return tdata.cross_entropy_loss(functional_call(model, p, (b[0],)),
                                        b[1])

    jit, tit = (jdata.synthetic_images("mnist", 16),
                tdata.synthetic_images("mnist", 16, device="cpu"))
    for _ in range(3):
        jl, _ = jopt.step(loss_fn=jloss, batch=next(jit))
        tl, _ = opt.step(loss_fn=tloss, batch=next(tit))
        assert abs(float(tl) - float(jl)) <= 1e-3
        assert _off_fraction(model, jopt.params) <= 1e-3


def test_loss_fn_ef_topk_free_run_tracks_jax_mlp():
    # Free-running for 3 steps of SGD(code=ef(topk(fraction=0.01,
    # pallas=True))) on the MLP (48, 10): its 784 x 48 kernel (37,632
    # elements) takes the threshold-refine selection, its other leaves the
    # sort fallback. Not bit-exact: the two frameworks' matmul gradients
    # differ in the last ulps, and the jitted JAX step contracts its
    # update into fused multiply-adds. So each step must send the same
    # elements (EF memory is zero exactly where an element was sent, on
    # both sides), the losses agree to 1e-6 and the parameters to rtol
    # 1e-6, atol 1e-7.
    variables, model = mlp_pair(features=(48, 10))
    jmodel = jm.MLP(features=(48, 10))
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=make_codec("ef_topk", jax_codec),
                mesh=make_mesh(devices=jax.devices()[:1]), **HYPER)
    opt = SGD(model, code=make_codec("ef_topk", get_codec), device="cpu",
              **HYPER)

    def jloss(p, b):
        return jdata.cross_entropy_loss(jmodel.apply(p, b[0]), b[1])

    def tloss(p, b):
        return tdata.cross_entropy_loss(functional_call(model, p, (b[0],)),
                                        b[1])

    jit, tit = (jdata.synthetic_images("mnist", 16),
                tdata.synthetic_images("mnist", 16, device="cpu"))
    for _ in range(3):
        jl, _ = jopt.step(loss_fn=jloss, batch=next(jit))
        tl, _ = opt.step(loss_fn=tloss, batch=next(tit))
        assert abs(float(tl) - float(jl)) <= 1e-6
        assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)
        jmem = jax.tree.map(np.asarray, jopt.codec_state)["params"]
        for name, state in opt.codec_state.items():
            node = jmem
            for key in flax_path(model, name):
                node = node[key]
            want = torch_layout(flax_path(model, name),
                                node["memory"][0]) == 0
            np.testing.assert_array_equal(state["memory"].numpy() == 0,
                                          want, err_msg=name)


def _jax_grads(jloss, params, batch, fast_variance: bool):
    """The JAX package's gradient; with ``fast_variance=False`` flax's
    GroupNorm takes the two-pass variance."""
    with _flax_two_pass_variance(not fast_variance):
        return jax.tree.map(np.asarray, jax.grad(jloss)(params, batch))


def test_port_gradient_holds_where_jax_drifts():
    """At the state two sign steps reach, the port's float32 gradient of
    the last stages agrees with its float64 gradient to 1e-5 (relative to
    the leaf's largest element), and so does the JAX package's once flax's
    GroupNorm takes the two-pass variance; with flax's default fast
    variance it is off by up to 9% (printed). ROADMAP queue 3 records
    the drift and its cause."""
    jmodel, _ = jax_resnet()
    _, jopt, _, _, batch = _sign_run()

    def jloss(p, b):
        return jdata.cross_entropy_loss(jmodel.apply(p, b[0]), b[1])

    x, y = (np.array(a) for a in batch)
    jgrads = _jax_grads(jloss, jopt.params, (x, y), fast_variance=True)
    jgrads_two_pass = _jax_grads(jloss, jopt.params, (x, y),
                                 fast_variance=False)
    state = jax.tree.map(np.asarray, jopt.params)

    def port_grads(dtype):
        model = torch_resnet()
        params_from_jax(state, model)
        model = model.to(dtype)
        params = {k: p.detach().requires_grad_()
                  for k, p in model.named_parameters()}
        logits = functional_call(model, params,
                                 (torch.from_numpy(x).to(dtype),))
        loss = tdata.cross_entropy_loss(logits, torch.from_numpy(y))
        return model, dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    model, g32 = port_grads(torch.float32)
    _, g64 = port_grads(torch.float64)
    for name in ("head.weight", "blocks.7.conv1.weight",
                 "blocks.6.conv2.weight", "blocks.6.conv1.weight"):
        path = flax_path(model, name)
        ref = g64[name].numpy()
        scale = np.abs(ref).max()

        def err(grads):
            node = grads["params"]
            for key in path:
                node = node[key]
            return np.abs(torch_layout(path, node) - ref).max() / scale

        port = np.abs(g32[name].numpy() - ref).max() / scale
        jax_fast, jax_two_pass = err(jgrads), err(jgrads_two_pass)
        print(f"{name}: port {port:.3g}, jax {jax_fast:.3g}, "
              f"jax two-pass variance {jax_two_pass:.3g}")
        assert port <= 1e-5, (name, port)
        assert jax_two_pass <= 1e-5, (name, jax_two_pass)

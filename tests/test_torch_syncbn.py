"""The port's BatchNorm ResNet and SyncBatchNorm against the JAX package.

(a) ``ResNet18(norm="batch")`` at width 8 on the same weights and running
    statistics as the JAX model (through ``interop``): logits, the moved
    running statistics and the loss's gradients with ``train=True``, and
    logits with ``train=False``. The port takes the variance in two passes,
    flax in one (``E[x^2] - E[x]^2``); on inputs offset by 3 the logits
    (largest ~6) agree to 2e-4 and the gradients to 2e-4 of each leaf's
    largest magnitude against flax's default, and to 5e-5 against flax
    made to take two passes; the running statistics to 1e-6.
(b) ``step(aux_state=...)`` of ``SGD`` on that model: three steps equal
    the JAX package's (world 1, the aux state threaded through) to rtol
    1e-4, atol 1e-5, the aux state to 1e-5, with flax made to take the
    variance in two passes. Against flax's one-pass variance the third
    step's parameters drift apart by up to 8e-4 (ROADMAP queue 3).
(c) SyncBatchNorm (``bn_axis="data"``) at world 2 and 4 over gloo, each
    rank on its slice of the global batch, against one process with plain
    BatchNorm on the global batch: logits to 3e-5 (the largest is ~3.4:
    the merged statistics round otherwise), running statistics to
    1e-6, the ranks' mean gradient to 1e-5 of each leaf's largest
    magnitude; 20 all-gathers in the forward and 20 all-reduces in the
    backward (one each a BatchNorm layer).
(d) The two-pass variance holds where the one-pass form cancels.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import data as jdata
from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import SGD, comms
from pytorch_ps_mpi_tpu_torch import data as tdata
from pytorch_ps_mpi_tpu_torch.models.resnet import (ResNet18,
                                                    apply_with_stats,
                                                    batch_stats)
from pytorch_ps_mpi_tpu_torch.utils.interop import (aux_from_jax, aux_to_jax,
                                                    flax_path,
                                                    params_from_jax,
                                                    params_to_jax,
                                                    torch_layout)
from torch_parity import one_torch_thread, spawn_ranks


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield

WIDTH = 8


@contextlib.contextmanager
def flax_two_pass(enabled: bool):
    """While active, flax's normalizations take the two-pass variance."""
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


def _inputs(batch: int = 16, seed: int = 0):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 8, 8, 3).astype(np.float32) + 3.0
    return x, rs.randint(0, 10, batch)


def _pair():
    jmodel = jm.ResNet18(num_classes=10, small_inputs=True,
                         num_filters=WIDTH, norm="batch")
    x, _ = _inputs()
    variables = jax.tree.map(np.asarray, jax.jit(
        jmodel.init, static_argnames="train")(
            jax.random.key(0), jnp.asarray(x[:1]), train=False))
    model = ResNet18(num_classes=10, small_inputs=True, num_filters=WIDTH,
                     norm="batch", device="cpu")
    params = params_from_jax(variables, model)
    return jmodel, variables, model, params, aux_from_jax(variables, model)


def _tree_max_err(a, b) -> float:
    return max(jax.tree.leaves(jax.tree.map(
        lambda u, v: float(np.abs(np.asarray(u) - np.asarray(v)).max()),
        a, b)))


@pytest.mark.parametrize("two_pass,tol", [(False, 2e-4), (True, 5e-5)])
def test_batchnorm_resnet_matches_jax(two_pass, tol):
    jmodel, variables, model, params, aux = _pair()
    x, y = _inputs()

    def jloss(p, stats):
        logits, upd = jmodel.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return jdata.cross_entropy_loss(logits, jnp.asarray(y)), (logits,
                                                                  upd)

    with flax_two_pass(two_pass):
        (_, (jlogits, upd)), jgrads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(variables["params"],
                                 variables["batch_stats"])
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    logits, new = apply_with_stats(model, leaves, aux, torch.from_numpy(x))
    grads = torch.autograd.grad(
        tdata.cross_entropy_loss(logits, torch.from_numpy(y)),
        list(leaves.values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=tol)
    assert _tree_max_err(aux_to_jax(new, model)["batch_stats"],
                         upd["batch_stats"]) < 1e-6
    for name, g in zip(leaves, grads):
        node = jgrads
        for key in flax_path(model, name):
            node = node[key]
        want = torch_layout(flax_path(model, name), np.asarray(node))
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=name)
    # aux_state is not altered; train=False normalizes with the given stats
    assert all(torch.equal(aux[k], t) for k, t in
               aux_from_jax(variables, model).items())
    eval_logits, same = apply_with_stats(model, params, new,
                                         torch.from_numpy(x), train=False)
    want = jmodel.apply({"params": variables["params"],
                         "batch_stats": upd["batch_stats"]},
                        jnp.asarray(x), train=False)
    np.testing.assert_allclose(eval_logits.detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    assert all(torch.equal(same[k], new[k]) for k in new)


def test_aux_state_step_matches_jax():
    jmodel, variables, model, _, aux = _pair()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables["params"]), lr=0.01,
                momentum=0.9, mesh=make_mesh(devices=jax.devices()[:1]))
    opt = SGD(model, lr=0.01, momentum=0.9, device="cpu")

    def jloss(p, stats, b):
        logits, upd = jmodel.apply({"params": p, "batch_stats": stats}, b[0],
                                   train=True, mutable=["batch_stats"])
        return jdata.cross_entropy_loss(logits, b[1]), upd["batch_stats"]

    def tloss(p, stats, b):
        logits, new = apply_with_stats(model, p, stats, b[0])
        return tdata.cross_entropy_loss(logits, b[1]), new

    jaux = jax.tree.map(jnp.asarray, variables["batch_stats"])
    for s in range(3):
        x, y = _inputs(seed=s)
        with flax_two_pass(True):
            jl, _ = jopt.step(loss_fn=jloss, batch=(jnp.asarray(x),
                                                    jnp.asarray(y)),
                              aux_state=jaux)
        tl, _ = opt.step(loss_fn=tloss, batch=(torch.from_numpy(x),
                                                torch.from_numpy(y)),
                         aux_state=aux)
        jaux, aux = jopt.aux_state, opt.aux_state
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert opt.state_dict()["aux_state"] is opt.aux_state
    assert _tree_max_err(aux_to_jax(aux, model)["batch_stats"], jaux) < 1e-5
    for a, b in zip(jax.tree.leaves(params_to_jax(model)["params"]),
                    jax.tree.leaves(jopt.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


_SYNC_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from pytorch_ps_mpi_tpu_torch import comms, mesh
from pytorch_ps_mpi_tpu_torch.data import cross_entropy_loss
from pytorch_ps_mpi_tpu_torch.models.resnet import (ResNet18,
                                                    apply_with_stats,
                                                    batch_stats_of)

rank, world, port, per_rank = map(int, sys.argv[1:5])
torch.set_num_threads(1)  # the ranks share the host's cores
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
rs = np.random.RandomState(7)
x = torch.from_numpy(rs.randn(per_rank * world, 8, 8, 3).astype(np.float32)
                     + 3.0)
y = torch.from_numpy(rs.randint(0, 10, per_rank * world))


def run(model, xs, ys):
    params = {k: p.detach().requires_grad_()
              for k, p in model.named_parameters()}
    logits, new = apply_with_stats(model, params, batch_stats_of(model), xs)
    grads = torch.autograd.grad(cross_entropy_loss(logits, ys),
                                list(params.values()))
    return logits.detach(), new, dict(zip(params, grads))


kw = dict(num_classes=10, small_inputs=True, num_filters=8, norm="batch",
          device="cpu")
sl = slice(rank * per_rank, (rank + 1) * per_rank)
comms.reset_calls()
logits, stats, grads = run(ResNet18(bn_axis="data", **kw), x[sl], y[sl])
assert comms.calls["all_gather"] == 20, comms.calls
assert comms.calls["all_reduce"] == 20, comms.calls
for g in grads.values():
    dist.all_reduce(g)
ref_logits, ref_stats, ref_grads = run(ResNet18(**kw), x, y)
np.testing.assert_allclose(logits, ref_logits[sl], rtol=0, atol=3e-5)
for k, t in ref_stats.items():
    np.testing.assert_allclose(stats[k], t, rtol=0, atol=1e-6, err_msg=k)
for k, g in ref_grads.items():
    np.testing.assert_allclose(grads[k] / world, g, rtol=0,
                               atol=1e-5 * float(g.abs().max()), err_msg=k)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_syncbn_equals_one_rank_on_the_global_batch_over_gloo(world):
    spawn_ranks(_SYNC_WORKER, world, (4,))


def test_two_pass_variance_holds_where_one_pass_cancels():
    """A channel whose mean is 1e4 times its spread: float32 E[x^2] -
    E[x]^2 loses every digit of the variance; the port's two passes (and
    the merge of two ranks' halves, Chan) keep it to 1e-3."""
    rs = np.random.RandomState(0)
    x64 = 1e4 + rs.randn(8, 2, 4, 4)
    x = torch.from_numpy(x64.astype(np.float32))
    want = x.double().var(dim=(0, 2, 3), unbiased=False)
    mean, var = batch_stats(x, sync=False)
    np.testing.assert_allclose(var.numpy(), want.numpy(), rtol=1e-3)
    fast = (x * x).mean((0, 2, 3)) - torch.square(x.mean((0, 2, 3)))
    assert float((fast.double() - want).abs().max()) > 1e-2 * float(
        want.max())
    # Chan's merge of two halves equals the whole, as two ranks would
    halves = [batch_stats(h, sync=False) for h in x.split(4)]
    n = 4 * 16
    merged = (halves[0][0] + halves[1][0]) / 2
    m2 = sum(v * n for _, v in halves) + n * sum(
        torch.square(m - merged) for m, _ in halves)
    np.testing.assert_allclose((m2 / (2 * n)).numpy(), want.numpy(),
                               rtol=1e-3)
    np.testing.assert_allclose(merged.numpy(), mean.numpy(), rtol=1e-6)


def test_sync_stats_without_a_group_are_one_ranks():
    """With no process group the differentiable all-gather is the
    identity, counts nothing, and SyncBatchNorm's statistics are plain
    BatchNorm's bit for bit."""
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    comms.reset_calls()
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    a, b = batch_stats(xa, sync=False), batch_stats(xb, sync=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    ga = torch.autograd.grad(a[0].sum() + a[1].sum(), [xa])[0]
    gb = torch.autograd.grad(b[0].sum() + b[1].sum(), [xb])[0]
    np.testing.assert_allclose(gb.numpy(), ga.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert sum(comms.calls.values()) == 0
    with pytest.raises(ValueError, match="bn_axis"):
        ResNet18(norm="batch", bn_axis="model", device="cpu")

"""``parallel/async_ps.py`` of the port against the JAX package's
``AsyncPS``: the same MLP weights and the same seeded numpy batches go
through both, with fixed lags, for identity, sign and int8 over three
rounds. Tolerance: rtol 1e-5 and atol 1e-6 on the parameters; the two
frameworks take the MLP's products in other orders, and the jitted JAX
update contracts into FMAs (ROADMAP queue 3 item 4). The sampled lags,
``staleness_probs_from_histogram`` and the constructor's errors are
checked against the JAX package's as well."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.parallel import async_ps as jasync
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import async_ps as tasync
from pytorch_ps_mpi_tpu_torch.utils.interop import (params_from_jax,
                                                    params_to_jax)

WORKERS, ROUNDS, LR = 4, 3, 0.05
FEATURES, D_IN, BATCH = (32, 8), 16, 8


def _mlp():
    jmodel = jm.MLP(features=FEATURES)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(3), jnp.zeros((1, D_IN))))
    model = tm.MLP(features=FEATURES, in_features=D_IN, device="cpu")
    params = params_from_jax(variables, model)
    return jmodel, variables, model, params


def _batches(round_: int):
    rng = np.random.RandomState(100 + round_)
    x = rng.randn(WORKERS, BATCH, D_IN).astype(np.float32)
    y = rng.randn(WORKERS, BATCH, FEATURES[-1]).astype(np.float32)
    return x, y


def _losses(jmodel, model):
    def jloss(params, batch):
        x, y = batch
        return jnp.mean((jmodel.apply(params, x) - y) ** 2)

    def tloss(params, batch):
        x, y = batch
        out = torch.func.functional_call(model, params, (x,))
        return torch.mean((out - y) ** 2)
    return jloss, tloss


def _jax_params(variables):
    return jax.tree.leaves(variables)


@pytest.mark.parametrize("lags", [[0, 0, 0, 0], [0, 1, 2, 1]])
@pytest.mark.parametrize("codec", ["identity", "sign", "int8"])
def test_fixed_lags_match_jax(codec, lags):
    jmodel, variables, model, params = _mlp()
    jloss, tloss = _losses(jmodel, model)
    jps = jasync.AsyncPS(variables, jloss, num_workers=WORKERS,
                         code=jax_codec(codec), max_staleness=2,
                         staleness=lags, lr=LR)
    ps = tasync.AsyncPS(params, tloss, num_workers=WORKERS,
                        code=get_codec(codec), max_staleness=2,
                        staleness=lags, lr=LR, device="cpu")
    for r in range(ROUNDS):
        x, y = _batches(r)
        jps.step((jnp.asarray(x), jnp.asarray(y)))
        ps.step((torch.from_numpy(x), torch.from_numpy(y)))
    got = jax.tree.leaves(params_to_jax(model))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jps.params))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert ps.staleness_hist == jps.staleness_hist


def test_zero_lags_equal_sequential_sgd():
    jmodel, variables, model, params = _mlp()
    _, tloss = _losses(jmodel, model)
    start = {k: v.detach().clone() for k, v in params.items()}
    ps = tasync.AsyncPS(params, tloss, num_workers=WORKERS, max_staleness=0,
                        staleness=[0] * WORKERS, lr=LR, device="cpu")
    x, y = _batches(0)
    ps.step((torch.from_numpy(x), torch.from_numpy(y)))
    grads = []
    for w in range(WORKERS):
        p = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        loss = tloss(p, (torch.from_numpy(x[w]), torch.from_numpy(y[w])))
        grads.append(dict(zip(p, torch.autograd.grad(loss, list(p.values())))))
    want = {k: v.clone() for k, v in start.items()}
    for g in grads:
        for k in want:
            want[k] -= LR * g[k]
    for k in want:
        torch.testing.assert_close(params[k], want[k], rtol=0, atol=0)


def test_sampled_lags_follow_their_distribution():
    jmodel, variables, model, params = _mlp()
    _, tloss = _losses(jmodel, model)
    probs = [0.5, 0.3, 0.2]
    ps = tasync.AsyncPS(params, tloss, num_workers=WORKERS, max_staleness=2,
                        staleness_probs=probs, lr=0.0, seed=7, device="cpu")
    x, y = _batches(0)
    for _ in range(100):
        ps.step((torch.from_numpy(x), torch.from_numpy(y)))
    total = sum(ps.staleness_hist.values())
    assert total == 100 * WORKERS
    freq = np.array([ps.staleness_hist.get(i, 0) for i in range(3)]) / total
    # 400 draws: 4 standard errors of the largest share is ~0.1
    np.testing.assert_allclose(freq, probs, atol=0.1)


def test_staleness_probs_from_histogram_matches_jax():
    for hist, s in [({0: 3, 1: 5, 2: 2, 7: 9}, 2), ({1: 1}, 3),
                    ({0: 1, 4: 4}, 4)]:
        np.testing.assert_array_equal(
            tasync.staleness_probs_from_histogram(hist, s),
            jasync.staleness_probs_from_histogram(hist, s))
    for mod in (tasync, jasync):
        with pytest.raises(ValueError, match="no mass"):
            mod.staleness_probs_from_histogram({5: 2}, 2)


@pytest.mark.parametrize("kwargs", [
    dict(staleness=[0, 1], staleness_probs=[1, 1, 1]),
    dict(staleness=[0, 1, 2, 3]),
    dict(staleness=[0, 1]),
    dict(staleness=[-1, 0, 0, 0]),
    dict(staleness_probs=[1.0, 1.0]),
    dict(staleness_probs=[1.0, -1.0, 1.0]),
    dict(staleness_probs=[0.0, 0.0, 0.0]),
])
def test_validation_errors_match_jax(kwargs):
    jmodel, variables, model, params = _mlp()
    jloss, tloss = _losses(jmodel, model)
    with pytest.raises(ValueError) as jerr:
        jasync.AsyncPS(variables, jloss, num_workers=WORKERS,
                       max_staleness=2, lr=LR, **kwargs)
    with pytest.raises(ValueError) as terr:
        tasync.AsyncPS(params, tloss, num_workers=WORKERS, max_staleness=2,
                       lr=LR, device="cpu", **kwargs)
    assert str(terr.value) == str(jerr.value)


def test_history_ring_keeps_the_versions():
    jmodel, variables, model, params = _mlp()
    _, tloss = _losses(jmodel, model)
    start = {k: v.detach().clone() for k, v in params.items()}
    ps = tasync.AsyncPS(params, tloss, num_workers=WORKERS, max_staleness=2,
                        staleness=[0, 1, 2, 1], lr=LR, device="cpu")
    x, y = _batches(0)
    ps.step((torch.from_numpy(x), torch.from_numpy(y)))
    for k in params:
        torch.testing.assert_close(ps.history[0][k], params[k])
        torch.testing.assert_close(ps.history[2][k], start[k])

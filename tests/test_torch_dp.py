"""The port's functional data-parallel step (``parallel/dp.py``) against
its ``MPI_PS`` and the JAX package's ``make_sync_train_step``.

The JAX package's five ``test_dp_functional.py`` cases, on the port:
the functional step equals the object API (bit for bit: both are built
from the same ``ps.py`` functions), error feedback's memory threads
through the returned codec state, leader mode equals allgather (rtol
1e-6 over 5 Adam steps) and divides by the world with ``average=True``,
and PowerSGD's fused seam equals ``MPI_PS`` in both modes bit for bit.
Also: the functional step equals the JAX package's on the same inputs at
world 1 (rtol 1e-6: the two frameworks' matmul gradients round apart),
the bucketed step equals ``MPI_PS(bucket_mb=...)`` bit for bit with a
codec that draws random numbers (QSGD), and ``step_fn`` alters none of
its inputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu.parallel import make_sync_train_step as jax_make
from pytorch_ps_mpi_tpu_torch import SGD, Adam
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import make_sync_train_step
from pytorch_ps_mpi_tpu_torch.ps import LeaderState
from torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def quad_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2)


def _numpy_inputs(seed=0, n=32, shape=(4, 3)):
    rs = np.random.RandomState(seed)
    w = rs.randn(*shape).astype(np.float32)
    x = rs.randn(n, shape[0]).astype(np.float32)
    y = rs.randn(n, shape[1]).astype(np.float32)
    return w, x, y


def _inputs(seed=0, n=32, shape=(4, 3)):
    w, x, y = _numpy_inputs(seed, n, shape)
    return {"w": torch.from_numpy(w)}, (torch.from_numpy(x),
                                        torch.from_numpy(y))


def _equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def test_functional_matches_object_api():
    params, batch = _inputs()
    init_fn, step_fn = make_sync_train_step(quad_loss, optim="sgd", lr=0.05,
                                            momentum=0.9)
    opt_state, codec_state = init_fn(params)
    p, opt_state, codec_state, loss = step_fn(params, opt_state, codec_state,
                                              batch)
    obj = SGD({"w": params["w"].clone()}, lr=0.05, momentum=0.9,
              device="cpu")
    obj_loss, _ = obj.step(loss_fn=quad_loss, batch=batch)
    assert torch.equal(loss, obj_loss) and _equal(p, obj.params)


def test_functional_matches_jax():
    w, x, y = _numpy_inputs()
    init_fn, step_fn = make_sync_train_step(quad_loss, optim="sgd", lr=0.05,
                                            momentum=0.9,
                                            code=get_codec("int8"))
    params = {"w": torch.from_numpy(w)}
    opt_state, codec_state = init_fn(params)

    def jloss(p, b):
        return jnp.mean((b[0] @ p["w"] - b[1]) ** 2)

    jinit, jstep = jax_make(jloss, make_mesh(devices=jax.devices()[:1]),
                            optim="sgd", lr=0.05, momentum=0.9,
                            code=jax_codec("int8"), donate=False)
    jparams = {"w": jnp.asarray(w)}
    jopt, jcodec = jinit(jparams)
    for s in range(3):
        params, opt_state, codec_state, loss = step_fn(
            params, opt_state, codec_state,
            (torch.from_numpy(x), torch.from_numpy(y)))
        jparams, jopt, jcodec, jl = jstep(jparams, jopt, jcodec,
                                          (jnp.asarray(x), jnp.asarray(y)),
                                          jax.random.key(s))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=1e-6, atol=1e-7)


def test_functional_with_ef_codec_state_threads():
    params, batch = _inputs()
    code = get_codec("ef", inner_name="topk", k=2)
    init_fn, step_fn = make_sync_train_step(quad_loss, optim="sgd", lr=0.01,
                                            code=code)
    opt_state, codec_state = init_fn(params)
    assert (codec_state["w"]["memory"] == 0).all()
    _, _, new_state, _ = step_fn(params, opt_state, codec_state, batch)
    assert new_state["w"]["memory"].abs().sum() > 0
    assert (codec_state["w"]["memory"] == 0).all()


def test_functional_leader_mode_matches_allgather():
    results = {}
    for mode in ("allgather", "leader"):
        params, batch = _inputs(seed=2, n=16)
        init_fn, step_fn = make_sync_train_step(quad_loss, optim="adam",
                                                lr=1e-2, mode=mode)
        opt_state, codec_state = init_fn(params)
        losses = []
        for _ in range(5):
            params, opt_state, codec_state, loss = step_fn(
                params, opt_state, codec_state, batch)
            losses.append(float(loss))
        results[mode] = (losses, params["w"].numpy())
        if mode == "leader":
            assert isinstance(opt_state, LeaderState)
            assert opt_state.inner.exp_avg["w"].shape == (1, 12)
    np.testing.assert_allclose(results["allgather"][0], results["leader"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(results["allgather"][1], results["leader"][1],
                               rtol=1e-6, atol=1e-7)


def test_functional_leader_mode_average_flag():
    outs = {}
    for mode in ("allgather", "leader"):
        params, batch = _inputs(seed=2, n=16)
        init_fn, step_fn = make_sync_train_step(quad_loss, optim="sgd",
                                                lr=0.1, mode=mode,
                                                average=True)
        opt_state, codec_state = init_fn(params)
        params, *_ = step_fn(params, opt_state, codec_state, batch)
        outs[mode] = params["w"].numpy()
    np.testing.assert_allclose(outs["allgather"], outs["leader"], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["allgather", "leader"])
def test_functional_powersgd_matches_object_api(mode):
    rs = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rs.randn(16, 12).astype(np.float32)),
              "b": torch.zeros(12)}
    batch = (torch.from_numpy(rs.randn(32, 16).astype(np.float32)),
             torch.from_numpy(rs.randn(32, 12).astype(np.float32)))

    def loss_fn(p, b):
        return torch.mean((b[0] @ p["w"] + p["b"] - b[1]) ** 2)

    def code():
        return get_codec("powersgd", rank=2, min_compression_elems=4)

    init_fn, step_fn = make_sync_train_step(loss_fn, optim="sgd", lr=0.01,
                                            code=code(), mode=mode)
    opt_state, codec_state = init_fn(params)
    obj = SGD({k: v.clone() for k, v in params.items()}, lr=0.01,
              code=code(), mode=mode, device="cpu")
    p = params
    for _ in range(3):
        p, opt_state, codec_state, loss = step_fn(p, opt_state, codec_state,
                                                  batch)
        obj_loss, _ = obj.step(loss_fn=loss_fn, batch=batch)
        assert torch.equal(loss, obj_loss)
    assert _equal(p, obj.params)
    assert torch.equal(codec_state["w"]["Q"], obj.codec_state["w"]["Q"])


def test_bucketed_functional_matches_bucketed_object_api():
    rs = np.random.RandomState(3)
    shapes = {"a": (64, 32), "b": (32,), "c": (32, 10), "d": (10,)}
    params = {k: torch.from_numpy(rs.randn(*s).astype(np.float32) * 0.1)
              for k, s in shapes.items()}
    batch = (torch.from_numpy(rs.randn(8, 64).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 10, 8)))

    def loss_fn(p, b):
        h = torch.relu(b[0] @ p["a"] + p["b"])
        return torch.nn.functional.cross_entropy(h @ p["c"] + p["d"], b[1])

    init_fn, step_fn = make_sync_train_step(loss_fn, optim="adam", lr=1e-2,
                                            code=get_codec("qsgd"),
                                            bucket_mb=0.004)
    opt_state, codec_state = init_fn(params)
    obj = Adam({k: v.clone() for k, v in params.items()}, lr=1e-2,
               code=get_codec("qsgd"), bucket_mb=0.004, seed=5, device="cpu")
    assert obj._bucket_plan.num_buckets > 1
    gen = torch.Generator().manual_seed(5 * 1_000_003)
    before = {k: v.clone() for k, v in params.items()}
    p = params
    for _ in range(3):
        p, opt_state, codec_state, loss = step_fn(p, opt_state, codec_state,
                                                  batch, gen)
        obj_loss, _ = obj.step(loss_fn=loss_fn, batch=batch)
        assert torch.equal(loss, obj_loss)
    assert _equal(p, obj.params)
    # the first call's inputs are as they were
    assert _equal(params, before)
    assert not _equal(p, before)


def test_step_fn_alters_no_input():
    params, batch = _inputs()
    init_fn, step_fn = make_sync_train_step(quad_loss, optim="sgd", lr=0.1,
                                            momentum=0.9, mode="leader")
    opt_state, codec_state = init_fn(params)
    w, shards = params["w"].clone(), opt_state.param_shards["w"].clone()
    new_params, new_state, *_ = step_fn(params, opt_state, codec_state,
                                        batch)
    assert torch.equal(params["w"], w)
    assert torch.equal(opt_state.param_shards["w"], shards)
    assert not torch.equal(new_params["w"], w)
    assert new_state.inner.step == 1 and opt_state.inner.step == 0
    with pytest.raises(ValueError, match="mode"):
        make_sync_train_step(quad_loss, mode="ring")


def test_init_fn_again_takes_the_new_params_bucket_plan():
    """``init_fn`` fixes the bucket plan: a second ``init_fn`` on another
    parameter set (other names and shapes) steps as a fresh
    ``make_sync_train_step`` does on it, bit for bit, and not through
    the first set's plan."""
    rs = np.random.RandomState(4)

    def loss_fn(p, b):
        return sum(torch.mean((b @ v.reshape(b.shape[1], -1)) ** 2)
                   for v in p.values())

    first = {"a": torch.from_numpy(rs.randn(8, 3).astype(np.float32))}
    second = {"u": torch.from_numpy(rs.randn(8, 5).astype(np.float32)),
              "v": torch.from_numpy(rs.randn(8, 2).astype(np.float32))}
    batch = torch.from_numpy(rs.randn(4, 8).astype(np.float32))
    kw = dict(optim="sgd", lr=0.1, momentum=0.9, code=get_codec("int8"),
              bucket_mb=1e-4)
    init_fn, step_fn = make_sync_train_step(loss_fn, **kw)
    step_fn(first, *init_fn(first), batch)
    fresh_init, fresh_step = make_sync_train_step(loss_fn, **kw)
    p, q = second, second
    state, fresh_state = init_fn(second), fresh_init(second)
    for _ in range(2):
        p, *state, _ = step_fn(p, *state, batch)
        q, *fresh_state, _ = fresh_step(q, *fresh_state, batch)
    assert set(p) == {"u", "v"} and p["u"].shape == (8, 5)
    assert _equal(p, q)

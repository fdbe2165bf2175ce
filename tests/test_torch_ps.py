"""The port's optimizer step against the JAX package's ``MPI_PS``.

(a) ``step(grads=...)`` with the sign codec on a width-32 ResNet-18: both
    sides get the same numpy gradients, so the sign bits agree and the
    parameters agree to rtol 1e-6 (atol 1e-7 for elements near zero)
    after 3 steps. World 1 is here; world 2 over gloo is in
    ``test_torch_ps_gloo.py`` and the ``loss_fn`` entry point in
    ``test_torch_ps_loss_fn.py``. Conv kernels are HWIO in flax and OIHW
    here: a permutation within a leaf, which the sign codec's elementwise
    decode and mean-|g| scale do not see.
    The int8 step is bit-exact against the JAX package's codec and update
    run one at a time, and within rtol 1e-6 of its jitted step, which
    contracts the update into fused multiply-adds.
(d) the options this slice does not port raise ``NotImplementedError``.
(e) the default ``device="cuda"`` raises when there is no GPU.
Also: the grads-only options (average, clip_norm, weight decay, bf16
psum, Adam, Adafactor, int8, error feedback around top-k) on a small MLP
with the metrics' byte counts (QSGD's too), the state_dict round trip,
and error feedback's memory on the parameters' device through a
state_dict round trip.
"""

from __future__ import annotations

import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import Adam as JAdam
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import SGD, Adam, Adafactor, MPI_PS
from pytorch_ps_mpi_tpu_torch import data as tdata
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from torch_parity import (HYPER, STEPS, assert_params_close, jax_grads_only,
                          jax_resnet, make_codec, mlp_pair, stacked_grads,
                          torch_grads, torch_resnet)


def test_grads_only_sign_step_matches_jax_world1():
    model = torch_resnet()
    opt = SGD(model, code=get_codec("sign"), device="cpu", **HYPER)
    _, variables = jax_resnet()
    for s in range(STEPS):
        loss, data = opt.step(grads=torch_grads(
            model, stacked_grads(variables, 1, s)))
        assert loss is None and data["wire_lowering"] == "allgather"
    assert_params_close(model, jax_grads_only(1), rtol=1e-6, atol=1e-7)


def _jax_int8_steps_op_by_op():
    """The JAX package's grads-only int8 step at world 1, its pieces run
    one at a time: the codec's encode (jitted, as the step compiles it)
    and ``decode_sum`` per leaf, then ``optim.sgd_update``."""
    from pytorch_ps_mpi_tpu import optim as jax_optim

    _, variables = jax_resnet()
    code = jax_codec("int8")
    hyper_cls, init, update = jax_optim.OPTIMIZERS["sgd"]
    params = jax.tree.map(jnp.asarray, variables)
    state, hyper = init(params), hyper_cls(**HYPER)

    encode = jax.jit(lambda g: code.encode(g)[0])

    def aggregate(g):
        payload = encode(g[0])
        stacked = jax.tree.map(lambda a: a[None], payload)
        return code.decode_sum(stacked, g.shape[1:], g.dtype)

    for s in range(STEPS):
        grads = jax.tree.map(aggregate, jax.tree.map(
            jnp.asarray, stacked_grads(variables, 1, s)))
        params, state = update(params, grads, state, hyper)
    return params


def test_grads_only_int8_step_is_bit_exact_world1():
    # Quantize, the one-rank dequantize-sum and the SGD update round once
    # per element on both sides, so the parameters are bit-identical to
    # the JAX package's codec and update run one at a time. The whole
    # jitted JAX step also fuses the dequantize product into the update
    # and contracts it to a fused multiply-add (its identity step differs
    # from the unfused one in the same way), hence rtol 1e-6, atol 1e-7
    # against it.
    model = torch_resnet()
    opt = SGD(model, code=get_codec("int8"), device="cpu", **HYPER)
    _, variables = jax_resnet()
    for s in range(STEPS):
        opt.step(grads=torch_grads(model, stacked_grads(variables, 1, s)))
    assert_params_close(model, _jax_int8_steps_op_by_op(), rtol=0, atol=0)
    assert_params_close(model, jax_grads_only(1, "int8"), rtol=1e-6,
                        atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(cls="sgd", average=True, code="sign", lr=0.05),
    dict(cls="sgd", clip_norm=0.5, code="sign", lr=0.05, momentum=0.9),
    dict(cls="sgd", code="identity", lr=0.05, weight_decay=1e-3),
    dict(cls="sgd", code="bf16", lr=0.05),
    dict(cls="adam", code="sign", lr=1e-3, amsgrad=True),
    dict(cls="sgd", code="int8", lr=0.05, momentum=0.9),
    dict(cls="sgd", code="ef_topk", lr=0.05, momentum=0.9),
], ids=["average", "clip_norm", "identity", "bf16_psum", "adam", "int8",
        "ef_topk"])
def test_grads_only_options_match_jax(kw):
    kw = dict(kw)
    cls, code = kw.pop("cls"), kw.pop("code")
    variables, model = mlp_pair()
    jcls, tcls = (JSGD, SGD) if cls == "sgd" else (JAdam, Adam)
    jopt = jcls(jax.tree.map(jnp.asarray, variables),
                code=make_codec(code, jax_codec),
                mesh=make_mesh(devices=jax.devices()[:1]), **kw)
    opt = tcls(model, code=make_codec(code, get_codec), device="cpu", **kw)
    for s in range(STEPS):
        jg = stacked_grads(variables, 1, s)
        _, jdata_ = jopt.step(grads=jax.tree.map(jnp.asarray, jg))
        _, data = opt.step(grads=torch_grads(model, jg))
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)
    assert set(data) == set(jdata_)
    for key in ("msg_bytes", "packaged_bytes", "wire_lowering",
                "wire_bytes_per_worker", "agg_launches"):
        assert data[key] == jdata_[key], key


def test_adafactor_grads_only_matches_jax():
    from pytorch_ps_mpi_tpu import Adafactor as JAdafactor

    variables, model = mlp_pair()
    jopt = JAdafactor(jax.tree.map(jnp.asarray, variables),
                      mesh=make_mesh(devices=jax.devices()[:1]))
    opt = Adafactor(model, device="cpu")
    for s in range(STEPS):
        jg = stacked_grads(variables, 1, s)
        jopt.step(grads=jax.tree.map(jnp.asarray, jg))
        opt.step(grads=torch_grads(model, jg))
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)


def test_state_dict_round_trip_resumes_identically():
    variables, model = mlp_pair()
    opt = SGD(model, code=get_codec("sign"), device="cpu", **HYPER)
    opt.step(grads=torch_grads(model, stacked_grads(variables, 1, 0)))
    saved = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in opt.state_dict().items()}
    saved["params"] = {k: p.clone() for k, p in opt.params.items()}
    saved["opt_state"] = (saved["opt_state"][0],
                          {k: b.clone()
                           for k, b in saved["opt_state"][1].items()})
    g1 = torch_grads(model, stacked_grads(variables, 1, 1))
    opt.step(grads=g1)
    after = {k: p.clone() for k, p in opt.params.items()}
    opt.load_state_dict(saved)
    assert opt.state_dict()["step_count"] == 1
    opt.step(grads=g1)
    for k, p in opt.params.items():
        assert torch.equal(p, after[k]), k


def test_qsgd_static_metrics_match_jax():
    # QSGD draws other random numbers than JAX, so only the byte
    # accounting is compared
    variables, model = mlp_pair()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), code=jax_codec("qsgd"),
                mesh=make_mesh(devices=jax.devices()[:1]), lr=0.05)
    opt = SGD(model, code=get_codec("qsgd"), device="cpu", lr=0.05)
    g = stacked_grads(variables, 1, 0)
    _, jdata_ = jopt.step(grads=jax.tree.map(jnp.asarray, g))
    _, data = opt.step(grads=torch_grads(model, g))
    for key in ("msg_bytes", "packaged_bytes", "wire_lowering",
                "wire_bytes_per_worker", "agg_launches"):
        assert data[key] == jdata_[key], key


def test_error_feedback_memory_lives_on_the_param_device_and_round_trips():
    variables, model = mlp_pair()
    code = make_codec("ef_topk", get_codec)
    # init_state makes the memory where it is told to
    assert code.init_state((4, 4), torch.float32,
                           torch.device("meta"))["memory"].is_meta
    opt = SGD(model, code=code, device="cpu", **HYPER)
    for name, p in opt.params.items():
        mem = opt.codec_state[name]["memory"]
        assert mem.device == p.device and mem.shape == p.shape
        assert not mem.any()
    opt.step(grads=torch_grads(model, stacked_grads(variables, 1, 0)))
    saved = opt.state_dict()
    saved = {**saved,
             "params": {k: p.clone() for k, p in saved["params"].items()},
             "opt_state": (saved["opt_state"][0],
                           {k: b.clone()
                            for k, b in saved["opt_state"][1].items()}),
             "codec_state": {k: {"memory": s["memory"].clone(), "inner": ()}
                             for k, s in saved["codec_state"].items()}}
    assert any(s["memory"].any() for s in saved["codec_state"].values())
    g1 = torch_grads(model, stacked_grads(variables, 1, 1))
    opt.step(grads=g1)
    after = {k: p.clone() for k, p in opt.params.items()}
    memory = {k: s["memory"].clone() for k, s in opt.codec_state.items()}
    opt.load_state_dict(saved)
    for k, s in opt.codec_state.items():
        assert torch.equal(s["memory"], saved["codec_state"][k]["memory"])
        assert s["memory"] is not saved["codec_state"][k]["memory"]
    opt.step(grads=g1)
    for k, p in opt.params.items():
        assert torch.equal(p, after[k]), k
        assert torch.equal(opt.codec_state[k]["memory"], memory[k]), k


@pytest.mark.parametrize("kw", [
    dict(mode="leader"), dict(bucket_mb=4.0), dict(numerics=True),
    dict(param_specs={}), dict(instrument=True), dict(axis_name=("a", "b")),
])
def test_unported_options_raise(kw):
    _, model = mlp_pair()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SGD(model, device="cpu", **kw)


@pytest.mark.parametrize("call", ["profile", "aux_state", "step_accumulate",
                                  "run_steps"])
def test_unported_step_paths_raise(call):
    variables, model = mlp_pair()
    opt = SGD(model, device="cpu", lr=0.1)
    grads = torch_grads(model, stacked_grads(variables, 1, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "profile":
            opt.step(grads=grads, profile=True)
        elif call == "aux_state":
            opt.step(grads=grads, aux_state={})
        else:
            getattr(opt, call)(None, None)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    _, model = mlp_pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPI_PS(model, lr=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tdata.synthetic_images("mnist", 2))


def test_bad_arguments_raise():
    variables, model = mlp_pair()
    with pytest.raises(ValueError):
        SGD(model, device="cpu", clip_norm=-1.0)
    with pytest.raises(ValueError):
        SGD(model, device="cpu", optim="lamb")
    opt = SGD(model, device="cpu")
    with pytest.raises(ValueError):
        opt.step()
    with pytest.raises(ValueError):
        opt.step(grads={n: torch.zeros((3,) + tuple(p.shape))
                        for n, p in model.named_parameters()})

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
Adam with TernGrad (``use_pallas=True``, chunked leaves) on the tiny BERT
through ``step(loss_fn=...)``: the port's payloads, run through the JAX
codec's ``aggregate``/``agg_decode`` and the JAX ``adam_update``, give
the port's parameters to rtol 1e-6 after 2 steps (BERT keeps
flax's layouts, so a payload is the same array in both packages).
(d) the options the port does not have yet raise ``NotImplementedError``
    (``bucket_mb`` and ``mode="leader"`` are in ``test_torch_bucketing.py``
    and ``test_torch_leader.py``); a grads-only step with ``aux_state``
    raises as in the JAX package.
(e) the default ``device="cuda"`` raises when there is no GPU.
Also: the grads-only options (average, clip_norm, weight decay, bf16
psum, Adam, Adafactor, int8, error feedback around top-k) on a small MLP
with the metrics' byte counts (QSGD's too), the state_dict round trip,
and error feedback's memory on the parameters' device through a
state_dict round trip.
Last, the training entry points (``instrument``, ``run_steps``,
``step_accumulate``; see the comment above their tests).
"""

from __future__ import annotations

import numpy as np
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
from torch_parity import (ADAM, HYPER, STEPS, TERN_KW, assert_params_close,
                          bert_batch, bert_loss_fn, jax_bert, jax_grads_only,
                          jax_replay_terngrad_adam, jax_resnet, make_codec,
                          mlp_pair, record_payloads, stacked_grads,
                          torch_bert, torch_grads, torch_resnet)


def test_grads_only_sign_step_matches_jax_world1():
    model = torch_resnet()
    opt = SGD(model, code=get_codec("sign"), device="cpu", **HYPER)
    _, variables = jax_resnet()
    for s in range(STEPS):
        loss, data = opt.step(grads=torch_grads(
            model, stacked_grads(variables, 1, s)))
        assert loss is None and data["wire_lowering"] == "allgather"
    assert_params_close(model, jax_grads_only(1), rtol=1e-6, atol=1e-7)


def test_adam_terngrad_loss_fn_step_on_tiny_bert_matches_jax_world1():
    model = torch_bert()
    sent = []
    code = record_payloads(get_codec("terngrad", **TERN_KW), sent)
    opt = Adam(model, code=code, device="cpu", **ADAM)
    names = list(opt.params)
    steps = []
    for s in range(2):
        loss, _ = opt.step(loss_fn=bert_loss_fn(model), batch=bert_batch(s))
        assert loss is not None and torch.isfinite(loss)
        steps.append([sent[-len(names):]])
    jparams = jax_replay_terngrad_adam(jax_bert()[1], names, steps)
    assert_params_close(model, jparams, rtol=1e-6, atol=1e-7)
    # chunked leaves with ragged tails, and both layouts, were on the path
    assert code._pallas_ok(65536) and not code._pallas_ok(192)
    assert opt.params["tok_emb.embedding"].numel() >= code.scan_threshold


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
    dict(numerics=True), dict(param_specs={}), dict(batch_spec=("data",)),
    dict(axis_name=("a", "b")),
])
def test_unported_options_raise(kw):
    _, model = mlp_pair()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SGD(model, device="cpu", **kw)


@pytest.mark.parametrize("call", ["profile", "aux_state", "step_accumulate",
                                  "run_steps"])
def test_unported_step_paths_raise(call):
    """``profile=True`` is not ported (it names its ROADMAP item); a
    grads-only step has no forward pass to give new aux state (JAX
    ``ps.py:2036-2041``); ``run_steps`` needs one leading step axis."""
    variables, model = mlp_pair()
    opt = SGD(model, device="cpu", lr=0.1)
    grads = torch_grads(model, stacked_grads(variables, 1, 0))
    if call == "profile":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            opt.step(grads=grads, profile=True)
    elif call == "aux_state":
        with pytest.raises(NotImplementedError, match="loss_fn path"):
            opt.step(grads=grads, aux_state={})
    elif call == "step_accumulate":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            opt.step_accumulate(None, None, profile=True)
    else:
        with pytest.raises(ValueError, match="leading"):
            opt.run_steps(None, (torch.zeros(2, 1), torch.zeros(3, 1)))


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


# -- the training entry points: instrument, run_steps, step_accumulate ------------
#
# The oracles are the JAX package's own (``test_ps.py:172,191,203,238,275,
# 302,332``): the staged pipeline equals the fused step, N ``run_steps``
# steps equal N ``step`` calls, and accumulated microbatches equal one big
# batch. Within the port these hold bit for bit (the same kernels and the
# same random numbers in the same order); against the JAX package on the
# MLP to rtol 1e-6 (1e-5 for the losses of 4 steps), its matmul gradients
# rounding apart.

def _mlp_loss(model):
    def loss_fn(p, b):
        return tdata.cross_entropy_loss(
            torch.func.functional_call(model, p, (b[0],)), b[1])
    return loss_fn


def _jax_mlp_loss(features=(48, 10)):
    from pytorch_ps_mpi_tpu import data as jd
    from pytorch_ps_mpi_tpu import models as jm

    jmodel = jm.MLP(features=features)

    def loss_fn(p, b):
        return jd.cross_entropy_loss(jmodel.apply(p, b[0]), b[1])
    return loss_fn


def _mnist(n, batch=8, seed=0):
    it = tdata.synthetic_images("mnist", batch, seed=seed, device="cpu")
    return [next(it) for _ in range(n)]


def _stack(batches):
    return tuple(torch.stack(t) for t in zip(*batches))


def _same(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


STAGED = [("identity", {}), ("sign", {}), ("qsgd", {}),
          ("identity", dict(bucket_mb=0.05)), ("int8", dict(mode="leader")),
          ("identity", dict(mode="leader", bucket_mb=0.05)),
          ("sign", dict(clip_norm=0.5, average=True))]


@pytest.mark.parametrize("code,kw", STAGED, ids=[
    "identity", "sign", "qsgd", "identity_bucketed", "int8_leader",
    "identity_leader_bucketed", "sign_clip_average"])
def test_instrumented_step_equals_the_fused_step(code, kw):
    """Two loss steps and one grads-only step, staged and fused, from the
    same weights: the same parameters bit for bit, and every stage of the
    staged pipeline timed."""
    variables, model = mlp_pair()
    _, twin = mlp_pair()
    fused = SGD(model, code=get_codec(code), device="cpu", seed=3, **HYPER,
                **kw)
    staged = SGD(twin, code=get_codec(code), device="cpu", seed=3,
                 instrument=True, **HYPER, **kw)
    for b in _mnist(2):
        lf, _ = fused.step(loss_fn=_mlp_loss(model), batch=b)
        ls, data = staged.step(loss_fn=_mlp_loss(twin), batch=b)
        assert torch.equal(lf, ls)
    grads = torch_grads(model, stacked_grads(variables, 1, 0))
    fused.step(grads=grads)
    _, grads_data = staged.step(grads=grads)
    assert _same(fused.params, staged.params)
    keys = ["grad_time", "code_wait", "comm_wait", "optim_step_time"]
    if staged.code.supports_psum:
        assert data["wire_lowering"] == "psum_staged"
    else:
        assert data["wire_lowering"] == "payload_gather_staged"
        assert data["agg_launches"] == len(staged.params)
        keys += ["isend_time", "decode_time"]
    assert all(data[k] > 0 for k in keys), data
    assert "grad_time" not in grads_data and grads_data["comm_wait"] > 0
    assert sum(data[k] for k in keys if k != "isend_time") <= \
        data["step_time"]


@pytest.mark.parametrize("code,kw", [("sign", {}), ("identity", {}),
                                     ("int8", dict(mode="leader")),
                                     ("sign", dict(bucket_mb=0.05))],
                         ids=["sign", "identity", "int8_leader",
                              "sign_bucketed"])
def test_instrumented_grads_only_step_matches_jax(code, kw):
    variables, model = mlp_pair()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), code=jax_codec(code),
                mesh=make_mesh(devices=jax.devices()[:1]), instrument=True,
                **HYPER, **kw)
    opt = SGD(model, code=get_codec(code), device="cpu", instrument=True,
              **HYPER, **kw)
    for s in range(2):
        jg = stacked_grads(variables, 1, s)
        _, jd = jopt.step(grads=jax.tree.map(jnp.asarray, jg))
        _, data = opt.step(grads=torch_grads(model, jg))
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)
    for key in ("msg_bytes", "packaged_bytes", "wire_lowering",
                "wire_bytes_per_worker", "bucket_count", "agg_launches"):
        assert data[key] == jd[key], key


def _aux_loss(p, aux, b):
    """A loss with a running-mean aux channel (JAX ``test_ps.py:266``)."""
    x, y = b
    logits = x.reshape(x.shape[0], -1) @ p["w"] + p["b"]
    new_aux = {"mean": 0.9 * aux["mean"] + 0.1 * torch.mean(x)}
    return tdata.cross_entropy_loss(logits, y), new_aux


def _linear_params(seed=0):
    rs = np.random.RandomState(seed)
    return {"w": torch.from_numpy(rs.randn(784, 10).astype(np.float32)
                                  * 0.01),
            "b": torch.zeros(10)}


def test_instrumented_aux_and_accumulate_equal_the_fused_steps():
    """``instrument=True`` with ``aux_state`` (the aux pmean in the grad
    stage) and with ``step_accumulate`` (the accumulation is the grad
    stage; ``grad_time_per_microbatch`` its mean) equals the fused paths
    bit for bit."""
    b = _mnist(1)[0]
    fused = SGD(_linear_params(), device="cpu", **HYPER)
    staged = SGD(_linear_params(), device="cpu", instrument=True, **HYPER)
    aux0 = {"mean": torch.zeros(())}
    lf, _ = fused.step(loss_fn=_aux_loss, batch=b, aux_state=aux0)
    ls, data = staged.step(loss_fn=_aux_loss, batch=b, aux_state=aux0)
    assert torch.equal(lf, ls) and _same(fused.aux_state, staged.aux_state)
    assert float(staged.aux_state["mean"]) != 0.0
    assert data["grad_time"] > 0 and data["optim_step_time"] > 0
    staged.step(loss_fn=_aux_loss, batch=b, aux_state=staged.aux_state)
    fused.step(loss_fn=_aux_loss, batch=b, aux_state=fused.aux_state)
    assert _same(fused.params, staged.params)
    assert _same(fused.aux_state, staged.aux_state)

    def plain_loss(p, mb):
        return _aux_loss(p, aux0, mb)[0]

    micro = _stack(_mnist(2, seed=4))
    lf, _ = fused.step_accumulate(plain_loss, micro)
    ls, data = staged.step_accumulate(plain_loss, micro)
    assert torch.equal(lf, ls) and _same(fused.params, staged.params)
    assert data["accum_steps"] == 2
    assert data["grad_time_per_microbatch"] == pytest.approx(
        data["grad_time"] / 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        staged.step_accumulate(plain_loss, micro, profile=True)


@pytest.mark.parametrize("code", ["qsgd", "sign", "randomk", "terngrad"])
def test_run_steps_equals_a_loop_of_step_bit_for_bit(code):
    def make(name):
        return (get_codec(name, fraction=0.25) if name == "randomk"
                else get_codec(name))

    _, ma = mlp_pair()
    _, mb = mlp_pair()
    a = SGD(ma, code=make(code), device="cpu", seed=1, **HYPER)
    b = SGD(mb, code=make(code), device="cpu", seed=1, **HYPER)
    batches = _mnist(3)
    losses, data = a.run_steps(_mlp_loss(ma), _stack(batches))
    loop = [b.step(loss_fn=_mlp_loss(mb), batch=x)[0] for x in batches]
    assert torch.equal(losses, torch.stack(loop))
    assert _same(a.params, b.params)
    assert data["n_steps"] == 3 and data["steps_per_sec"] > 0
    assert a.state_dict()["step_count"] == 3
    if a._gen is not None:
        assert torch.equal(a._gen.get_state(), b._gen.get_state())


def test_run_steps_and_step_accumulate_match_jax():
    variables, model = mlp_pair()
    jloss = _jax_mlp_loss()
    batches = _mnist(4, batch=16)
    jbatches = tuple(jnp.asarray(t.numpy()) for t in _stack(batches))

    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                mesh=make_mesh(devices=jax.devices()[:1]), **HYPER)
    jlosses, _ = jopt.run_steps(jloss, jbatches)
    opt = SGD(model, device="cpu", **HYPER)
    losses, _ = opt.run_steps(_mlp_loss(model), _stack(batches))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    assert_params_close(model, jopt.params, rtol=1e-5, atol=1e-6)

    # 2 microbatches of 16 == one batch of 32, and == the JAX package's
    variables, model = mlp_pair()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), average=True,
                mesh=make_mesh(devices=jax.devices()[:1]), lr=0.05)
    jl, jd = jopt.step_accumulate(jloss, tuple(j[:2] for j in jbatches))
    opt = SGD(model, device="cpu", average=True, lr=0.05)
    micro = _stack(batches[:2])
    loss, data = opt.step_accumulate(_mlp_loss(model), micro)
    assert data["accum_steps"] == jd["accum_steps"] == 2
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)
    _, big_model = mlp_pair()
    big = SGD(big_model, device="cpu", average=True, lr=0.05)
    big_loss, _ = big.step(loss_fn=_mlp_loss(big_model), batch=(
        torch.cat([b[0] for b in batches[:2]]),
        torch.cat([b[1] for b in batches[:2]])))
    np.testing.assert_allclose(float(loss), float(big_loss), rtol=1e-6)
    for k, p in opt.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   big.params[k].detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode,codec,kw", [
    ("leader", "int8", {}),
    ("leader", "blocktopk8", {"fraction": 0.05, "block_size": 128}),
    ("allgather", "blocktopk8", {"fraction": 0.05, "block_size": 128})],
    ids=["leader_int8", "leader_blocktopk8", "allgather_blocktopk8"])
def test_run_steps_composes_with_lowerings(mode, codec, kw):
    """``run_steps`` under each lowering equals the step loop bit for bit
    (JAX ``test_ps.py:797``), and in leader mode the allgather step loop
    to rtol 1e-6 (``test_ps.py:438``)."""
    rs = np.random.RandomState(1)
    w = rs.randn(16, 8).astype(np.float32)
    batch = (torch.from_numpy(rs.randn(64, 16).astype(np.float32)),
             torch.from_numpy(rs.randn(64, 8).astype(np.float32)))

    def loss(p, b):
        return torch.mean((b[0] @ p["w"] - b[1]) ** 2)

    def make(m):
        return SGD({"w": torch.from_numpy(w.copy())}, lr=0.05, momentum=0.9,
                   mode=m, code=get_codec(codec, **kw), device="cpu")

    a, b = make(mode), make(mode)
    losses, _ = a.run_steps(loss, tuple(t.expand(4, *t.shape)
                                        for t in batch))
    loop = torch.stack([b.step(loss_fn=loss, batch=batch)[0]
                        for _ in range(4)])
    assert torch.equal(losses, loop) and _same(a.params, b.params)
    if mode == "leader":
        c = make("allgather")
        for _ in range(4):
            c.step(loss_fn=loss, batch=batch)
        np.testing.assert_allclose(a.params["w"].numpy(),
                                   c.params["w"].numpy(), rtol=1e-6,
                                   atol=1e-7)

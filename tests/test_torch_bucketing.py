"""The port's flat-bucket aggregation (``bucketing.py``,
``MPI_PS(bucket_mb=...)``) against the JAX package's, at world 1.

- Plans: offsets, sizes and dtypes equal the JAX ``plan_buckets`` on the
  same shapes: a mixed-dtype tree with a 0-d and odd-sized leaves, and
  ResNet-18's and BERT-base's leaves in JAX order at 4, 16 and 32 MB
  (shapes only: the port's models on the meta device, the JAX ones under
  ``jax.eval_shape``). Round trip bit-exact, dtype drift raises,
  ``bucket_mb=0`` gives no plan.
- psum codecs (identity, the bf16 cast, ``comm_dtype``, ``average``,
  ``clip_norm``) on the width-32 ResNet-18, 10 buckets at 1 MB: bit-exact
  against the port's own per-leaf step, and within rtol 1e-6, atol 1e-7
  of the JAX bucketed step (the jitted JAX update contracts into fused
  multiply-adds, ROADMAP queue 3 item 4). The metrics' byte counts equal
  the JAX package's.
- Adafactor bucketed on the tiny BERT, against the JAX bucketed step.
- sign and int8 on the ResNet: a bucket holds the JAX bucket's elements
  in the port's layout inside conv and dense leaves, so the payloads are
  compared per leaf after unflatten and layout mapping (int8 codes and
  sign bits exact, decoded values rtol 1e-6: the sign scale is a float
  sum in another order), and the parameters after 3 steps to rtol 1e-6.
- TernGrad (``use_pallas=True``, chunked and both layouts) on the tiny
  BERT through ``step(loss_fn=...)``: the port's per-bucket payloads,
  replayed through the JAX ``decode_sum_payloads``,
  ``unflatten_from_buckets`` and ``adam_update``, give the port's
  parameters to rtol 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import Adafactor as JAdafactor
from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu import optim as jax_optim
from pytorch_ps_mpi_tpu import bucketing as jb
from pytorch_ps_mpi_tpu import ps as jps
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import SGD, Adam, Adafactor
from pytorch_ps_mpi_tpu_torch import bucketing as tb
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.utils.interop import (flax_layout, flax_path,
                                                    jax_leaf_order,
                                                    params_from_jax)
from torch_parity import (ADAM, HYPER, STEPS, TERN_KW, assert_params_close,
                          bert_batch, bert_loss_fn, jax_bert, jax_resnet,
                          record_payloads, stacked_grads, torch_bert,
                          torch_grads)

#: the width-32 ResNet-18 in 10 buckets, 6 of them a multiple of 1024
RESNET_MB = 1.0
#: the tiny BERT in 10 buckets: sublane- and flat-layout TernGrad buckets,
#: whole and chunked
BERT_MB = 0.05


def _mixed_shapes():
    """``tests/test_bucketing.py``'s mixed tree, in JAX (sorted) order:
    a bf16 leaf, a 0-d leaf and odd sizes."""
    return {"b1": ((17,), "float32"), "big": ((4096,), "float32"),
            "h": ((999,), "bfloat16"), "s": ((), "float32"),
            "w1": ((300, 17), "float32")}


def _mixed_pair():
    rng = np.random.RandomState(0)
    arrays = {k: np.asarray(rng.randn(*shape), np.float32)
              for k, (shape, _) in _mixed_shapes().items()}
    jtree = {k: jnp.asarray(a, dtype=getattr(jnp, _mixed_shapes()[k][1]))
             for k, a in arrays.items()}
    ttree = {k: torch.from_numpy(np.asarray(a)).to(
        getattr(torch, _mixed_shapes()[k][1])) for k, a in arrays.items()}
    return jtree, ttree


def _model_shapes(name: str):
    """(port meta-tensor dict in JAX leaf order, JAX shape tree)."""
    if name == "resnet18":
        model = tm.ResNet18(num_classes=10, small_inputs=True, device="meta")
        jtree = jax.eval_shape(
            jm.ResNet18(num_classes=10, small_inputs=True).init,
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    else:
        model = tm.BertMLM(tm.BertConfig(), device="meta")
        jtree = jax.eval_shape(jm.BertMLM(jm.BertConfig.base()).init,
                               jax.random.key(0),
                               jnp.zeros((1, 16), jnp.int32))
    named = dict(model.named_parameters())
    return {n: named[n] for n in jax_leaf_order(model)}, jtree


#: (model, bucket_mb) -> the JAX plan's bucket sizes on the full models
FULL_PLANS = {
    ("resnet18", 4): [976330, 624128, 589824, 591872, 1179648, 2359296,
                      134144, 2359296, 2359296, 128],
    ("resnet18", 16): [3961802, 2493440, 2359296, 2359424],
    ("resnet18", 32): [6455242, 4718720],
    ("bert_base", 16): [2364672] + [2955264, 4132608] * 11
    + [2955264, 1799994, 23440896, 393216, 23440896],
    ("bert_base", 32): [7092480] + [7087872] * 10
    + [7115322, 23440896, 393216, 23440896],
}


@pytest.mark.parametrize("case", [
    ("mixed", 0.01), ("mixed", 0.02), ("resnet18", 4), ("resnet18", 16),
    ("resnet18", 32), ("bert_base", 4), ("bert_base", 16),
    ("bert_base", 32)], ids=lambda c: f"{c[0]}-{c[1]}MB")
def test_plan_matches_jax(case):
    name, mb = case
    if name == "mixed":
        jtree, ttree = _mixed_pair()
    else:
        ttree, jtree = _model_shapes(name)
    got, want = tb.plan_buckets(ttree, mb), jb.plan_buckets(jtree, mb)
    assert [(s.bucket, s.offset, s.size) for s in got.leaf_slots] == \
        [(s.bucket, s.offset, s.size) for s in want.leaf_slots]
    assert [(b.size, str(b.dtype).replace("torch.", ""), b.nbytes)
            for b in got.buckets] == \
        [(b.size, jnp.dtype(b.dtype).name, b.nbytes) for b in want.buckets]
    assert got.total_bytes == want.total_bytes
    if (name, mb) in FULL_PLANS:
        assert [b.size for b in got.buckets] == FULL_PLANS[(name, mb)]
    if name == "mixed":
        # the 0-d leaf takes one element; the bf16 leaf its own group
        s = got.leaf_slots[got.names.index("s")]
        assert (s.size, s.shape) == (1, ())
        assert {b.dtype for b in got.buckets} == {torch.float32,
                                                  torch.bfloat16}


def test_plan_round_trip_is_bit_exact_and_unpacks_views():
    _, tree = _mixed_pair()
    plan = tb.plan_buckets(tree, 0.02)
    assert plan.num_buckets < plan.num_leaves
    buckets = tb.flatten_into_buckets(plan, tree)
    assert [b.dtype for b in buckets] == [b.dtype for b in plan.buckets]
    back = tb.unflatten_from_buckets(plan, buckets)
    assert list(back) == list(tree)
    for k, v in tree.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype
        assert torch.equal(back[k], v), k
        # a view into its bucket: unpacking copies nothing
        slot = plan.leaf_slots[plan.names.index(k)]
        assert back[k].data_ptr() == (buckets[slot.bucket].data_ptr()
                                      + slot.offset * v.element_size())
    templates = plan.bucket_templates()
    assert [(t.shape, t.dtype, t.is_meta) for t in templates] == \
        [((b.size,), b.dtype, True) for b in plan.buckets]


def test_plan_rejects_dtype_drift_and_leaf_count():
    _, tree = _mixed_pair()
    plan = tb.plan_buckets(tree, 0.01)
    with pytest.raises(TypeError):
        tb.flatten_into_buckets(plan, dict(tree, h=torch.zeros(999)))
    with pytest.raises(ValueError):
        plan.pack_leaves(list(tree.values())[:-1])
    with pytest.raises(ValueError):
        plan.unpack_leaves([torch.zeros(1)])


def test_bucket_mb_zero_is_the_per_leaf_path():
    _, tree = _mixed_pair()
    assert tb.plan_buckets(tree, 0) is None
    assert tb.plan_buckets(tree, None) is None
    opt = SGD({k: v.clone() for k, v in tree.items()}, lr=0.1, bucket_mb=0,
              device="cpu")
    assert opt._bucket_plan is None
    with pytest.raises(ValueError):
        SGD({k: v.clone() for k, v in tree.items()}, bucket_mb=-1.0,
            device="cpu")


# -- steps on the width-32 ResNet-18 -------------------------------------------------

def _resnet_params():
    """The port's width-32 ResNet-18 and its parameters in JAX leaf
    order."""
    model = tm.ResNet18(num_classes=10, num_filters=32, small_inputs=True,
                        device="cpu")
    return model, params_from_jax(jax_resnet()[1], model)


PSUM_CASES = {
    "identity": dict(code="identity"),
    "bf16": dict(code="bf16"),
    "comm_dtype": dict(code="identity", comm_dtype="bfloat16"),
    "average": dict(code="identity", average=True),
    "clip_norm": dict(code="identity", clip_norm=0.05),
}


def _split(kw):
    kw = dict(kw)
    code = kw.pop("code")
    dtype = kw.pop("comm_dtype", None)
    return code, dtype, kw


@pytest.mark.parametrize("case", list(PSUM_CASES))
def test_bucketed_psum_step_is_bit_exact_and_matches_jax(case):
    code, dtype, kw = _split(PSUM_CASES[case])
    _, variables = jax_resnet()
    opts = []
    for mb in (0.0, RESNET_MB):
        model, params = _resnet_params()
        opts.append((model, SGD(
            params, code=get_codec(code), bucket_mb=mb, device="cpu",
            comm_dtype=getattr(torch, dtype) if dtype else None,
            **HYPER, **kw)))
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), code=jax_codec(code),
                mesh=make_mesh(devices=jax.devices()[:1]), bucket_mb=RESNET_MB,
                comm_dtype=getattr(jnp, dtype) if dtype else None,
                **HYPER, **kw)
    for s in range(STEPS):
        jg = stacked_grads(variables, 1, s)
        for model, opt in opts:
            _, data = opt.step(grads=torch_grads(model, jg))
        _, jdata = jopt.step(grads=jax.tree.map(jnp.asarray, jg))
    (_, leaf), (model, bucketed) = opts
    for k, p in bucketed.params.items():
        assert torch.equal(p, leaf.params[k]), k
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)
    assert data["bucket_count"] == 10 == bucketed._bucket_plan.num_buckets
    for key in ("msg_bytes", "packaged_bytes", "wire_lowering",
                "wire_bytes_per_worker", "bucket_count", "bucket_bytes_total",
                "agg_launches"):
        assert data[key] == jdata[key], key


def _jax_encode_bucket(code, grads_tree, plan):
    """The JAX codec's payload of every bucket of ``grads_tree`` (world 1),
    jitted as the step compiles it."""
    encode = jax.jit(lambda b: code.encode(b)[0])
    return [encode(b) for b in jb.flatten_into_buckets(plan, grads_tree)]


def _per_leaf_flax(model, plan, buckets):
    """Port buckets (numpy or tensors) unflattened and mapped to flax
    layout: ``name -> array``."""
    tensors = [torch.as_tensor(np.asarray(b)) for b in buckets]
    return {n: flax_layout(flax_path(model, n), v.numpy())
            for n, v in tb.unflatten_from_buckets(plan, tensors).items()}


def _jax_per_leaf(model, plan, jplan, buckets):
    tree = jb.unflatten_from_buckets(jplan, [jnp.asarray(b) for b in buckets])
    out = {}
    for n in plan.names:
        node = tree["params"]
        for key in flax_path(model, n):
            node = node[key]
        out[n] = np.asarray(node)
    return out


def _jax_per_leaf_tree(tree, name: str) -> np.ndarray:
    """The leaf of a flax variables tree at a BERT parameter's name."""
    node = tree["params"]
    for key in name.split("."):
        node = node[key]
    return np.asarray(node)


@pytest.mark.parametrize("codec", ["sign", "int8"])
def test_bucketed_lossy_codec_matches_jax_per_leaf(codec):
    model, params = _resnet_params()
    _, variables = jax_resnet()
    sent = []
    code = record_payloads(get_codec(codec), sent)
    opt = SGD(params, code=code, bucket_mb=RESNET_MB, device="cpu", **HYPER)
    plan = opt._bucket_plan
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), code=jax_codec(codec),
                mesh=make_mesh(devices=jax.devices()[:1]), bucket_mb=RESNET_MB,
                **HYPER)
    jplan, jc = jopt._bucket_plan, jax_codec(codec)
    for s in range(STEPS):
        jg = stacked_grads(variables, 1, s)
        start = len(sent)
        opt.step(grads=torch_grads(model, jg))
        # this step's payloads, against the JAX encode of the same buckets
        mine = sent[start:]
        assert len(mine) == plan.num_buckets
        theirs = _jax_encode_bucket(jc, jax.tree.map(lambda g: g[0], jg),
                                    jplan)
        if codec == "int8":
            got = _per_leaf_flax(model, plan, [p["q"] for p in mine])
            want = _jax_per_leaf(model, plan, jplan,
                                 [t["q"] for t in theirs])
            for n in got:
                np.testing.assert_array_equal(got[n], want[n], err_msg=n)
            np.testing.assert_array_equal(
                [float(p["scale"]) for p in mine],
                [float(t["scale"]) for t in theirs])
        dec = [code.decode({k: torch.from_numpy(v) for k, v in p.items()},
                           (b.size,), torch.float32)
               for p, b in zip(mine, plan.buckets)]
        jdec = [jc.decode(t, (b.size,), jnp.float32)
                for t, b in zip(theirs, jplan.buckets)]
        got = _per_leaf_flax(model, plan, dec)
        want = _jax_per_leaf(model, plan, jplan, jdec)
        for n in got:
            np.testing.assert_array_equal(got[n] > 0, want[n] > 0, err_msg=n)
            np.testing.assert_allclose(got[n], want[n], rtol=1e-6, err_msg=n)
        jopt.step(grads=jax.tree.map(jnp.asarray, jg))
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)


def test_per_tensor_and_stateful_codecs():
    _, tree = _mixed_pair()
    tree = {k: v.float() for k, v in tree.items()}
    # top-k and error feedback are not bucketable: the per-leaf path
    opt = SGD({k: v.clone() for k, v in tree.items()},
              code=get_codec("ef", inner=get_codec("topk", fraction=0.5)),
              bucket_mb=0.01, device="cpu")
    assert opt._bucket_plan is None
    _, data = opt.step(grads={k: v[None] for k, v in tree.items()})
    assert data["bucket_count"] == 0 and data["agg_launches"] == len(tree)

    class Stateful(type(get_codec("sign"))):
        def init_state(self, shape, dtype, device=None):
            return {"memory": torch.zeros(shape, dtype=dtype, device=device)}

    with pytest.raises(TypeError, match="stateless"):
        SGD({k: v.clone() for k, v in tree.items()}, code=Stateful(),
            bucket_mb=0.01, device="cpu")


# -- the tiny BERT ------------------------------------------------------------------------

def test_bucketed_adafactor_matches_jax_on_tiny_bert():
    _, variables = jax_bert()
    model = torch_bert()
    params = params_from_jax(variables, model)
    leaf = {k: p.detach().clone() for k, p in params.items()}
    opts = [Adafactor(params, bucket_mb=BERT_MB, device="cpu"),
            Adafactor(leaf, device="cpu")]
    assert opts[0]._bucket_plan.num_buckets == 10
    jopt = JAdafactor(jax.tree.map(jnp.asarray, variables),
                      mesh=make_mesh(devices=jax.devices()[:1]),
                      bucket_mb=BERT_MB)
    names = list(params)
    for s in range(STEPS):
        jg = stacked_grads(variables, 1, s)
        # BERT keeps flax's layouts: a leaf's gradient crosses unchanged
        grads = {n: torch.from_numpy(_jax_per_leaf_tree(jg, n))
                 for n in names}
        for opt in opts:
            opt.step(grads=grads)
        jopt.step(grads=jax.tree.map(jnp.asarray, jg))
    for n in names:
        assert torch.equal(opts[0].params[n], opts[1].params[n]), n
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)


def _jax_replay_bucketed_adam(variables, bucket_mb, steps):
    """The JAX package's parameters after the port's per-bucket TernGrad
    payloads (``steps``: per step, per rank, one payload a bucket) run
    through the JAX codec's ``decode_sum_payloads``,
    ``unflatten_from_buckets`` and ``adam_update``."""
    jc = jax_codec("terngrad", **TERN_KW)
    hyper_cls, init, update = jax_optim.OPTIMIZERS["adam"]
    params = jax.tree.map(jnp.asarray, variables)
    plan = jb.plan_buckets(params, bucket_mb)
    state, h = init(params), hyper_cls(**ADAM)

    @jax.jit
    def aggregate(stacked):
        return jb.unflatten_from_buckets(plan, [
            jps.decode_sum_payloads(jc, st, (b.size,), b.dtype)
            for st, b in zip(stacked, plan.buckets)])

    update = jax.jit(update, static_argnums=3)
    for ranks in steps:
        stacked = [{k: jnp.stack([jnp.asarray(r[i][k]) for r in ranks])
                    for k in ranks[0][i]} for i in range(plan.num_buckets)]
        params, state = update(params, aggregate(stacked), state, h)
    return params


def test_bucketed_adam_terngrad_loss_fn_step_matches_jax_replay():
    _, variables = jax_bert()
    model = torch_bert()
    params = params_from_jax(variables, model)
    sent = []
    code = record_payloads(get_codec("terngrad", **TERN_KW), sent)
    opt = Adam(params, code=code, bucket_mb=BERT_MB, device="cpu", **ADAM)
    plan = opt._bucket_plan
    sizes = [b.size for b in plan.buckets]
    # chunked and whole buckets, in both layouts, are on the path
    assert any(n % 512 == 0 and n >= code.scan_threshold for n in sizes)
    assert any(n % 512 and n >= code.scan_threshold for n in sizes)
    assert any(n % 512 == 0 and n < code.scan_threshold for n in sizes)
    assert any(n % 512 and n < code.scan_threshold for n in sizes)
    steps = []
    for s in range(2):
        loss, data = opt.step(loss_fn=bert_loss_fn(model), batch=bert_batch(s))
        assert torch.isfinite(loss)
        steps.append([sent[-plan.num_buckets:]])
    assert len(sent) == 2 * plan.num_buckets
    assert data["packaged_bytes"] == sum(
        code.payload_bits((n,), torch.float32) // 8 for n in sizes)
    assert_params_close(model,
                        _jax_replay_bucketed_adam(variables, BERT_MB, steps),
                        rtol=1e-6, atol=1e-7)

"""The port's ``BertMLM`` against the JAX package's, with the flax
weights carried across by ``params_from_jax`` (the port keeps flax's
names and layouts, so every leaf crosses unchanged).

float32, ``BertConfig.tiny(attention="flash")`` (2 layers, 4 heads of
16, seq 32; the JAX flash kernel in interpret mode) and the dense
``"full"`` path: logits to rtol 1e-5 / atol 1e-5 and ``mlm_loss`` to
rtol 1e-6, gradients leaf by leaf in JAX leaf order to rtol 1e-4 / atol
2e-5 of the leaf's largest element (measured: 1.8e-6). The two
frameworks sum the matmuls in another order and flax's LayerNorm takes
the variance as E[x²] − E[x]² where PyTorch takes E[(x − E[x])²]; at
this size the activations' means are small and the two agree to a few
ulps.

bfloat16 compute (float32 parameters): the logits agree to 0.02 of their
largest magnitude (measured 0.011, about 1.5 bf16 ulps at the largest
logit) and the loss to rtol 1e-3 (measured 2.6e-4). Both models round
every activation to bf16 (8 bits of mantissa, 2**-9 relative), but at
places the frameworks choose differently (XLA's CPU dot rounds its bf16
output once, the GELU and softmax run in bf16 in JAX and in float32
inside PyTorch's kernels), so the two differ by a few bf16 ulps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu.models.bert import mlm_loss as jax_mlm_loss
from pytorch_ps_mpi_tpu_torch import data as tdata
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.models.bert import dense_attention
from pytorch_ps_mpi_tpu_torch.utils.interop import (jax_leaf_order,
                                                    params_to_jax)
from torch_parity import bert_batch as _batch
from torch_parity import jax_bert, torch_bert


def _jax_loss(jmodel, variables, b):
    logits = jmodel.apply(variables, jnp.asarray(b["tokens"].numpy()))
    return jax_mlm_loss(logits, jnp.asarray(b["targets"].numpy()),
                        jnp.asarray(b["mask"].numpy())), logits


def test_synthetic_mlm_matches_jax():
    from pytorch_ps_mpi_tpu.data import synthetic_mlm

    ours = tdata.synthetic_mlm(3, 16, 500, seed=4, device="cpu")
    theirs = synthetic_mlm(3, 16, 500, seed=4)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        for key in ("tokens", "targets", "mask"):
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
        assert a["tokens"].dtype == torch.int64 and a["mask"].dtype == torch.bool


def test_leaf_order_names_and_round_trip_are_flax_own():
    model = torch_bert()
    _, variables = jax_bert()
    paths = [tuple(n.split(".")) for n in jax_leaf_order(model)]
    flat, _ = jax.tree_util.tree_flatten_with_path(variables["params"])
    assert paths == [tuple(k.key for k in path) for path, _ in flat]
    assert paths.index(("layer_1", "Dense_0", "bias")) < \
        paths.index(("tok_emb", "embedding"))
    back = params_to_jax(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bert_base_has_the_jax_parameter_shapes():
    cfg = jm.BertConfig.base()
    shapes = jax.eval_shape(jm.BertMLM(cfg).init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    want = {"/".join(k.key for k in path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = tm.BertMLM(tm.BertConfig.base(), device="cpu")
    got = {n.replace(".", "/"): tuple(p.shape)
           for n, p in model.named_parameters()}
    assert got == want
    assert len(got) == 150
    assert sum(p.numel() for p in model.parameters()) == 132_361_530


@pytest.mark.parametrize("attention", ["flash", "full"])
def test_logits_loss_and_gradients_match_jax_f32(attention):
    jmodel, variables = jax_bert("float32", attention)
    model = torch_bert("float32", attention)
    b = _batch()
    params = {n: p.detach().requires_grad_() for n, p in
              model.named_parameters()}
    logits = torch.func.functional_call(model, params, (b["tokens"],))
    loss = tm.mlm_loss(logits, b["targets"], b["mask"])
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jloss, jlogits = _jax_loss(jmodel, variables, b)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    jgrads = jax.jit(jax.grad(lambda v: _jax_loss(jmodel, v, b)[0]))(variables)
    jflat = dict((tuple(k.key for k in path[1:]), np.asarray(g)) for path, g
                 in jax.tree_util.tree_flatten_with_path(jgrads)[0])
    for name in jax_leaf_order(model):
        want = jflat[tuple(name.split("."))]
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_logits_and_loss_match_jax_bf16():
    jmodel, variables = jax_bert("bfloat16", "flash")
    model = torch_bert("bfloat16", "flash")
    b = _batch(1)
    with torch.no_grad():
        logits = model(b["tokens"])
        loss = tm.mlm_loss(logits, b["targets"], b["mask"])
    jloss, jlogits = _jax_loss(jmodel, variables, b)
    assert logits.dtype == torch.float32
    jl = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jl, rtol=0,
                               atol=0.02 * np.abs(jl).max())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)


def test_flash_and_dense_attention_agree_and_modes_raise():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 32, 4, 16).astype(np.float32))
               for _ in range(3))
    from pytorch_ps_mpi_tpu_torch.ops.attention import flash_attention

    for causal in (False, True):
        torch.testing.assert_close(flash_attention(q, k, v, causal=causal),
                                   dense_attention(q, k, v, causal),
                                   rtol=2e-5, atol=2e-5)
    # ported: ring and Ulysses at one rank, and scan_layers, compute the
    # full model's function (the multi-rank forms: test_torch_ring.py,
    # test_torch_ulysses.py)
    tokens = torch.from_numpy(rng.randint(0, 1024, (1, 32)))
    want = tm.BertMLM(tm.BertConfig.tiny(), device="cpu")(tokens)
    for kw in (dict(attention="ring"), dict(attention="ulysses"),
               dict(scan_layers=True)):
        model = tm.BertMLM(tm.BertConfig.tiny(**kw), device="cpu")
        torch.testing.assert_close(model(tokens), want, rtol=1e-5,
                                   atol=1e-5)
    model = tm.BertMLM(tm.BertConfig.tiny(attention="flash",
                                          dtype=torch.bfloat16), device="cpu")
    with pytest.raises(ValueError, match="cannot tile"):
        model(torch.zeros(1, 24, dtype=torch.int64))
    with pytest.raises(ValueError, match="unknown attention"):
        tm.BertMLM(tm.BertConfig.tiny(attention="sparse"),
                   device="cpu")(torch.zeros(1, 32, dtype=torch.int64))


def test_remat_gives_the_same_gradients():
    b = _batch(2)
    grads = []
    for remat in (False, True):
        model = tm.BertMLM(tm.BertConfig.tiny(attention="flash", remat=remat),
                           seed=3, device="cpu")
        loss = tm.mlm_loss(model(b["tokens"]), b["targets"], b["mask"])
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, c in zip(*grads):
        assert torch.equal(a, c)


def test_bert_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.BertMLM(tm.BertConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tdata.synthetic_mlm(2, 8, 100))

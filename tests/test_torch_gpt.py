"""The port's GPT (``models/gpt.py``) against the JAX ``GPTLM`` in float32,
the JAX model's weights carried across (``utils.interop.params_from_jax``):

- the logits (tied and untied heads, a ``position_offset``, the
  ``scan_layers`` layout against the JAX ``nn.scan`` model and
  ``stack_layer_params``), ``causal_lm_loss`` with and without a mask,
  and the loss's gradient of every leaf, to rtol 1e-5;
- causality (logits before t do not move when tokens after t change),
  the ``causal=False`` rejection;
- the async fleet's model ``gpt``: its batches are the JAX
  ``make_problem``'s tokens and its loss on the JAX weights is the JAX
  loss;
- over gloo at world 2, one sequence shard a rank: the GPT with ring and
  with Ulysses attention (flash path) against the dense JAX GPT, the
  logits and the loss's gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu.models import GPTLM as JGPTLM
from pytorch_ps_mpi_tpu.models import causal_lm_loss as jloss
from pytorch_ps_mpi_tpu.models import gpt_tiny as jgpt_tiny
from pytorch_ps_mpi_tpu.models.bert import \
    stack_layer_params as jstack_layer_params
from pytorch_ps_mpi_tpu_torch.models.bert import stack_layer_params
from pytorch_ps_mpi_tpu_torch.models.gpt import (GPTLM, causal_lm_loss,
                                                 gpt_tiny)
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax
from torch_parity import spawn_ranks

RTOL, ATOL = 1e-5, 1e-5
KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
          intermediate_size=64, max_position=64)


def _tokens(shape=(2, 32), seed=1):
    return np.random.RandomState(seed).randint(0, KW["vocab_size"], shape)


def _pair(tie=True, **kw):
    jcfg = jgpt_tiny(**KW, **kw)
    toks = _tokens()
    jparams = jax.tree.map(np.asarray, JGPTLM(jcfg, tie_embeddings=tie).init(
        jax.random.key(0), jnp.asarray(toks)))
    model = GPTLM(gpt_tiny(**KW, **kw), tie, device="cpu")
    params_from_jax(jparams, model)
    return jcfg, jparams, model, toks


@pytest.mark.parametrize("tie,offset", [(True, 0), (False, 0), (True, 16)])
def test_logits_loss_and_grads_match_jax(tie, offset):
    jcfg, jparams, model, toks = _pair(tie)
    jmodel = JGPTLM(jcfg, tie_embeddings=tie)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(toks),
                                   position_offset=offset))
    got = model(torch.from_numpy(toks), position_offset=offset)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    mask = (np.random.RandomState(2).rand(*toks.shape) > 0.3)
    for m in (None, mask):
        jl = jloss(jnp.asarray(want), jnp.asarray(toks),
                   None if m is None else jnp.asarray(m))
        tl = causal_lm_loss(got, torch.from_numpy(toks),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    jg = jax.grad(lambda p: jloss(jmodel.apply(p, jnp.asarray(toks)),
                                  jnp.asarray(toks)))(jparams)
    loss = causal_lm_loss(model(torch.from_numpy(toks)),
                          torch.from_numpy(toks))
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    for (name, _), g in zip(named.items(), grads):
        node = jg["params"]
        for k in name.split("."):
            node = node[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(node), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_scan_layers_match_the_jax_scan_model():
    jcfg, jparams, model, toks = _pair(scan_layers=True)
    assert "layers.EncoderLayer_0.Dense_0.kernel" in dict(
        model.named_parameters())
    want = JGPTLM(jcfg).apply(jparams, jnp.asarray(toks))
    np.testing.assert_allclose(model(torch.from_numpy(toks)).detach().numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)
    # the loop layout, stacked, is the scan layout on both sides
    _, lparams, loop, _ = _pair()
    stacked = stack_layer_params(dict(loop.named_parameters()), 2)
    jstacked = jstack_layer_params(lparams["params"], 2)
    for name, t in stacked.items():
        node = jstacked
        for k in name.split("."):
            node = node[k]
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(node))
    scan = GPTLM(gpt_tiny(**KW, scan_layers=True, remat=True), device="cpu")
    with torch.no_grad():
        for name, p in scan.named_parameters():
            p.copy_(stacked[name])
    torch.testing.assert_close(scan(torch.from_numpy(toks)),
                               loop(torch.from_numpy(toks)), rtol=RTOL,
                               atol=ATOL)


def test_causality_and_the_non_causal_rejection():
    _, _, model, toks = _pair()
    base = model(torch.from_numpy(toks))
    t = 10
    pert = toks.copy()
    pert[:, t + 1:] = (pert[:, t + 1:] + 7) % KW["vocab_size"]
    out = model(torch.from_numpy(pert))
    assert torch.equal(base[:, :t + 1], out[:, :t + 1])
    assert not torch.equal(base[:, t + 1:], out[:, t + 1:])
    with pytest.raises(ValueError, match="GPTLM requires cfg.causal=True"):
        GPTLM(gpt_tiny(causal=False), device="cpu")


def test_async_fleet_gpt_is_the_jax_problem():
    from pytorch_ps_mpi_tpu.parallel.async_train import make_problem
    from pytorch_ps_mpi_tpu_torch.parallel.async_train import Problem

    cfg = {"model": "gpt", "batch": 4, "seq_len": 32, "seed": 3}
    jmodel, jparams, jbatch_fn, jloss_fn = make_problem(cfg)
    prob = Problem(cfg, "cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), prob.model)
    for step, worker in ((0, 0), (5, 2)):
        toks = prob.batch_fn(step, worker)
        np.testing.assert_array_equal(toks.numpy(),
                                      np.asarray(jbatch_fn(step, worker)))
        np.testing.assert_allclose(float(prob.loss(toks).detach()),
                                   float(jloss_fn(jparams, jbatch_fn(
                                       step, worker))), rtol=RTOL)
    assert jax.tree.structure(prob.template) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))


_WORKER = """
import sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import mesh
from pytorch_ps_mpi_tpu_torch.models.gpt import GPTLM, causal_lm_loss, gpt_tiny
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax
from test_torch_gpt import KW

rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
m = mesh.make_mesh((world,), ("seq",))
data = np.load(src)
flat = {}
for key in data.files:
    if key.startswith("p/"):
        node = flat
        parts = key[2:].split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = data[key]
toks = torch.from_numpy(m.shard(data["tokens"], mesh.P(None, "seq")).copy())
l_local = toks.shape[1]
out = {}
for sp in ("ring", "ulysses"):
    model = GPTLM(gpt_tiny(attention=sp, **KW), device="cpu", mesh=m)
    params_from_jax(flat, model)
    logits = model(toks, position_offset=rank * l_local)
    out[sp + "_logits"] = logits.detach().numpy()
    # each shard's next-token terms over the whole batch's count
    ll = torch.log_softmax(logits[:, :-1], -1).gather(
        -1, toks[:, 1:, None])[..., 0]
    loss = -ll.sum() / float(data["den"])
    named = dict(model.named_parameters())
    for (n, _), g in zip(named.items(),
                         torch.autograd.grad(loss, list(named.values()))):
        out[f"{sp}_g/{n}"] = g.numpy()
np.savez(f"{dst}.{rank}.npz", **out)
torch.distributed.destroy_process_group()
"""


def test_sequence_parallel_gpt_matches_dense_jax_over_gloo(tmp_path):
    world = 2
    jcfg, jparams, _, toks = _pair()
    l_local = toks.shape[1] // world
    den = float(toks.shape[0] * (toks.shape[1] - world))
    from pytorch_ps_mpi_tpu_torch.utils.interop import flat_from_jax

    np.savez(tmp_path / "in.npz", tokens=toks, den=den,
             **{"p/" + k: v for k, v in flat_from_jax(jparams).items()})
    spawn_ranks(_WORKER, world, [tmp_path / "in.npz", tmp_path / "out"])
    ranks = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    jmodel = JGPTLM(jcfg)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(toks)))

    def shard_local_loss(p):
        logits = jmodel.apply(p, jnp.asarray(toks))
        total = 0.0
        for r in range(world):
            sl = slice(r * l_local, (r + 1) * l_local)
            lg, tk = logits[:, sl], jnp.asarray(toks)[:, sl]
            lp = jax.nn.log_softmax(lg[:, :-1], axis=-1)
            total = total + jnp.take_along_axis(lp, tk[:, 1:, None],
                                                axis=-1).sum()
        return -total / den

    jg = jax.grad(shard_local_loss)(jparams)["params"]
    for sp in ("ring", "ulysses"):
        got = np.concatenate([r[sp + "_logits"] for r in ranks], 1)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=sp)
        for key in ranks[0].files:
            if not key.startswith(sp + "_g/"):
                continue
            name = key.split("/", 1)[1]
            node = jg
            for k in name.split("."):
                node = node[k]
            # the gradient of the summed loss is the sum of the ranks'
            np.testing.assert_allclose(sum(r[key] for r in ranks),
                                       np.asarray(node), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{sp} {name}")


def test_async_fleet_trains_gpt_over_shm():
    """The async fleet's model ``gpt`` end to end (JAX
    ``tests/test_async_train.py::test_gpt_causal_lm_over_async_wire`` at
    fleet-test size): two spawned workers push bf16 gradients of the
    tiny GPT over shm, the server applies them, the held-out loss falls."""
    import os

    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer

    cfg = {"model": "gpt", "seq_len": 16, "batch": 16, "seed": 2,
           "model_kw": {"vocab_size": 64, "hidden_size": 32, "num_layers": 1,
                        "num_heads": 2, "intermediate_size": 64,
                        "max_position": 32},
           "codec": "bf16", "optim": "adam", "hyper": {"lr": 1e-2},
           "steps": 8, "open_timeout": 120.0, "push_timeout": 120.0,
           "device": "cpu", "frame_check": True}
    name = f"/psq_torch_gpt_{os.getpid()}"
    server = ShmPSServer(name, 2, at.make_problem(cfg, "cpu").template,
                         max_staleness=4, code=get_codec("bf16"),
                         frame=True, device="cpu")
    procs = []
    try:
        procs = [at.spawn_worker(name, i, cfg, env={"OMP_NUM_THREADS": "1"})
                 for i in range(2)]
        _, m = at.serve(server, cfg, total_grads=0, total_received=16,
                        timeout=120.0)
        assert at.join_workers(procs, timeout=120.0) == [0, 0]
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
    assert m["grads_received"] == 16.0
    assert m["loss_final"] < m["loss_initial"]

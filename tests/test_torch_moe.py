"""The port's Switch MoE MLM (``models/moe.py``) against the JAX
``SwitchMLM`` in float32, the JAX weights carried across:

- dense routing (no expert axis), top-1 and top-2: the logits, the
  summed balance loss (the port returns what flax ``sow``s into
  ``"aux_loss"``, summed over the layers), the loss's gradients, to
  rtol 1e-5; ``moe_param_spec``;
- expert parallel over gloo at worlds 2 and 4 (tokens replicated, each
  rank its experts' rows of the stacks): the logits and the balance loss
  against the JAX model under ``shard_map``, with a capacity that keeps
  every token, and with one that drops tokens (against the JAX
  expert-parallel model, which drops the same ones).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from pytorch_ps_mpi_tpu.mesh import make_mesh as jax_make_mesh
from pytorch_ps_mpi_tpu.models.bert import mlm_loss as jmlm_loss
from pytorch_ps_mpi_tpu.models.moe import SwitchConfig as JSwitchConfig
from pytorch_ps_mpi_tpu.models.moe import SwitchMLM as JSwitchMLM
from pytorch_ps_mpi_tpu.models.moe import moe_param_spec as jmoe_param_spec
from pytorch_ps_mpi_tpu_torch.models import mlm_loss
from pytorch_ps_mpi_tpu_torch.models.moe import (SwitchConfig, SwitchMLM,
                                                 moe_param_spec)
from pytorch_ps_mpi_tpu_torch.utils.interop import (flat_from_jax,
                                                    params_from_jax)
from torch_parity import spawn_ranks

RTOL, ATOL = 1e-5, 1e-5
KW = dict(vocab_size=211, hidden_size=32, num_layers=2, num_heads=4,
          intermediate_size=48, max_position=32, n_experts=8)


def _tokens():
    return np.random.RandomState(0).randint(0, KW["vocab_size"], (2, 16))


def _jax(**kw):
    cfg = JSwitchConfig(**KW, **kw)
    # the parameters alone: init also returns the "aux_loss" it sowed,
    # which an apply would extend
    params = jax.tree.map(np.asarray, JSwitchMLM(cfg).init(
        jax.random.key(1), jnp.asarray(_tokens()))["params"])
    return cfg, {"params": params}


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_routing_matches_jax(top_k):
    jcfg, jparams = _jax(top_k=top_k, aux_loss_weight=0.01, capacity=256)
    model = SwitchMLM(SwitchConfig(**KW, top_k=top_k, aux_loss_weight=0.01,
                                   capacity=256), device="cpu")
    named = params_from_jax(jparams, model)
    toks = _tokens()
    jlogits, state = JSwitchMLM(jcfg).apply(jparams, jnp.asarray(toks),
                                            mutable=["aux_loss"])
    jaux = sum(jax.tree.leaves(state["aux_loss"]))
    logits, aux = model(torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=RTOL)
    mask = np.random.RandomState(4).rand(*toks.shape) < 0.3

    def jobj(p):
        lg, st = JSwitchMLM(jcfg).apply(p, jnp.asarray(toks),
                                        mutable=["aux_loss"])
        return (jmlm_loss(lg, jnp.asarray(toks), jnp.asarray(mask))
                + sum(jax.tree.leaves(st["aux_loss"])))

    jg = jax.grad(jobj)(jparams)["params"]
    obj = mlm_loss(logits, torch.from_numpy(toks),
                   torch.from_numpy(mask)) + aux
    for (name, _), g in zip(named.items(),
                            torch.autograd.grad(obj, list(named.values()))):
        node = jg
        for k in name.split("."):
            node = node[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(node), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    jspec = flat_from_jax(jax.tree.map(
        lambda s: np.array(tuple(s), dtype=object),
        jmoe_param_spec(jparams, "expert")["params"]))
    assert {k: tuple(v) for k, v in moe_param_spec(named, "expert").items()} \
        == {k: tuple(v) for k, v in jspec.items()}


_WORKER = """
import dataclasses, sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import mesh
from pytorch_ps_mpi_tpu_torch.models.moe import SwitchConfig, SwitchMLM
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax
from test_torch_moe import KW

rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
m = mesh.make_mesh((world,), ("expert",))
data = np.load(src)
tree = {}
for key in data.files:
    if key.startswith("p/"):
        node = tree
        parts = key[2:].split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = data[key]
out = {}
for cap in (256, 2):
    cfg = SwitchConfig(**KW, capacity=cap, aux_loss_weight=0.01,
                       expert_axis="expert")
    model = SwitchMLM(cfg, device="cpu", mesh=m)
    params_from_jax(tree, model)
    logits, aux = model(torch.from_numpy(data["tokens"]), return_aux=True)
    out[f"logits{cap}"] = logits.detach().numpy()
    out[f"aux{cap}"] = aux.detach().numpy()
np.savez(f"{dst}.{rank}.npz", **out)
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_expert_parallel_matches_jax_over_gloo(tmp_path, world):
    jcfg, jparams = _jax(capacity=256, aux_loss_weight=0.01)
    toks = _tokens()
    np.savez(tmp_path / "in.npz", tokens=toks,
             **{"p/" + k: v for k, v in flat_from_jax(jparams).items()})
    spawn_ranks(_WORKER, world, [tmp_path / "in.npz", tmp_path / "out"])
    ranks = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    mesh = jax_make_mesh(axis_names=("expert",), devices=jax.devices()[:world])
    spec = jmoe_param_spec(jparams, "expert")
    dense = np.asarray(JSwitchMLM(jcfg).apply(jparams, jnp.asarray(toks)))
    for cap in (256, 2):
        ep_cfg = dataclasses.replace(jcfg, capacity=cap, expert_axis="expert")

        def fwd(p, t, ep_cfg=ep_cfg):
            lg, st = JSwitchMLM(ep_cfg).apply(p, t, mutable=["aux_loss"])
            return lg, sum(jax.tree.leaves(st["aux_loss"]))

        jl, ja = jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(spec, JP()),
                                       out_specs=(JP(), JP()),
                                       check_vma=False))(jparams,
                                                         jnp.asarray(toks))
        for r in ranks:
            np.testing.assert_allclose(r[f"logits{cap}"], np.asarray(jl),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(float(r[f"aux{cap}"]), float(ja),
                                       rtol=RTOL)
        if cap == 256:  # nothing drops: the dense routing's function
            np.testing.assert_allclose(ranks[0]["logits256"], dense,
                                       rtol=RTOL, atol=ATOL)
        else:
            assert not np.allclose(ranks[0]["logits2"], dense, atol=1e-3)

"""The port's tensor, pipeline and expert parallelism
(``parallel/{tp,pp,ep}.py``) over gloo at worlds 2 and 4 against the JAX
functions under a vma-checked ``shard_map`` on 2- or 4-device sub-meshes,
on the same numpy inputs and weights:

- ``tp_mlp`` over ``model``; ``tp_self_attention`` over (seq, model) with
  ring and with Ulysses sequence parallelism: the output, each rank's
  gradient of its own weight shards, the replicated input's and biases'
  gradients;
- ``pipeline_apply`` and ``pipeline_loss`` over ``pipe`` (M = 3
  microbatches through S stages): the outputs, the loss and each stage's
  gradient;
- ``moe_apply`` over ``expert`` at top-1 and top-2 with a capacity that
  drops tokens, and ``load_balance_loss``: the outputs, the dropped set
  (bit for bit), the gradients (a replicated router's summed over the
  ranks, as the JAX transpose sums it), the loss.

Everything is float32 and held to rtol 1e-5, with atol 1e-5 of an
array's largest magnitude where a gradient's sum over tokens cancels
(the mesh and the JAX program sum in their own orders, ROADMAP queue 3
item 9).
Single-process: the routers' tie order and dispatch slots against the
JAX functions, the specs, the dense equivalents and the inits' shapes.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from pytorch_ps_mpi_tpu.mesh import make_mesh as jax_make_mesh
from pytorch_ps_mpi_tpu.parallel import ep as jep
from pytorch_ps_mpi_tpu.parallel import pp as jpp
from pytorch_ps_mpi_tpu.parallel import tp as jtp
from torch_parity import spawn_ranks

D, F, HEADS, B, L = 8, 16, 4, 2, 16
M, MB = 3, 2
N_TOK, N_EXP, CAP = 32, 4, 2
RTOL, ATOL = 1e-5, 1e-6

_WORKER = """
import json, sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import comms, mesh
from pytorch_ps_mpi_tpu_torch.mesh import P
from pytorch_ps_mpi_tpu_torch.parallel import ep, pp, tp

rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
data = np.load(src)
T = lambda a: torch.from_numpy(np.array(a)).requires_grad_()
out = {}

def grads(loss, named):
    g = torch.autograd.grad(loss, list(named.values()))
    for k, t in zip(named, g):
        out[k] = t.numpy()

# -- tensor parallelism over "model"
m = mesh.make_mesh((world,), ("model",))
mlp = {k: T(m.shard(data["mlp_" + k], P("model") if data["mlp_" + k].ndim > 1
                    else P())) for k in ("w1", "b1", "w2", "b2")}
x = T(data["x"])
y = tp.tp_mlp(x, mlp, "model", mesh=m)
out["mlp_out"] = y.detach().numpy()
grads((y * torch.from_numpy(data["x_cot"])).sum(),
      {**{"mlp_d" + k: v for k, v in mlp.items()}, "mlp_dx": x})

# -- tensor x sequence parallel attention over ("seq", "model")
m2 = mesh.make_mesh((2, world // 2), ("seq", "model"))
for sp in ("ring", "ulysses"):
    att = {k: T(m2.shard(data["att_" + k], P("model")
                         if data["att_" + k].ndim > 1 else P()))
           for k in ("wqkv", "wo", "bo")}
    xs = T(m2.shard(data["xs"], P(None, "seq")))
    ya = tp.tp_self_attention(xs, att, "model", seq_axis="seq", causal=True,
                              sp=sp, mesh=m2)
    out[sp + "_out"] = ya.detach().numpy()
    cot = torch.from_numpy(m2.shard(data["xs_cot"], P(None, "seq")).copy())
    grads((ya * cot).sum(), {**{f"{sp}_d" + k: v for k, v in att.items()},
                             f"{sp}_dx": xs})

# -- pipeline parallelism over "pipe"
mp = mesh.make_mesh((world,), ("pipe",))
stage = {k: T(mp.shard(data["pp_" + k], P("pipe"))) for k in ("w", "b")}
fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
comms.reset_calls()
o = pp.pipeline_apply(stage, torch.from_numpy(data["x_mb"]), fn, "pipe",
                      mesh=mp)
out["pp_out"] = o.detach().numpy()
loss = pp.pipeline_loss(stage, torch.from_numpy(data["x_mb"]),
                        torch.from_numpy(data["y_mb"]), fn,
                        lambda a, b: ((a - b) ** 2).mean(), "pipe", mesh=mp)
out["pp_loss"] = loss.detach().numpy()
grads(loss, {"pp_d" + k: v for k, v in stage.items()})
out["pp_permutes"] = comms.calls["ring_permute"]

# -- expert parallelism over "expert"
me = mesh.make_mesh((world,), ("expert",))
for k_top in (1, 2):
    prm = {k: T(me.shard(data["moe_" + k], P("expert") if k != "wr"
                         else P())) for k in ("wr", "w1", "w2")}
    xt = T(me.shard(data["tok"], P("expert")))
    comms.reset_calls()
    yo = ep.moe_apply(xt, prm, "expert", capacity=%(cap)d, top_k=k_top,
                      mesh=me)
    out[f"moe{k_top}_out"] = yo.detach().numpy()
    out[f"moe{k_top}_keep"] = ep.dispatch_plan(
        xt.detach(), prm["wr"].detach(), %(n_exp)d, %(cap)d, k_top)[3].numpy()
    grads((yo * torch.from_numpy(me.shard(data["tok_cot"], P("expert"))
                                 .copy())).sum(),
          {**{f"moe{k_top}_d" + k: v for k, v in prm.items()},
           f"moe{k_top}_dx": xt})
    out[f"moe{k_top}_a2a"] = comms.calls["all_to_all"]
    lb = ep.load_balance_loss(xt, prm["wr"], top_k=k_top,
                              expert_axis="expert", mesh=me)
    out[f"lb{k_top}"] = lb.detach().numpy()
    grads(lb, {f"lb{k_top}_dwr": prm["wr"]})
np.savez(f"{dst}.{rank}.npz", **out)
torch.distributed.destroy_process_group()
""" % {"cap": CAP, "n_exp": N_EXP}


def _inputs():
    rng = np.random.RandomState(5)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "x": f32(B, L, D), "x_cot": f32(B, L, D),
        "mlp_w1": 0.3 * f32(4, D, F // 4), "mlp_b1": 0.1 * f32(4, F // 4),
        "mlp_w2": 0.3 * f32(4, F // 4, D), "mlp_b2": 0.1 * f32(D),
        "xs": f32(B, L, D), "xs_cot": f32(B, L, D),
        "x_mb": f32(M, MB, D), "y_mb": f32(M, MB, D),
        "tok": f32(N_TOK, D), "tok_cot": f32(N_TOK, D),
        "moe_wr": f32(D, N_EXP), "moe_w1": 0.3 * f32(N_EXP, D, F),
        "moe_w2": 0.3 * f32(N_EXP, F, D),
    }


def _world_inputs(world):
    """The TP leaves at the world's TP width (the MLP's 4-way stack
    regrouped; the attention's heads split ``world // 2`` ways), and the
    pipeline's ``world`` stages."""
    data = _inputs()
    rng = np.random.RandomState(6)
    w1 = np.concatenate(list(data["mlp_w1"]), -1)
    b1 = np.concatenate(list(data["mlp_b1"]), -1)
    w2 = np.concatenate(list(data["mlp_w2"]), 0)
    data["mlp_w1"] = np.stack(np.split(w1, world, -1))
    data["mlp_b1"] = np.stack(np.split(b1, world, -1))
    data["mlp_w2"] = np.stack(np.split(w2, world, 0))
    tpa = world // 2
    data["att_wqkv"] = 0.3 * rng.randn(tpa, D, 3, HEADS // tpa,
                                       D // HEADS).astype(np.float32)
    data["att_wo"] = 0.3 * rng.randn(tpa, (HEADS // tpa) * (D // HEADS),
                                     D).astype(np.float32)
    data["att_bo"] = 0.1 * rng.randn(D).astype(np.float32)
    data["pp_w"] = 0.5 * rng.randn(world, D, D).astype(np.float32)
    data["pp_b"] = 0.1 * rng.randn(world, D).astype(np.float32)
    return data


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return jax_make_mesh(shape=shape, axis_names=names,
                         devices=jax.devices()[:n])


def _vjp(fn, args, cot):
    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)

    return jax.jit(run)(args, cot)


def _jax_all(data, world):
    a = {k: jnp.asarray(v) for k, v in data.items()}
    want = {}
    # tp_mlp
    mesh = _jmesh((world,), ("model",))
    mlp = {k: a["mlp_" + k] for k in ("w1", "b1", "w2", "b2")}
    spec = jtp.tp_param_spec(mlp, "model")
    f = jax.shard_map(lambda x, p: jtp.tp_mlp(x, p, "model"), mesh=mesh,
                      in_specs=(JP(), spec), out_specs=JP())
    o, (dx, dp) = _vjp(f, (a["x"], mlp), a["x_cot"])
    want["mlp_out"], want["mlp_dx"] = o, dx
    want.update({"mlp_d" + k: v for k, v in dp.items()})
    # tp x sp attention
    mesh2 = _jmesh((2, world // 2), ("seq", "model"))
    att = {k: a["att_" + k] for k in ("wqkv", "wo", "bo")}
    aspec = jtp.tp_param_spec(att, "model")
    for sp in ("ring", "ulysses"):
        f = jax.shard_map(
            lambda x, p, sp=sp: jtp.tp_self_attention(
                x, p, "model", seq_axis="seq", causal=True, sp=sp),
            mesh=mesh2, in_specs=(JP(None, "seq"), aspec),
            out_specs=JP(None, "seq"))
        o, (dx, dp) = _vjp(f, (a["xs"], att), a["xs_cot"])
        want[sp + "_out"], want[sp + "_dx"] = o, dx
        want.update({f"{sp}_d" + k: v for k, v in dp.items()})
    # pipeline
    meshp = _jmesh((world,), ("pipe",))
    stage = {"w": a["pp_w"], "b": a["pp_b"]}
    sspec = jpp.stage_spec(stage, "pipe")
    fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])  # noqa: E731
    want["pp_out"] = jax.jit(jax.shard_map(
        lambda p, x: jpp.pipeline_apply(p, x, fn, "pipe"), mesh=meshp,
        in_specs=(sspec, JP()), out_specs=JP()))(stage, a["x_mb"])
    lf = jax.shard_map(
        lambda p, x, y: jpp.pipeline_loss(
            p, x, y, fn, lambda u, v: ((u - v) ** 2).mean(), "pipe"),
        mesh=meshp, in_specs=(sspec, JP(), JP()), out_specs=JP())
    loss, dp = jax.jit(jax.value_and_grad(lf))(stage, a["x_mb"], a["y_mb"])
    want["pp_loss"] = loss
    want.update({"pp_d" + k: v for k, v in dp.items()})
    # experts
    meshe = _jmesh((world,), ("expert",))
    prm = {k: a["moe_" + k] for k in ("wr", "w1", "w2")}
    espec = jep.moe_spec(prm, "expert")
    for k_top in (1, 2):
        f = jax.shard_map(
            lambda x, p, k_top=k_top: jep.moe_apply(
                x, p, "expert", capacity=CAP, top_k=k_top),
            mesh=meshe, in_specs=(JP("expert"), espec),
            out_specs=JP("expert"))
        o, (dx, dp) = _vjp(f, (a["tok"], prm), a["tok_cot"])
        want[f"moe{k_top}_out"], want[f"moe{k_top}_dx"] = o, dx
        want.update({f"moe{k_top}_d" + k: v for k, v in dp.items()})
        lb = jax.shard_map(
            lambda x, wr, k_top=k_top: jep.load_balance_loss(
                x, wr, top_k=k_top, expert_axis="expert"),
            mesh=meshe, in_specs=(JP("expert"), JP()), out_specs=JP())
        v, g = jax.jit(jax.value_and_grad(lb, argnums=1))(a["tok"],
                                                         a["moe_wr"])
        want[f"lb{k_top}"], want[f"lb{k_top}_dwr"] = v, g
    return {k: np.asarray(v) for k, v in want.items()}


#: how a port rank's array joins the others' into the JAX global array:
#: the concatenation axis, "sum" (a replicated leaf's rank gradients,
#: which the JAX transpose sums) or None (replicated: every rank's equals
#: it)
_JOIN = {"mlp_dw1": 0, "mlp_db1": 0, "mlp_dw2": 0, "pp_dw": 0, "pp_db": 0,
         "moe1_dw1": 0, "moe1_dw2": 0, "moe2_dw1": 0, "moe2_dw2": 0,
         "moe1_out": 0, "moe1_dx": 0, "moe2_out": 0, "moe2_dx": 0,
         "moe1_dwr": "sum", "moe2_dwr": "sum", "lb1_dwr": "sum",
         "lb2_dwr": "sum"}


def _same(arrays, key):
    for a in arrays[1:]:
        np.testing.assert_allclose(a, arrays[0], rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    return arrays[0]


def _gathered(ranks, key, world):
    if key.startswith(("ring", "ulysses")):
        # rank i·tpa + j sits at (seq i, model j): activations are sharded
        # over seq; weight gradients sum over the seq shards (the JAX
        # transpose of a seq-replicated weight), heads join over model
        tpa = world // 2
        at = [[ranks[i * tpa + j][key] for j in range(tpa)]
              for i in range(2)]
        if key.endswith(("_out", "_dx")):
            return np.concatenate([_same(row, key) for row in at], 1)
        per_model = [sum(at[i][j] for i in range(2)) for j in range(tpa)]
        if key.endswith("_dbo"):
            return _same(per_model, key)
        return np.concatenate(per_model, 0)
    join = _JOIN.get(key)
    if join == "sum":
        return sum(r[key] for r in ranks)
    if join is None:
        return _same([r[key] for r in ranks], key)
    return np.concatenate([r[key] for r in ranks], join)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_pp_ep_match_jax_over_gloo(tmp_path, world):
    data = _world_inputs(world)
    src = tmp_path / "in.npz"
    np.savez(src, **data)
    spawn_ranks(_WORKER, world, [src, tmp_path / "out"])
    ranks = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    want = _jax_all(data, world)
    for key, w in want.items():
        got = _gathered(ranks, key, world)
        # where a gradient's sum over tokens cancels, atol is 1e-5 of the
        # array's largest magnitude
        np.testing.assert_allclose(got, w, rtol=RTOL,
                                   atol=max(ATOL, RTOL * np.abs(w).max()),
                                   err_msg=key)
    for k_top in (1, 2):
        # both ranks' exchanges each way: one all-to-all a direction
        assert all(int(r[f"moe{k_top}_a2a"]) == 4 for r in ranks)
    # the dropped set: a dropped top-1 token's output is exactly 0
    keep = np.concatenate([r["moe1_keep"] for r in ranks], 0)[:, 0]
    dropped = np.all(want["moe1_out"] == 0, axis=1)
    assert dropped.any() and np.array_equal(~keep, dropped)
    # S + M - 1 ticks a pass: apply, then the loss's forward and backward
    ticks = world + M - 1
    assert all(int(r["pp_permutes"]) == 3 * ticks - 1 for r in ranks)


def test_routers_break_ties_to_the_lower_expert():
    from pytorch_ps_mpi_tpu_torch.parallel import ep

    rng = np.random.RandomState(2)
    x = rng.randn(16, D).astype(np.float32)
    wr = rng.randn(D, N_EXP).astype(np.float32)
    wr[:, 2] = wr[:, 1]  # experts 1 and 2 tie for every token
    wr[:, 3] = wr[:, 0]
    e1, g1 = ep._route_top1(torch.from_numpy(x), torch.from_numpy(wr))
    je1, jg1 = jep._route_top1(jnp.asarray(x), jnp.asarray(wr))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(je1))
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg1), rtol=RTOL)
    for k in (2, 3):
        ek, gk = ep._route_topk(torch.from_numpy(x), torch.from_numpy(wr), k)
        jek, jgk = jep._route_topk(jnp.asarray(x), jnp.asarray(wr), k)
        np.testing.assert_array_equal(ek.numpy(), np.asarray(jek))
        np.testing.assert_allclose(gk.numpy(), np.asarray(jgk), rtol=RTOL)
    # the one-rank dispatch (dense oracle without drops) at a capacity
    # that keeps every token
    prm = {"wr": torch.from_numpy(wr),
           "w1": torch.from_numpy(0.3 * rng.randn(N_EXP, D, F)
                                  .astype(np.float32)),
           "w2": torch.from_numpy(0.3 * rng.randn(N_EXP, F, D)
                                  .astype(np.float32))}
    for k in (1, 2):
        got = ep.moe_apply(torch.from_numpy(x), prm, "expert", capacity=16,
                           top_k=k)
        dense = jep.moe_dense_oracle(jnp.asarray(x), {
            n: jnp.asarray(t.numpy()) for n, t in prm.items()}, top_k=k)
        np.testing.assert_allclose(got.numpy(), np.asarray(dense),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            ep.moe_dense_oracle(torch.from_numpy(x), prm, top_k=k).numpy(),
            np.asarray(dense), rtol=RTOL, atol=ATOL)


def test_specs_inits_and_dense_equivalents():
    from pytorch_ps_mpi_tpu_torch.mesh import P
    from pytorch_ps_mpi_tpu_torch.parallel import ep, pp, tp

    mlp = tp.init_tp_mlp(0, D, F, 4)
    att = tp.init_tp_attention(1, D, HEADS, 2)
    jmlp = jtp.init_tp_mlp(jax.random.key(0), D, F, 4)
    jatt = jtp.init_tp_attention(jax.random.key(1), D, HEADS, 2)
    for ours, theirs in ((mlp, jmlp), (att, jatt)):
        assert {k: tuple(v.shape) for k, v in ours.items()} == \
            {k: tuple(v.shape) for k, v in theirs.items()}
        assert tp.tp_param_spec(ours, "model") == {
            k: P(*s) for k, s in jtp.tp_param_spec(theirs, "model").items()}
    for ours, theirs in ((tp.dense_equivalent_mlp(mlp),
                          jtp.dense_equivalent_mlp(jax.tree.map(
                              lambda t: jnp.asarray(t.numpy()), mlp))),
                         (tp.dense_equivalent_attention(att),
                          jtp.dense_equivalent_attention(jax.tree.map(
                              lambda t: jnp.asarray(t.numpy()), att)))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    stack = pp.init_stage_stack(3, 4, lambda g: {
        "w": torch.randn(D, D, generator=g), "b": torch.zeros(D)})
    assert {k: tuple(v.shape) for k, v in stack.items()} == {
        "w": (4, D, D), "b": (4, D)}
    assert pp.stage_spec(stack, "pipe") == {"w": P("pipe"), "b": P("pipe")}
    moe = ep.init_moe(4, D, F, N_EXP)
    jmoe = jep.init_moe(jax.random.key(4), D, F, N_EXP)
    assert {k: tuple(v.shape) for k, v in moe.items()} == \
        {k: tuple(v.shape) for k, v in jmoe.items()}
    assert ep.moe_spec(moe, "expert") == {
        k: P(*s) for k, s in jep.moe_spec(jmoe, "expert").items()}

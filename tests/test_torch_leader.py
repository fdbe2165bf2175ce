"""The port's leader (ZeRO-1) mode, ``MPI_PS(mode="leader")``, and its
collectives, per leaf and in buckets.

World 1, in process:
- leader mode equals allgather mode on the width-32 ResNet-18 (SGD and
  Adam, identity and int8, per leaf and bucketed, with and without
  ``clip_norm``): bit for bit, but for the bucketed leader's clip, whose
  sum of squares runs over buckets instead of leaves (rtol 1e-6, as the
  JAX package's own ``test_bucketed_global_norm_clip_parity``);
- the leader step matches the JAX package's leader step (rtol 1e-6, atol
  1e-7: the jitted JAX update contracts into fused multiply-adds), with
  the same metrics (``wire_lowering`` ``psum_scatter`` for identity,
  ``payload_gather`` for int8 at world 1);
- Adafactor with ``mode="leader"`` raises; the ``LeaderState`` round-trips
  through ``state_dict``.

Worlds 2 and 4, one process a rank over gloo, several configurations in
one spawn each, on the MLP (four leaves; three buckets at 0.01 MB):
- the port's leader steps equal its allgather steps, and its bucketed
  identity steps its per-leaf ones (bit for bit at world 2; at world 4
  the ring may sum a bucket in another order than a leaf, rtol 1e-6);
- port == JAX on a 2- and 4-device mesh after 3 steps (rtol 1e-6, atol
  1e-7): bucketed identity and int8, and leader identity, int8 and
  ef∘topk, with the ranks' ``LeaderState`` rows stacked against the JAX
  ``LeaderState`` arrays;
- ``wire_lowering``: ``payload_gather`` for int8 at world 2,
  ``dense_scatter`` at world 4, ``psum_scatter`` for identity;
- collective calls of one grads-only step from ``comms.calls``;
- ``gather_to_leader`` and ``broadcast_from_leader(_tree)``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import bucketing as jb
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import SGD, Adam, Adafactor
from pytorch_ps_mpi_tpu_torch import bucketing as tb
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.ps import LeaderState
from pytorch_ps_mpi_tpu_torch.utils.interop import (flax_layout, flax_path,
                                                    params_from_jax)
from torch_parity import (HYPER, STEPS, assert_params_close, jax_resnet,
                          make_codec, mlp_pair, spawn_ranks, stacked_grads,
                          torch_grads)

RESNET_MB = 1.0
MLP_MB = 0.01
METRIC_KEYS = ("msg_bytes", "packaged_bytes", "wire_lowering",
               "wire_bytes_per_worker", "bucket_count", "bucket_bytes_total",
               "agg_launches")


def _resnet_params():
    model = tm.ResNet18(num_classes=10, num_filters=32, small_inputs=True,
                        device="cpu")
    return model, params_from_jax(jax_resnet()[1], model)


def _run(cls, codec, world, steps, grads_of, **kw):
    model, params = _resnet_params()
    opt = cls(params, code=get_codec(codec), device="cpu", **kw)
    for s in range(steps):
        _, data = opt.step(grads=torch_grads(model, grads_of(s)))
    return model, opt, data


@pytest.mark.parametrize("clip", [0.0, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("mb", [0.0, RESNET_MB], ids=["leaf", "bucket"])
@pytest.mark.parametrize("codec", ["identity", "int8"])
@pytest.mark.parametrize("optim", ["sgd", "adam"])
def test_leader_equals_allgather_world1(optim, codec, mb, clip):
    cls, kw = (SGD, HYPER) if optim == "sgd" else (Adam, dict(lr=1e-3))
    _, variables = jax_resnet()

    def grads_of(s):
        return stacked_grads(variables, 1, s)

    _, ag, _ = _run(cls, codec, 1, STEPS, grads_of, bucket_mb=mb,
                    clip_norm=clip, **kw)
    _, leader, data = _run(cls, codec, 1, STEPS, grads_of, bucket_mb=mb,
                           clip_norm=clip, mode="leader", **kw)
    assert isinstance(leader.opt_state, LeaderState)
    assert data["wire_lowering"] == ("psum_scatter" if codec == "identity"
                                     else "payload_gather")
    for k, p in ag.params.items():
        if clip and mb and codec == "identity":
            torch.testing.assert_close(leader.params[k], p, rtol=1e-6,
                                       atol=1e-7)
        else:
            assert torch.equal(leader.params[k], p), k


@pytest.mark.parametrize("mb", [0.0, RESNET_MB], ids=["leaf", "bucket"])
@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_leader_step_matches_jax_world1(codec, mb):
    _, variables = jax_resnet()
    model, opt, data = _run(SGD, codec, 1, STEPS,
                            lambda s: stacked_grads(variables, 1, s),
                            bucket_mb=mb, mode="leader", **HYPER)
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), code=jax_codec(codec),
                mesh=make_mesh(devices=jax.devices()[:1]), mode="leader",
                bucket_mb=mb, **HYPER)
    for s in range(STEPS):
        _, jdata = jopt.step(grads=jax.tree.map(
            jnp.asarray, stacked_grads(variables, 1, s)))
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)
    for key in METRIC_KEYS:
        assert data[key] == jdata[key], key
    # this rank's rows are the JAX LeaderState's row 0
    got = _rows_per_leaf(model, opt._bucket_plan, opt.opt_state.param_shards)
    want = _jax_rows_per_leaf(model, variables, mb,
                              jopt.opt_state.param_shards)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_adafactor_leader_raises():
    _, model = mlp_pair()
    with pytest.raises(NotImplementedError, match="leader"):
        Adafactor(model, mode="leader", device="cpu")
    with pytest.raises(ValueError):
        SGD(model, mode="server", device="cpu")


def _clone(tree):
    from pytorch_ps_mpi_tpu_torch.comms import tree_map

    return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, tree)


@pytest.mark.parametrize("mb", [0.0, MLP_MB], ids=["leaf", "bucket"])
def test_leader_state_dict_round_trip_resumes_identically(mb):
    variables, model = mlp_pair()
    params = params_from_jax(variables, model)
    opt = Adam(params, mode="leader", bucket_mb=mb, lr=1e-3, device="cpu")
    opt.step(grads=torch_grads(model, stacked_grads(variables, 1, 0)))
    saved = _clone(opt.state_dict())
    shards, inner = saved["opt_state"]
    assert set(shards) == (set(range(3)) if mb else set(params))
    assert all(s.shape[0] == 1 for s in shards.values())
    g1 = torch_grads(model, stacked_grads(variables, 1, 1))
    opt.step(grads=g1)
    after = _clone(opt.params)
    opt.load_state_dict(saved)
    assert isinstance(opt.opt_state, LeaderState)
    assert opt.state_dict()["step_count"] == 1
    with torch.no_grad():  # the master copy, not the working one, steps
        for p in opt.params.values():
            p.add_(1.0)
    opt.step(grads=g1)
    for k, p in opt.params.items():
        assert torch.equal(p, after[k]), k
    # the module being trained sees the leader's gathered parameters
    for n, p in model.named_parameters():
        assert torch.equal(p, after[n]), n


# -- LeaderState rows, in flax layout per leaf ------------------------------------------

def _rows_per_leaf(model, plan, rows):
    """Stacked ``[world, ss]`` rows (``key -> array``) as ``name -> flat
    flax-layout array``."""
    named = dict(model.named_parameters())
    if plan is None:
        leaves = {n: np.asarray(r).reshape(-1)[:named[n].numel()]
                  .reshape(named[n].shape) for n, r in rows.items()}
    else:
        buckets = [torch.from_numpy(np.ascontiguousarray(
            np.asarray(rows[i]).reshape(-1)[:b.size]))
            for i, b in enumerate(plan.buckets)]
        leaves = {n: v.numpy() for n, v in
                  tb.unflatten_from_buckets(plan, buckets).items()}
    return {n: flax_layout(flax_path(model, n), a).reshape(-1)
            for n, a in leaves.items()}


def _jax_rows_per_leaf(model, variables, mb, jrows):
    """The JAX ``LeaderState`` arrays of one field as ``name -> flat
    array`` (per leaf, or through the JAX plan's buckets)."""
    tree = jrows
    if mb:
        jplan = jb.plan_buckets(variables, mb)
        tree = jb.unflatten_from_buckets(jplan, [
            np.asarray(r).reshape(-1)[:b.size]
            for r, b in zip(jrows, jplan.buckets)])
    out = {}
    for n, p in model.named_parameters():
        node = tree["params"]
        for key in flax_path(model, n):
            node = node[key]
        out[n] = np.asarray(node).reshape(-1)[:p.numel()]
    return out


# -- worlds 2 and 4 over gloo -----------------------------------------------------

#: (name, mode, codec, bucket_mb)
CONFIGS = [
    ("ag_identity_leaf", "allgather", "identity", 0.0),
    ("ag_identity_bucket", "allgather", "identity", MLP_MB),
    ("ag_int8_bucket", "allgather", "int8", MLP_MB),
    ("leader_identity_leaf", "leader", "identity", 0.0),
    ("leader_identity_bucket", "leader", "identity", MLP_MB),
    ("leader_int8_leaf", "leader", "int8", 0.0),
    ("leader_int8_bucket", "leader", "int8", MLP_MB),
    ("leader_ef_topk_leaf", "leader", "ef_topk", 0.0),
]

_WORKER = """
import json, sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import SGD, comms, mesh
from pytorch_ps_mpi_tpu_torch.codecs import get_codec

rank, world, port, src, dst, steps, configs = sys.argv[1:8]
rank, world, steps = int(rank), int(world), int(steps)
torch.set_num_threads(1)  # the ranks share the host's cores
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
data = np.load(src)
names = [str(n) for n in data["names"]]
out, counts = {}, {}
for name, mode, codec, mb in json.loads(configs):
    params = {n: torch.from_numpy(data["p:" + n].copy()) for n in names}
    code = (get_codec("ef", inner=get_codec("topk", fraction=0.01,
                                            pallas=True))
            if codec == "ef_topk" else get_codec(codec))
    opt = SGD(params, lr=0.01, momentum=0.9, code=code, mode=mode,
              bucket_mb=mb, device="cpu")
    for s in range(steps):
        if s == steps - 1:
            comms.reset_calls()
        _, metrics = opt.step(grads={n: torch.from_numpy(data[f"g{s}:" + n])
                                     for n in names})
    counts[name] = dict(comms.calls, wire_lowering=metrics["wire_lowering"],
                        units=metrics["agg_launches"])
    for n, p in params.items():
        out[f"{name}/p/{n}"] = p.numpy()
    if mode == "leader":
        for k, r in opt.opt_state.param_shards.items():
            out[f"{name}/shard/{k}"] = r.numpy()
        for k, r in opt.opt_state.inner.momentum_buf.items():
            out[f"{name}/mom/{k}"] = r.numpy()
comms.reset_calls()
x = torch.full((3,), float(rank))
g = comms.gather_to_leader(x)
b = comms.broadcast_from_leader(x + 10)
t = comms.broadcast_from_leader_tree({"a": x + 20, "b": [x + 30]})
prims = {"gather": None if g is None else g.tolist(), "bcast": b.tolist(),
         "tree": [t["a"].tolist(), t["b"][0].tolist()], "calls": dict(comms.calls)}
np.savez(f"{dst}.{rank}.npz", counts=json.dumps(counts),
         prims=json.dumps(prims), **out)
torch.distributed.destroy_process_group()
"""

#: payload tensors a unit of the gathered codecs here (int8, ef∘topk)
PAYLOAD_TENSORS = 2


def _expected_calls(lowering, units):
    calls = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
             "broadcast": 0, "gather": 0, "all_to_all": 0,
             "ring_permute": 0}
    if lowering == "psum":
        calls["all_reduce"] = units
    elif lowering == "allgather":
        calls["all_gather"] = PAYLOAD_TENSORS * units
    elif lowering in ("psum_scatter", "dense_scatter"):
        calls["reduce_scatter"] = calls["all_gather"] = units
    else:  # payload_gather: the payloads, then the parameter gather
        calls["all_gather"] = (PAYLOAD_TENSORS + 1) * units
    return calls


def _jax_run(variables, world, mode, codec, mb):
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=make_codec(codec, jax_codec),
                mesh=make_mesh(devices=jax.devices()[:world]), mode=mode,
                bucket_mb=mb, **HYPER)
    for s in range(STEPS):
        _, jdata = jopt.step(grads=jax.tree.map(
            jnp.asarray, stacked_grads(variables, world, s)))
    return jopt, jdata


@pytest.mark.parametrize("world", [2, 4])
def test_leader_and_bucketed_steps_over_gloo(tmp_path, world):
    variables, model = mlp_pair()
    params = params_from_jax(variables, model)
    names = list(params)
    arrays = {"names": np.array(names)}
    arrays.update({f"p:{n}": p.detach().numpy() for n, p in params.items()})
    for s in range(STEPS):
        for n, g in torch_grads(model,
                                stacked_grads(variables, world, s)).items():
            arrays[f"g{s}:{n}"] = g.numpy()
    src, dst = tmp_path / "in.npz", tmp_path / "out"
    np.savez(src, **arrays)
    spawn_ranks(_WORKER, world, (src, dst, STEPS, json.dumps(CONFIGS)))
    outs = [np.load(f"{dst}.{r}.npz") for r in range(world)]
    counts = json.loads(str(outs[0]["counts"]))
    plan = tb.plan_buckets(params, MLP_MB)
    assert plan.num_buckets == 3

    def final(name):
        return {n: outs[0][f"{name}/p/{n}"] for n in names}

    # every rank holds the same parameters
    for name, *_ in CONFIGS:
        for out in outs[1:]:
            for n in names:
                np.testing.assert_array_equal(out[f"{name}/p/{n}"],
                                              final(name)[n])
    # port leader == port allgather; bucketed identity == per-leaf. At
    # world 4 int8's leader takes dense_scatter, whose reduce-scatter sums
    # the decoded gradients in gloo's order, not the decode-sum's rank
    # order; and gloo's ring sums a bucket's elements in another order
    # than a leaf's
    for a, b, exact in [
            ("leader_identity_leaf", "ag_identity_leaf", True),
            ("leader_identity_bucket", "ag_identity_bucket", True),
            ("leader_int8_bucket", "ag_int8_bucket", world == 2),
            ("ag_identity_bucket", "ag_identity_leaf", world == 2)]:
        for n in names:
            if exact:
                np.testing.assert_array_equal(final(a)[n], final(b)[n],
                                              err_msg=f"{a} {b} {n}")
            else:
                np.testing.assert_allclose(final(a)[n], final(b)[n],
                                           rtol=1e-6, atol=1e-7)

    want_lowering = {"identity": "psum_scatter", "ef_topk": "payload_gather",
                     "int8": "payload_gather" if world == 2
                     else "dense_scatter"}
    for name, mode, codec, mb in CONFIGS:
        c = counts[name]
        units = plan.num_buckets if mb else len(names)
        assert c.pop("units") == units, name
        lowering = c.pop("wire_lowering")
        if mode == "leader":
            assert lowering == want_lowering[codec], name
        assert c == _expected_calls(lowering, units), name
        if name in ("ag_identity_leaf",):
            continue
        jopt, jdata = _jax_run(variables, world, mode, codec, mb)
        assert jdata["wire_lowering"] == lowering, name
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(final(name)[n]))
        assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)
        if mode != "leader":
            continue
        # the ranks' rows, stacked, are the JAX LeaderState's arrays
        bplan = plan if mb else None
        keys = range(plan.num_buckets) if mb else names
        for field, jrows in (("shard", jopt.opt_state.param_shards),
                             ("mom", jopt.opt_state.inner.momentum_buf)):
            rows = {k: np.concatenate([out[f"{name}/{field}/{k}"]
                                       for out in outs]) for k in keys}
            got = _rows_per_leaf(model, bplan, rows)
            want = _jax_rows_per_leaf(model, variables, mb, jrows)
            for n in names:
                np.testing.assert_allclose(got[n], want[n], rtol=1e-6,
                                           atol=1e-7, err_msg=f"{name} {n}")

    for r, out in enumerate(outs):
        prims = json.loads(str(out["prims"]))
        assert prims["gather"] == ([[float(i)] * 3 for i in range(world)]
                                   if r == 0 else None)
        assert prims["bcast"] == [10.0] * 3
        assert prims["tree"] == [[20.0] * 3, [30.0] * 3]
        assert prims["calls"] == {"all_reduce": 0, "all_gather": 0,
                                  "reduce_scatter": 0, "broadcast": 3,
                                  "gather": 1, "all_to_all": 0,
                                  "ring_permute": 0}

"""The port's ``MPI_PS(param_specs=, mesh=, axis_name=, batch_spec=)``
(``ps.py``) over gloo at worlds 2 and 4 against the JAX ``MPI_PS`` on a
2- or 4-device sub-mesh of the virtual CPU mesh, from the same numpy
weights and batches, each rank holding its shard of every leaf (``interop.shards_from_jax``):

- tensor parallelism (``tp_mlp`` over (data, model)): SGD with momentum
  in allgather and leader mode, global-norm clipping in both, the payload
  path (``topk(fraction=1.0)``), Adam in leader mode, Adafactor with its
  scalar means over the model axis;
- expert parallelism over (data, expert) with tuple aggregation axes: the
  expert stacks sum over ``data`` only, the router over both;
- pipeline parallelism over (data, pipe) with ``batch_spec=P(None,
  "data")``;
- the 3-D toy transformer over (data, seq, model) with ring and with
  Ulysses attention, allgather and leader;

the parameters after the steps (to rtol 1e-6, the sums over the mesh
taken in another order than the JAX program's, ROADMAP queue 3 item 9;
the attention cases to rtol 1e-5; atol 1e-7, Adam's 1e-6), the reported
losses (rtol 1e-5), the
collective calls of a step and the wire accounting. Single-process: the
constructor's model-parallel errors are the JAX package's, word for
word; ``adafactor_check_sharding`` and ``adafactor_state_specs`` against
the JAX functions.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as JP

from pytorch_ps_mpi_tpu import optim as jax_optim
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh as jax_make_mesh
from pytorch_ps_mpi_tpu.parallel import ep as jep
from pytorch_ps_mpi_tpu.parallel import pp as jpp
from pytorch_ps_mpi_tpu.parallel import tp as jtp
from pytorch_ps_mpi_tpu.ps import MPI_PS as JMPI_PS
from torch_parity import spawn_ranks

D, F, GB, SEQ = 8, 32, 8, 4
N_EXP, N_TOK = 8, 32
ADA_N, ADA_M = 256, 160
VOCAB, D3, HEADS3, FFN3, L3, B3 = 64, 16, 4, 32, 16, 4


def cases(world: int) -> dict:
    """name -> (model, mesh shape, axis names, aggregation axes, MPI_PS
    options, steps, batch spec)."""
    dp, other = world // 2, 2
    tp2 = ("tp", (dp, other), ("data", "model"), "data")
    c3 = ("3d", (1, 2, world // 2), ("data", "seq", "model"),
          ("data", "seq"))
    return {
        "tp_sgd": (*tp2, dict(optim="sgd", lr=0.1, momentum=0.9), 3),
        "tp_leader_sgd": (*tp2, dict(optim="sgd", lr=0.1, momentum=0.9,
                                     mode="leader"), 3),
        "tp_clip": (*tp2, dict(optim="sgd", lr=0.1, clip_norm=0.05), 2),
        "tp_leader_clip": (*tp2, dict(optim="sgd", lr=0.1, clip_norm=0.05,
                                      mode="leader"), 2),
        "tp_topk": (*tp2, dict(optim="sgd", lr=0.1, code="topk"), 2),
        "tp_leader_adam": (*tp2, dict(optim="adam", lr=1e-2,
                                      mode="leader"), 3),
        "ada": ("ada", (dp, other), ("data", "model"), "data",
                dict(optim="adafactor", lr=1e-2), 2),
        "ep": ("ep", (dp, other), ("data", "expert"), ("data", "expert"),
               dict(optim="sgd", lr=0.1), 2),
        "pp": ("pp", (dp, other), ("data", "pipe"), "data",
               dict(optim="sgd", lr=0.1), 2),
        "3d_ring": (*c3, dict(optim="sgd", lr=0.5), 2),
        "3d_ulysses": (*c3, dict(optim="sgd", lr=0.5, sp="ulysses"), 2),
        "3d_leader": (*c3, dict(optim="adam", lr=1e-2, mode="leader"), 2),
    }


def inputs(world: int) -> dict:
    """Global weights and batches, numpy, keyed ``<model>/<leaf>`` and
    ``<model>:<batch part>``."""
    rng = np.random.RandomState(21)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    tp_n, dp = 2, world // 2
    out = {}
    for k, v in {"w1": 0.3 * f(tp_n, D, F // tp_n),
                 "b1": 0.1 * f(tp_n, F // tp_n),
                 "w2": 0.3 * f(tp_n, F // tp_n, D), "b2": 0.1 * f(D)}.items():
        out["tp/" + k] = v
    out["tp:x"], out["tp:y"] = f(GB, SEQ, D), f(GB, SEQ, D)
    out["ada/w"], out["ada/b"] = 0.1 * f(2, ADA_N, ADA_M), 0.1 * f(2, ADA_M)
    out["ada:c"] = np.zeros((2 * dp,), np.float32)
    out["ep/wr"], out["ep/w1"], out["ep/w2"] = (
        0.1 * f(D, N_EXP), 0.1 * f(N_EXP, D, 16), 0.1 * f(N_EXP, 16, D))
    out["ep:x"], out["ep:y"] = f(N_TOK, D), f(N_TOK, D)
    out["pp/w1"], out["pp/w2"] = 0.1 * f(2, D, 2 * D), 0.1 * f(2, 2 * D, D)
    out["pp:x"], out["pp:y"] = f(4, 2 * dp, D), f(4, 2 * dp, D)
    tpa = world // 2
    out["3d/emb"], out["3d/pos"] = 0.02 * f(VOCAB, D3), 0.02 * f(L3, D3)
    out["3d/head"] = 0.02 * f(D3, VOCAB)
    out["3d/attn.wqkv"] = 0.02 * f(tpa, D3, 3, HEADS3 // tpa, D3 // HEADS3)
    out["3d/attn.wo"] = 0.02 * f(tpa, (HEADS3 // tpa) * (D3 // HEADS3), D3)
    out["3d/attn.bo"] = np.zeros((D3,), np.float32)
    out["3d/mlp.w1"] = 0.02 * f(tpa, D3, FFN3 // tpa)
    out["3d/mlp.b1"] = np.zeros((tpa, FFN3 // tpa), np.float32)
    out["3d/mlp.w2"] = 0.02 * f(tpa, FFN3 // tpa, D3)
    out["3d/mlp.b2"] = np.zeros((D3,), np.float32)
    out["3d:tok"] = rng.randint(1, VOCAB, (B3, L3)).astype(np.int64)
    return out


def leaf_specs(model: str, names) -> dict:
    """``name -> spec entries`` (tuples, for either package)."""
    shard = {"tp": "model", "ada": "model", "pp": "pipe"}
    out = {}
    for n in names:
        if model in shard:
            rep = model == "tp" and n == "b2"
            out[n] = () if rep else (shard[model],)
        elif model == "ep":
            out[n] = () if n == "wr" else ("expert",)
        else:  # 3d: the TP leaves of more than one dim
            out[n] = ("model",) if (n.startswith(("attn", "mlp"))
                                    and n not in ("attn.bo", "mlp.b2")) \
                else ()
    return out


BATCH_SPECS = {"tp": ("data",), "ada": None, "ep": (("data", "expert"),),
               "pp": (None, "data"), "3d": ("data", "seq")}

_WORKER = """
import json, sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import MPI_PS, comms, mesh
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.mesh import P
from pytorch_ps_mpi_tpu_torch.parallel import ep, pp, tp
from pytorch_ps_mpi_tpu_torch.utils.interop import shards_from_jax
from test_torch_model_parallel_ps import (BATCH_SPECS, D, GB, L3, SEQ, B3,
                                          N_TOK, cases, leaf_specs)

rank, world, port, src, dst = sys.argv[1:7][:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
data = np.load(src)
out, calls, meta = {}, {}, {}


def loss_fns(model, m, opt_kw):
    if model == "tp":
        def f(p, b):
            pred = tp.tp_mlp(b[0], p, "model", local_grads=True, mesh=m)
            return ((pred - b[1]) ** 2).sum() / (GB * SEQ * D)
    elif model == "ada":
        def f(p, b):
            return 0.5 * (p["w"] ** 2).sum() + (p["b"] ** 3).sum() + 0 * b.sum()
    elif model == "ep":
        def f(p, b):
            o = ep.moe_apply(b[0], p, "expert", capacity=N_TOK, mesh=m)
            return ((o - b[1]) ** 2).sum() / (N_TOK * D)
    elif model == "pp":
        def f(p, b):
            def stage(q, x):
                return x + torch.nn.functional.gelu(
                    x @ q["w1"], approximate="tanh") @ q["w2"]
            return pp.pipeline_loss(p, b[0], b[1], stage,
                                    lambda o, t: ((o - t) ** 2).mean(),
                                    "pipe", local_grads=True,
                                    mesh=m) / m.shape["data"]
    else:
        sp = opt_kw.pop("sp", "ring")
        l_local = L3 // m.shape["seq"]

        def f(p, toks):
            off = m.axis_index("seq") * l_local
            x = p["emb"][toks] + p["pos"][off + torch.arange(l_local)][None]
            attn = {k[5:]: v for k, v in p.items() if k.startswith("attn.")}
            mlp = {k[4:]: v for k, v in p.items() if k.startswith("mlp.")}
            x = x + tp.tp_self_attention(x, attn, "model", seq_axis="seq",
                                         sp=sp, local_grads=True, mesh=m)
            x = x + tp.tp_mlp(x, mlp, "model", local_grads=True, mesh=m)
            ll = torch.log_softmax(x @ p["head"], dim=-1)
            ll = torch.gather(ll, -1, toks[..., None])[..., 0]
            return -ll.sum() / (B3 * L3)
    return f


for name, (model, shape, axes, agg, opt_kw, steps) in cases(world).items():
    m = mesh.make_mesh(shape, axes)
    opt_kw = dict(opt_kw)
    if opt_kw.get("code") == "topk":
        opt_kw["code"] = get_codec("topk", fraction=1.0)
    names = sorted(k.split("/", 1)[1] for k in data.files
                   if k.startswith(model + "/"))
    specs = {n: P(*s) for n, s in leaf_specs(model, names).items()}
    params = shards_from_jax({n: data[f"{model}/{n}"] for n in names},
                             specs, m)
    batch = [torch.from_numpy(data[k]) for k in sorted(data.files)
             if k.startswith(model + ":")]
    batch = batch[0] if len(batch) == 1 else tuple(batch)
    bs = BATCH_SPECS[model]
    loss_fn = loss_fns(model, m, opt_kw)
    opt = MPI_PS(params, mesh=m, axis_name=agg, param_specs=specs,
                 batch_spec=None if bs is None else P(*bs), device="cpu",
                 **opt_kw)
    losses = []
    for s in range(steps):
        comms.reset_calls()
        loss, d = opt.step(loss_fn=loss_fn, batch=batch)
        losses.append(float(loss))
    calls[name] = {k: v for k, v in comms.calls.items() if v}
    meta[name] = [losses, d["wire_lowering"], d["wire_bytes_per_worker"]]
    for n, p in opt.params.items():
        out[f"{name}/{n}"] = p.numpy()
np.savez(f"{dst}.{rank}.npz", calls=json.dumps(calls), meta=json.dumps(meta),
         **out)
torch.distributed.destroy_process_group()
"""


def _jax_loss_fn(model, shape, opt_kw):
    if model == "tp":
        def f(p, b):
            pred = jtp.tp_mlp(b[0], p, "model", local_grads=True)
            return ((pred - b[1]) ** 2).sum() / (GB * SEQ * D)
    elif model == "ada":
        def f(p, b):
            return 0.5 * (p["w"] ** 2).sum() + (p["b"] ** 3).sum() + 0 * b.sum()
    elif model == "ep":
        def f(p, b):
            o = jep.moe_apply(b[0], p, "expert", capacity=N_TOK)
            return ((o - b[1]) ** 2).sum() / (N_TOK * D)
    elif model == "pp":
        def f(p, b):
            def stage(q, x):
                return x + jax.nn.gelu(x @ q["w1"]) @ q["w2"]
            return jpp.pipeline_loss(p, b[0], b[1], stage,
                                     lambda o, t: jnp.mean((o - t) ** 2),
                                     "pipe", local_grads=True) / shape[0]
    else:
        sp = opt_kw.pop("sp", "ring")
        l_local = L3 // shape[1]

        def f(p, toks):
            off = lax.axis_index("seq") * l_local
            x = p["emb"][toks] + p["pos"][off + jnp.arange(l_local)][None]
            x = x + jtp.tp_self_attention(x, p["attn"], "model",
                                          seq_axis="seq", sp=sp,
                                          local_grads=True)
            x = x + jtp.tp_mlp(x, p["mlp"], "model", local_grads=True)
            ll = jax.nn.log_softmax(x @ p["head"], axis=-1)
            ll = jnp.take_along_axis(ll, toks[..., None], axis=-1)[..., 0]
            return -ll.sum() / (B3 * L3)
    return f


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _jax_case(data, world, model, shape, axes, agg, opt_kw, steps):
    opt_kw = dict(opt_kw)
    if opt_kw.get("code") == "topk":
        opt_kw["code"] = jax_codec("topk", fraction=1.0)
    mesh = jax_make_mesh(shape=shape, axis_names=axes,
                         devices=jax.devices()[:int(np.prod(shape))])
    names = sorted(k.split("/", 1)[1] for k in data if k.startswith(model + "/"))
    flat = {n: jnp.asarray(data[f"{model}/{n}"]) for n in names}
    specs = {n: JP(*s) for n, s in leaf_specs(model, names).items()}
    batch = [jnp.asarray(data[k]) for k in sorted(data)
             if k.startswith(model + ":")]
    batch = batch[0] if len(batch) == 1 else tuple(batch)
    loss_fn = _jax_loss_fn(model, shape, opt_kw)
    bs = BATCH_SPECS[model]
    opt = JMPI_PS(_nest(flat), mesh=mesh, axis_name=agg,
                  param_specs=_nest(specs),
                  batch_spec=JP(agg) if bs is None else JP(*bs), **opt_kw)
    losses = []
    for _ in range(steps):
        loss, d = opt.step(loss_fn=loss_fn, batch=batch)
        losses.append(float(loss))
    params = {}
    for n in names:
        node = opt.params
        for p in n.split("."):
            node = node[p]
        params[n] = np.asarray(node)
    return params, specs, losses, d


def _joined(ranks, name, leaf, spec, jmesh_shape, axes):
    """The global leaf from the ranks' shards: rank r sits at
    ``unravel_index(r, shape)``; a sharded dim 0 joins over its axis at
    the other coordinates 0."""
    if not spec:
        return ranks[0][f"{name}/{leaf}"]
    ax = spec[0] if isinstance(spec[0], str) else spec[0][0]
    i = axes.index(ax)
    parts = []
    for c in range(jmesh_shape[i]):
        coord = [0] * len(jmesh_shape)
        coord[i] = c
        parts.append(ranks[int(np.ravel_multi_index(coord, jmesh_shape))][
            f"{name}/{leaf}"])
    return np.concatenate(parts, 0)


@pytest.mark.parametrize("world", [2, 4])
def test_model_parallel_steps_match_jax_over_gloo(tmp_path, world):
    data = inputs(world)
    src = tmp_path / "in.npz"
    np.savez(src, **data)
    spawn_ranks(_WORKER, world, [src, tmp_path / "out"])
    ranks = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    metas = [json.loads(str(r["meta"])) for r in ranks]
    calls = [json.loads(str(r["calls"])) for r in ranks]
    for name, (model, shape, axes, agg, opt_kw, steps) in cases(world).items():
        want, specs, losses, jdata = _jax_case(data, world, model, shape,
                                               axes, agg, opt_kw, steps)
        rtol = 1e-5 if model == "3d" else 1e-6
        # Adam's m/sqrt(v) turns a gradient's last bits near 0 into lr-sized
        # steps: atol 1e-6 there
        atol = 1e-6 if opt_kw["optim"] == "adam" else 1e-7
        for leaf, w in want.items():
            got = _joined(ranks, name, leaf, tuple(specs[leaf]), shape, axes)
            np.testing.assert_allclose(got, w, rtol=rtol, atol=atol,
                                       err_msg=f"{name} {leaf}")
        # the Adafactor case's loss is each model shard's own, and the JAX
        # step reports device 0's
        for meta in metas[:1] if model == "ada" else metas:
            np.testing.assert_allclose(meta[name][0], losses, rtol=1e-5,
                                       err_msg=name)
            assert meta[name][1] == jdata["wire_lowering"], name
            assert meta[name][2] == pytest.approx(
                jdata["wire_bytes_per_worker"]), name
    # a TP step's collectives: one all-reduce a leaf over data, the loss's
    # over data and the row-parallel product's over model (allgather);
    # leader mode a reduce-scatter and an all-gather a leaf
    # (at world 2 the data axis has one rank: its sums are the identity)
    dp = world // 2
    for c in calls:
        if dp > 1:
            assert c["tp_sgd"] == {"all_reduce": 4 + 1 + 1}
            assert c["tp_leader_sgd"] == {"all_reduce": 2,
                                          "reduce_scatter": 4,
                                          "all_gather": 4}
        else:
            assert c["tp_sgd"] == c["tp_leader_sgd"] == {"all_reduce": 1}
        assert c["3d_ulysses"]["all_to_all"] == 4


def _guard_cases():
    tp_params = {"w1": np.zeros((2, D, F // 2), np.float32),
                 "b2": np.zeros((D,), np.float32)}
    tp_specs = {"w1": ("model",), "b2": ()}
    return [
        (tp_params, tp_specs, dict(axis_name="model", mode="leader")),
        (tp_params, tp_specs, dict(bucket_mb=1.0)),
        (tp_params, tp_specs, dict(numerics=True)),
        (tp_params, tp_specs, dict(instrument=True)),
        ({"w": np.zeros((D, 4), np.float32)}, {"w": (None, "model")},
         dict(mode="leader")),
        ({"w": np.zeros((2, 256, 160), np.float32)},
         {"w": (None, "model")}, dict(optim="adafactor")),
    ]


@pytest.mark.parametrize("case", range(6))
def test_constructor_errors_are_the_jax_packages(case):
    from pytorch_ps_mpi_tpu_torch import MPI_PS
    from pytorch_ps_mpi_tpu_torch import mesh as tmesh

    params, specs, kw = _guard_cases()[case]
    kw = {"axis_name": "data", **kw}
    jmesh = jax_make_mesh(shape=(1, 1), axis_names=("data", "model"),
                          devices=jax.devices()[:1])
    with pytest.raises(Exception) as jerr:
        JMPI_PS({k: jnp.asarray(v) for k, v in params.items()}, mesh=jmesh,
                param_specs={k: JP(*s) for k, s in specs.items()}, **kw)
    with pytest.raises(Exception) as terr:
        MPI_PS({k: torch.from_numpy(v) for k, v in params.items()},
               mesh=tmesh.make_mesh((1, 1), ("data", "model")),
               param_specs={k: tmesh.P(*s) for k, s in specs.items()},
               device="cpu", **kw)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def test_adafactor_sharding_helpers_match_jax():
    from pytorch_ps_mpi_tpu_torch import optim
    from pytorch_ps_mpi_tpu_torch.mesh import P

    shapes = {"w": (2, 256, 160), "b": (2, 160), "e": (4, 8, 8),
              "m": (300, 200)}
    specs = {"w": ("model",), "b": ("model",), "e": ("model",), "m": ()}
    jparams = {k: jnp.zeros(s) for k, s in shapes.items()}
    got = optim.adafactor_state_specs(shapes,
                                      {k: P(*s) for k, s in specs.items()})
    want = jax_optim.adafactor_state_specs(
        jparams, {k: JP(*s) for k, s in specs.items()})
    for field in ("v_row", "v_col", "v_full"):
        assert {k: tuple(v) for k, v in getattr(got, field).items()} == \
            {k: tuple(v) for k, v in getattr(want, field).items()}, field
    optim.adafactor_check_sharding(shapes, {k: P(*s)
                                            for k, s in specs.items()})
    with pytest.raises(NotImplementedError) as terr:
        optim.adafactor_check_sharding({"m": (300, 200)},
                                       {"m": P(None, "model")})
    with pytest.raises(NotImplementedError) as jerr:
        jax_optim.adafactor_check_sharding({"m": jnp.zeros((300, 200))},
                                           {"m": JP(None, "model")})
    assert str(terr.value) == str(jerr.value)

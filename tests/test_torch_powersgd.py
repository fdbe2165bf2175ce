"""The port's PowerSGD codec and its two-all-reduce protocol against the
JAX package's, on the same numpy inputs, with the JAX warm-start Q
carried across (``utils.interop.codec_state_from_jax``):

- the per-rank ``encode`` over three steps with its state carried, and
  ``decode``, ``decode_sum`` and ``aggregate`` (the factors side by
  side), on a matrix, a leaf with leading singleton dims, a leaf below
  ``min_compression_elems``, a leaf whose rank-r factors would not be
  smaller, and a vector; compressed leaves to 1e-5 of each tensor's
  largest magnitude (matmuls and the QR sum in another order than XLA's;
  the QR's column signs may differ, so P and Q are held up to their
  signs), uncompressed ones bit for bit;
- the warm-start Q: the same on every call and every rank, seeded with
  the JAX package's ``hash((n, m, r)) % 2**31``;
- grads-only ``SGD`` steps of the width-32 ResNet-18 at world 1 through
  ``fused_allreduce`` in ``mode="allgather"`` and ``mode="leader"``:
  parameters to 1e-4 and the carried residual to 1e-2 of each leaf's
  largest magnitude. A flax 3×3 kernel is viewed as a 3 × (9·in·out)
  matrix whose three singular values nearly tie on random gradients, so
  which rank-2 subspace the power iteration keeps is ill-conditioned:
  float32 sums in another order grow to 2.3e-3 of the residual and 1.7e-5
  of the parameters in three steps (the BERT-base leaves on the card hold
  1e-5, ``chip_smoke.py``);
- ``wire_lowering`` (``two_psum_lowrank``) and ``wire_bytes_per_worker``
  at worlds 1, 2 and 4, and the layouts ``codec_state_from_jax`` gives;
- the fused step at worlds 2 and 4, one process a rank over gloo, in both
  modes, against the JAX step on a 2- and 4-device mesh (rtol 1e-5, atol
  1e-6), with its all-reduce count.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.codecs.powersgd import _matrix_shape, warm_seed
from pytorch_ps_mpi_tpu_torch.utils.interop import (codec_state_from_jax,
                                                    flax_path,
                                                    params_from_jax,
                                                    params_to_jax,
                                                    torch_layout)
from torch_parity import (HYPER, STEPS, assert_params_close, codec_views,
                          jax_resnet, mlp_pair, spawn_ranks, stacked_grads,
                          torch_grads, torch_resnet)

RTOL = 1e-5  # of each tensor's largest magnitude


def _close(got, want, rtol=RTOL) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _to_torch(state):
    if isinstance(state, dict):
        return {k: _to_torch(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_to_torch(v) for v in state)
    return torch.from_numpy(np.array(state))


SHAPES = {"matrix": (64, 48), "leading-ones": (1, 1, 40, 30),
          "below-min": (30, 20), "no-saving": (3, 3, 8, 16),
          "vector": (5,)}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_encode_and_decodes_over_three_steps_with_carried_q(case):
    shape = SHAPES[case]
    jc, tc = jax_codec("powersgd", rank=4), get_codec("powersgd", rank=4)
    compresses = tc._compresses(shape)
    assert compresses == jc._compresses(shape) == (case in ("matrix",
                                                            "leading-ones"))
    js = jc.init_state(shape, jnp.float32)
    ts = _to_torch(js)
    encode = jax.jit(lambda g, s: jc.encode(g, s))
    rng = np.random.RandomState(len(case))
    for _ in range(3):
        xs = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
        jp, js_next = encode(jnp.asarray(xs[0]), js)
        tp, ts_next = tc.encode(torch.from_numpy(xs[0]), ts)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert tuple(jp[k].shape) == tuple(tp[k].shape)
            assert tp[k].dtype == torch.float32
        if compresses:
            # P and Q up to the signs of their columns
            signs = np.sign(np.sum(np.asarray(jp["P"]) * tp["P"].numpy(), 0))
            _close(tp["P"].numpy() * signs, jp["P"])
            _close(tp["Q"].numpy() * signs, jp["Q"])
            _close(ts_next["memory"], js_next["memory"])
        else:
            assert np.array_equal(tp["raw"].numpy(), np.asarray(jp["raw"]))
        _close(tc.decode(tp, shape, torch.float32),
               jc.decode(jp, shape, jnp.float32))
        jps = [jp, encode(jnp.asarray(xs[1]), js)[0]]
        tps = [tp, tc.encode(torch.from_numpy(xs[1]), ts)[0]]
        jst = {k: jnp.stack([p[k] for p in jps]) for k in jp}
        tst = {k: torch.stack([p[k] for p in tps]) for k in tp}
        _close(tc.decode_sum(tst, shape, torch.float32),
               jax.jit(lambda p: jc.decode_sum(p, shape, jnp.float32))(jst))
        agg, meta = tc.aggregate(tst, shape, torch.float32)
        jagg, jmeta = jc.aggregate(jst, shape, jnp.float32)
        assert meta == jmeta and {k: tuple(v.shape) for k, v in agg.items()} \
            == {k: tuple(v.shape) for k, v in jagg.items()}
        js, ts = js_next, ts_next
        assert tc.payload_bits(shape, torch.float32) == jc.payload_bits(
            shape, jnp.float32)


def test_warm_start_q_is_shared_and_seeded_as_jax_keys_it():
    code = get_codec("powersgd", rank=4)
    shape = (64, 48)
    n, m = _matrix_shape(shape)
    assert warm_seed(n, m, 4) == int(np.int64(hash((n, m, 4))) % (2 ** 31))
    a, b = (code.init_state(shape, torch.float32, "cpu") for _ in range(2))
    assert torch.equal(a["Q"], b["Q"]) and a["Q"].shape == (m, 4)
    assert not a["memory"].any()
    assert code.init_state(shape, torch.float32, "meta")["Q"].is_meta
    assert code.init_state((5,), torch.float32, "cpu") == ()
    assert _matrix_shape((1, 1, 40, 30)) == (40, 30)


def test_fused_allreduce_at_world_one_is_the_encode():
    code = get_codec("powersgd", rank=2)
    g = torch.from_numpy(np.random.RandomState(0).randn(48, 32)
                         .astype(np.float32))
    state = code.init_state((48, 32), torch.float32, "cpu")
    summed, fused = code.fused_allreduce(g, state)
    payload, enc = code.encode(g, state)
    assert torch.equal(summed, code.decode(payload, (48, 32), torch.float32))
    assert torch.equal(fused["memory"], enc["memory"])
    assert torch.equal(fused["Q"], enc["Q"])
    raw, same = code.fused_allreduce(g[0], (), comm_dtype=torch.bfloat16)
    assert same == () and raw.dtype == torch.float32
    assert torch.equal(raw, g[0].to(torch.bfloat16).float())


def _jax_state_rows(jopt, model, code):
    return {n: _to_torch(s) for n, s in codec_state_from_jax(
        jopt.codec_state, model, code).items()}


@pytest.mark.parametrize("mode", ["allgather", "leader"])
def test_resnet18_fused_step_matches_jax(mode):
    _, variables = jax_resnet()
    kw = {"rank": 2}
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=jax_codec("powersgd", **kw), mode=mode,
                mesh=make_mesh(devices=jax.devices()[:1]), **HYPER)
    model = torch_resnet()
    code = get_codec("powersgd", **kw)
    opt = SGD(model, code=code, device="cpu", mode=mode, **HYPER)
    opt.codec_state = _jax_state_rows(jopt, model, code)
    assert sum(bool(s) for s in opt.codec_state.values()) == sum(
        code._compresses(opt._view_shape(k)) for k in opt.params)
    for s in range(STEPS):
        grads = stacked_grads(variables, 1, s)
        jopt.step(grads=jax.tree.map(jnp.asarray, grads))
        opt.step(grads=torch_grads(model, grads))
    got = jax.tree.leaves(params_to_jax(model))
    for a, b in zip(got, jax.tree.leaves(jopt.params)):
        _close(a, b, rtol=1e-4)
    want = _jax_state_rows(jopt, model, code)
    for n, st in opt.codec_state.items():
        if st:
            _close(st["memory"], want[n]["memory"], rtol=1e-2)


@pytest.mark.parametrize("comm_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("mode", ["allgather", "leader"])
def test_wire_accounting_matches_jax(mode, world, comm_dtype):
    _, variables = jax_resnet()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=jax_codec("powersgd", rank=4), mode=mode,
                comm_dtype=getattr(jnp, comm_dtype) if comm_dtype else None,
                mesh=make_mesh(devices=jax.devices()[:world]), **HYPER)
    opt = SGD(torch_resnet(), code=get_codec("powersgd", rank=4),
              device="cpu", mode=mode,
              comm_dtype=getattr(torch, comm_dtype) if comm_dtype else None,
              **HYPER)
    opt.size = world  # the accounting of a world-rank step
    got = opt._static_metrics()
    assert got["wire_lowering"] == "two_psum_lowrank"
    assert (got["wire_lowering"], got["wire_bytes_per_worker"]) == \
        jopt._wire_accounting
    assert got["packaged_bytes"] == jopt._payload_bytes


def test_codec_state_from_jax_keeps_each_codec_in_its_layout():
    """Order-dependent codecs keep their state in the flax layout (their
    view); error feedback around sign keeps the port's layout."""
    variables, model = mlp_pair()
    name = "layers.0.weight"
    path = flax_path(model, name)
    mesh = make_mesh(devices=jax.devices()[:2])
    for inner, flax_kept in [("sign", False), ("threshold", True)]:
        jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                    code=jax_codec("ef", inner_name=inner), mesh=mesh,
                    **HYPER)
        jopt.step(grads=jax.tree.map(jnp.asarray,
                                     stacked_grads(variables, 2, 0)))
        rows = codec_state_from_jax(jopt.codec_state, model,
                                    get_codec("ef", inner_name=inner), rank=1)
        node = jopt.codec_state["params"]
        for key in path:
            node = node[key]
        flax_mem = np.asarray(node["memory"])[1]
        want = flax_mem if flax_kept else torch_layout(path, flax_mem)
        np.testing.assert_array_equal(rows[name]["memory"], want)
        assert list(rows) == list(params_from_jax(variables, model))
        if flax_kept:
            assert rows[name]["inner"]["tau"].shape == ()
    assert dict(model.named_parameters())[name].codec_view == (1, 0)


# -- the fused step over gloo -------------------------------------------------------

_WORKER = """
import sys
import json
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import SGD, comms, mesh
from pytorch_ps_mpi_tpu_torch.codecs import get_codec

rank, world, port, src, dst, steps = sys.argv[1:7]
rank, world, steps = int(rank), int(world), int(steps)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
data = np.load(src)
names = [str(n) for n in data["names"]]
out, calls = {}, {}
for mode in ("allgather", "leader"):
    params = {n: torch.from_numpy(data["p:" + n].copy()) for n in names}
    for n in names:
        if "v:" + n in data.files:  # the model's kernel tags, carried across
            params[n].codec_view = tuple(int(d) for d in data["v:" + n])
    opt = SGD(params, lr=0.01, momentum=0.9, device="cpu", mode=mode,
              code=get_codec("powersgd", rank=2))
    for n in names:
        if "q:" + n in data.files:
            opt.codec_state[n]["Q"] = torch.from_numpy(data["q:" + n].copy())
    for s in range(steps):
        comms.reset_calls()
        opt.step(grads={n: torch.from_numpy(data[f"g{s}:" + n])
                        for n in names})
    calls[mode] = {k: v for k, v in comms.calls.items() if v}
    out.update({f"{mode}/{n}": p.numpy() for n, p in params.items()})
np.savez(f"{dst}.{rank}.npz", calls=np.array(json.dumps(calls)), **out)
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_fused_step_over_gloo(tmp_path, world):
    variables, model = mlp_pair()
    params = params_from_jax(variables, model)
    code = get_codec("powersgd", rank=2)
    mesh = make_mesh(devices=jax.devices()[:world])
    jopts = {mode: JSGD(jax.tree.map(jnp.asarray, variables),
                        code=jax_codec("powersgd", rank=2), mode=mode,
                        mesh=mesh, **HYPER)
             for mode in ("allgather", "leader")}
    arrays = {"names": np.array(list(params))}
    arrays.update({f"p:{n}": p.detach().numpy() for n, p in params.items()})
    arrays.update({f"v:{n}": np.array(v)
                   for n, v in codec_views(model).items()})
    rows = codec_state_from_jax(jopts["allgather"].codec_state, model, code)
    arrays.update({f"q:{n}": st["Q"] for n, st in rows.items() if st})
    assert len([n for n, st in rows.items() if st]) == 1
    for s in range(STEPS):
        grads = stacked_grads(variables, world, s)
        for jopt in jopts.values():
            jopt.step(grads=jax.tree.map(jnp.asarray, grads))
        for n, g in torch_grads(model, grads).items():
            arrays[f"g{s}:{n}"] = g.numpy()
    src, dst = tmp_path / "in.npz", tmp_path / "out"
    np.savez(src, **arrays)
    spawn_ranks(_WORKER, world, (src, dst, STEPS))
    for r in range(world):
        out = np.load(f"{dst}.{r}.npz")
        # two all-reduces for the one compressed leaf, one for each of the
        # three others; the leader all-gathers the 4 leaves' shards back
        assert json.loads(str(out["calls"])) == {
            "allgather": {"all_reduce": 5},
            "leader": {"all_reduce": 5, "all_gather": 4}}
        for mode, jopt in jopts.items():
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(out[f"{mode}/{n}"]))
            assert_params_close(model, jopt.params, rtol=1e-5, atol=1e-6)

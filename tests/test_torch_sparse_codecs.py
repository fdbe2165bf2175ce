"""The port's sparse codecs, ``randomk``, ``blocktopk``, ``blocktopk8`` and
``threshold``, against the JAX package's on the same numpy inputs, the
JAX codec run under ``jax.jit``:

- every payload key for key, in dtype, shape and bytes (random-k fed the
  JAX encode's own uniforms, ``jax.random.uniform(key, (k,))``), and
  ``decode``, ``decode_sum`` and ``aggregate``/``agg_decode`` bit for bit,
  over ragged tail blocks, a single block, pad-slot picks and ties, a
  threshold cap that survivors overflow and the adaptive tau of
  ``target_fraction`` over three steps (tau to rtol 1e-6: the JAX
  ``ratio ** eta`` is XLA's pow), and error feedback around threshold
  and block top-k;
- grads-only ``SGD`` steps (world 1): random-k per leaf and bucketed on
  the MLP, and each codec on the width-32 ResNet-18, through the codecs'
  views of the PyTorch layouts (the kernels' ``codec_view`` tags);
  parameters to rtol
  1e-6, atol 1e-7 (the jitted JAX update contracts into fused
  multiply-adds);
- the metrics' ``wire_lowering`` and ``wire_bytes_per_worker`` at worlds
  1, 2 and 4, the constructor errors, and ``comms.ragged_all_gather``;
- threshold's ragged step at worlds 2 and 4, one process a rank over
  gloo, against the JAX step on a 2- and 4-device mesh (rtol 1e-6, atol
  1e-7: gloo sums in its own order, ROADMAP queue 3 item 9).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu_torch import SGD, comms
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.utils.interop import (flax_layout, flax_path,
                                                    params_from_jax,
                                                    torch_layout)
from torch_parity import (HYPER, STEPS, assert_params_close, codec_views,
                          jax_resnet, mlp_pair, spawn_ranks, stacked_grads,
                          torch_grads, torch_resnet)


def _key(i: int):
    return jax.random.key(100 + i)


def _jax_payload(code, x: np.ndarray, i: int, state=()):
    """The JAX codec's jitted encode of ``x`` for rank ``i``."""
    return jax.jit(lambda g, s: code.encode(g, s, _key(i)))(
        jnp.asarray(x), state)


def _port_payload(code, x: np.ndarray, i: int, state=()):
    g = torch.from_numpy(x)
    if code.needs_rng:
        k = code._k_for(x.shape)
        u = np.array(jax.random.uniform(_key(i), (k,)))
        return code.sample(g, torch.from_numpy(u)), state
    return code.encode(g, state)


def _assert_same_payload(jp: dict, tp: dict) -> None:
    assert sorted(jp) == sorted(tp)
    for k in jp:
        a, b = np.asarray(jp[k]), tp[k].numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        assert a.tobytes() == b.tobytes(), k


def _same(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _check_codec(name: str, kw: dict, xs: list) -> None:
    """Payloads, decode, decode_sum and aggregate/agg_decode of the ranks'
    ``xs`` on both sides, bit for bit."""
    jc, tc = jax_codec(name, **kw), get_codec(name, **kw)
    shape = xs[0].shape
    jps = [_jax_payload(jc, x, i, jc.init_state(shape, jnp.float32))[0]
           for i, x in enumerate(xs)]
    tps = [_port_payload(tc, x, i, tc.init_state(shape, torch.float32,
                                                 "cpu"))[0]
           for i, x in enumerate(xs)]
    for jp, tp in zip(jps, tps):
        _assert_same_payload(jp, tp)
    jst = {k: jnp.stack([p[k] for p in jps]) for k in jps[0]}
    tst = {k: torch.stack([p[k] for p in tps]) for k in tps[0]}
    f32 = jnp.float32
    _same(jax.jit(lambda p: jc.decode(p, shape, f32))(jps[0]),
          tc.decode(tps[0], shape, torch.float32))
    _same(jax.jit(lambda p: jc.decode_sum(p, shape, f32))(jst),
          tc.decode_sum(tst, shape, torch.float32))
    _same(jax.jit(lambda p: jc.agg_decode(*jc.aggregate(p, shape, f32),
                                          shape, f32))(jst),
          tc.agg_decode(*tc.aggregate(tst, shape, torch.float32), shape,
                        torch.float32))
    assert tc.payload_bits(shape, torch.float32) == jc.payload_bits(
        shape, jnp.float32)


CASES = {
    "randomk-frac": ("randomk", {"fraction": 0.1}, (37, 11), 2),
    "randomk-k": ("randomk", {"k": 7}, (100,), 3),
    "randomk-biased": ("randomk", {"fraction": 0.05, "unbiased": False},
                       (64, 64), 2),
    # 3,000 = 23 blocks of 128 and a tail of 56
    "blocktopk-tail": ("blocktopk", {"fraction": 0.01, "block_size": 128},
                       (1000, 3), 2),
    "blocktopk-one-block": ("blocktopk", {"fraction": 0.05,
                                          "block_size": 256}, (100,), 2),
    # BERT's qkv bias: 3 blocks of 1024, the last 768 of it padding
    "blocktopk-qkv-bias": ("blocktopk", {"fraction": 0.01}, (3, 12, 64), 2),
    "blocktopk8-tail": ("blocktopk8", {"fraction": 0.01, "block_size": 128},
                        (1000, 3), 2),
    "blocktopk8-one-block": ("blocktopk8", {"fraction": 0.05,
                                            "block_size": 256}, (100,), 2),
    "blocktopk8-qkv-bias": ("blocktopk8", {"fraction": 0.01},
                            (3, 12, 64), 3),
    "threshold": ("threshold", {"tau": 2.0, "max_fraction": 0.05},
                  (1000, 3), 2),
    # ~62% survive tau 0.5, against a cap of 5%
    "threshold-overflow": ("threshold", {"tau": 0.5, "max_fraction": 0.05},
                           (300,), 2),
    "threshold-wide": ("threshold", {"tau": 1.0, "max_fraction": 0.5},
                       (100,), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_payloads_and_decodes_match_jax(case):
    name, kw, shape, world = CASES[case]
    rng = np.random.RandomState(len(case))
    _check_codec(name, kw, [rng.randn(*shape).astype(np.float32)
                            for _ in range(world)])


def test_threshold_overflow_keeps_the_cap():
    x = np.random.RandomState(1).randn(300).astype(np.float32)
    code = get_codec("threshold", tau=0.5, max_fraction=0.05)
    payload, _ = code.encode(torch.from_numpy(x), code.init_state(
        (300,), torch.float32, "cpu"))
    kept = int((np.abs(x) > 0.5 * np.abs(x).mean()).sum())
    assert kept > 15 and int(payload["length"]) == 15
    assert payload["length"].dtype == torch.int32
    assert payload["length"].shape == ()


@pytest.mark.parametrize("name", ["blocktopk", "blocktopk8"])
def test_block_topk_ties_and_pad_picks(name):
    # two blocks of 128 with 32 picks each: the first all ties of five
    # magnitudes, the tail block two real elements, so 30 of its picks
    # land in the padding (indices >= n, dropped by decode)
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], 128),
                        [0.5, -0.25]]).astype(np.float32)
    _check_codec(name, {"fraction": 0.25, "block_size": 128},
                 [x, x[::-1].copy()])
    payload, _ = get_codec(name, fraction=0.25, block_size=128).encode(
        torch.from_numpy(x))
    assert int((payload["indices"] >= x.size).sum()) == 30


def test_threshold_adaptive_tau_over_three_steps():
    kw = dict(tau=1.0, max_fraction=0.2, target_fraction=0.05)
    jc, tc = jax_codec("threshold", **kw), get_codec("threshold", **kw)
    shape = (40, 25)
    js, ts = jc.init_state(shape, jnp.float32), tc.init_state(
        shape, torch.float32, "cpu")
    rng = np.random.RandomState(4)
    for step in range(3):
        x = rng.randn(*shape).astype(np.float32)
        jp, js = _jax_payload(jc, x, 0, js)
        tp, ts = tc.encode(torch.from_numpy(x), ts)
        _assert_same_payload(jp, tp)
        np.testing.assert_allclose(ts["tau"].numpy(), np.asarray(js["tau"]),
                                   rtol=1e-6)
        assert ts["tau"].dtype == torch.float32 and ts["tau"].shape == ()
    assert float(ts["tau"]) > 1.5  # ~30% kept against a 5% target


@pytest.mark.parametrize("inner", ["threshold", "blocktopk"])
def test_error_feedback_around_sparse_codecs(inner):
    kw = ({"inner_name": "threshold", "tau": 1.5, "max_fraction": 0.1}
          if inner == "threshold"
          else {"inner_name": "blocktopk", "fraction": 0.05,
                "block_size": 128})
    jc, tc = jax_codec("ef", **kw), get_codec("ef", **kw)
    shape = (30, 20)
    assert tc.order_dependent
    js, ts = jc.init_state(shape, jnp.float32), tc.init_state(
        shape, torch.float32, "cpu")
    rng = np.random.RandomState(5)
    for _ in range(3):
        x = rng.randn(*shape).astype(np.float32)
        jp, js = _jax_payload(jc, x, 0, js)
        tp, ts = tc.encode(torch.from_numpy(x), ts)
        _assert_same_payload(jp, tp)
        _same(js["memory"], ts["memory"])


def _jax_uniforms(seed: int, step: int, ks: list) -> list:
    """The uniforms the JAX step draws for its units at world 1: the step's
    key splits off the optimizer's, is folded with the rank and split
    into one key a unit (``ps.py:386-388``, ``:515-517``, ``:1976``)."""
    rng = jax.random.key(seed)
    for _ in range(step + 1):
        rng, key = jax.random.split(rng)
    keys = jax.random.split(jax.random.fold_in(key, 0), len(ks))
    return [torch.from_numpy(np.array(jax.random.uniform(kk, (k,))))
            for kk, k in zip(keys, ks)]


def _fed_randomk(kw: dict, units: list):
    """The port's random-k whose encode takes, unit by unit, the uniforms
    of the JAX step; ``units``: the sizes of a step's units in order."""
    code = get_codec("randomk", **kw)
    ks = [code._k_for((n,)) for n in units]
    draws = []  # per step, the units' uniforms
    calls = iter(range(10**6))

    def encode(grad, state=(), rng=None):
        step, i = divmod(next(calls), len(units))
        if step == len(draws):
            draws.append(_jax_uniforms(0, step, ks))
        return code.sample(grad, draws[step][i]), state

    code.encode = encode
    return code


@pytest.mark.parametrize("mb", [0.0, 0.01], ids=["leaf", "bucket"])
def test_randomk_step_per_leaf_and_bucketed_on_the_mlp(mb):
    variables, model = mlp_pair()
    params = params_from_jax(variables, model)
    kw = {"fraction": 0.1}
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=jax_codec("randomk", **kw),
                mesh=make_mesh(devices=jax.devices()[:1]), bucket_mb=mb,
                **HYPER)
    opt = SGD(params, code=get_codec("randomk", **kw), device="cpu",
              bucket_mb=mb, **HYPER)
    units = ([b.size for b in opt._bucket_plan.buckets] if mb
             else [p.numel() for p in params.values()])
    assert len(units) == (3 if mb else 4)
    opt.code = _fed_randomk(kw, units)
    for s in range(STEPS):
        grads = stacked_grads(variables, 1, s)
        jopt.step(grads=jax.tree.map(jnp.asarray, grads))
        opt.step(grads=torch_grads(model, grads))
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)


RESNET_CODECS = {
    "blocktopk": ("blocktopk", {"fraction": 0.05, "block_size": 128}),
    "blocktopk8": ("blocktopk8", {"fraction": 0.05}),
    "threshold": ("threshold", {"tau": 1.5, "max_fraction": 0.1}),
    "ef-threshold": ("ef", {"inner_name": "threshold", "tau": 2.0,
                            "max_fraction": 0.05}),
    "randomk": ("randomk", {"fraction": 0.02}),
}


@pytest.mark.parametrize("case", sorted(RESNET_CODECS))
def test_resnet18_grads_only_step_matches_jax(case):
    """Three grads-only steps of the width-32 ResNet-18 at world 1; the
    port keeps its OIHW and [out, in] layouts and the codec sees the
    flax layouts through the kernels' ``codec_view`` tags."""
    name, kw = RESNET_CODECS[case]
    _, variables = jax_resnet()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=jax_codec(name, **kw),
                mesh=make_mesh(devices=jax.devices()[:1]), **HYPER)
    model = torch_resnet()
    params = params_from_jax(variables, model)
    code = get_codec(name, **kw)
    if name == "randomk":
        code = _fed_randomk(kw, [p.numel() for p in params.values()])
    opt = SGD(params, code=code, device="cpu", **HYPER)
    for s in range(STEPS):
        grads = stacked_grads(variables, 1, s)
        jopt.step(grads=jax.tree.map(jnp.asarray, grads))
        opt.step(grads=torch_grads(model, grads))
    assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)


def test_codec_views_put_each_resnet_leaf_kind_in_flax_layout():
    """A 3×3 conv, a 1×1 shortcut conv and the dense head: the views the
    model tags its kernels with are the flax layouts, and one SGD(lr=1)
    step on the zeroed leaf alone moves it by the JAX codec's decode of
    the flax-layout gradient, in the port's layout."""
    model = torch_resnet()
    views = codec_views(model)
    named = dict(model.named_parameters())
    leaves = ("blocks.2.conv1.weight", "blocks.2.shortcut.weight",
              "head.weight")
    assert [named[n].dim() for n in leaves] == [4, 4, 2]
    assert named[leaves[0]].shape[-1] == 3 and named[leaves[1]].shape[-1] == 1
    kw = {"fraction": 0.05, "block_size": 128}
    rng = np.random.RandomState(6)
    for n in leaves:
        path = flax_path(model, n)
        g = rng.randn(*named[n].shape).astype(np.float32)
        view = torch.from_numpy(g).permute(views[n])
        np.testing.assert_array_equal(view.numpy(), flax_layout(path, g))
        p = named[n]
        with torch.no_grad():
            p.zero_()
        opt = SGD({n: p}, code=get_codec("blocktopk", **kw), device="cpu",
                  lr=1.0)
        opt.step(grads={n: torch.from_numpy(g)[None]})
        fg = flax_layout(path, g)
        jd = jax_codec("blocktopk", **kw).decode_sum(
            {k: v[None] for k, v in _jax_payload(
                jax_codec("blocktopk", **kw), fg, 0)[0].items()},
            fg.shape, jnp.float32)
        np.testing.assert_array_equal(
            (-p).detach().numpy(), torch_layout(path, np.asarray(jd)))


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("mode", ["allgather", "leader"])
@pytest.mark.parametrize("name,kw", [
    ("randomk", {"fraction": 0.01}), ("blocktopk", {"fraction": 0.01}),
    ("blocktopk8", {"fraction": 0.01}),
    ("threshold", {"tau": 2.0, "max_fraction": 0.05})])
def test_wire_accounting_matches_jax(name, kw, mode, world):
    _, variables = jax_resnet()
    jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                code=jax_codec(name, **kw), mode=mode,
                mesh=make_mesh(devices=jax.devices()[:world]), **HYPER)
    model = torch_resnet()
    opt = SGD(model, code=get_codec(name, **kw), device="cpu", mode=mode,
              **HYPER)
    opt.size = world  # the accounting of a world-rank step
    got = opt._static_metrics()
    assert (got["wire_lowering"], got["wire_bytes_per_worker"]) == \
        jopt._wire_accounting
    assert got["packaged_bytes"] == jopt._payload_bytes


@pytest.mark.parametrize("name,kw", [
    ("randomk", {}), ("randomk", {"k": 3, "fraction": 0.1}),
    ("blocktopk", {"fraction": 0.0}), ("blocktopk", {"block_size": 100}),
    ("blocktopk", {"block_size": 0}), ("blocktopk8", {"block_size": 1000}),
    ("threshold", {"max_fraction": 0.0}),
    ("threshold", {"max_fraction": 1.5}),
    ("threshold", {"max_fraction": 0.1, "target_fraction": 0.2}),
    ("threshold", {"compaction": "heap"}), ("threshold", {"chunk": 1000}),
    ("threshold", {"chunk": 3000})])
def test_constructor_errors_match_jax(name, kw):
    with pytest.raises(ValueError) as want:
        jax_codec(name, **kw)
    with pytest.raises(ValueError) as got:
        get_codec(name, **kw)
    assert str(got.value) == str(want.value)


def test_jax_keywords_are_accepted():
    for name, kw in [("threshold", {"compaction": "sort", "chunk": 0}),
                     ("blocktopk", {"approx": True, "block_size": 4096}),
                     ("randomk", {"k": 5, "unbiased": False})]:
        assert type(get_codec(name, **kw)).__name__ == \
            type(jax_codec(name, **kw)).__name__
    assert get_codec("randomk", fraction=0.1).bucketable
    assert not get_codec("randomk", k=3).bucketable
    assert not get_codec("threshold").bucketable


def test_ragged_all_gather_without_a_group():
    comms.reset_calls()
    payload = {"values": torch.arange(4.0), "indices": torch.arange(4)}
    gathered, lengths = comms.ragged_all_gather(payload, torch.tensor(2))
    assert gathered["values"].shape == (1, 4) and lengths.tolist() == [2]
    assert lengths.dtype == torch.int32
    assert sum(comms.calls.values()) == 0


def test_streaming_forms_name_their_item():
    for name, kw in [("randomk", {"k": 2}), ("blocktopk8", {}),
                     ("threshold", {})]:
        with pytest.raises(NotImplementedError, match="queue 1 item 3"):
            get_codec(name, **kw).agg_init((4,), torch.float32)


# -- threshold's ragged step over gloo ------------------------------------------

_WORKER = """
import sys
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
params = {n: torch.from_numpy(data["p:" + n].copy()) for n in names}
for n in names:
    if "v:" + n in data.files:  # the model's kernel tags, carried across
        params[n].codec_view = tuple(int(d) for d in data["v:" + n])
opt = SGD(params, lr=0.01, momentum=0.9, device="cpu",
          code=get_codec("threshold", tau=1.5, max_fraction=0.1))
for s in range(steps):
    comms.reset_calls()
    opt.step(grads={n: torch.from_numpy(data[f"g{s}:" + n]) for n in names})
np.savez(f"{dst}.{rank}.npz", calls=np.array(comms.calls["all_gather"]),
         **{n: p.numpy() for n, p in params.items()})
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_threshold_ragged_step_over_gloo(tmp_path, world):
    variables, model = mlp_pair()
    params = params_from_jax(variables, model)
    arrays = {"names": np.array(list(params))}
    arrays.update({f"p:{n}": p.detach().numpy() for n, p in params.items()})
    arrays.update({f"v:{n}": np.array(v)
                   for n, v in codec_views(model).items()})
    for s in range(STEPS):
        for n, g in torch_grads(model,
                                stacked_grads(variables, world, s)).items():
            arrays[f"g{s}:{n}"] = g.numpy()
    src, dst = tmp_path / "in.npz", tmp_path / "out"
    np.savez(src, **arrays)
    spawn_ranks(_WORKER, world, (src, dst, STEPS))
    outs = [np.load(f"{dst}.{r}.npz") for r in range(world)]
    code = jax_codec("threshold", tau=1.5, max_fraction=0.1)
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), code=code,
                mesh=make_mesh(devices=jax.devices()[:world]), **HYPER)
    for s in range(STEPS):
        jopt.step(grads=jax.tree.map(jnp.asarray,
                                     stacked_grads(variables, world, s)))
    for out in outs:
        # values, indices and the length sidecar of each of the 4 leaves
        assert int(out["calls"]) == 3 * 4
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(out[n]))
        assert_params_close(model, jopt.params, rtol=1e-6, atol=1e-7)

"""The port's numerics layer (``telemetry/numerics.py``, ``MPI_PS(numerics=
True)``, the codecs' fidelity probes) against the JAX package's, on the
same seeded numpy inputs.

- ``tree_stats``: the non-finite counts exact, the finite sums of squares
  to rtol 1e-6; ``sanitize_tree`` exact; ``update_weight_ratio`` to rtol
  1e-6.
- ``MPI_PS(numerics=True)`` against JAX ``SGD(numerics=True)``: grads-only
  steps on the MLP and the width-32 ResNet-18 with sign, int8, error
  feedback around top-k and ``bucket_mb``; ``grad_norm``,
  ``nonfinite_total``, ``update_ratio``, ``ef_residual_norm`` and
  ``bucket_grad_norms`` to rtol 1e-5 (the leaves in the JAX order, so the
  bucket plans agree). A NaN/Inf planted in one leaf: the count exact and
  the norm the finite part's. ``update_ratio`` is also held, to rtol
  1e-6, to its exact value in float64 from each package's own parameters
  before and after the step, and the two exact values to each other: on
  the ResNet the JAX package's float32 sum of squares over 2.8M
  parameters is itself 1.4e-5 off that exact value (the port's, 1e-7),
  so there the JAX figure is held to the exact one at 2e-5 instead of
  the port to it at 1e-5.
- ``Codec.fidelity_probe`` of every deterministic codec: bits per
  parameter exact, errors, cosine and norm to rtol 1e-5; and
  ``CodecWire.probe_fidelity`` on a two-leaf wire.
- ``NumericsMonitor``: the same push stream gives the same actions,
  quarantines and counts under each policy.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.mesh import make_mesh
from pytorch_ps_mpi_tpu.telemetry import numerics as jnum
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.telemetry import numerics as tnum
from pytorch_ps_mpi_tpu_torch.utils.interop import (jax_leaf_order,
                                                    params_to_jax)
from torch_parity import (jax_resnet, make_codec, mlp_pair,
                          one_torch_thread, stacked_grads, torch_grads,
                          torch_resnet)

#: SGD with momentum
HYPER = dict(lr=0.01, momentum=0.9)
FIELDS = ("grad_norm", "nonfinite_total", "update_ratio",
          "ef_residual_norm")


def _tree(seed: int = 0):
    rng = np.random.RandomState(seed)
    t = {"a": rng.randn(64, 8).astype(np.float32),
         "b": {"c": rng.randn(37).astype(np.float32),
               "d": rng.randn(3, 3, 4).astype(np.float32)}}
    t["a"][3, 2] = np.nan
    t["a"][7, 0] = np.inf
    t["b"]["d"][1, 1, 1] = -np.inf
    return t


def test_tree_stats_matches_jax():
    t = _tree()
    js, jn = jnum.tree_stats(t)
    for tree in (t, {"a": torch.from_numpy(t["a"]),
                     "b": {k: torch.from_numpy(v)
                           for k, v in t["b"].items()}}):
        s, n = tnum.tree_stats(tree)
        np.testing.assert_array_equal(n, np.asarray(jn))
        np.testing.assert_allclose(s, np.asarray(js), rtol=1e-6)
    s, n = tnum.tree_stats({})
    assert s.size == 0 and n.size == 0


def test_sanitize_and_update_ratio_match_jax():
    t = _tree(1)
    got = tnum.sanitize_tree({k: (torch.from_numpy(v) if k == "a" else v)
                              for k, v in t.items()})
    want = jnum.sanitize_tree(t)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    for k in ("c", "d"):
        np.testing.assert_array_equal(got["b"][k], np.asarray(want["b"][k]))
    old = {k: v for k, v in _tree(2).items() if k == "a"}
    old["a"] = np.nan_to_num(old["a"], posinf=0.0, neginf=0.0)
    new = {"a": old["a"] * 1.01 + 0.001}
    np.testing.assert_allclose(
        tnum.update_weight_ratio({"a": torch.from_numpy(old["a"])},
                                 {"a": torch.from_numpy(new["a"])}),
        jnum.update_weight_ratio(old, new), rtol=1e-6)


def _f64(params) -> list:
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(params)]


def _ratio(old: list, new: list) -> float:
    """``||new - old|| / ||old||`` in float64."""
    up = sum(np.sum((n - o) ** 2) for o, n in zip(old, new))
    return float(np.sqrt(up) / np.sqrt(sum(np.sum(o ** 2) for o in old)))


def _models(model: str):
    if model == "mlp":
        variables, tmodel = mlp_pair()
    else:
        _, variables = jax_resnet()
        tmodel = torch_resnet()
    return variables, tmodel


@pytest.mark.parametrize("model,codec,bucket_mb,mode", [
    ("mlp", "sign", 0.0, "allgather"), ("mlp", "int8", 0.0, "allgather"),
    ("mlp", "ef_topk", 0.0, "allgather"), ("mlp", "sign", 0.05, "allgather"),
    ("mlp", "int8", 0.05, "allgather"), ("mlp", "int8", 0.05, "leader"),
    ("resnet", "sign", 0.0, "allgather")])
def test_step_numerics_match_jax(model, codec, bucket_mb, mode):
    variables, tmodel = _models(model)
    named = dict(tmodel.named_parameters())
    params = {n: named[n] for n in jax_leaf_order(tmodel)}
    with one_torch_thread():
        opt = SGD(params, code=make_codec(codec, get_codec), device="cpu",
                  numerics=True, bucket_mb=bucket_mb, mode=mode, **HYPER)
        jopt = JSGD(jax.tree.map(jnp.asarray, variables),
                    code=make_codec(codec, jax_codec),
                    mesh=make_mesh(devices=jax.devices()[:1]), numerics=True,
                    bucket_mb=bucket_mb, mode=mode, **HYPER)
        for s in range(2):
            old_t = _f64(params_to_jax(tmodel))
            old_j = _f64(jopt.params)
            g = stacked_grads(variables, 1, s)
            if s == 1:
                # a NaN and an Inf in one leaf of the second step
                leaf = max(jax.tree.leaves(g), key=np.size)
                leaf.reshape(-1)[5] = np.nan
                leaf.reshape(-1)[9] = np.inf
            _, d = opt.step(grads=torch_grads(tmodel, g))
            _, jd = jopt.step(grads=jax.tree.map(jnp.asarray, g))
            exact_t = _ratio(old_t, _f64(params_to_jax(tmodel)))
            exact_j = _ratio(old_j, _f64(jopt.params))
            np.testing.assert_allclose(d["update_ratio"], exact_t,
                                       rtol=1e-6)
            np.testing.assert_allclose(exact_t, exact_j, rtol=1e-6)
            for k in FIELDS:
                assert (k in d) == (k in jd), k
                if k == "update_ratio" and model == "resnet":
                    np.testing.assert_allclose(jd[k], exact_j, rtol=2e-5)
                elif k in jd:
                    np.testing.assert_allclose(d[k], jd[k], rtol=1e-5,
                                               err_msg=k)
            assert d["nonfinite_total"] == jd["nonfinite_total"] == 2.0 * s
            assert ("bucket_grad_norms" in d) == (bucket_mb > 0)
            if bucket_mb:
                np.testing.assert_allclose(d["bucket_grad_norms"],
                                           jd["bucket_grad_norms"],
                                           rtol=1e-5)
    # the finite part's norm: the planted elements count as zeros
    leaves = [np.nan_to_num(np.asarray(x), nan=0.0, posinf=0.0, neginf=0.0)
              for x in jax.tree.leaves(g)]
    want = float(np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                             for x in leaves)))
    np.testing.assert_allclose(d["grad_norm"], want, rtol=1e-5)


def test_loss_fn_and_accumulate_paths_carry_numerics():
    """The loss_fn step and ``step_accumulate`` take the statistics of
    the gradient they aggregate (the mean of the microbatches'), and
    ``instrument=True`` and ``run_steps`` skip them, as in the JAX
    package."""
    from pytorch_ps_mpi_tpu_torch import data as tdata
    from torch.func import functional_call

    _, model = mlp_pair()
    x, y = next(tdata.synthetic_images("mnist", 8, seed=3, device="cpu"))

    def loss_fn(p, batch):
        out = functional_call(model, p, (batch[0],))
        return torch.nn.functional.cross_entropy(out, batch[1])

    with one_torch_thread():
        opt = SGD(model, device="cpu", numerics=True, lr=0.0)
        _, d = opt.step(loss_fn=loss_fn, batch=(x, y))
        g = torch.autograd.grad(loss_fn(dict(model.named_parameters()),
                                        (x, y)), list(model.parameters()))
        want = float(torch.sqrt(sum(torch.sum(t.double() ** 2) for t in g)))
        np.testing.assert_allclose(d["grad_norm"], want, rtol=1e-5)
        assert d["update_ratio"] == 0.0  # lr 0: the parameters stand
        micro = (torch.stack([x, x]), torch.stack([y, y]))
        _, d2 = opt.step_accumulate(loss_fn, micro)
        np.testing.assert_allclose(d2["grad_norm"], want, rtol=1e-5)
        losses, d3 = opt.run_steps(loss_fn, micro)
        assert "grad_norm" not in d3
        staged = SGD(mlp_pair()[1], device="cpu", numerics=True, lr=0.1,
                     instrument=True)
        _, d4 = staged.step(loss_fn=loss_fn, batch=(x, y))
        assert "grad_norm" not in d4


#: the codecs whose encode draws no random numbers (name, kwargs)
DETERMINISTIC = [
    ("identity", {}), ("bf16", {}), ("f16", {}), ("sign", {}),
    ("int8", {}), ("topk", {"fraction": 0.05}),
    ("blocktopk", {"fraction": 0.05}), ("threshold", {"tau": 1.0}),
]


@pytest.mark.parametrize("name,kw", DETERMINISTIC,
                         ids=[n for n, _ in DETERMINISTIC])
def test_fidelity_probe_matches_jax(name, kw):
    g = np.random.RandomState(7).randn(4096).astype(np.float32)
    got = get_codec(name, **kw).fidelity_probe(torch.from_numpy(g))
    want = jax_codec(name, **kw).fidelity_probe(jnp.asarray(g))
    assert got["bits_per_param"] == want["bits_per_param"]
    for k in ("rel_error", "cosine", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_error_feedback_probe_matches_jax_and_reads_only():
    g = np.random.RandomState(8).randn(2048).astype(np.float32)
    mem = (0.1 * np.random.RandomState(9).randn(2048)).astype(np.float32)
    ef = get_codec("ef", inner=get_codec("topk", fraction=0.01))
    st = ef.init_state((2048,), torch.float32, torch.device("cpu"))
    st["memory"] = torch.from_numpy(mem.copy())
    got = ef.fidelity_probe(torch.from_numpy(g), st)
    jef = jax_codec("ef", inner=jax_codec("topk", fraction=0.01))
    jst = jef.init_state((2048,), jnp.float32)
    jst["memory"] = jnp.asarray(mem)
    want = jef.fidelity_probe(jnp.asarray(g), jst)
    for k in ("rel_error", "cosine", "grad_norm", "ef_residual_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["bits_per_param"] == want["bits_per_param"]
    np.testing.assert_array_equal(st["memory"].numpy(), mem)  # read-only


@pytest.mark.parametrize("name", ["sign", "int8"])
def test_codec_wire_probe_fidelity_matches_jax(name):
    from pytorch_ps_mpi_tpu.parallel.dcn import CodecWire as JWire
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import CodecWire

    tpl = {"a": np.zeros((1024,), np.float32), "b": np.zeros((8,), np.float32)}
    rng = np.random.RandomState(11)
    g = {"a": rng.randn(1024).astype(np.float32),
         "b": rng.randn(8).astype(np.float32)}
    got = CodecWire(get_codec(name), tpl, device="cpu").probe_fidelity(
        {k: torch.from_numpy(v) for k, v in g.items()})
    want = JWire(jax_codec(name), tpl).probe_fidelity(g)
    assert (got["unit"], got["codec"]) == (want["unit"], want["codec"])
    assert got["bits_per_param"] == want["bits_per_param"]
    for k in ("rel_error", "cosine", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _stream():
    """A seeded push stream over three workers: worker 1 pushes a NaN at
    its second push, worker 2 an Inf at its fourth; the rest finite."""
    rng = np.random.RandomState(5)
    out = []
    for i in range(12):
        w = i % 3
        g = {"w": rng.randn(16).astype(np.float32),
             "b": rng.randn(4).astype(np.float32)}
        if (w, i // 3) == (1, 1):
            g["w"][3] = np.nan
        if (w, i // 3) == (2, 3):
            g["b"][0] = np.inf
        out.append((w, g))
    return out


@pytest.mark.parametrize("policy,quarantine_after", [
    ("skip", 1), ("skip", 2), ("zero", 1), ("abort", 1)])
def test_monitor_policy_decisions_match_jax(policy, quarantine_after,
                                            tmp_path):
    kw = dict(num_workers=3, policy=policy,
              quarantine_after=quarantine_after)
    tm = tnum.NumericsMonitor(cfg={"numerics_dir": str(tmp_path / "t")},
                              **kw)
    jm = jnum.NumericsMonitor(cfg={"numerics_dir": str(tmp_path / "j")},
                              **kw)
    for i, (w, g) in enumerate(_stream()):
        a = tm.observe_push(w, {k: torch.from_numpy(v)
                                for k, v in g.items()}, i)
        b = jm.observe_push(w, g, i)
        assert a == b, (i, w, a, b)
        if a == "abort":
            break
    ts, js = tm.snapshot(), jm.snapshot()
    for k in ("pushes", "nonfinite_total", "nonfinite_elems_total",
              "quarantined", "policy"):
        assert ts[k] == js[k], k
    np.testing.assert_allclose(ts["grad_norm"]["last"],
                               js["grad_norm"]["last"], rtol=1e-6)
    assert [w["verdict"] for w in ts["workers"]] == \
        [w["verdict"] for w in js["workers"]]
    assert [os.path.basename(p) for p in ts["postmortems"]] == \
        [os.path.basename(p) for p in js["postmortems"]]
    if ts["postmortems"]:
        doc = json.load(open(ts["postmortems"][0]))
        assert doc["kind"] == "numerics_postmortem"
        assert doc["offending"]["leaves"][0]["shape"]
    assert (ts["aborted"] is None) == (policy != "abort")

"""The port's sharded parameter servers (``parallel/sharded.py``) against
the JAX package's, on the CPU.

- ``shard_plan`` equals JAX's over a grid, its rejections too;
- a slice's update equals the whole vector's on that slice: SGD with
  momentum bit for bit, Adam to rtol 1e-6; the port's whole-vector
  update against the jitted JAX one to rtol 1e-6 (its FMAs, ROADMAP
  queue 3 item 4);
- a port worker's slice push is taken by a JAX shard server, and a JAX
  worker's by a port one, decoded alike;
- ``assemble`` tiles the vector and rejects a gap;
- one spawned fleet: 2 shards, 2 MLP workers, int8, checkpoints a shard,
  then a resume that carries on from them.
"""

from __future__ import annotations

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.optim import OPTIMIZERS as JAX_OPTIMIZERS
from pytorch_ps_mpi_tpu.parallel import dcn as jdcn
from pytorch_ps_mpi_tpu.parallel import sharded as jsharded
from pytorch_ps_mpi_tpu.parallel import tcp as jtcp
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.parallel import sharded
from pytorch_ps_mpi_tpu_torch.parallel import tcp as ttcp

LIMIT = 90.0  # seconds for one spawned fleet


@pytest.mark.parametrize("n", [1, 2, 7, 10, 103, 1000, 23520842])
def test_shard_plan_matches_jax(n):
    for s in (1, 2, 3, 4, 7, 16):
        if s > n:
            for mod in (sharded, jsharded):
                with pytest.raises(ValueError):
                    mod.shard_plan(n, s)
            continue
        plan = sharded.shard_plan(n, s)
        assert plan == jsharded.shard_plan(n, s)
        assert plan[0][0] == 0 and plan[-1][1] == n
    for mod in (sharded, jsharded):
        with pytest.raises(ValueError):
            mod.shard_plan(n, 0)


@pytest.mark.parametrize("name,kw", [("sgd", {"lr": 0.05, "momentum": 0.9}),
                                     ("adam", {"lr": 0.01})])
def test_slice_updates_equal_the_whole_vector_update(name, kw):
    rng = np.random.default_rng(0)
    n, steps = 103, 5
    grads = [rng.standard_normal(n).astype(np.float32) for _ in range(steps)]
    p0 = rng.standard_normal(n).astype(np.float32)
    hyper_cls, init_state, update_fn = OPTIMIZERS[name]
    h = hyper_cls(**kw)

    def run(lo, hi):
        p = {"flat": torch.from_numpy(p0[lo:hi].copy())}
        s = init_state(p)
        for g in grads:
            _, s = update_fn(p, {"flat": torch.from_numpy(g[lo:hi])}, s, h)
        return p["flat"].numpy()

    whole = run(0, n)
    pieces = np.concatenate([run(a, b)
                             for a, b in sharded.shard_plan(n, 4)])
    if name == "sgd":
        np.testing.assert_array_equal(pieces, whole)
    else:
        np.testing.assert_allclose(pieces, whole, rtol=1e-6)
    jh_cls, jinit, jupdate = JAX_OPTIMIZERS[name]
    jh = jh_cls(**kw)
    update = jax.jit(lambda p, g, s: jupdate(p, g, s, jh))
    jp = {"flat": p0.copy()}
    js = jinit(jp)
    for g in grads:
        jp, js = update(jp, {"flat": g}, js)
    np.testing.assert_allclose(whole, np.asarray(jp["flat"]), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["int8", "identity", "sign"])
@pytest.mark.parametrize("pusher", ["port", "jax"])
def test_slice_pushes_interoperate(name, pusher, monkeypatch):
    monkeypatch.setenv("PS_NO_NATIVE", "0")
    n = 5000
    tmpl = sharded._slice_template(n)
    assert json.dumps(jax.tree.map(np.shape, tmpl)) == json.dumps(
        jax.tree.map(np.shape, jsharded._slice_template(n)))
    g = np.random.RandomState(3).randn(n).astype(np.float32)
    port_server = pusher == "jax"
    if port_server:
        server = ttcp.TcpPSServer(0, 2, tmpl, code=get_codec(name),
                                  frame=True, device="cpu")
    else:
        server = jtcp.TcpPSServer(0, 2, tmpl, code=jax_codec(name),
                                  frame=True)
    server.publish(tmpl)
    errors = []

    def push():
        try:
            if port_server:
                w = jtcp.TcpPSWorker("127.0.0.1", server.port, 1, tmpl,
                                     code=jax_codec(name), frame=True,
                                     timeout=30.0)
                _, v = w.read_params()
                w.push_grad({"flat": g}, v, lineage=(0, 0))
            else:
                w = ttcp.TcpPSWorker("127.0.0.1", server.port, 1, tmpl,
                                     code=get_codec(name), frame=True,
                                     timeout=30.0, device="cpu")
                _, v = w.read_flat()
                w.push_payload(w.encode([torch.from_numpy(g)]), v,
                               lineage=(0, 0))
            w.close()
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=push)
    t.start()
    try:
        item, deadline = None, time.time() + 60
        while item is None and time.time() < deadline and not errors:
            item = server.poll_grad()
            time.sleep(0.002)
        t.join(timeout=30)
        assert not errors, errors
        assert item is not None and item[0] == 1
        assert server.frames_rejected_total == 0
        got = item[2]["flat"]
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        jwire = jdcn.CodecWire(jax_codec(name), tmpl)
        want = np.asarray(jwire.decode_from_bytes(np.array(
            jwire.encode_to_bytes({"flat": g})))["flat"])
        if name == "sign":  # the scale sidecar (ROADMAP queue 3 item 2)
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    finally:
        server.close()


def test_assemble_tiles_the_vector_and_rejects_a_gap(tmp_path):
    tmpl = {"a": np.zeros((3, 4), np.float32), "b": np.zeros(5, np.float32)}
    flat = np.arange(17, dtype=np.float32)
    paths = []
    for i, (a, b) in enumerate(sharded.shard_plan(17, 3)):
        p = str(tmp_path / f"s{i}.npz")
        np.savez(p, flat=flat[a:b], start=a, stop=b)
        paths.append(p)
    got = sharded.assemble(paths, tmpl)
    want = jsharded.assemble(paths, tmpl)
    for k in tmpl:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="cover"):
        sharded.assemble(paths[:2], tmpl)
    # no plan in the control directory: the cfg's count
    assert sharded.planned_shards(str(tmp_path), 2) == 2
    assert sharded.planned_shards(None, 3) == 3


def _fleet(cfg, n_shards, n_workers, tmp_path, tag):
    one = {"OMP_NUM_THREADS": "1"}
    servers, workers, paths, wpaths = [], [], [], []
    try:
        for s in range(n_shards):
            paths.append(str(tmp_path / f"{tag}_shard{s}.npz"))
            servers.append(sharded.spawn_shard_server(s, n_shards, cfg,
                                                      paths[-1], env=one))
        addrs = [f"127.0.0.1:{sharded.read_server_port(p, LIMIT)}"
                 for p in servers]
        for w in range(n_workers):
            wpaths.append(str(tmp_path / f"{tag}_w{w}.json"))
            workers.append(sharded.spawn_sharded_worker(addrs, w, cfg,
                                                        wpaths[-1], env=one))
        assert at.join_workers(workers, LIMIT) == [0] * n_workers
        assert at.join_workers(servers, LIMIT) == [0] * n_shards
    finally:
        at.join_workers(servers + workers, timeout=5.0)
    return paths, [json.load(open(p)) for p in wpaths]


def test_two_shards_checkpoint_and_resume_independently(tmp_path):
    n_workers, steps = 2, 5
    cfg = {"model": "mlp", "model_kw": {"features": (32, 4)},
           "in_shape": [8], "batch": 32, "seed": 13, "optim": "sgd",
           "hyper": {"lr": 0.02, "momentum": 0.9}, "codec": "int8",
           "n_workers": n_workers, "steps": steps, "max_staleness": 10**9,
           "frame_check": True, "device": "cpu", "server_timeout": LIMIT,
           "open_timeout": LIMIT, "push_timeout": LIMIT,
           "server_slow_ms": {"1": 20.0},
           "checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_every": 4}
    prob = at.make_problem(cfg, "cpu")
    loss0 = prob.eval_loss()

    def loss_of(paths):
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import flatten_params

        params = sharded.assemble(paths, prob.template)
        prob.load_flat(torch.from_numpy(flatten_params(params)))
        return prob.eval_loss()

    paths1, w1 = _fleet(cfg, 2, n_workers, tmp_path, "p1")
    versions1 = []
    for p in paths1:
        z = np.load(p)
        assert int(z["applied_total"]) == int(z["grads_received"]) == \
            n_workers * steps
        assert json.loads(str(z["launches"]))["quantize_int8"] == 0
        versions1.append(int(z["version"]))
    assert all(w["pushed"] == steps for w in w1)
    for s in range(2):
        assert os.listdir(tmp_path / "ckpt" / f"shard{s}")
    loss1 = loss_of(paths1)
    assert loss1 < loss0
    paths2, _ = _fleet({**cfg, "resume": True}, 2, n_workers, tmp_path, "p2")
    for p, v1 in zip(paths2, versions1):
        z = np.load(p)
        assert int(z["applied_total"]) == 2 * n_workers * steps
        assert int(z["version"]) > v1  # the crash-window jump, then on
    assert loss_of(paths2) < loss1

"""The port's training layer: ``Trainer`` (fit, scan chunks through
``run_steps``, evaluate, checkpoint and resume), ``CheckpointManager``,
the metrics helpers, ``synthetic_lm`` and ``prefetch``, the launcher and
the ``train`` CLI.

The oracles are the JAX package's ``test_trainer.py`` (fit, scan chunks,
resume, leader resume, Adafactor resume) and ``test_utils.py``
(``StepTimer``, ``MetricsAccumulator``, ``print_summary``). A resumed
trainer equals an uninterrupted one bit for bit: parameters, optimizer
state, codec generator and BatchNorm running statistics. ``Trainer.fit``
on the MLP equals the JAX package's to rtol 1e-5 (losses) and 1e-5,
atol 1e-6 (parameters): the two frameworks' matmul gradients round
apart. ``synthetic_lm`` draws the JAX package's tokens bit for bit.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu_torch import SGD, Adafactor, Adam
from pytorch_ps_mpi_tpu_torch import data as tdata
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.models.resnet import (ResNet18,
                                                    apply_with_stats,
                                                    batch_stats_of)
from pytorch_ps_mpi_tpu_torch.ps import LeaderState
from pytorch_ps_mpi_tpu_torch.trainer import Trainer
from pytorch_ps_mpi_tpu_torch.utils.checkpoint import CheckpointManager
from pytorch_ps_mpi_tpu_torch.utils.metrics import (MetricsAccumulator,
                                                    StepTimer, print_summary)
from torch_parity import (ROOT, assert_params_close, mlp_pair,
                          one_torch_thread)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def quad_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2)


def make_data(seed=0):
    """Zero weights and an endless stream of linear-regression batches."""
    gen = torch.Generator().manual_seed(seed)
    w_true = torch.randn(4, 2, generator=gen)

    def stream():
        while True:
            x = torch.randn(16, 4, generator=gen)
            yield x, x @ w_true
    return {"w": torch.zeros(4, 2)}, stream()


def _equal_trees(a, b) -> None:
    flat_a, flat_b = [], []
    from pytorch_ps_mpi_tpu_torch.comms import tree_map
    tree_map(flat_a.append, a)
    tree_map(flat_b.append, b)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            assert x == y


def test_fit_decreases_loss():
    params, data = make_data()
    t = Trainer(SGD(params, lr=0.1, average=True, device="cpu"), quad_loss)
    out = t.fit(data, num_steps=20)
    assert out["final_loss"] < 1.0 and t.step_count == 20
    assert out["steps_per_sec_overall"] > 0 and "step_time" in out


def test_fit_scan_chunks_equal_single_steps():
    """``scan_chunk=5`` (through ``run_steps``) over 12 steps, the last
    two as single steps, equals 12 single steps bit for bit."""
    outs = []
    for chunk in (5, 1):
        params, data = make_data()
        t = Trainer(SGD(params, lr=0.1, momentum=0.9, average=True,
                        device="cpu"), quad_loss, scan_chunk=chunk)
        out = t.fit(data, num_steps=12)
        assert t.step_count == 12
        outs.append((out["final_loss"], t.opt.params["w"].clone()))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])


def test_fit_matches_jax():
    from pytorch_ps_mpi_tpu import SGD as JSGD
    from pytorch_ps_mpi_tpu import data as jd
    from pytorch_ps_mpi_tpu import models as jm
    from pytorch_ps_mpi_tpu.mesh import make_mesh
    from pytorch_ps_mpi_tpu.trainer import Trainer as JTrainer

    variables, model = mlp_pair()
    jmodel = jm.MLP(features=(48, 10))

    def jloss(p, b):
        return jd.cross_entropy_loss(jmodel.apply(p, b[0]), b[1])

    def tloss(p, b):
        return tdata.cross_entropy_loss(
            torch.func.functional_call(model, p, (b[0],)), b[1])

    jt = JTrainer(JSGD(jax.tree.map(jnp.asarray, variables), lr=0.05,
                       momentum=0.9, average=True,
                       mesh=make_mesh(devices=jax.devices()[:1])), jloss,
                  scan_chunk=2)
    tt = Trainer(SGD(model, lr=0.05, momentum=0.9, average=True,
                     device="cpu"), tloss, scan_chunk=2)
    jout = jt.fit(jd.synthetic_images("mnist", 8, seed=2), num_steps=5)
    tout = tt.fit(tdata.synthetic_images("mnist", 8, seed=2, device="cpu"),
                  num_steps=5)
    np.testing.assert_allclose(tout["final_loss"], jout["final_loss"],
                               rtol=1e-5)
    assert_params_close(model, jt.opt.params, rtol=1e-5, atol=1e-6)


def _resume_run(tmp_path, build, break_at: int, total: int, **trainer_kw):
    """``total`` steps uninterrupted, and ``break_at`` steps, a fresh
    trainer restored from the checkpoint, then the rest on the same
    stream; returns both trainers."""
    opt, loss_fn, data, kw = build()
    straight = Trainer(opt, loss_fn, **kw, **trainer_kw)
    straight.fit(data, num_steps=total)

    opt, loss_fn, data, kw = build()
    first = Trainer(opt, loss_fn, checkpoint_dir=str(tmp_path / "ck"),
                    checkpoint_every=break_at, **kw, **trainer_kw)
    first.fit(data, num_steps=break_at)
    opt2, loss_fn2, _, kw2 = build()
    resumed = Trainer(opt2, loss_fn2, checkpoint_dir=str(tmp_path / "ck"),
                      **kw2, **trainer_kw)
    assert resumed.maybe_restore() and resumed.step_count == break_at
    resumed.fit(data, num_steps=total - break_at)
    return straight, resumed


def _sgd_qsgd():
    params, data = make_data()
    opt = SGD(params, lr=0.05, momentum=0.9, average=True,
              code=get_codec("qsgd"), seed=4, device="cpu")
    return opt, quad_loss, data, {}


def _adam_leader():
    params, data = make_data(seed=3)
    return Adam(params, lr=0.01, mode="leader", device="cpu"), quad_loss, \
        data, {}


def _adafactor():
    params, data = make_data()
    params = {"w": params["w"] + 0.1}
    return Adafactor(params, lr=0.02, average=True, device="cpu"), \
        quad_loss, data, {}


def _syncbn_sign():
    model = ResNet18(num_classes=10, small_inputs=True, num_filters=8,
                     norm="batch", bn_axis="data", device="cpu")

    def loss_fn(p, aux, b):
        logits, new = apply_with_stats(model, p, aux, b[0])
        return tdata.cross_entropy_loss(logits, b[1]), new

    opt = SGD(model, lr=0.01, momentum=0.9, code=get_codec("sign"),
              device="cpu")
    data = tdata.synthetic_images("cifar10", 8, seed=1, device="cpu")
    return opt, loss_fn, data, {"aux_state": batch_stats_of(model)}


@pytest.mark.parametrize("build,break_at,total,kw", [
    (_sgd_qsgd, 5, 10, {}), (_adam_leader, 4, 10, {}),
    (_adafactor, 4, 8, {}), (_syncbn_sign, 4, 8, {"scan_chunk": 4})],
    ids=["sgd_qsgd", "adam_leader", "adafactor", "syncbn_sign_scan4"])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, build, break_at,
                                                 total, kw):
    straight, resumed = _resume_run(tmp_path, build, break_at, total, **kw)
    assert resumed.step_count == straight.step_count == total
    _equal_trees(resumed.opt.state_dict(), straight.opt.state_dict())
    if build is _adam_leader:
        assert isinstance(resumed.opt.opt_state, LeaderState)
    if build is _syncbn_sign:
        assert resumed.opt.aux_state is not None


def test_restore_of_another_schema_is_reported_and_skipped(tmp_path,
                                                           capsys):
    params, data = make_data()
    t = Trainer(SGD(params, lr=0.1, momentum=0.9, device="cpu"), quad_loss,
                checkpoint_dir=str(tmp_path))
    t.fit(data, num_steps=2)
    other = Trainer(SGD({"v": torch.zeros(3)}, lr=0.1, momentum=0.9,
                        device="cpu"), quad_loss,
                    checkpoint_dir=str(tmp_path))
    assert not other.maybe_restore()
    assert "starting fresh" in capsys.readouterr().err
    # a file that is not a plain tree (here a pickled set) is refused too
    torch.save({"a", "b"}, os.path.join(tmp_path, "ckpt_9.pt"))
    assert not other.maybe_restore()
    assert "starting fresh" in capsys.readouterr().err
    assert other.step_count == 0 and torch.equal(other.opt.params["v"],
                                                 torch.zeros(3))
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        Trainer(SGD(make_data()[0], device="cpu"), quad_loss).save()


def test_checkpoint_manager_keeps_and_restores(tmp_path):
    from pytorch_ps_mpi_tpu_torch.optim import SGDState

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({})
    template = {"w": torch.zeros(2, 3), "opt": SGDState(0, {"w": torch.zeros(
        2, 3)}), "rng": None, "n": 0}
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((2, 3), float(step)),
                        "opt": SGDState(step, {"w": torch.ones(2, 3)}),
                        "rng": None, "n": step})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    out = mgr.restore(template)
    assert isinstance(out["opt"], SGDState) and out["opt"].step == 3
    assert torch.equal(out["w"], torch.full((2, 3), 3.0))
    assert mgr.restore(template, step=2)["n"] == 2
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({**template, "w": torch.zeros(3)})
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_evaluate_leaves_the_optimizer_alone():
    params, data = make_data()
    opt = SGD(params, lr=0.1, device="cpu")
    t = Trainer(opt, quad_loss)
    t.fit(data, num_steps=3)
    w = opt.params["w"].clone()
    loss = t.evaluate(data, num_batches=2)
    assert np.isfinite(loss) and torch.equal(opt.params["w"], w)
    assert t.evaluate(data, 1, eval_fn=lambda p, b: torch.tensor(2.0)) == 2.0
    with pytest.raises(ValueError, match="combine"):
        Trainer(opt, quad_loss, scan_chunk=2, accum_steps=2)


def test_accum_steps_runs_step_accumulate():
    params, data = make_data()
    t = Trainer(SGD(params, lr=0.1, average=True, device="cpu"), quad_loss,
                accum_steps=2)
    out = t.fit(data, num_steps=3)
    assert t.step_count == 3 and out["accum_steps"] == 2.0


def test_step_timer_and_accumulator(capsys):
    timer = StepTimer()
    with timer("comm_wait"):
        pass
    with timer("comm_wait"):
        pass
    assert timer.data["comm_wait"] >= 0
    acc = MetricsAccumulator()
    acc.add({"a": 1.0, "b": 2.0, "wire_lowering": "psum"})
    acc.add({"a": 3.0})
    m = acc.mean()
    assert m == {"a": 2.0, "b": 2.0} and len(acc) == 2
    s = print_summary({"x": torch.zeros(2, 3), "y": [1, "z"]})
    assert s == "{x: array(2, 3), y: [1, 'z']}"
    assert capsys.readouterr().out.strip() == s


@pytest.mark.parametrize("order", [1, 2])
def test_synthetic_lm_tokens_equal_jax_bit_for_bit(order):
    from pytorch_ps_mpi_tpu import data as jd

    j = jd.synthetic_lm(3, 17, 100, seed=5, order=order, table_seed=2)
    t = tdata.synthetic_lm(3, 17, 100, seed=5, order=order, table_seed=2,
                           device="cpu")
    for jb, tb in itertools.islice(zip(j, t), 3):
        assert tb["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
    np.testing.assert_array_equal(tdata.markov_table(50, 3),
                                  jd.markov_table(50, 3))


def test_prefetch_keeps_order_and_forwards_errors():
    assert list(tdata.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("boom")

    it = tdata.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
    import threading

    before = set(threading.enumerate())
    endless = tdata.prefetch(itertools.count())
    assert [next(endless) for _ in range(3)] == [0, 1, 2]
    endless.close()
    # the batch thread has ended: none may be cut off at interpreter exit
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]


@pytest.mark.parametrize("argv", [
    ["--num-processes", "2", "x.py"], ["--process-id", "0", "x.py"],
    ["--coordinator", "localhost:1", "--num-processes", "2", "x.py"]])
def test_launch_refuses_a_half_given_topology(argv, monkeypatch):
    from pytorch_ps_mpi_tpu_torch import launch

    for var in ("PS_COORDINATOR", "PS_NUM_PROCESSES", "PS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as e:
        launch.main(argv)
    assert e.value.code == 2


def test_train_cli_resnet18_batchnorm_through_the_launcher(tmp_path):
    """``launch --platform cpu`` (a gloo group of one) running ``train.py``
    on ``resnet18_cifar10 --norm batch --codec int8``: the last line is a
    JSON of ``Trainer.fit``'s metrics with a finite ``final_loss``; a
    second run resumes from its checkpoint."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.launch",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
           "--process-id", "0", "--platform", "cpu",
           str(ROOT / "pytorch_ps_mpi_tpu_torch" / "train.py"),
           "--config", "resnet18_cifar10", "--norm", "batch", "--codec",
           "int8", "--steps", "2", "--batch", "2", "--log-every", "0",
           "--checkpoint-dir", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for resumed in (False, True):
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.strip().splitlines()
        summary = json.loads(lines[-1])
        assert np.isfinite(summary["final_loss"])
        assert ("resumed from step 2" in out.stdout) == resumed
        assert "world=1" in lines[0] and "norm=batch" in lines[0]


def test_train_cli_mlp_and_unported_configs(capsys, monkeypatch):
    from pytorch_ps_mpi_tpu_torch import train

    monkeypatch.setenv("PS_PLATFORM", "cpu")
    out = train.main(["--config", "mlp_mnist", "--steps", "3", "--batch",
                      "8", "--codec", "topk",
                      "--codec-arg", "fraction=0.25", "--scan-chunk", "2",
                      "--instrument", "--log-every", "0"])
    assert np.isfinite(out["final_loss"]) and out["comm_wait"] >= 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # ported: the GPT and Switch MoE configs train (JAX examples/train.py:
    # 53-79), and --donate is accepted
    for config in ("gpt_lm", "switch_mlm"):
        out = train.main(["--config", config, "--steps", "2", "--batch", "2",
                          "--log-every", "0", "--donate"])
        assert np.isfinite(out["final_loss"]) and np.isfinite(
            out["first_loss"])

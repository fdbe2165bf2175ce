"""A run's result line, its refusals, and ``correct`` coming out false
when the timed path is broken underneath.

The runs here skip ``run.py``'s look for a card and drive the rest of a
run (``harness.measure.run``) on the CPU, on tiny copies of the cells in
which the port agrees with the reference to rounding (BERT's products in
float32), held to limits of 1e-4.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import measure, spec
from portbench.tests import tiny

RUN = str(spec.HERE / "run.py")


def _run(cell, traced=False, seed=2**31 + 17):
    out = measure.run(cell, seed, 0.3, traced, "cpu", time.perf_counter())
    out.pop("notes")
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_result_has_the_contract_keys(traced):
    out = _run(tiny.cell("bert-base-mlm.identity.b32"), traced)
    assert list(out)[-1] == "compared"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    names = set(out["metrics"])
    if traced:
        assert {"host_ms_per_step", "stage_ms.grad", "stage_ms.update",
                "mfu"} <= names
    else:
        assert names == {"train_samples_per_s", "step_ms_p95",
                         "peak_mem_gib", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    json.dumps(out)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_sound_run_is_correct(workload):
    assert _run(tiny.cell(workload))["correct"] is True


def _skip_update(monkeypatch):
    from pytorch_ps_mpi_tpu_torch import ps

    monkeypatch.setattr(ps.MPI_PS, "_aggregate_update",
                        lambda self, grads, stats=False: None)


def _half_batch(monkeypatch, cell):
    fam = cell.family
    make = fam.program_loss

    def halved(model):
        loss_fn = make(model)
        return lambda params, batch: loss_fn(params, fam.half(batch))
    monkeypatch.setattr(fam, "program_loss", halved)


#: the faults a one-chip training cell can have (the exchange between
#: chips is not on its path)
FAULTS = {"state_unchanged": lambda mp, cell: _skip_update(mp),
          "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    cell = tiny.cell(workload)
    FAULTS[fault](monkeypatch, cell)
    out = _run(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())


def test_forbidden_modules_compare_whole_names(monkeypatch):
    sys.path.insert(0, str(spec.HERE))
    try:
        import run as runner
    finally:
        sys.path.remove(str(spec.HERE))
    monkeypatch.setitem(sys.modules, "pytorch_ps_mpi_tpu_torch_x", sys)
    assert "pytorch_ps_mpi_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in runner.forbidden_modules()


def _cli(cwd, workload="bert-base-mlm.terngrad.b32"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _cli(spec.ROOT)
    assert p.returncode != 0 and "{" not in p.stdout


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and "{" not in p.stdout

"""The port's fault injector (``pytorch_ps_mpi_tpu_torch/resilience/
faults.py``) against the JAX package's: the same plans normalize to the
same entries, the same plans are rejected with the same messages, the
same faults are due at the same steps, the same bytes are corrupted and
the same rows are logged. All exact."""

from __future__ import annotations

import numpy as np
import pytest

from pytorch_ps_mpi_tpu.resilience import faults as jf
from pytorch_ps_mpi_tpu_torch.resilience import faults as tf

PLANS = [
    [],
    [{"at_step": 5, "worker": 1, "kind": "crash_worker"}],
    [{"at_step": 3, "worker": "0", "kind": "corrupt", "corrupt_bytes": 3},
     {"at_step": 20, "kind": "crash_server"},
     {"at_step": 2, "worker": 2, "kind": "drop"}],
    [{"at_step": 1, "worker": 0, "kind": k} for k in
     ("delay", "wire_delay", "duplicate", "nan")],
    [{"at_step": 4, "worker": "leader1", "kind": "slow_leader",
      "slow_ms": 5},
     {"at_step": 0, "worker": "reader0", "kind": "reader_storm", "id": 9},
     {"at_step": 7, "worker": "server", "kind": "delay", "delay_ms": 1}],
    [{"at_step": 2, "worker": -1, "kind": "drop", "id": 4},
     {"at_step": 2, "worker": 3, "kind": "corrupt", "id": 17}],
]

BAD_PLANS = [
    [{"at_step": 1, "worker": 0, "kind": "explode"}],
    [{"at_step": 1, "kind": "drop"}],
    [{"at_step": 1, "worker": 0, "kind": "crash_server"}],
    [{"at_step": 1, "worker": 0, "kind": "slow_leader"}],
    [{"at_step": 1, "worker": "leader0", "kind": "reader_storm"}],
    [{"at_step": 1, "worker": 0, "kind": "drop", "id": 3},
     {"at_step": 2, "worker": 1, "kind": "drop", "id": 3}],
]


@pytest.mark.parametrize("plan", PLANS)
def test_normalize_plan_matches_jax(plan):
    assert tf.normalize_plan(plan) == jf.normalize_plan(plan)
    assert tf.FAULT_KINDS == jf.FAULT_KINDS
    assert tf.CRASH_EXIT_CODE == jf.CRASH_EXIT_CODE


@pytest.mark.parametrize("plan", BAD_PLANS)
def test_rejected_plans_match_jax(plan):
    with pytest.raises(ValueError) as jerr:
        jf.normalize_plan(plan)
    with pytest.raises(ValueError) as terr:
        tf.normalize_plan(plan)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("plan", PLANS[1:])
@pytest.mark.parametrize("fired", [(), (0,), (1, 9)])
def test_due_faults_match_jax(plan, fired):
    roles = {0, 1, 2, 3, -1, "server", "leader1", "reader0"}
    for role in roles:
        a = jf.FaultInjector(plan, seed=3, role=role, fired=fired)
        b = tf.FaultInjector(plan, seed=3, role=role, fired=fired)
        for step in range(-1, 22):
            assert b.faults_at(step) == a.faults_at(step)
            assert b.faults_between(step - 3, step) == \
                a.faults_between(step - 3, step)


@pytest.mark.parametrize("seed,fid,nbytes,size", [
    (0, 0, 8, 64), (7, 3, 1, 4096), (123456, 41, 32, 37), (2**31, 0, 5, 1)])
def test_corrupt_positions_match_jax(seed, fid, nbytes, size):
    fault = {"id": fid, "kind": "corrupt", "worker": 0, "at_step": 0,
             "corrupt_bytes": nbytes}
    data = np.random.RandomState(fid).randint(0, 256, size).astype(np.uint8)
    a, b = data.copy(), data.copy()
    jf.FaultInjector([], seed=seed).corrupt(fault, a)
    tf.FaultInjector([], seed=seed).corrupt(fault, b)
    np.testing.assert_array_equal(a, b)
    assert (a != data).any() or size == 0


def test_fired_rows_and_logs_match_jax(tmp_path):
    plan = PLANS[2] + PLANS[3]
    cfg = {"fault_plan": plan, "fault_seed": 5, "fault_fired": [1]}
    rows = {}
    for name, mod in (("jax", jf), ("port", tf)):
        d = tmp_path / name
        inj = mod.FaultInjector.from_cfg({**cfg, "fault_log_dir": str(d)},
                                         role=0)
        for step in range(6):
            for f in inj.faults_at(step):
                if f["kind"] == "corrupt":
                    buf = np.zeros(16, np.uint8)
                    inj.make_tamper(f)(buf)
                    assert buf.any()
                else:
                    inj.fire(f)
        rows[name] = (inj.events, mod.load_fault_log(
            str(d / "faults-0.jsonl")))
        assert mod.FaultInjector.from_cfg({}) is None
        # a server plan skips its fired crash
        srv = mod.FaultInjector.from_cfg(cfg | {"fault_fired": [1]},
                                         role="server")
        assert srv.faults_between(0, 100) == []
    assert rows["port"] == rows["jax"]
    assert rows["port"][0] == rows["port"][1]
    assert tf.load_fault_log(str(tmp_path / "none.jsonl")) == []


def test_injected_server_crash_carries_its_fault():
    f = tf.normalize_plan([{"at_step": 4, "kind": "crash_server"}])[0]
    e = tf.InjectedServerCrash(f)
    assert e.fault is f and isinstance(e, RuntimeError)
    assert str(e) == str(jf.InjectedServerCrash(f))

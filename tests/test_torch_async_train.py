"""The port's async fleet end to end on the CPU (``parallel/async_train.py``
and ``python -m pytorch_ps_mpi_tpu_torch.train_async``): worker
processes are fresh interpreters pushing through the shm or TCP wire.
Four spawn tests, each under its own time limit: (a) the CLI, two MLP
workers over shm, async; (b) the sync barrier with int8, folded in the
compressed domain, one decode a publish; (c) TCP with frames through the
native batched ingest; (d) a resume from a checkpoint keeps the publish
version monotonic. Unported options name their ROADMAP item; the
scale-out, resilience and read-tier keys no longer raise, and a port key
set to 0 counts as set."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer
from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 120.0  # seconds for one fleet, spawn to join
# the spawned processes take one intra-op thread each: the suite's other
# workers share the cores
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _cfg(**kw):
    cfg = {"model": "mlp", "model_kw": {"features": (32, 8)},
           "in_shape": [8], "batch": 16, "seed": 0, "optim": "sgd",
           "hyper": {"lr": 0.05}, "steps": 4, "open_timeout": LIMIT,
           "push_timeout": LIMIT, "device": "cpu", "frame_check": True}
    cfg.update(kw)
    return cfg


def _fleet(server, name, cfg, workers, **serve_kw):
    procs = []
    try:
        procs = [at.spawn_worker(name, i, cfg, env=ONE_THREAD)
                 for i in range(workers)]
        params, m = at.serve(server, cfg, total_grads=0,
                             total_received=workers * cfg["steps"],
                             timeout=LIMIT, **serve_kw)
        assert at.join_workers(procs, timeout=LIMIT) == [0] * workers
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
    return params, m


def _shm(cfg, workers, code=None, name_tag="a"):
    tmpl = at.make_problem(cfg, "cpu").template
    name = f"/psq_torch_test_{os.getpid()}_{name_tag}"
    return ShmPSServer(name, workers, tmpl, max_staleness=4, code=code,
                       frame=cfg["frame_check"], device="cpu"), name


def test_cli_async_mlp_over_shm():
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.train_async",
         "--model", "mlp", "--workers", "2", "--steps", "5", "--lr", "0.05",
         "--timeout", str(LIMIT)],
        cwd=ROOT, capture_output=True, text=True, timeout=2 * LIMIT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "PS_PLATFORM": "cpu",
             **ONE_THREAD})
    assert out.returncode == 0, out.stderr[-3000:]
    m = json.loads(out.stdout.strip().splitlines()[-1])
    assert m["grads_received"] == 10.0
    assert m["applied"] + m["stale_drops"] == 10.0
    assert m["publish_version"] == 1.0 + m["applied"]
    assert sum(m["staleness_hist"].values()) == 10
    assert m["decodes_per_publish"] == 1.0 and m["agg_mode"] == 0.0
    assert m["frames_rejected"] == 0.0
    assert m["loss_final"] < m["loss_initial"]


def test_sync_barrier_int8_folds_once_a_publish():
    cfg = _cfg(codec="int8")
    server, name = _shm(cfg, 2, get_codec("int8"), "b")
    _, m = _fleet(server, name, cfg, 2, sync_barrier=True)
    assert m["agg_mode"] == 1.0 and m["decodes_per_publish"] == 1.0
    assert m["agg_fallbacks"] == 0.0 and m["applied"] == 8.0
    assert m["publish_version"] == 5.0  # the initial publish + 4 rounds
    assert m["loss_final"] < m["loss_initial"]
    assert m["server_times"]["fold_s"] > 0


def test_tcp_with_frames_takes_the_native_batch_ingest(monkeypatch):
    monkeypatch.setenv("PS_NO_NATIVE", "0")
    cfg = _cfg(codec="sign", transport="tcp")
    tmpl = at.make_problem(cfg, "cpu").template
    server = TcpPSServer(0, 2, tmpl, code=get_codec("sign"), frame=True,
                         device="cpu")
    _, m = _fleet(server, f"127.0.0.1:{server.port}", cfg, 2)
    assert m["native_batches"] > 0 and m["native_batch_frames"] == 8.0
    assert m["grads_received"] == 8.0 and m["frames_rejected"] == 0.0
    assert m["compression_ratio"] > 20
    assert m["loss_final"] < m["loss_initial"]


def test_resume_keeps_the_version_monotonic(tmp_path):
    cfg = _cfg(codec="identity", frame_check=False)
    server, name = _shm(cfg, 1, get_codec("identity"), "d1")
    p1, m1 = _fleet(server, name, cfg, 1, checkpoint_dir=str(tmp_path),
                    checkpoint_every=2)
    assert m1["applied_total"] == 4.0
    server, name = _shm(cfg, 1, get_codec("identity"), "d2")
    _, m2 = _fleet(server, name, cfg, 1, checkpoint_dir=str(tmp_path),
                   checkpoint_every=2, resume=True)
    # the version jumps past the saved one by the cadence, then moves on
    assert m2["publish_version"] > m1["publish_version"] + 2
    assert m2["applied_total"] == 8.0 and m2["applied"] == 4.0
    # the resumed run starts from the saved parameters, not the seed's
    assert m2["loss_initial"] == pytest.approx(m1["loss_final"], rel=1e-6)


#: the telemetry keys this package has, with the fleet observability
#: plane's and the controller's beside them
TELEMETRY_KEYS = ("telemetry_dir", "metrics_port")


@pytest.mark.parametrize("key,item", [
    ("telemetry_dir", "item 3"), ("metrics_port", "item 3"),
    ("topo_actions", "item 3"), ("control", "item 3")])
def test_unported_options_name_their_item(key, item):
    # every key is ported: accepted alone and beside the fleet keys; the
    # model gpt is ported too, and a model the fleet does not know raises
    at.check_cfg({"model": "mlp", key: 1})
    at.check_cfg({"model": "mlp", key: 1, "fleet_dir": "d"})
    at.check_cfg({"model": "gpt", key: 1})
    with pytest.raises(ValueError, match="unknown model"):
        at.check_cfg({"model": "transformer-xl"})
    # the scale-out, resilience, read-tier and telemetry keys are ported
    at.check_cfg({"model": "mlp", "fault_plan": [{}], "resilient": True,
                  "tree": True, "tree_members": [4], "supervise": True,
                  "serving": True, "read_port": 1, "serving_kw": {"ring": 2},
                  "health": True, "health_port": 0, "numerics": True,
                  "numerics_kw": {"policy": "skip"}, "lineage": True,
                  "trace": True, "anatomy": "auto", "freshness": True,
                  "hop_anatomy": True, "timeseries": True, "slo": True,
                  "profile": True, "fleet": True, "control_kw": {},
                  "control_dir": "d"})


@pytest.mark.parametrize("key", ["metrics_port", "health_port"])
def test_port_zero_counts_as_set(key, tmp_path):
    # port 0 picks a free port in the JAX package (serving/core.py:109,186,
    # core.py:220-222): it arms the read tier, and a standalone core's
    # own /metrics + /health endpoint
    import urllib.request

    at.check_cfg({"model": "mlp", "read_port": 0, key: 0})
    from pytorch_ps_mpi_tpu_torch.serving import ServingCore

    core = ServingCore(None, {"read_port": 0, "read_native": False,
                              "device": "cpu", key: 0},
                       template={"w": np.zeros(4)})
    try:
        assert core.armed and core.read_port > 0
        assert core.metrics_http_port > 0
        base = f"http://127.0.0.1:{core.metrics_http_port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert "ps_read_seconds" in text
        doc = json.loads(urllib.request.urlopen(base + "/health",
                                                timeout=10).read())
        assert doc["armed"] is False and "serving" in doc
    finally:
        core.close()
    # a fleet_dir registers the standalone core's endpoint card, and the
    # card leaves with the core
    from pytorch_ps_mpi_tpu_torch.telemetry.fleet import list_endpoints

    fdir = str(tmp_path / "fleet")
    core = ServingCore(None, {"read_port": 0, "read_native": False,
                              "device": "cpu", key: 0, "fleet_dir": fdir},
                       template={"w": np.zeros(4)})
    try:
        cards = list_endpoints(fdir)
        assert [c["name"] for c in cards] == ["read-tier"]
        assert cards[0]["role"] == "read"
        assert cards[0]["url"].endswith(f":{core.metrics_http_port}")
    finally:
        core.close()
    assert list_endpoints(fdir) == []

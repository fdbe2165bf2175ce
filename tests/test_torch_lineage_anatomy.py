"""The port's lineage, round anatomy and hop anatomy against the JAX
package's, on rows a CPU MLP fleet of the port wrote: a flat fleet (the
server in this process, ``/metrics`` and ``/health`` scraped while it
runs, numerics with a ``nan`` fault, lineage and anatomy) and a tree
(leaders writing ``lineage-leader<g>.jsonl`` and ``hop-leader<g>.jsonl``,
the root tailing the hop rows). The rows go through both packages'
``LineageTracker`` (replayed), ``anatomy_from_rows`` and
``hop_anatomy_from_rows``, which must agree. Also the shard servers'
per-shard monitors, the read tier's ``/health`` ``serving`` section and
a follower's ``reader_round`` anatomy rows (host Python; the card work
under them is unchanged)."""

from __future__ import annotations

import glob
import json
import os
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pytorch_ps_mpi_tpu.telemetry import anatomy as janat
from pytorch_ps_mpi_tpu.telemetry import hop_anatomy as jhop
from pytorch_ps_mpi_tpu.telemetry import lineage as jlin
from pytorch_ps_mpi_tpu.telemetry import load_jsonl as jload_jsonl
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.parallel import sharded, tree
from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer
from pytorch_ps_mpi_tpu_torch.resilience.faults import normalize_plan
from pytorch_ps_mpi_tpu_torch.telemetry import anatomy as tanat
from pytorch_ps_mpi_tpu_torch.telemetry import hop_anatomy as thop
from pytorch_ps_mpi_tpu_torch.telemetry import lineage as tlin

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 90.0  # seconds for one spawned fleet, spawn to join
ONE = {"OMP_NUM_THREADS": "1"}
STEPS, WORKERS = 5, 2


def _scrape(port: int):
    base = f"http://127.0.0.1:{port}"
    text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
    doc = json.loads(urllib.request.urlopen(base + "/health",
                                            timeout=10).read())
    return text.decode(), doc


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    """One CPU MLP fleet, async, int8, frames, every telemetry key armed;
    worker 1 paced 50 ms and poisoned with NaN at its third push."""
    d = tmp_path_factory.mktemp("flat")
    tdir = str(d / "telemetry")
    cfg = {"model": "mlp", "model_kw": {"features": (16, 4)},
           "in_shape": [8], "batch": 32, "seed": 3, "optim": "sgd",
           "hyper": {"lr": 0.05}, "steps": STEPS, "device": "cpu",
           "frame_check": True, "codec": "int8", "open_timeout": LIMIT,
           "push_timeout": LIMIT, "slow_ms": {"1": 50.0},
           "telemetry_dir": tdir, "metrics_port": 0, "health": True,
           "health_dir": tdir, "numerics": True, "numerics_dir": tdir,
           "numerics_kw": {"policy": "skip", "probe_every": 2},
           "trace": True, "freshness": True, "read_port": 0,
           "read_native": False, "tick_interval": 0.05,
           "fault_plan": normalize_plan([{"worker": 1, "at_step": 2,
                                          "kind": "nan"}])}
    template = at.make_problem(cfg, "cpu").template
    name = f"/psq_tel_test_{os.getpid()}"
    server = ShmPSServer(name, WORKERS, template,
                         max_staleness=10 ** 9, code=get_codec("int8"),
                         frame=True, device="cpu")
    scrapes = []

    def on_tick():
        http = getattr(server, "_metrics_http", None)
        if http is not None:
            scrapes.append(_scrape(http.port))

    procs = []
    try:
        procs = [at.spawn_worker(name, w, cfg, env=ONE)
                 for w in range(WORKERS)]
        _, m = at.serve(server, cfg, total_grads=0,
                        total_received=WORKERS * STEPS, timeout=LIMIT,
                        on_tick=on_tick)
        final = _scrape(m["metrics_port"])
        assert at.join_workers(procs, LIMIT) == [0] * WORKERS
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
    return {"m": m, "dir": tdir, "scrapes": scrapes, "final": final}


def test_fleet_serves_metrics_health_and_numerics(flat):
    m, scrapes = flat["m"], flat["scrapes"]
    assert len(scrapes) >= 2
    for text, doc in scrapes:
        assert text.startswith("# HELP") and doc["armed"] is True
    text, doc = flat["final"]
    for series in ("ps_grad_norm", "ps_worker_health", "ps_lineage_pushes",
                   "ps_anatomy_rounds_total", "ps_update_seconds_bucket",
                   "ps_read_seconds_bucket"):
        assert series in text, series
    assert "numerics" in doc and "serving" in doc
    num = m["numerics"]
    assert num["nonfinite_total"] == 1 and num["quarantined"] == [1]
    # worker 1's two later pushes are dropped too: quarantined under skip
    assert m["reject_reasons"] == {"nonfinite": 1, "quarantined": 2}
    assert m["applied"] + 3 == WORKERS * STEPS
    assert {w["worker"]: w["verdict"] for w in m["health"]["workers"]}[1] \
        == "quarantined"
    # probes at steps 0, 2 and 4 on each worker; the server's trajectory
    for w in range(WORKERS):
        rows = [json.loads(x) for x in open(os.path.join(
            flat["dir"], f"numerics-{w}.jsonl"))]
        assert [r["step"] for r in rows] == [0, 2, 4]
        assert rows[0]["codec"] == "Int8Codec"
    assert m["freshness"]["publishes"] >= m["applied"]
    # every process's recorder JSONL reads back with the JAX reader
    for name in ["server"] + [f"worker-{w}" for w in range(WORKERS)]:
        meta, events = jload_jsonl(os.path.join(flat["dir"],
                                                f"{name}.jsonl"))
        assert events and meta["dropped"] == 0
    assert os.path.exists(m["metrics_prom"])


def _snap(engine) -> dict:
    """An engine's snapshot without its own CPU cost (``overhead_s``)."""
    return {k: v for k, v in engine.snapshot().items() if k != "overhead_s"}


def _rows(path):
    return [json.loads(x) for x in open(path) if x.strip()]


def _replay(mod, rows, workers: int):
    """The lineage rows fed back through a tracker, in their order."""
    t = mod.LineageTracker(num_workers=workers)
    for r in rows:
        if r.get("kind") == "publish":
            for p in r["pushes"]:
                t.observe_consume(dict(p))
            t.observe_publish(r["version"], r["apply_s"])
        elif r.get("kind") == "drop":
            t.observe_consume(dict(r["push"], stale_drop=r["reason"]
                                   == "stale"))
            if r["reason"] != "stale":
                t.discard_last(r["push"]["worker"], reason=r["reason"])
    snap = t.snapshot()
    return {k: snap[k] for k in ("consumed", "composed", "drops",
                                 "publishes", "rounds", "staleness_exact")
            if k in snap}


def test_lineage_replay_and_anatomy_match_jax(flat):
    rows = _rows(os.path.join(flat["dir"], "lineage-server.jsonl"))
    pubs = [r for r in rows if r["kind"] == "publish"]
    assert len(pubs) == flat["m"]["applied"]
    drops = [r for r in rows if r["kind"] == "drop"]
    assert {r["reason"] for r in drops} == {"numerics"}
    assert (1, 2) in {(r["push"]["worker"], r["push"]["step"])
                      for r in drops}
    assert _replay(tlin, rows, WORKERS) == _replay(jlin, rows, WORKERS)
    assert _snap(tanat.anatomy_from_rows(rows)) == \
        _snap(janat.anatomy_from_rows(rows))
    assert tlin.clock_offsets_from_rows(rows) == \
        jlin.clock_offsets_from_rows(rows)
    rounds = tanat.load_anatomy_rows(os.path.join(flat["dir"],
                                                  "anatomy-server.jsonl"))
    assert len([r for r in rounds if r["kind"] == "round"]) == len(pubs)
    assert _snap(tanat.anatomy_from_round_rows(rounds)) == \
        _snap(janat.anatomy_from_round_rows(rounds))


def test_report_tool_reads_the_fleet_directory(flat):
    sys.path.insert(0, str(ROOT))
    from tools.telemetry_report import collect_files, summarize

    out = summarize(collect_files([flat["dir"]]))
    names = {r["name"] for r in out["spans"]}
    assert {"serve.update", "worker.grad", "worker.push_grad"} <= names


@pytest.fixture(scope="module")
def tree_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tree")
    tdir = str(d / "telemetry")
    cfg = {"model": "mlp", "model_kw": {"features": (16, 4)},
           "in_shape": [8], "batch": 32, "seed": 3, "codec": "int8",
           "optim": "sgd", "hyper": {"lr": 0.05}, "frame_check": True,
           "max_staleness": 10 ** 9, "device": "cpu", "steps": 3,
           "n_workers": 4, "group_size": 2, "open_timeout": LIMIT,
           "push_timeout": LIMIT, "lineage_dir": tdir, "lineage": True,
           "hop_anatomy": True,
           "leader_kw": {"degrade_after": 1.0, "flush_after": 2.0,
                         "idle_exit_s": 1.0}}
    _, m = tree.run_tree(cfg, total_pushes=12, timeout=LIMIT,
                         worker_env=ONE, leader_env=ONE)
    return {"m": m, "dir": tdir}


def test_tree_hop_rows_and_hop_anatomy_match_jax(tree_run):
    m, tdir = tree_run["m"], tree_run["dir"]
    assert m["tree_composed"] == 12
    lrows = []
    for path in sorted(glob.glob(os.path.join(tdir,
                                              "lineage-leader*.jsonl"))):
        lrows.extend(_rows(path))
    hops = [r for r in lrows if r["kind"] == "hop"]
    assert sum(len(r["composed"]) for r in hops) == 12
    assert all({"fold_s", "encode_s", "push_s", "ef_residual_norm"}
               <= set(r) for r in hops)
    hrows = []
    for path in sorted(glob.glob(os.path.join(tdir, "hop-*.jsonl"))):
        hrows.extend(thop.load_hop_rows(path))
    assert len(hrows) == len(hops)
    assert _snap(thop.hop_anatomy_from_rows(hrows)) == \
        _snap(jhop.hop_anatomy_from_rows(hrows))
    # the root tailed every leader's rows into its own scoreboard
    assert m["hop"]["rounds"] == len(hrows)
    rows = _rows(os.path.join(tdir, "lineage-server.jsonl")) + lrows
    assert _snap(tanat.anatomy_from_rows(rows)) == \
        _snap(janat.anatomy_from_rows(rows))
    events = thop.hop_trace_events(hrows, rows, t0_wall=0.0)
    assert events == jhop.hop_trace_events(hrows, rows, t0_wall=0.0)


def test_shard_servers_arm_their_own_monitors(tmp_path):
    tdir = str(tmp_path / "telemetry")
    cfg = {"model": "mlp", "model_kw": {"features": (16, 4)},
           "in_shape": [8], "batch": 32, "seed": 5, "optim": "sgd",
           "hyper": {"lr": 0.05}, "codec": "int8", "n_workers": 2,
           "steps": 3, "max_staleness": 10 ** 9, "frame_check": True,
           "device": "cpu", "server_timeout": LIMIT, "open_timeout": LIMIT,
           "push_timeout": LIMIT, "health": True, "metrics_port": 0,
           "lineage": True, "lineage_dir": tdir}
    servers, workers, paths = [], [], []
    hellos = []
    try:
        for s in range(2):
            paths.append(str(tmp_path / f"shard{s}.npz"))
            servers.append(sharded.spawn_shard_server(s, 2, cfg, paths[-1],
                                                      env=ONE))
            hellos.append(sharded.read_server_hello(servers[-1], LIMIT))
        addrs = [f"127.0.0.1:{h['port']}" for h in hellos]
        for w in range(2):
            workers.append(sharded.spawn_sharded_worker(
                addrs, w, cfg, str(tmp_path / f"w{w}.json"), env=ONE))
        assert at.join_workers(workers, LIMIT) == [0, 0]
        assert at.join_workers(servers, LIMIT) == [0, 0]
    finally:
        at.join_workers(servers + workers, timeout=5.0)
    assert all(h["health_port"] > 0 for h in hellos)
    assert len({h["health_port"] for h in hellos}) == 2
    for s, p in enumerate(paths):
        z = np.load(p)
        health = json.loads(str(z["health"]))
        assert [w["worker"] for w in health["workers"]] == [0, 1]
        lineage = json.loads(str(z["lineage"]))
        assert lineage["publishes"] == int(z["applied"]) == 6
        rows = _rows(os.path.join(tdir, f"lineage-shard{s}.jsonl"))
        assert len([r for r in rows if r["kind"] == "publish"]) == 6
        assert os.path.exists(os.path.join(tdir, f"anatomy-shard{s}.jsonl"))


def test_read_tier_health_section_and_follower_anatomy(tmp_path):
    from pytorch_ps_mpi_tpu_torch.serving import FollowerLoop, ServingCore

    tmpl = {"a": np.zeros((64, 4), np.float32)}
    kw = {"ring": 4}
    root = ServingCore(None, {"read_port": 0, "read_native": False,
                              "device": "cpu", "metrics_port": 0,
                              "serving_kw": kw}, template=tmpl)
    replica = ServingCore(None, {"read_port": 0, "read_native": False,
                                 "device": "cpu", "serving_kw": kw},
                          template=tmpl)
    anat = tanat.RoundAnatomy(None, {"telemetry_dir": str(tmp_path)},
                              num_workers=1, name="replica")
    follower = FollowerLoop(replica, "127.0.0.1", root.read_port,
                            template=tmpl, poll_s=0.01, serving_kw=kw,
                            anatomy=anat)
    try:
        for v in range(1, 4):
            root.publish(flat=np.full(256, float(v), np.float32))
            assert follower.step()["outcome"] == "republished"
        _, doc = _scrape(root.metrics_http_port)
        assert doc["serving"]["armed"] and root.latest_version() == 3
    finally:
        follower.close()
        anat.close()
        replica.close()
        root.close()
    rows = tanat.load_anatomy_rows(str(tmp_path / "anatomy-replica.jsonl"))
    assert [r["version"] for r in rows
            if r["kind"] == "reader_round"] == [1, 2, 3]

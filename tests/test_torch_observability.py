"""The port's fleet observability plane (``telemetry/timeseries.py``,
``slo.py``, ``profiler.py``, ``fleet.py``) held against the JAX package's
on the same numpy-made rows: the history's query documents and windowed
quantiles, the SLO verdicts and their replay, the collapsed-stack files,
``parse_prometheus_text`` and the ``/fleet`` merge, each byte for byte as
JSON. Then the plane armed in a two-worker MLP fleet through ``serve``,
and the JAX ``tools/telemetry_report.py`` reading what the port wrote."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from pytorch_ps_mpi_tpu.telemetry import fleet as jfleet
from pytorch_ps_mpi_tpu.telemetry import profiler as jprof
from pytorch_ps_mpi_tpu.telemetry import slo as jslo
from pytorch_ps_mpi_tpu.telemetry import timeseries as jts
from pytorch_ps_mpi_tpu_torch.telemetry import fleet as tfleet
from pytorch_ps_mpi_tpu_torch.telemetry import profiler as tprof
from pytorch_ps_mpi_tpu_torch.telemetry import slo as tslo
from pytorch_ps_mpi_tpu_torch.telemetry import timeseries as tts

LIMIT = 120


def _rows(seed: int, n: int = 400):
    """``n`` metric rows a 0.2 s apart: a gauge, a counter with a reset,
    an exponential latency and a step change."""
    rng = np.random.RandomState(seed)
    lat = rng.exponential(10.0, n)
    out, c = [], 0.0
    for i in range(n):
        c = 0.0 if i == n // 2 else c + float(rng.randint(0, 5))
        out.append((1000.0 + 0.2 * i,
                    {"gauge": float(rng.randn()), "drops": c,
                     "lat": float(lat[i]),
                     "step": 50.0 if n // 3 < i < 2 * n // 3 else 1.0}))
    return out


def _doc(d) -> str:
    """A document as sorted JSON, its self-timed overhead (a wall-clock
    measurement of this process) left out."""
    return json.dumps({k: v for k, v in d.items()
                       if not k.startswith("overhead") and k != "file"},
                      sort_keys=True)


def _fill(mod, rows, **kw):
    h = mod.MetricsHistory(name="srv", **kw)
    for t, m in rows:
        h.sample(m, now=t)
    return h


@pytest.mark.parametrize("seed", [0, 1])
def test_history_query_documents_and_quantiles_match_jax(seed):
    rows = _rows(seed)
    jh, th = _fill(jts, rows, max_points=64), _fill(tts, rows, max_points=64)
    end = rows[-1][0]
    queries = [{}, {"key": "lat", "window": "30"},
               {"key": "lat", "window": str(end), "q": "0.95"},
               {"key": "drops", "window": "40"}, {"key": "nope"},
               {"key": "gauge", "window": "75", "q": "0.5"}]
    for q in queries:
        assert _doc(th.query(q)) == _doc(jh.query(q)), q
    for key in ("lat", "gauge", "step"):
        for window in (5.0, 20.0, 70.0):
            assert th.window_stats(key, window, now=end) == \
                jh.window_stats(key, window, now=end)
            for q in (0.5, 0.95, 0.99):
                assert th.quantile(key, q, window, now=end) == \
                    jh.quantile(key, q, window, now=end)
    assert th.rate("drops", 30.0, now=end) == jh.rate("drops", 30.0, now=end)


def test_history_rows_persist_and_cross_read(tmp_path):
    rows = _rows(2, 120)
    for mod, sub in ((jts, "j"), (tts, "t")):
        h = _fill(mod, rows, dir=str(tmp_path / sub), flush_every=16)
        h.close()
    jp = tmp_path / "j" / "timeseries-srv.jsonl"
    tp = tmp_path / "t" / "timeseries-srv.jsonl"
    assert tp.read_bytes() == jp.read_bytes()
    # each package rebuilds the other's file to the same windows
    a = jts.history_from_rows(tts.load_timeseries_rows(str(tp)))
    b = tts.history_from_rows(jts.load_timeseries_rows(str(jp)))
    end = rows[-1][0]
    assert a.window_stats("lat", 10.0, now=end) == \
        b.window_stats("lat", 10.0, now=end)


def _slo_rules():
    return [{"name": "lat", "key": "lat", "mode": "value", "target": 8.0},
            {"name": "drops", "key": "drops", "mode": "rate",
             "target": 0.5},
            {"name": "step", "key": "step", "mode": "value",
             "target": 10.0}]


def _strip(xs):
    return [{k: x[k] for k in ("kind", "rule", "t", "burn_short",
                               "burn_long")} for x in xs]


def test_slo_verdicts_and_replay_match_jax(tmp_path):
    rows = _rows(3, 500)
    out = {}
    for mod, hmod, sub in ((jslo, jts, "j"), (tslo, tts, "t")):
        d = str(tmp_path / sub)
        h = hmod.MetricsHistory(name="srv", dir=d, flush_every=8)
        wd = mod.SLOWatchdog(history=h, rules=_slo_rules(),
                             short_window_s=5.0, long_window_s=20.0,
                             eval_every_s=0.2, dir=d)
        live = []
        for t, m in rows:
            h.sample(m, now=t)
            live.extend(wd.evaluate(now=t))
        h.close()
        wd.close()
        out[sub] = (live, wd.snapshot(), d)
    assert json.dumps(out["t"][0], sort_keys=True) == \
        json.dumps(out["j"][0], sort_keys=True)
    assert _doc(out["t"][1]) == _doc(out["j"][1])
    kinds = {(v["rule"], v["kind"]) for v in out["t"][0]}
    assert ("step", "breach") in kinds and ("step", "recover") in kinds
    # each package's replay over the port's persisted rows re-derives the
    # port's live verdicts
    trows = tts.load_timeseries_rows(
        os.path.join(out["t"][2], "timeseries-srv.jsonl"))
    kw = dict(rules=_slo_rules(), short_window_s=5.0, long_window_s=20.0,
              eval_every_s=0.2)
    assert _strip(tslo.SLOWatchdog.replay(trows, **kw)) == \
        _strip(out["t"][0])
    assert _strip(jslo.SLOWatchdog.replay(trows, **kw)) == \
        _strip(out["t"][0])


def test_derive_targets_reads_only_the_callers_paths(tmp_path):
    # no path: the defaults, whatever the working directory holds
    assert tslo.derive_targets() == tslo.DEFAULT_TARGETS
    res = tmp_path / "results"
    res.mkdir()
    (res / "x.jsonl").write_text(
        json.dumps({"push_e2e_p95_ms": 40.0}) + "\n"
        + json.dumps({"push_e2e_p95_ms": 60.0}) + "\n")
    assert tslo.derive_targets(str(res)) == jslo.derive_targets(str(res))


#: collapsed stacks of three threads, the profiler's text format
_STACKS = {"MainThread;main (a.py);serve (async_train.py)": 7,
           "MainThread;main (a.py);serve (async_train.py);poll (tcp.py)": 3,
           "Thread-1;run (threading.py);_loop (profiler.py)": 2}


def test_collapsed_stacks_write_load_merge_match_jax(tmp_path):
    paths = []
    for mod, sub in ((jprof, "j"), (tprof, "t")):
        d = tmp_path / sub
        d.mkdir()
        p = mod.SamplingProfiler(name="w", dir=str(d), hz=50)
        p.counts.update(_STACKS)
        p.samples = sum(_STACKS.values())
        paths.append(p.write())
    jp, tp = paths
    jmeta, jcounts = jprof.load_profile(tp)
    tmeta, tcounts = tprof.load_profile(jp)
    assert tcounts == jcounts == _STACKS
    assert tmeta["samples"] == jmeta["samples"] == 12
    assert tprof.merge_profiles([tp, jp]) == jprof.merge_profiles([tp, jp])
    merged = tprof.merge_profiles([tp, jp])
    assert tprof.top_frames(merged, 4) == jprof.top_frames(merged, 4)


_PROM = ("# HELP x y\n# TYPE x counter\nx 3\n"
         'x_bucket{le="+Inf",worker="1"} 7\n'
         'ps_frames_rejected_total{worker="2",reason="crc"} 4\n'
         "ps_grads_received_total 12\nbad{ 1\ny NaN\n")


def test_parse_prometheus_text_matches_jax():
    got = tfleet.parse_prometheus_text(_PROM)
    want = jfleet.parse_prometheus_text(_PROM)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert {"name": "x", "labels": {}, "value": 3.0} in got


def _member_docs(seed: int):
    rng = np.random.RandomState(seed)
    docs = {}
    for i, name in enumerate(("shard0", "shard1", "read-tier")):
        grads = float(rng.randint(5, 200))
        prom = (f"ps_grads_received_total {grads}\n"
                f"ps_stale_drops_total {float(rng.randint(0, 5))}\n"
                f'ps_frames_rejected_total{{worker="{i}"}} 1\n')
        health = {"armed": False, "workers": [], "ts": 1000.0 + i,
                  "uptime_s": 5.0 + i,
                  "control": {"actions_total": i, "flaps": 0, "epoch": i}}
        docs[name] = ("shard" if name.startswith("shard") else "read",
                      prom, health)
    return docs


@pytest.mark.parametrize("seed", [0, 3])
def test_fleet_monitor_merge_matches_jax(tmp_path, monkeypatch, seed):
    """The same member payloads through both monitors' merge: the
    members' fetch is replaced by the fixed documents."""
    docs = _member_docs(seed)
    d = str(tmp_path)
    for i, (name, (role, _, _)) in enumerate(docs.items()):
        tfleet.register_endpoint(d, name, 9000 + i, role=role)
    snaps = []
    for mod in (jfleet, tfleet):
        by_url = {f"http://127.0.0.1:{9000 + i}": v
                  for i, v in enumerate(docs.values())}

        def fetch(url, path, _by=by_url):
            _, prom, health = _by[url]
            return prom if path == "/metrics" else json.dumps(health)

        mon = mod.FleetMonitor(fleet_dir=d, skew_min=1.0, min_poll_s=0.0)
        monkeypatch.setattr(mon, "_fetch", fetch)
        snaps.append(mon._merge([mon._poll_member(m)
                                 for m in mon.members()], 2000.0))
    jsnap, tsnap = snaps
    assert json.dumps(tsnap, sort_keys=True, default=str) == json.dumps(
        jsnap, sort_keys=True, default=str)
    assert tsnap["n_members"] == 3
    assert tsnap["fleet"]["grads_received"] == sum(
        float(p.split()[1]) for _, p, _ in docs.values())
    assert "grads_received" in tsnap["skew"]


def test_serve_arms_the_plane_and_the_jax_report_reads_it(tmp_path):
    """One two-worker MLP fleet with the whole plane armed (history, SLO,
    the sampling profiler in the server and the workers, the fleet card,
    the controller's input rows): ``/history`` answers with monotone
    timestamps while the endpoint lives, ``/fleet`` covers the server,
    the sections ride the metrics, and the JAX package's report reads
    the port's rows into its sections."""
    import urllib.request

    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer
    from tools.telemetry_report import format_table, summarize

    tdir, fdir = tmp_path / "t", tmp_path / "fleet"
    cfg = {"model": "mlp", "model_kw": {"features": (16, 4)},
           "in_shape": [4], "batch": 8, "seed": 0, "steps": 6,
           "optim": "sgd", "hyper": {"lr": 0.05}, "device": "cpu",
           "frame_check": True, "open_timeout": LIMIT,
           "push_timeout": LIMIT, "timeseries": True, "slo": True,
           "profile": True, "telemetry_dir": str(tdir), "fleet": True,
           "fleet_dir": str(fdir), "metrics_port": 0, "control": True,
           "control_dir": str(tdir), "tick_interval": 0.05,
           "timeseries_kw": {"sample_min_interval_s": 0.0},
           "control_kw": {"eval_every_s": 0.05},
           "slo_kw": {"targets": {"push_e2e_p95_ms": 10_000.0}}}
    tmpl = at.make_problem(cfg, "cpu").template
    name = f"/psq_torch_obs_{os.getpid()}"
    server = ShmPSServer(name, 2, tmpl, frame=True, device="cpu")
    procs = []
    try:
        procs = [at.spawn_worker(name, i, cfg, env={"OMP_NUM_THREADS": "1"})
                 for i in range(2)]
        _, m = at.serve(server, cfg, total_grads=0, total_received=12,
                        timeout=LIMIT)
        assert at.join_workers(procs, timeout=LIMIT) == [0, 0]
        base = f"http://127.0.0.1:{m['metrics_port']}"
        doc = json.loads(urllib.request.urlopen(
            base + "/history?key=grads_received&window=600",
            timeout=10).read())
        ts = [p[0] for p in doc["points"]]
        assert len(ts) >= 2 and ts == sorted(ts)
        assert doc["points"][-1][1] == 12.0
        pane = json.loads(urllib.request.urlopen(base + "/fleet",
                                                 timeout=10).read())
        assert pane["n_members"] == 1 and pane["n_ok"] == 1
        assert pane["fleet"]["grads_received"] == 12.0
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
    assert not os.listdir(fdir)  # the card left with the server
    assert m["history"]["samples"] > 0
    assert m["slo"]["breaches_total"] == 0
    assert m["profile"]["samples"] > 0 and m["control"]["flaps"] == 0
    _, counts = tprof.load_profile(str(tdir / "profile-server.txt"))
    assert any("serve (async_train.py)" in stack for stack in counts)
    assert (tdir / "profile-worker-1.txt").exists()
    summary = summarize([str(tdir / f) for f in os.listdir(tdir)])
    assert summary["history"]["samples"] > 0
    assert summary["profile"]["samples"] > 0
    assert "slo" in summary and "actions" in summary
    text = format_table(summary)
    assert "history (" in text and "profile (merged" in text


def test_ps_top_panes_match_jax():
    """The port's dashboard renders the fleet, control and topo panes as
    the JAX ``tools/ps_top.py`` does, frame for frame."""
    from pytorch_ps_mpi_tpu_torch import ps_top as tps
    from tools import ps_top as jps

    snap = {"armed": True, "n_members": 2, "n_ok": 1,
            "fleet": {"grads_received": 5, "stale_drops": 1,
                      "reads_total": 2, "reads_shed": 0,
                      "worst_verdict": "slow"},
            "slo": {"breaches_total": 1, "burning": ["shard0:lat"]},
            "skew": {"grads_received": {"min": 1, "max": 4,
                                        "spread_frac": 0.75,
                                        "flagged": True}},
            "members": {
                "shard0": {"name": "shard0", "role": "shard", "ok": True,
                           "verdict": "slow", "uptime_s": 9.0,
                           "age_s": 0.1, "url": "http://x",
                           "metrics": {"grads_received": 4,
                                       "publish_version": 4,
                                       "staleness_p95": 1.0,
                                       "push_e2e_p95_ms": 2.0,
                                       "reads_total": 2}},
                "shard1": {"name": "shard1", "role": "shard", "ok": False,
                           "error": "unreachable", "metrics": {}}}}
    spark = {("shard0", "staleness_p95"): [0.0, 1.0, 2.0]}
    assert tps.render_fleet(snap, spark) == jps.render_fleet(snap, spark)
    control = {"actions_total": 7, "flaps": 0, "epoch": 1,
               "ladder": ["identity", "int8"], "ladder_idx": 1,
               "transition_active": False, "agg_suspended": False,
               "lr_scale": {1: 0.42}, "evicted": [2], "probation": [],
               "admission_depth": 32, "ring": 8, "pinned": [],
               "topo_armed": True, "topo_actions": 2, "group_replans": 1,
               "replicas": 2, "shard_extra": 0,
               "recent_actions": [{"rule": "codec", "action": "renegotiate",
                                   "old": "identity", "new": "int8",
                                   "verdict": {"kind": "wire_bound"}}]}
    assert tps.render_control(control) == jps.render_control(control)
    text = "\n".join(tps.render_control(control))
    assert "wire=int8" in text and "replans=1" in text
    for vals in ([], [1.0, 1.0], [0, 1, 2, 3, 4, 5, 6, 7]):
        assert tps.sparkline(vals) == jps.sparkline(vals)

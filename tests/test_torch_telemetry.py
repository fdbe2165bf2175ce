"""The port's per-process telemetry against the JAX package's, on the same
inputs: the flight recorder's JSONL (read by the JAX ``load_jsonl`` and
``tools/telemetry_report.py``), the Prometheus text of the same
observations (byte for byte), the health verdicts of the same beacon rows
and observations, the ``/metrics`` and ``/health`` endpoint, the merged
Chrome trace of the same host records, and the keys of
``step(profile=True)``'s split."""

from __future__ import annotations

import json
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu import telemetry as jtel
from pytorch_ps_mpi_tpu.telemetry import diagnosis as jdiag
from pytorch_ps_mpi_tpu.telemetry import registry as jreg
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch import telemetry as ttel
from pytorch_ps_mpi_tpu_torch.telemetry import diagnosis as tdiag
from pytorch_ps_mpi_tpu_torch.telemetry import registry as treg
from pytorch_ps_mpi_tpu_torch.utils import tracing
from torch_parity import mlp_pair, stacked_grads, torch_grads

ROOT = Path(__file__).resolve().parent.parent
#: the time fields of a record: each recorder stamps its own clock
CLOCK = ("ts", "wall", "t0_monotonic", "t0_wall")


def _script(rec) -> None:
    """One fixed sequence of spans and events with explicit times."""
    rec.event("worker.grad", kind="span", ts=10.0, dur=0.25, step=0,
              version=3)
    rec.event("worker.push_grad", kind="span", ts=10.3, dur=0.05, step=0,
              seq=0)
    rec.event("fault.injected", id=1, kind="nan", worker=1, at_step=2)
    rec.event("serve.grad", worker=1, staleness=2, step=5, version=3)
    rec.event("worker.grad", kind="span", ts=11.0, dur=0.5, step=1,
              note=np.float32(1.5))


def _rows(path) -> list:
    with open(path) as f:
        return [{k: v for k, v in json.loads(x).items() if k not in CLOCK}
                for x in f if x.strip()]


def test_recorder_jsonl_matches_jax_and_reads_back(tmp_path):
    tr = ttel.FlightRecorder(capacity=3, worker=0)
    jr = jtel.FlightRecorder(capacity=3, worker=0)
    _script(tr)
    _script(jr)
    tp = tr.dump_jsonl(str(tmp_path / "t.jsonl"))
    jp = jr.dump_jsonl(str(tmp_path / "j.jsonl"))
    assert _rows(tp) == _rows(jp)
    assert tr.dropped == jr.dropped == 2  # bounded, and it says so
    tmeta, tev = jtel.load_jsonl(tp)
    jmeta, jev = ttel.load_jsonl(jp)
    assert tmeta["dropped"] == jmeta["dropped"] == 2
    assert [e["name"] for e in tev] == [e["name"] for e in jev]


def test_train_cli_jsonl_read_by_jax_and_report(tmp_path, monkeypatch,
                                                capsys):
    """A port run's ``train.jsonl`` through the JAX ``load_jsonl`` and
    ``tools/telemetry_report.py``: the same summary as the JAX
    recorder's dump of the same events, timestamps aside."""
    from pytorch_ps_mpi_tpu_torch import train

    sys.path.insert(0, str(ROOT))
    from tools.telemetry_report import summarize

    monkeypatch.setenv("PS_PLATFORM", "cpu")
    try:
        train.main(["--config", "mlp_mnist", "--steps", "3", "--batch", "8",
                    "--log-every", "0", "--telemetry-dir", str(tmp_path)])
    finally:
        ttel.disable()
    path = str(tmp_path / "train.jsonl")
    meta, events = jtel.load_jsonl(path)
    assert meta["worker"] == "trainer" and meta["dropped"] == 0
    names = [e["name"] for e in events]
    assert names.count("ps.step") == 3 and names.count("trainer.step") == 3
    jr = jtel.FlightRecorder(worker="trainer")
    for e in events:
        jr.event(e["name"], kind=e["kind"], ts=e["ts"], dur=e.get("dur"),
                 step=e.get("step"))
    jpath = jr.dump_jsonl(str(tmp_path / "jax.jsonl"))
    got, want = summarize([path]), summarize([jpath])
    assert got["spans"] == want["spans"]
    assert got["events"] == want["events"]


def _observe(mod) -> "object":
    r = mod.MetricsRegistry()
    c = r.counter("ps_things_total", "things")
    c.inc(3)
    r.counter("ps_rej_total", "rejected", labels={"worker": "1"}).set(2.0)
    r.gauge("ps_ratio", "a ratio").set(0.125)
    r.gauge("ps_big", "big").set(1.5e17)
    h = r.histogram("ps_lat_seconds", (0.001, 0.01, 0.1, 1.0), "latency")
    for v in (0.0005, 0.02, 0.02, 0.5, 3.0):
        h.observe(v)
    r.histogram("ps_stale", (0, 1, 2, 4), "stale").load({0: 3, 1: 2, 5: 1})
    return r


def test_prometheus_text_byte_equal():
    assert _observe(treg).prometheus_text() == \
        _observe(jreg).prometheus_text()
    assert _observe(treg).to_dict() == _observe(jreg).to_dict()


class _FakeServer:
    """The attributes ``ps_server_registry`` reads off a PS server."""

    def __init__(self, mod):
        self.wire = None
        self.template = {"w": np.zeros((4, 3), np.float32)}
        self._flat_params = 12
        self.grads_received, self.bytes_received = 9, 432
        self.stale_drops, self.version, self.num_workers = 1, 7, 3
        self.max_staleness = 10 ** 9
        self.staleness_seen = {0: 4, 1: 3, 3: 1, 40: 1}
        self.frames_rejected = {1: 2}
        self.frames_rejected_total = 2
        self.decodes_done, self.grad_publishes = 8, 8
        for k in ("numerics_monitor", "lineage_tracker", "anatomy",
                  "hop_anatomy", "serving_core", "controller"):
            setattr(self, k, None)


def _without_clock(text: str) -> str:
    return "\n".join(x for x in text.splitlines()
                     if not x.startswith(("ps_scrape_ts_seconds",
                                          "ps_uptime_seconds")))


def test_server_registry_text_equal():
    got = treg.ps_server_registry(_FakeServer(treg)).prometheus_text()
    want = jreg.ps_server_registry(_FakeServer(jreg)).prometheus_text()
    assert _without_clock(got) == _without_clock(want)
    tm = treg.ps_server_metrics(_FakeServer(treg))
    jm = jreg.ps_server_metrics(_FakeServer(jreg))
    assert list(tm) == list(jm)
    assert set(tm) == set(treg.PS_SERVER_METRIC_KEYS)
    for k in tm:
        if k not in ("ts", "uptime_s"):
            assert tm[k] == jm[k], k


def _health(mod, d):
    cfg = {"health_dir": str(d)}
    for wid, (compute, wire) in ((0, (0.5, 0.001)), (1, (0.002, 0.6))):
        b = mod.BeaconWriter(str(d), worker=wid)
        for s in range(6):
            b.step(s, compute, wire)
        b.close()
    b2 = mod.BeaconWriter(str(d), worker=2)
    b2.step(0, 0.002, 0.001, retries=2, reconnects=2)
    b2.close(retries=2, reconnects=2)
    mon = mod.HealthMonitor(num_workers=4, cfg=cfg)
    t = 0.0
    for i in range(30):
        t += 0.01
        for wid in range(3):
            mon.observe_grad(wid, i % 3, now=t)
    for wid in range(3):
        mon.observe_grad(wid, 9, now=t + 3.0)
    mon.observe_round({0: 1.0, 1: 1.2, 2: 1.9}, active=[0, 1, 2])
    mon.observe_round({0: 3.0, 1: 3.1}, active=[0, 1])
    mon.tick()
    return mon.snapshot(now=t + 3.0)


def _no_time(x):
    if isinstance(x, dict):
        return {k: _no_time(v) for k, v in x.items()
                if k not in ("ts", "uptime_s", "age_s", "last_beacon_age_s",
                             "t", "at", "t_wall")}
    if isinstance(x, list):
        return [_no_time(v) for v in x]
    return x


def test_health_verdicts_equal_jax(tmp_path):
    got = _health(tdiag, tmp_path / "t")
    want = _health(jdiag, tmp_path / "j")
    assert [(w["verdict"], w["cause"]) for w in got["workers"]] == \
        [(w["verdict"], w["cause"]) for w in want["workers"]]
    assert _no_time(got) == _no_time(want)


def test_metrics_http_serves_metrics_and_health():
    reg = _observe(treg)
    http = ttel.MetricsHTTPServer(
        reg.prometheus_text, port=0,
        routes={"/health": lambda: (json.dumps({"armed": True}),
                                    "application/json")})
    try:
        base = f"http://127.0.0.1:{http.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        assert text.decode() == reg.prometheus_text()
        doc = json.loads(urllib.request.urlopen(base + "/health",
                                                timeout=10).read())
        assert doc == {"armed": True}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        http.close()


def _host_records():
    r1 = jtel.FlightRecorder(worker="server")
    r1.event("serve.consume", kind="span", ts=1.0, dur=0.002, step=3,
             src_worker=0, seq=4, staleness=1)
    r1.event("serve.update", kind="span", ts=1.01, dur=0.01, step=1)
    r2 = jtel.FlightRecorder(worker=0)
    r2.event("worker.push_grad", kind="span", ts=5.0, dur=0.004, step=3,
             seq=4)
    r2.event("worker.grad", kind="span", ts=4.9, dur=0.09, step=3)
    events = r1.events() + r2.events()
    base = events[0]["wall"]
    for i, e in enumerate(events):
        e["wall"] = base + 0.001 * i  # one timeline, fixed
    lineage = [{"kind": "publish", "version": 2, "t": base + 0.01,
                "pushes": [{"worker": 0, "step": 3, "seq": 4}]}]
    return events, lineage


def test_merged_trace_events_equal_jax():
    from pytorch_ps_mpi_tpu.telemetry import trace_export as jte
    from pytorch_ps_mpi_tpu_torch.telemetry import trace_export as tte

    events, lineage = _host_records()
    kw = dict(lineage_rows=lineage, clock_offsets={0: 0.0005})
    got = tte.merged_trace_events([dict(e) for e in events], **kw)
    want = jte.merged_trace_events([dict(e) for e in events], **kw)
    assert got == want
    assert sum(1 for e in got if e.get("ph") == "s") == 1  # one arrow


def test_trace_export_reads_torch_profiler_trace(tmp_path):
    """Device rows come from the Chrome trace ``torch.profiler`` writes:
    kernels, copies and memsets, on their device's track, the lead spin
    kernels left out."""
    d = tmp_path / "device-trace"
    d.mkdir()
    rows = [{"ph": "X", "cat": "kernel", "name": "spin_kernel(long)",
             "ts": 100.0, "dur": 1.0, "args": {"device": 0}},
            {"ph": "X", "cat": "kernel", "name": "sign_encode_kernel",
             "ts": 101.0, "dur": 3.0, "args": {"device": 0}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
             "ts": 105.0, "dur": 2.0, "args": {"device": 0}},
            {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 99.0,
             "dur": 1.0}]
    (d / "trace-1.json").write_text(json.dumps({"traceEvents": rows}))
    got = [row for events in tracing._trace_files(str(d))
           for row in tracing._device_rows(events)]
    assert [(n, s, t) for _, n, s, t in got] == [
        ("sign_encode_kernel", 101e3, 3e3), ("Memcpy DtoH", 105e3, 2e3)]
    events, _ = _host_records()
    path, counts = ttel.export_chrome_trace(
        str(tmp_path / "trace.json"), events, device_trace_dir=str(d),
        device_t0_wall=events[0]["wall"])
    assert counts["host"] == 4 and counts["device"] == 2
    split = tracing.device_split(
        [(0, "ncclDevKernel_AllGather_RING_LL", 0.0, 4e6)]
        + [(0, n, s, t) for _, n, s, t in got])
    assert split["devices"] == 1 and split["comm_s"] == pytest.approx(4e-3)
    assert split["compute_s"] == pytest.approx(5e-6)
    assert [n for n, _ in split["top_ops"]][0].startswith("nccl")


def test_profile_split_has_jax_keys():
    """``step(profile=True)`` on the CPU: the JAX step's data keys and the
    JAX split's keys (the CPU has no device rows: zeros, devices 0)."""
    from pytorch_ps_mpi_tpu import SGD as JSGD
    from pytorch_ps_mpi_tpu.mesh import make_mesh
    from pytorch_ps_mpi_tpu.utils import tracing as jtracing

    variables, model = mlp_pair()
    opt = SGD(model, device="cpu", lr=0.1)
    g = stacked_grads(variables, 1, 0)
    _, data = opt.step(grads=torch_grads(model, g), profile=True)
    jopt = JSGD(jax.tree.map(jnp.asarray, variables), lr=0.1,
                mesh=make_mesh(devices=jax.devices()[:1]))
    _, jdata = jopt.step(grads=jax.tree.map(jnp.asarray, g), profile=True)
    assert set(data) >= {"comm_wait", "profile_device_busy",
                         "profile_compute", "profile_devices"}
    assert set(jdata) - set(data) <= {"grad_norm"}
    _, jsplit = jtracing.profiled_device_split(lambda: jnp.ones(3) + 1)
    assert set(opt.profile_split) == set(jsplit)
    assert opt.profile_split["devices"] == 0


def test_step_and_trainer_spans_with_recorder():
    from pytorch_ps_mpi_tpu_torch.trainer import Trainer

    variables, model = mlp_pair()
    opt = SGD(model, device="cpu", lr=0.1)
    grads = torch_grads(model, stacked_grads(variables, 1, 0))
    opt.step(grads=grads)  # disabled: nothing recorded anywhere
    rec = ttel.configure(worker="trainer")
    try:
        opt.step(grads=grads)
        x = torch.zeros(4, 28, 28, 1)
        y = torch.zeros(4, dtype=torch.long)

        def loss_fn(p, b):
            out = torch.func.functional_call(model, p, (b[0],))
            return torch.nn.functional.cross_entropy(out, b[1])

        Trainer(opt, loss_fn).fit(iter([(x, y)] * 2), 2)
    finally:
        ttel.disable()
    names = [e["name"] for e in rec.events()]
    assert names.count("ps.step") == 3 and names.count("trainer.step") == 2
    # the step's stages are spans of their own, before its row
    assert names[:3] == ["ps.aggregate", "ps.update", "ps.wait"]
    span = rec.events()[3]
    assert span["name"] == "ps.step"
    assert span["kind"] == "span" and span["dur"] > 0
    assert span["attrs"]["wire_lowering"] == "psum"
    assert ttel.get_recorder() is None


def test_train_async_telemetry_flags_map_to_cfg(tmp_path):
    """The CLI's telemetry flags become the fleet's cfg keys as in the JAX
    package (``train_async.py:286-384``), the fleet-plane and control
    flags too (``train_async.py:328-345``)."""
    from pytorch_ps_mpi_tpu_torch import train_async

    tdir = str(tmp_path / "t")
    args = train_async.parser().parse_args([
        "--telemetry-dir", tdir, "--health-port", "0", "--numerics",
        "--numerics-policy", "zero", "--numerics-probe-every", "3",
        "--freshness", "--hop-anatomy"])
    cfg = {"frame_check": True}
    train_async._telemetry_cfg(args, cfg)
    assert cfg == {"frame_check": True, "telemetry_dir": tdir,
                   "fault_log_dir": tdir, "lineage": True,
                   "lineage_dir": tdir, "numerics": True,
                   "numerics_dir": tdir,
                   "numerics_kw": {"policy": "zero", "probe_every": 3},
                   "freshness": True, "hop_anatomy": True,
                   "metrics_port": 0, "health_port": 0, "health_dir": tdir}
    args = train_async.parser().parse_args(["--no-trace"])
    cfg = {"frame_check": True}
    train_async._telemetry_cfg(args, cfg)
    assert cfg == {"frame_check": True}
    args = train_async.parser().parse_args([
        "--telemetry-dir", tdir, "--slo", "--slo-target",
        "push_e2e_p95_ms=250", "--profile", "--control", "--fleet-dir",
        str(tmp_path / "f")])
    cfg = {}
    train_async._fleet_cfg(args, cfg)
    assert cfg == {"timeseries": True, "slo": True,
                   "slo_kw": {"targets": {"push_e2e_p95_ms": 250.0}},
                   "profile": True, "control": True, "control_dir": tdir,
                   "fleet_dir": str(tmp_path / "f"), "metrics_port": 0}
    # the fleet-plane flags need the directory their artifacts land in
    for flag in ("--history", "--slo", "--profile", "--control"):
        with pytest.raises(SystemExit):
            train_async.main([flag])

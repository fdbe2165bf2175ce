"""Async (AsySG-InCon) training from the command line
(``examples/train_async.py`` of the JAX package).

The server runs in this process and each worker is a fresh interpreter
(``parallel.async_train.spawn_worker``); gradients travel as codec
payload bytes through shared memory (``--transport shm``) or TCP. Every
process computes on the card, or on the CPU when ``PS_PLATFORM=cpu`` (as
``train.py``; ``launch.py --platform cpu`` sets it). The last line
printed is the server's metrics as one JSON object.

    python -m pytorch_ps_mpi_tpu_torch.train_async --model mlp --workers 4 \\
        --steps 50
    python -m pytorch_ps_mpi_tpu_torch.train_async --model resnet18 \\
        --codec sign --workers 4 --steps 10 --straggler-ms 500 \\
        --max-staleness 3

Resilience: ``--resilient`` workers back off and reconnect across a
server restart; ``--supervise`` runs the job under the
:class:`Supervisor` (dead workers respawned, a crashed server restarted
from ``--checkpoint-dir``; it implies ``--resilient``); ``--fault-plan``
(JSON, or ``@file.json``; needs ``--supervise``), ``--fault-seed`` and
``--fault-log-dir`` inject seeded faults:

    python -m pytorch_ps_mpi_tpu_torch.train_async --model mlp \
        --workers 2 --steps 6 --supervise --checkpoint-dir D \
        --fault-plan '[{"at_step": 3, "worker": 1, "kind": "crash_worker"}]'

The read tier: ``--read-port 0`` (or a port) arms it on the server, the
bound port in the last line as ``read_port``; ``--snapshot-ring K`` keeps
K versions for delta reads. Readers use
``pytorch_ps_mpi_tpu_torch.serving.ServingReader``.

Telemetry: ``--telemetry-dir D`` writes every process's flight-recorder
JSONL, ``metrics.prom``, the lineage, anatomy and numerics rows and a
merged Chrome trace (``trace.json``, with the server's kernels on the
card) into D, and serves ``/metrics`` and ``/health``
(``--metrics-port``, 0 by default there); ``--health-port`` arms the
health monitor and its worker beacons; ``--trace``/``--no-trace`` arm
lineage (on by default with ``--telemetry-dir`` and frames);
``--numerics`` checks every push and probes the codec's fidelity
(``--numerics-policy``, ``--numerics-probe-every``); ``--freshness`` and
``--hop-anatomy`` arm the read-path and tree-hop planes:

    PS_PLATFORM=cpu python -m pytorch_ps_mpi_tpu_torch.train_async \
        --model mlp --workers 2 --steps 5 --metrics-port 0 \
        --health-port 0 --numerics --telemetry-dir D

The fleet observability plane and the controller
(``train_async.py:94-190`` of the JAX example): ``--history`` retains
every canonical metric (``timeseries-server.jsonl``, ``/history``),
``--slo`` arms the burn-rate watchdog over it (``--slo-target
KEY=VALUE`` overrides a target), ``--profile`` runs the sampling
profiler in the server and every worker (``profile-*.txt``), these three
in ``--telemetry-dir``; ``--control`` arms the self-driving controller
(its action and input rows and ``control-epoch.json`` in
``--telemetry-dir``); ``--fleet-dir`` registers the server for the
fleet pane and serves ``/fleet``; ``--ps-top`` runs ``python -m
pytorch_ps_mpi_tpu_torch.ps_top`` against the live endpoint:

    PS_PLATFORM=cpu python -m pytorch_ps_mpi_tpu_torch.train_async \
        --model mlp --workers 2 --steps 30 --control --telemetry-dir D \
        --health-port 0
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import subprocess
import sys

from pytorch_ps_mpi_tpu_torch.parallel.async_train import (join_workers,
                                                           make_problem,
                                                           serve, spawn_worker)
from pytorch_ps_mpi_tpu_torch.resilience import Supervisor, normalize_plan


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["mlp", "resnet18", "resnet50"],
                    default="mlp")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50,
                    help="gradient pushes per worker")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--optim", choices=["sgd", "adam"], default="sgd")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--codec", default=None,
                    help="codec registry name (e.g. sign, int8, threshold)")
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="with a bucketable --codec: ship dtype-grouped ~N "
                         "MB flat bucket payloads instead of per-leaf ones")
    ap.add_argument("--max-staleness", type=int, default=4)
    ap.add_argument("--straggler-ms", type=float, default=0.0,
                    help="delay the last worker's loop by this much")
    ap.add_argument("--sync-barrier", action="store_true",
                    help="the synchronous-PS oracle (for comparison runs)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--transport", default="shm", choices=["shm", "tcp"])
    ap.add_argument("--port", type=int, default=0,
                    help="tcp transport: listen port (0 picks one)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-frame-check", action="store_true",
                    help="push without the PSF2 frame header")
    ap.add_argument("--resilient", action="store_true",
                    help="workers back off on timeouts and reconnect on "
                         "EOF (they survive a server restart)")
    ap.add_argument("--supervise", action="store_true",
                    help="respawn dead workers and restart a crashed "
                         "server from --checkpoint-dir; implies "
                         "--resilient")
    ap.add_argument("--fault-plan", default=None,
                    help="seeded faults: a JSON list of {at_step, worker, "
                         "kind}, or @path/to/plan.json")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the corrupt positions and the backoff "
                         "jitter")
    ap.add_argument("--fault-log-dir", default=None,
                    help="directory of the per-process fired-fault JSONLs")
    ap.add_argument("--read-port", type=int, default=None,
                    help="arm the read tier on this port (0 picks one; "
                         "the bound port in the last line as read_port)")
    ap.add_argument("--snapshot-ring", type=int, default=None,
                    help="with --read-port: versions kept for delta reads "
                         "(default 8)")
    ap.add_argument("--telemetry-dir", default=None,
                    help="full telemetry into this directory: every "
                         "process's flight-recorder JSONL, metrics.prom, "
                         "lineage/anatomy/numerics rows and a merged "
                         "trace.json; implies --metrics-port 0")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (+ /health) on this "
                         "port (0 picks one; bound port in the last line "
                         "as metrics_port)")
    ap.add_argument("--health-port", type=int, default=None,
                    help="arm the HealthMonitor and serve /health beside "
                         "/metrics on this port (0 picks one); the worker "
                         "beacons land in --telemetry-dir, else a "
                         "temporary dir")
    ap.add_argument("--trace", action="store_true", default=None,
                    help="arm gradient lineage: each published version "
                         "billed to its pushes (lineage-server.jsonl), "
                         "round anatomy, flow arrows in trace.json; needs "
                         "--telemetry-dir and frames")
    ap.add_argument("--no-trace", dest="trace", action="store_false",
                    help="no lineage (otherwise implied by "
                         "--telemetry-dir)")
    ap.add_argument("--numerics", action="store_true",
                    help="check every consumed push on the server's "
                         "device (NaN/Inf counted and quarantined), "
                         "grad-norm and update-ratio statistics, worker "
                         "codec-fidelity probes, postmortems")
    ap.add_argument("--numerics-policy", choices=["skip", "zero", "abort"],
                    default="skip",
                    help="the fate of a non-finite push")
    ap.add_argument("--numerics-probe-every", type=int, default=25,
                    help="codec-fidelity probe / trajectory cadence "
                         "(steps)")
    ap.add_argument("--freshness", action="store_true",
                    help="arm the read-path freshness tracker "
                         "(freshness-server.jsonl in --telemetry-dir)")
    ap.add_argument("--hop-anatomy", action="store_true",
                    help="arm the tree leaders' hop occupancy tracing")
    ap.add_argument("--history", action="store_true",
                    help="arm the metrics history (TSDB): every canonical "
                         "key retained in raw and 1s/10s/60s tiers, "
                         "timeseries-server.jsonl in --telemetry-dir, "
                         "served at /history")
    ap.add_argument("--slo", action="store_true",
                    help="arm the SLO burn-rate watchdog over the history "
                         "(implies --history): latched verdicts into "
                         "slo-server.jsonl, /health's slo section")
    ap.add_argument("--slo-target", action="append", default=[],
                    help="override one SLO target, KEY=VALUE (repeatable; "
                         "e.g. push_e2e_p95_ms=250)")
    ap.add_argument("--profile", action="store_true",
                    help="arm the sampling profiler in the server and "
                         "every worker (profile-*.txt in --telemetry-dir)")
    ap.add_argument("--control", action="store_true",
                    help="arm the self-driving controller (needs "
                         "--telemetry-dir for its action and replay rows "
                         "and control-epoch.json)")
    ap.add_argument("--fleet-dir", default=None,
                    help="register the server's endpoint here and serve "
                         "the merged /fleet snapshot")
    ap.add_argument("--ps-top", action="store_true",
                    help="run the ps_top dashboard against the live "
                         "/health endpoint for the run (implies "
                         "--health-port 0)")
    return ap


def _parse_fault_plan(spec: str) -> list:
    """A fault plan from the command line: JSON, or ``@file.json``."""
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return json.load(f)
    return json.loads(spec)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    if args.supervise:
        args.resilient = True
    fault_plan = None
    if args.fault_plan:
        try:
            fault_plan = normalize_plan(_parse_fault_plan(args.fault_plan))
        except (ValueError, OSError) as e:
            ap.error(f"--fault-plan is not a valid plan: {e}")
        if not args.supervise:
            # a fixed received count is unreachable under drop or corrupt
            # faults, and a crashed worker is respawned by nobody
            ap.error("--fault-plan requires --supervise")
        if any(f["kind"] == "crash_server" for f in fault_plan) \
                and not args.checkpoint_dir:
            ap.error("a crash_server fault needs --checkpoint-dir")
    if args.snapshot_ring is not None and args.read_port is None:
        ap.error("--snapshot-ring needs --read-port (it sizes the read "
                 "tier's snapshot ring)")
    if args.trace and not args.telemetry_dir:
        ap.error("--trace needs --telemetry-dir (lineage rows and the "
                 "flow-event trace land there)")
    if (args.history or args.slo or args.profile) and not args.telemetry_dir:
        ap.error("--history/--slo/--profile need --telemetry-dir (their "
                 "timeseries-/slo-/profile- artifacts land there)")
    if args.slo_target and not args.slo:
        ap.error("--slo-target needs --slo")
    if args.control and not args.telemetry_dir:
        ap.error("--control needs --telemetry-dir (action rows, replay "
                 "input rows and control-epoch.json land there)")
    if args.ps_top and args.health_port is None:
        if args.supervise:
            ap.error("--ps-top with --supervise needs an explicit "
                     "--health-port (the pinned port survives restarts)")
        args.health_port = 0
    if args.trace and args.no_frame_check:
        ap.error("--trace needs frame checking (the trace ID rides the "
                 "frame header); drop --no-frame-check")
    device = "cpu" if os.environ.get("PS_PLATFORM") == "cpu" else "cuda"
    in_shape = (8,) if args.model == "mlp" else (32, 32, 3)
    cfg = {
        "model": args.model,
        "model_kw": ({"num_classes": 10} if args.model != "mlp"
                     else {"features": (64, 8)}),
        "in_shape": list(in_shape),
        "batch": args.batch,
        "seed": 0,
        "optim": args.optim,
        "hyper": {"lr": args.lr},
        "steps": args.steps,
        "open_timeout": args.timeout,
        "push_timeout": args.timeout,
        "frame_check": not args.no_frame_check,
        "transport": args.transport,
        "device": device,
    }
    if args.codec:
        cfg["codec"] = args.codec
        if args.bucket_mb:
            cfg["bucket_mb"] = args.bucket_mb
    if args.read_port is not None:
        cfg["read_port"] = args.read_port
        if args.snapshot_ring is not None:
            cfg["serving_kw"] = {"ring": args.snapshot_ring}
    _telemetry_cfg(args, cfg)
    try:
        _fleet_cfg(args, cfg)
    except ValueError as e:
        ap.error(str(e))
    if args.straggler_ms:
        cfg["slow_ms"] = {str(args.workers - 1): args.straggler_ms}
    if args.resilient:
        cfg["resilient"] = True
        # a failover shows when a push times out: short op timeouts
        cfg["push_timeout"] = min(float(args.timeout), 10.0)
    if fault_plan is not None:
        cfg.update(fault_plan=fault_plan, fault_seed=args.fault_seed)
        if args.fault_log_dir:
            os.makedirs(args.fault_log_dir, exist_ok=True)
            # fault logs append across respawns: one run, one fresh log
            for old in glob.glob(os.path.join(args.fault_log_dir,
                                              "faults-*.jsonl")):
                os.remove(old)
            cfg["fault_log_dir"] = args.fault_log_dir
    if args.supervise:
        cfg["max_staleness"] = args.max_staleness
        if args.resume:
            cfg["resume"] = True
        top = _spawn_ps_top(args.health_port) if args.ps_top else None
        try:
            params, metrics = Supervisor(
                cfg, args.workers, port=args.port,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                sync_barrier=args.sync_barrier, timeout=args.timeout).run()
        finally:
            _stop_ps_top(top)
        if args.telemetry_dir:
            metrics.update(_export_telemetry(args.telemetry_dir))
        print(json.dumps(metrics, default=str), flush=True)
        return metrics
    code = None
    if args.codec:
        from pytorch_ps_mpi_tpu_torch.codecs import get_codec

        code = get_codec(args.codec)
    template = make_problem(cfg, device).template
    kw = dict(num_workers=args.workers, template=template,
              max_staleness=args.max_staleness, code=code,
              bucket_mb=cfg.get("bucket_mb", 0.0),
              frame=cfg["frame_check"], device=device)
    if args.transport == "tcp":
        from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer

        server = TcpPSServer(args.port, **kw)
        name = f"127.0.0.1:{server.port}"
        print(f"tcp PS listening on {name}", flush=True)
    else:
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer

        name = f"/psq_train_torch_{os.getpid()}"
        server = ShmPSServer(name, **kw)
    procs = []
    top = None
    if args.ps_top:
        # bind the endpoint now (serve's own call returns this same port)
        # so the dashboard attaches before the first push
        bound = server.start_metrics_http(
            args.metrics_port if args.metrics_port is not None
            else args.health_port)
        print(f"/health live on port {bound}", flush=True)
        top = _spawn_ps_top(bound)
    device_trace_dir = device_t0_wall = None
    trace_cm = None
    if args.telemetry_dir and device == "cuda":
        # the server's kernels, the device half of the merged timeline;
        # the workers' story arrives through their JSONLs
        import time

        from pytorch_ps_mpi_tpu_torch.utils.tracing import trace

        device_trace_dir = os.path.join(args.telemetry_dir, "device-trace")
        trace_cm = trace(device_trace_dir)
        trace_cm.__enter__()
        device_t0_wall = time.time()
    try:
        procs = [spawn_worker(name, i, cfg) for i in range(args.workers)]
        _, metrics = serve(server, cfg, total_grads=0,
                           total_received=args.workers * args.steps,
                           sync_barrier=args.sync_barrier,
                           timeout=args.timeout,
                           checkpoint_dir=args.checkpoint_dir,
                           checkpoint_every=args.checkpoint_every,
                           resume=args.resume)
        for rc in join_workers(procs, timeout=args.timeout):
            if rc != 0:
                raise SystemExit(f"worker exited {rc}")
    finally:
        if trace_cm is not None:
            trace_cm.__exit__(None, None, None)
        _stop_ps_top(top)
        # the /metrics + /health endpoint closes with the server
        server.close()
        join_workers(procs, timeout=5.0)
    if args.telemetry_dir:
        metrics.update(_export_telemetry(args.telemetry_dir,
                                         device_trace_dir, device_t0_wall))
    print(json.dumps(metrics, default=str), flush=True)
    return metrics


def _telemetry_cfg(args, cfg: dict) -> None:
    """The telemetry flags as cfg keys (``train_async.py:286-384``)."""
    import tempfile

    if args.telemetry_dir:
        os.makedirs(args.telemetry_dir, exist_ok=True)
        # a reused dir must not leak a previous run's rows into this run's
        # trace
        for stale in (glob.glob(os.path.join(args.telemetry_dir, "*.jsonl"))
                      + glob.glob(os.path.join(args.telemetry_dir,
                                               "trace.json"))
                      + glob.glob(os.path.join(args.telemetry_dir,
                                               "postmortem-*.json"))
                      + glob.glob(os.path.join(args.telemetry_dir,
                                               "profile-*.txt"))):
            os.remove(stale)
        cfg["telemetry_dir"] = args.telemetry_dir
        if args.metrics_port is None:
            args.metrics_port = 0
        if args.fault_log_dir is None:
            cfg.setdefault("fault_log_dir", args.telemetry_dir)
    if (args.trace or (args.trace is None and args.telemetry_dir
                       and cfg["frame_check"])):
        cfg["lineage"] = True
        cfg["lineage_dir"] = args.telemetry_dir
    if args.numerics:
        cfg["numerics"] = True
        # one dir, both ends: workers append probe rows, the server tails
        # them and writes postmortems beside them
        cfg["numerics_dir"] = (args.telemetry_dir
                               or tempfile.mkdtemp(prefix="ps_numerics_"))
        cfg["numerics_kw"] = {"policy": args.numerics_policy,
                              "probe_every": args.numerics_probe_every}
    if args.freshness:
        cfg["freshness"] = True
    if args.hop_anatomy:
        cfg["hop_anatomy"] = True
    if args.metrics_port is not None:
        cfg["metrics_port"] = args.metrics_port
    if args.health_port is not None:
        cfg["health_port"] = args.health_port
        cfg["health_dir"] = (args.telemetry_dir
                             or tempfile.mkdtemp(prefix="ps_health_"))


def _fleet_cfg(args, cfg: dict) -> None:
    """The fleet-plane and control flags as cfg keys
    (``train_async.py:328-345``)."""
    if args.history or args.slo:
        cfg["timeseries"] = True
    if args.slo:
        cfg["slo"] = True
        if args.slo_target:
            targets = {}
            for kv in args.slo_target:
                k, _, v = kv.partition("=")
                try:
                    targets[k] = float(v)
                except ValueError:
                    raise ValueError(f"--slo-target {kv!r} is not "
                                     "KEY=FLOAT") from None
            cfg["slo_kw"] = {"targets": targets}
    if args.profile:
        cfg["profile"] = True
    if args.control:
        cfg["control"] = True
        cfg["control_dir"] = args.telemetry_dir
    if args.fleet_dir:
        cfg["fleet_dir"] = args.fleet_dir
        if cfg.get("metrics_port") is None:
            cfg["metrics_port"] = 0  # registration needs a live endpoint


def _spawn_ps_top(port) -> subprocess.Popen:
    """The live dashboard against the local ``/health`` endpoint."""
    from pathlib import Path

    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.Popen([sys.executable, "-m",
                             "pytorch_ps_mpi_tpu_torch.ps_top",
                             str(int(port))], env=env)


def _stop_ps_top(proc) -> None:
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=5)


def _export_telemetry(tdir: str, device_trace_dir=None,
                      device_t0_wall=None) -> dict:
    """Merge every process's flight-recorder JSONL, the lineage flow
    arrows and hop tracks, and the server's device trace into
    ``trace.json`` (``train_async.py:530``); returns the artifact paths
    and counts. The JSONLs are readable by the JAX package's
    ``tools/telemetry_report.py``."""
    from pytorch_ps_mpi_tpu_torch.telemetry import (clock_offsets_from_rows,
                                                    export_chrome_trace,
                                                    is_sidecar, load_jsonl,
                                                    load_hop_rows,
                                                    load_lineage_rows)

    files = sorted(f for f in glob.glob(os.path.join(tdir, "*.jsonl"))
                   if not is_sidecar(f))
    events = []
    for f in files:
        events.extend(load_jsonl(f)[1])
    lineage_rows = []
    for f in sorted(glob.glob(os.path.join(tdir, "lineage-*.jsonl"))):
        lineage_rows.extend(load_lineage_rows(f))
    offsets = clock_offsets_from_rows(lineage_rows) if lineage_rows else None
    hop_rows = []
    for f in sorted(glob.glob(os.path.join(tdir, "hop-*.jsonl"))):
        hop_rows.extend(load_hop_rows(f))
    path, counts = export_chrome_trace(
        os.path.join(tdir, "trace.json"), events,
        device_trace_dir=device_trace_dir, device_t0_wall=device_t0_wall,
        lineage_rows=lineage_rows or None, clock_offsets=offsets,
        hop_rows=hop_rows or None)
    return {"telemetry_trace": path,
            "telemetry_trace_host_events": counts["host"],
            "telemetry_trace_device_events": counts["device"],
            "telemetry_trace_flows": counts["flow"],
            "telemetry_files": files}


if __name__ == "__main__":
    main()

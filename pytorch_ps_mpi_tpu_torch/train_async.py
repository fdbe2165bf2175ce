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
``pytorch_ps_mpi_tpu_torch.serving.ServingReader``. The JAX CLI's
telemetry flags are accepted and raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

from pytorch_ps_mpi_tpu_torch.parallel.async_train import (UNPORTED,
                                                           join_workers,
                                                           make_problem,
                                                           serve, spawn_worker)
from pytorch_ps_mpi_tpu_torch.resilience import Supervisor, normalize_plan

#: the JAX CLI's flags the port does not have yet -> the cfg key whose
#: ROADMAP item they wait for
_UNPORTED_FLAGS = {
    "telemetry-dir": "telemetry_dir", "metrics-port": "metrics_port",
    "health-port": "health_port", "ps-top": "health", "trace": "trace",
    "numerics": "numerics", "history": "timeseries",
    "profile": "profile", "slo": "slo", "freshness": "freshness",
    "hop-anatomy": "hop_anatomy", "control": "control",
    "fleet-dir": "fleet_dir",
}


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
    for flag in _UNPORTED_FLAGS:
        ap.add_argument(f"--{flag}", default=None, nargs="?", const=True)
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
    for flag, key in _UNPORTED_FLAGS.items():
        if getattr(args, flag.replace("-", "_")) is not None:
            raise NotImplementedError(
                f"--{flag} is not ported yet: {UNPORTED[key]}")
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
        params, metrics = Supervisor(
            cfg, args.workers, port=args.port,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            sync_barrier=args.sync_barrier, timeout=args.timeout).run()
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
        server.close()
        join_workers(procs, timeout=5.0)
    print(json.dumps(metrics, default=str), flush=True)
    return metrics


if __name__ == "__main__":
    main()

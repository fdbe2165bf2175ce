"""A read-only parameter-serving tier from a checkpoint directory
(``examples/serve_readonly.py`` of the JAX package).

The :class:`~pytorch_ps_mpi_tpu_torch.serving.ServingCore` without a
trainer loop, workers or transport server: restore the latest PS
checkpoint that ``serve`` or the ``Supervisor`` wrote (``--checkpoint-dir``
with ``--checkpoint-every``), publish it into the snapshot ring and serve
version-conditional reads (not-modified, delta or full, with coalescing
and admission control). Inference replicas read a model this way without
touching the training fleet.

``--follow N`` polls the checkpoint directory every N seconds and
republishes a newer step (idle polls back off to ``max(8, 4N)`` s), so
readers track a live run through delta reads. ``--follow-endpoint
HOST:PORT`` makes the process a replica instead: it subscribes to an
upstream read tier (:class:`~pytorch_ps_mpi_tpu_torch.serving.FollowerLoop`)
and re-serves it from its own ring; chained replicas build the tree.

The first line printed is the JSON hello (``read_port``, ``tenant``,
``version``, ``checkpoint_step``, ``native``, and for a replica
``upstream`` and ``fanout``); the last, at exit (``--duration`` or
SIGINT), ``{"final_serving": {...}}``.

    python -m pytorch_ps_mpi_tpu_torch.train_async --model mlp \\
        --workers 2 --steps 50 --checkpoint-dir D
    python -m pytorch_ps_mpi_tpu_torch.serve_readonly --checkpoint-dir D \\
        --model mlp --read-port 0 --duration 60

A lossy delta codec (``--serving-kw '{"delta_codec": "int8"}'``) encodes
on the card, or on the CPU with ``PS_PLATFORM=cpu``. ``--metrics-port``
serves ``/metrics`` and ``/health`` (its ``serving`` section) from the
core's own endpoint, the bound port in the hello as ``metrics_port``;
in replica mode ``--telemetry-dir`` writes the follower's
``reader_round`` anatomy rows (``anatomy-<fleet name>.jsonl``) there.
``--fleet-dir`` registers the tier's endpoint card for the fleet pane
(``read-tier``, or ``replica-<pid>`` with role ``replica`` when it
follows an endpoint; needs ``--metrics-port``) and serves ``/fleet``;
``--control-dir`` makes a replica poll ``control-topo.json`` there and
re-parent its subscription when the ``replica_upstream`` map names it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

def model_cfg(model: str) -> dict:
    """The async fleet's cfg of ``model`` as ``train_async`` builds it
    (the checkpoint's template)."""
    return {"model": model,
            "model_kw": ({"num_classes": 10} if model != "mlp"
                         else {"features": (64, 8)}),
            "in_shape": [8] if model == "mlp" else [32, 32, 3],
            "batch": 1, "seed": 0}


def template_of(cfg: dict):
    """The model's JAX-layout parameter template (built on the CPU: only
    its shapes are used)."""
    from pytorch_ps_mpi_tpu_torch.parallel.async_train import make_problem

    return make_problem(cfg, "cpu").template


def restore_latest(checkpoint_dir: str, cfg: dict, template):
    """``(flat, version, step)`` from the newest PS checkpoint in
    ``checkpoint_dir`` (the layout of ``async_train._PSCheckpointCadence``)."""
    import torch

    from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import flat_size
    from pytorch_ps_mpi_tpu_torch.utils.checkpoint import CheckpointManager

    flat = torch.zeros(flat_size(template), dtype=torch.float32)
    _, init_state, _ = OPTIMIZERS[cfg.get("optim", "sgd")]
    ckpt = CheckpointManager(checkpoint_dir)
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {checkpoint_dir}")
    restored = ckpt.restore({"flat": flat,
                             "opt_state": init_state({"flat": flat}),
                             "version": 0, "applied_total": 0,
                             "checkpoint_every": 0}, step=step)
    return (restored["flat"].numpy().astype(np.float32, copy=False),
            int(restored["version"]), int(step))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory of PS checkpoints (required unless "
                         "--follow-endpoint)")
    ap.add_argument("--model", choices=["mlp", "resnet18", "resnet50"],
                    default="mlp",
                    help="model the checkpoint was trained with (its "
                         "parameter template)")
    ap.add_argument("--read-port", type=int, default=0,
                    help="read-tier port (0 picks one; in the hello)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="/metrics + /health port (0 picks one; in the "
                         "hello)")
    ap.add_argument("--telemetry-dir", default=None,
                    help="replica mode: write the follower's reader_round "
                         "anatomy rows (anatomy-replica.jsonl) here")
    ap.add_argument("--tenant", default="default",
                    help="tenant namespace this tier serves under")
    ap.add_argument("--ring", type=int, default=8,
                    help="snapshot ring depth (versions kept for deltas)")
    ap.add_argument("--admission-depth", type=int, default=64)
    ap.add_argument("--follow", type=float, default=0.0,
                    help="poll the checkpoint dir every N seconds and "
                         "republish newer steps (0: serve one snapshot); "
                         "in replica mode, the upstream poll period")
    ap.add_argument("--follow-endpoint", default=None, metavar="HOST:PORT",
                    help="replica mode: subscribe to this upstream read "
                         "tier and re-serve it")
    ap.add_argument("--fanout", type=int, default=2,
                    help="replica mode: downstream replicas this node is "
                         "provisioned to feed (in the hello)")
    ap.add_argument("--serving-kw", default=None,
                    help="JSON dict merged into serving_kw (delta codec "
                         "knobs; in replica mode the upstream's)")
    ap.add_argument("--read-native", default="auto",
                    help="native C++ read tier: auto (falls back to the "
                         "Python loop) or off")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="exit after this many seconds (0: until SIGINT)")
    ap.add_argument("--fleet-dir", default=None,
                    help="register this tier's endpoint card here "
                         "(role=replica when following an endpoint)")
    ap.add_argument("--control-dir", default=None,
                    help="replica mode: poll control-topo.json here and "
                         "re-parent the subscription when its "
                         "replica_upstream map names this replica")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if not args.checkpoint_dir and not args.follow_endpoint:
        ap.error("--checkpoint-dir is required unless --follow-endpoint")
    serving_kw = {"ring": args.ring, "admission_depth": args.admission_depth}
    serving_kw.update(json.loads(args.serving_kw) if args.serving_kw
                      else {})
    cfg = {**model_cfg(args.model),
           "device": "cpu" if os.environ.get("PS_PLATFORM") == "cpu"
           else "cuda",
           "read_port": args.read_port, "read_native": args.read_native,
           "serving_kw": serving_kw, "metrics_port": args.metrics_port}
    if args.fleet_dir:
        cfg["fleet_dir"] = args.fleet_dir
        cfg["fleet_name"] = (f"replica-{os.getpid()}"
                             if args.follow_endpoint else "read-tier")
        if args.follow_endpoint:
            cfg["fleet_role"] = "replica"
            cfg["fleet_meta"] = {"upstream": args.follow_endpoint,
                                 "fanout": args.fanout}
    template = template_of(cfg)
    flat, version, step = None, 0, -1
    if args.checkpoint_dir:
        flat, version, step = restore_latest(args.checkpoint_dir, cfg,
                                             template)

    from pytorch_ps_mpi_tpu_torch.serving import FollowerLoop, ServingCore

    core = ServingCore(None, cfg, template=template, tenant=args.tenant)
    if flat is not None:
        core.publish(flat=flat, version=max(version, 1), tenant=args.tenant)
    follower = anatomy = None
    if args.follow_endpoint:
        up_host, _, up_port = str(args.follow_endpoint).rpartition(":")
        if args.telemetry_dir:
            from pytorch_ps_mpi_tpu_torch.telemetry.anatomy import \
                RoundAnatomy

            anatomy = RoundAnatomy(
                None, {"telemetry_dir": args.telemetry_dir},
                num_workers=1, name=str(cfg.get("fleet_name") or "replica"))
        follower = FollowerLoop(
            core, up_host or "127.0.0.1", int(up_port), template=template,
            tenant=args.tenant, poll_s=args.follow or 0.25,
            serving_kw=serving_kw, anatomy=anatomy).start()
    hello = {"read_port": core.read_port, "tenant": args.tenant,
             "version": max(version, 1) if flat is not None else 0,
             "checkpoint_step": step, "native": core.read_native}
    if follower is not None:
        hello["upstream"] = args.follow_endpoint
        hello["fanout"] = args.fanout
    if core.metrics_http_port is not None:
        hello["metrics_port"] = core.metrics_http_port
    deadline = time.time() + args.duration if args.duration else None
    topo_state = {"seq": 0, "mtime": 0}
    replica_name = str(cfg.get("fleet_name") or f"replica-{os.getpid()}")

    def poll_reparent() -> None:
        # structural control: a scale event may rebuild the replica tree;
        # control-topo.json's replica_upstream map names each replica's
        # parent, and repoint is idempotent
        if not (args.control_dir and follower is not None):
            return
        from pytorch_ps_mpi_tpu_torch.control.topo import poll_topo

        doc = poll_topo(args.control_dir, topo_state)
        up = ((doc or {}).get("replica_upstream") or {}).get(replica_name)
        if not up:
            return
        host, _, port = str(up).rpartition(":")
        try:
            if follower.repoint(host or "127.0.0.1", int(port)):
                print(json.dumps({"reparented": up}), flush=True)
        except (TypeError, ValueError):
            pass

    last_step = step
    # idle backoff: a fresh checkpoint snaps the poll back to the base
    # period; every empty poll doubles it
    base_sleep = min(args.follow, 1.0) if args.follow else 0.25
    max_sleep = max(8.0, 4.0 * base_sleep) if args.follow else base_sleep
    sleep_s = base_sleep
    try:
        # inside the try: a SIGINT sent as soon as the hello is read may
        # land before print returns, and must still end with the final
        # line and exit 0
        print(json.dumps(hello), flush=True)
        while deadline is None or time.time() < deadline:
            time.sleep(sleep_s if deadline is None
                       else min(sleep_s, max(deadline - time.time(), 0)))
            poll_reparent()
            if not (args.follow and args.checkpoint_dir):
                continue
            try:
                flat, version, step = restore_latest(args.checkpoint_dir,
                                                     cfg, template)
            except (FileNotFoundError, ValueError, OSError):
                sleep_s = min(sleep_s * 2.0, max_sleep)
                continue  # the trainer is mid-write; the next poll gets it
            if step > last_step:
                v = core.publish(flat=flat, version=max(version, 1),
                                 tenant=args.tenant)
                last_step = step
                sleep_s = base_sleep
                print(json.dumps({"republished": v,
                                  "checkpoint_step": step}), flush=True)
            else:
                sleep_s = min(sleep_s * 2.0, max_sleep)
    except KeyboardInterrupt:
        pass
    finally:
        if follower is not None:
            follower.close()
        if anatomy is not None:
            anatomy.close()
        snap = core.serving_snapshot()
        core.close()
        final = {k: snap[k] for k in ("reads_total", "reads_delta",
                                      "reads_not_modified", "reads_shed",
                                      "coalesce_hits")}
        if follower is not None:
            final["republished"] = follower.republished
            final["replica_lag_versions"] = snap["replica_lag_versions"]
            final["follower_bytes_relayed"] = snap["follower_bytes_relayed"]
        print(json.dumps({"final_serving": final}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

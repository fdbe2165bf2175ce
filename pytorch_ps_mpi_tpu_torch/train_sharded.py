"""Training against sharded parameter servers from the command line
(``examples/train_sharded.py`` of the JAX package, the same flags).

Spawns S shard servers (each owning a contiguous slice of the flat
parameter vector, ``parallel/sharded.py``) and W workers over the TCP
wire, all fresh interpreters on the card (the CPU with
``PS_PLATFORM=cpu``), waits for them, assembles the final model from the
shards' snapshots and prints the metrics as one JSON line, the last.

    python -m pytorch_ps_mpi_tpu_torch.train_sharded --shards 2 \\
        --workers 3 --steps 40
    python -m pytorch_ps_mpi_tpu_torch.train_sharded --codec int8 \\
        --slow-shard-ms 8
    python -m pytorch_ps_mpi_tpu_torch.train_sharded --checkpoint-dir D \\
        --resume
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", choices=["mlp", "resnet18", "resnet50"],
                    default="mlp")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=40,
                    help="gradient pushes per worker (per shard)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--optim", choices=["sgd", "adam"], default="sgd")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--codec", default=None,
                    help="payload codec on every shard wire (e.g. int8)")
    ap.add_argument("--max-staleness", type=int, default=4)
    ap.add_argument("--slow-shard-ms", type=float, default=0.0,
                    help="per-update sleep in the LAST shard")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")

    from pytorch_ps_mpi_tpu_torch.parallel.async_train import make_problem
    from pytorch_ps_mpi_tpu_torch.parallel.sharded import (
        assemble, read_server_port, spawn_shard_server, spawn_sharded_worker)

    device = "cpu" if os.environ.get("PS_PLATFORM") == "cpu" else "cuda"
    in_shape = (8,) if args.model == "mlp" else (32, 32, 3)
    cfg = {
        "model": args.model,
        "model_kw": ({"num_classes": 10} if args.model != "mlp"
                     else {"features": (64, 8)}),
        "in_shape": list(in_shape), "batch": args.batch, "seed": 0,
        "optim": args.optim, "hyper": {"lr": args.lr},
        "n_workers": args.workers, "steps": args.steps,
        "max_staleness": args.max_staleness,
        "server_timeout": args.timeout, "open_timeout": args.timeout,
        "push_timeout": args.timeout, "device": device,
    }
    if args.codec:
        cfg["codec"] = args.codec
    if args.slow_shard_ms:
        cfg["server_slow_ms"] = {str(args.shards - 1): args.slow_shard_ms}
    if args.checkpoint_dir:
        cfg.update(checkpoint_dir=args.checkpoint_dir,
                   checkpoint_every=args.checkpoint_every,
                   resume=args.resume)
    # the coordinator computes only the two held-out losses
    prob = make_problem(cfg, device)
    loss0 = prob.eval_loss()
    tmp = tempfile.mkdtemp(prefix="sharded_torch_")
    servers, workers = [], []
    shard_paths = [os.path.join(tmp, f"shard{s}.npz")
                   for s in range(args.shards)]
    worker_paths = [os.path.join(tmp, f"worker{w}.json")
                    for w in range(args.workers)]
    try:
        servers = [spawn_shard_server(s, args.shards, cfg, shard_paths[s])
                   for s in range(args.shards)]
        addrs = [f"127.0.0.1:{read_server_port(p, timeout=args.timeout)}"
                 for p in servers]
        print(f"shard servers: {addrs}", flush=True)
        workers = [spawn_sharded_worker(addrs, w, cfg, worker_paths[w])
                   for w in range(args.workers)]
        for p in workers:
            if p.wait(timeout=args.timeout) != 0:
                raise SystemExit(f"worker exited {p.returncode}")
        for p in servers:
            if p.wait(timeout=args.timeout) != 0:
                raise SystemExit(f"shard server exited {p.returncode}")
        import numpy as np
        import torch

        from pytorch_ps_mpi_tpu_torch.parallel.dcn import flatten_params

        params = assemble(shard_paths, prob.template)
        prob.load_flat(torch.from_numpy(flatten_params(params)).to(
            prob.device))
        shards = []
        for path in shard_paths:
            z = np.load(path, allow_pickle=False)
            shards.append({
                "applied_total": int(z["applied_total"]),
                "version": int(z["version"]),
                "stale_drops": int(z["stale_drops"]),
                "compression_ratio": round(float(z["compression_ratio"]),
                                           2)})
        spreads = [json.load(open(p))["max_version_spread"]
                   for p in worker_paths]
        metrics = {"loss_initial": loss0, "loss_final": prob.eval_loss(),
                   "shards": shards,
                   "max_version_spread_seen": max(spreads, default=0)}
    finally:
        for p in servers + workers:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()

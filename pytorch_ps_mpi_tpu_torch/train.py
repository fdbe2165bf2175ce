"""Train a BASELINE configuration from the command line
(``examples/train.py`` of the JAX package).

    python -m pytorch_ps_mpi_tpu_torch.train --config mlp_mnist --steps 50
    python -m pytorch_ps_mpi_tpu_torch.train --config resnet18_cifar10 \\
        --norm batch --codec int8 --steps 20
    python -m pytorch_ps_mpi_tpu_torch.train --config bert_mlm --optim adam \\
        --lr 1e-4 --accum-steps 2

Several processes: run it through ``pytorch_ps_mpi_tpu_torch.launch``.
It runs on the card, or on the CPU when ``PS_PLATFORM=cpu`` (the
launcher's ``--platform cpu``). Every rank draws its own batches
(``--batch`` is the batch of one rank, seeded by the rank) and starts
from the same weights (seed 0). The data is synthetic; ``bert_mlm`` is
``BertConfig.base()`` at sequence length 128, on the card in bfloat16
with the flash attention kernels. The last line printed is a JSON object
of ``Trainer.fit``'s metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.func import functional_call

from pytorch_ps_mpi_tpu_torch import MPI_PS, mesh
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss, prefetch,
                                           synthetic_images, synthetic_mlm)
from pytorch_ps_mpi_tpu_torch.models import (MLP, BertConfig, BertMLM,
                                             ResNet18, ResNet50, mlm_loss)
from pytorch_ps_mpi_tpu_torch.models.resnet import (apply_with_stats,
                                                    batch_stats_of)
from pytorch_ps_mpi_tpu_torch.optim import step_decay, warmup_cosine
from pytorch_ps_mpi_tpu_torch.trainer import Trainer
from pytorch_ps_mpi_tpu_torch.utils.interop import jax_leaf_order

SEED = 0
SEQ_LEN = 128

CONFIGS = ["mlp_mnist", "resnet18_cifar10", "resnet50_imagenet", "bert_mlm",
           "switch_mlm", "gpt_lm"]

#: configurations of the JAX package whose models the port lacks
UNPORTED = {
    "switch_mlm": "the Switch MoE model (models/moe.py) is not ported yet: "
                  "ROADMAP queue 1 item 8",
    "gpt_lm": "the GPT model (models/gpt.py) is not ported yet: ROADMAP "
              "queue 1 item 8",
}


def build(args, device: torch.device
          ) -> Tuple[torch.nn.Module, Callable, Iterator, Optional[Dict]]:
    """``(model, loss_fn, batches, aux_state)``: ``aux_state`` is the
    running statistics of a BatchNorm model (``loss_fn`` then takes and
    returns them), else ``None``."""
    if args.config in UNPORTED:
        raise NotImplementedError(UNPORTED[args.config])
    data_seed = SEED + mesh.rank()
    if args.config == "bert_mlm":
        cfg = dataclasses.replace(BertConfig.base(), remat=args.remat,
                                  scan_layers=args.scan_layers)
        if device.type == "cuda":
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16,
                                      attention="flash")
        model = BertMLM(cfg, seed=SEED, device=device)
        data = synthetic_mlm(args.batch, SEQ_LEN, cfg.vocab_size,
                             seed=data_seed, device=device)

        def loss_fn(p, b):
            logits = functional_call(model, p, (b["tokens"],))
            return mlm_loss(logits, b["targets"], b["mask"])

        return model, loss_fn, data, None
    if args.config == "mlp_mnist":
        model = MLP(features=(128, 10), seed=SEED, device=device)
        dataset = "mnist"
    elif args.config == "resnet18_cifar10":
        model = ResNet18(num_classes=10, small_inputs=True, norm=args.norm,
                         bn_axis="data" if args.norm == "batch" else None,
                         seed=SEED, device=device)
        dataset = "cifar10"
    else:
        model = ResNet50(num_classes=1000, norm=args.norm,
                         bn_axis="data" if args.norm == "batch" else None,
                         seed=SEED, device=device)
        dataset = "imagenet"
    data = synthetic_images(dataset, args.batch, seed=data_seed,
                            device=device)
    if getattr(model, "norm", "group") == "batch":
        def loss_fn(p, aux, b):
            x, y = b
            logits, new_aux = apply_with_stats(model, p, aux, x)
            return cross_entropy_loss(logits, y), new_aux

        return model, loss_fn, data, batch_stats_of(model)

    def loss_fn(p, b):
        x, y = b
        return cross_entropy_loss(functional_call(model, p, (x,)), y)

    return model, loss_fn, data, None


def codec_from_args(name: Optional[str], kvs) -> Any:
    """``get_codec(name, **kv)`` with each ``k=v`` value parsed as JSON
    where it parses."""
    if not name:
        return None
    kw = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        kw[k] = v
    return get_codec(name, **kw)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", choices=CONFIGS, default="mlp_mnist")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64,
                    help="the batch of one rank")
    ap.add_argument("--norm", choices=["group", "batch"], default="group",
                    help="ResNet normalization; 'batch' is SyncBatchNorm "
                         "across the ranks")
    ap.add_argument("--optim", choices=["sgd", "adam", "adafactor"],
                    default="sgd")
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default 0.01; adafactor with no "
                         "--lr and no schedule takes the paper's relative "
                         "step size)")
    ap.add_argument("--lr-schedule",
                    choices=["constant", "warmup_cosine", "step_decay"],
                    default=None)
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--decay-boundaries", default="",
                    help="comma-separated steps for step_decay")
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--clip-norm", type=float, default=0.0)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--adamw", action="store_true",
                    help="decoupled weight decay (adam only)")
    ap.add_argument("--mode", choices=["allgather", "leader"],
                    default="allgather")
    ap.add_argument("--codec", default=None,
                    help="a registered codec name (identity, sign, int8, "
                         "qsgd, topk, ef, terngrad, powersgd, ...)")
    ap.add_argument("--codec-arg", action="append", default=[],
                    help="k=v passed to the codec (repeatable)")
    ap.add_argument("--bucket-mb", type=float, default=0.0)
    ap.add_argument("--bf16-comm", action="store_true",
                    help="bfloat16 gradient all-reduces")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--scan-layers", action="store_true")
    ap.add_argument("--scan-chunk", type=int, default=1,
                    help=">1 runs that many steps a call (run_steps)")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help=">1 accumulates that many batches a step")
    ap.add_argument("--instrument", action="store_true",
                    help="per-stage timing metrics")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    return ap


def main(argv=None) -> Dict[str, float]:
    ap = parser()
    args = ap.parse_args(argv)
    if args.adamw and args.optim != "adam":
        ap.error("--adamw requires --optim adam")
    device = mesh.resolve_device(
        "cpu" if os.environ.get("PS_PLATFORM") == "cpu" else "cuda")
    if device.type == "cuda" and device.index is None:
        # batches are made on a prefetch thread, which has its own current
        # device: name this process's card
        device = torch.device("cuda", torch.cuda.current_device())
    model, loss_fn, data, aux = build(args, device)
    named = dict(model.named_parameters())
    params = {n: named[n] for n in jax_leaf_order(model)}

    lr = 0.01 if args.lr is None else args.lr
    if args.lr_schedule == "warmup_cosine":
        lr = warmup_cosine(lr, total_steps=args.steps,
                           warmup_steps=args.warmup_steps)
    elif args.lr_schedule == "step_decay":
        bounds = tuple(int(b) for b in args.decay_boundaries.split(",") if b)
        lr = step_decay(lr, boundaries=bounds or (args.steps // 2,))
    hyper: Dict[str, Any] = {"lr": lr}
    if args.optim == "sgd":
        hyper["momentum"] = args.momentum
    if args.weight_decay:
        hyper["weight_decay"] = args.weight_decay
    if args.adamw:
        hyper["decoupled_weight_decay"] = True
        hyper.setdefault("weight_decay", 0.01)
    if args.optim == "adafactor" and args.lr is None \
            and args.lr_schedule is None:
        hyper["lr"] = None
    opt = MPI_PS(params, optim=args.optim,
                 code=codec_from_args(args.codec, args.codec_arg),
                 mode=args.mode, average=True, instrument=args.instrument,
                 comm_dtype=torch.bfloat16 if args.bf16_comm else None,
                 clip_norm=args.clip_norm, bucket_mb=args.bucket_mb,
                 device=device, **hyper)
    print(f"config={args.config} device={device} world={opt.size} "
          f"codec={args.codec or 'identity'} norm={args.norm}", flush=True)
    trainer = Trainer(opt, loss_fn, checkpoint_dir=args.checkpoint_dir,
                      scan_chunk=args.scan_chunk,
                      accum_steps=args.accum_steps, aux_state=aux)
    if trainer.maybe_restore():
        print(f"resumed from step {trainer.step_count}", flush=True)
    batches = prefetch(data)
    try:
        summary = trainer.fit(batches, args.steps, log_every=args.log_every)
    finally:
        batches.close()  # stops the batch thread before the process exits
    print(json.dumps({k: (None if v is None else round(float(v), 6))
                      for k, v in summary.items()}), flush=True)
    return summary


if __name__ == "__main__":
    main()

"""Train a causal LM at long sequence length with sequence parallelism
(``examples/train_longcontext.py`` of the JAX package).

    python -m pytorch_ps_mpi_tpu_torch.train_longcontext --seq 2048 --sp 1
    python -m pytorch_ps_mpi_tpu_torch.launch --coordinator 127.0.0.1:<port> \\
        --num-processes 4 --process-id <r> --platform cpu \\
        pytorch_ps_mpi_tpu_torch/train_longcontext.py --dp 2 --sp 2 \\
        --seq 64 --attention ulysses

A GPT (``gpt_config``, FFN twice the hidden width) over a (data, seq)
mesh of ``dp · sp`` ranks, one process a rank (run it through
``launch``; one process needs no launcher): every rank holds one
sequence shard of its data shard's batch, ring hops (or Ulysses
all-to-alls) exchange the context, per-layer remat keeps activation
memory flat, and one all-reduce a leaf sums the gradients over the
(seq, data) ranks before an SGD step with momentum. On the card the
model computes in bfloat16 with every attention block on the flash
kernels; on the CPU (``PS_PLATFORM=cpu``) in float32.

The loss is the JAX script's: each shard's targets are its own next
tokens (position t predicts t + 1 within the shard, so the sp − 1
cross-shard predictions are left out) and the denominator is the static
``batch · (seq − sp)``; the loss is the sum over the ranks of the shards'
terms. The gradient is the one of that loss: each rank differentiates
its own terms and the all-reduce sums them (the JAX script differentiates
the summed loss inside a ``shard_map`` with ``check_vma=False``, whose
transpose of the sum multiplies every gradient by ``dp · sp``; ROADMAP
queue 3). The tokens are uniform draws from ``--seed``. Each step prints
a JSON line; the last line is a JSON summary with the median step ms,
the peak device GB and whether every loss was finite.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from pytorch_ps_mpi_tpu_torch import comms, mesh as meshlib
from pytorch_ps_mpi_tpu_torch.models.bert import target_log_likelihood
from pytorch_ps_mpi_tpu_torch.models.gpt import GPTLM, gpt_config
from pytorch_ps_mpi_tpu_torch.optim import (SGDHyper, init_sgd_state,
                                            sgd_update)
from pytorch_ps_mpi_tpu_torch.utils.interop import jax_leaf_order


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ways")
    ap.add_argument("--sp", type=int, default=8,
                    help="sequence-parallel ways (ranks = dp * sp)")
    ap.add_argument("--attention", choices=["ring", "ulysses"],
                    default="ring")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1,
                    help="global batch (must divide by --dp)")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-layer rematerialization")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    return ap.parse_args(argv)


def check_args(args) -> Optional[str]:
    """The CLI mistakes the JAX script rejects before it starts, as its
    messages; None when the flags fit."""
    if args.batch % args.dp:
        return f"--batch {args.batch} must divide by --dp {args.dp}"
    if args.seq % args.sp:
        return f"--seq {args.seq} must divide by --sp {args.sp}"
    if args.attention == "ulysses" and args.heads % args.sp:
        return (f"--attention ulysses needs --heads {args.heads} divisible "
                f"by --sp {args.sp}")
    return None


def model_config(args, device: torch.device):
    """The GPT of the flags: FFN 2 × hidden, ``max_position`` the sequence,
    bf16 on the card."""
    kw = dict(vocab_size=args.vocab, hidden_size=args.hidden,
              num_layers=args.layers, num_heads=args.heads,
              intermediate_size=2 * args.hidden, max_position=args.seq,
              remat=not args.no_remat, attention=args.attention)
    if device.type == "cuda":
        kw["dtype"] = torch.bfloat16
    return gpt_config(**kw)


def make_tokens(args, seed: int = 1) -> torch.Tensor:
    """The global ``[batch, seq]`` token batch, uniform over the vocab."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, args.vocab,
                                        size=(args.batch, args.seq)))


def shard_loss(model, params, toks: torch.Tensor, mesh, den: float
               ) -> torch.Tensor:
    """This rank's loss, summed over the (seq, data) ranks: its shard's
    next-token log-likelihoods over the static ``den``. The sum's backward
    is the identity, so each rank's gradient is its own terms'."""
    offset = mesh.axis_index("seq") * toks.shape[1]
    logits = functional_call(model, params, (toks,),
                             {"position_offset": offset})
    ll = target_log_likelihood(logits[:, :-1], toks[:, 1:])
    return comms.psum_fwd_identity_bwd(-ll.sum() / den,
                                       mesh.group(("seq", "data")))


class LongContextTrainer:
    """The JAX script's compiled step as a loop: the model, its SGD state
    and the (data, seq) mesh; :meth:`step` takes the global tokens."""

    def __init__(self, args, device: torch.device, seed: int = 0):
        self.args, self.device = args, device
        self.mesh = meshlib.make_mesh(shape=(args.dp, args.sp),
                                      axis_names=("data", "seq"))
        self.model = GPTLM(model_config(args, device), seed=seed,
                           device=device, mesh=self.mesh)
        named = dict(self.model.named_parameters())
        self.params = {n: named[n] for n in jax_leaf_order(self.model)}
        self.opt_state = init_sgd_state(self.params)
        self.hyper = SGDHyper(lr=args.lr, momentum=args.momentum)
        self.den = float(args.batch * (args.seq - args.sp))
        self.group = self.mesh.group(("seq", "data"))

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One step on the global ``tokens``: the summed loss (a device
        scalar) after the parameters moved."""
        toks = self.mesh.shard(tokens, meshlib.P("data", "seq")).to(
            self.device)
        leaves = {k: p.detach().requires_grad_()
                  for k, p in self.params.items()}
        loss = shard_loss(self.model, leaves, toks, self.mesh, self.den)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        # one all-reduce a leaf over both mesh axes
        summed = {k: comms.allreduce_sum(g, self.group)
                  for k, g in zip(leaves, grads)}
        self.params, self.opt_state = sgd_update(self.params, summed,
                                                 self.opt_state, self.hyper)
        return loss.detach()


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    err = check_args(args)
    if err:
        print(err, file=sys.stderr)
        sys.exit(2)
    if meshlib.world_size() != args.dp * args.sp:
        print(f"{meshlib.world_size()} rank(s) != dp*sp={args.dp * args.sp}; "
              "start one process a rank through pytorch_ps_mpi_tpu_torch."
              "launch", file=sys.stderr)
        sys.exit(2)
    device = meshlib.resolve_device(
        "cpu" if os.environ.get("PS_PLATFORM") == "cpu" else "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    trainer = LongContextTrainer(args, device)
    tokens = make_tokens(args)
    print(f"mesh=({args.dp}x{args.sp}) attention={args.attention} "
          f"seq={args.seq} (l_local={args.seq // args.sp}) "
          f"remat={not args.no_remat} device={device}", flush=True)
    t0 = time.time()
    losses, step_ms = [], []
    for i in range(args.steps):
        ts = time.perf_counter()
        loss = float(trainer.step(tokens))
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(loss)
        print(json.dumps({"step": i, "loss": round(loss, 4),
                          "wall_s": round(time.time() - t0, 2)}), flush=True)
    summary = {"losses": losses, "finite": bool(np.all(np.isfinite(losses))),
               "step_ms_median": float(np.median(step_ms)),
               "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None)}
    print(json.dumps(summary), flush=True)
    if not summary["finite"]:
        raise SystemExit(f"non-finite loss: {losses}")
    return summary


if __name__ == "__main__":
    main()

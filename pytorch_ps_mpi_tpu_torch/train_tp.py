"""Train a tensor-parallel transformer block with the drop-in optimizer
(``examples/train_tp.py`` of the JAX package).

    python -m pytorch_ps_mpi_tpu_torch.train_tp --dp 1 --tp 1
    python -m pytorch_ps_mpi_tpu_torch.launch --coordinator 127.0.0.1:<port> \\
        --num-processes 8 --process-id <r> --platform cpu \\
        pytorch_ps_mpi_tpu_torch/train_tp.py --dp 2 --sp 2 --tp 2 \\
        --codec bf16 --mode leader

A (data, seq, model) mesh of ``dp · sp · tp`` ranks, one process a rank
(through ``launch``): Megatron column- and row-parallel attention and MLP
keep their weights sharded over ``model`` (``parallel.tp``), ring
attention shards the sequence when ``--sp`` > 1, and
``MPI_PS(param_specs=...)`` drives the whole block: each rank's local
gradients go through the codec, aggregate over the data axes only, and
the optimizer state (leader mode's included) stays sharded beside the
weights. The weights are drawn from seed 0 and the tokens from seed 1
(uniform over ``[1, vocab)``); the loss is the local loss over the static
``batch · seq``. Float32 on the card, on the CPU with ``PS_PLATFORM=cpu``.
Each step prints a JSON line; the last line says which axes the TP
leaves are sharded over.
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

from pytorch_ps_mpi_tpu_torch import mesh as meshlib
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.mesh import P
from pytorch_ps_mpi_tpu_torch.parallel import tp as tpmod
from pytorch_ps_mpi_tpu_torch.ps import MPI_PS
from pytorch_ps_mpi_tpu_torch.utils.interop import flat_from_jax


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dp", type=int, default=2, help="data-parallel ways")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ways (ring attention)")
    ap.add_argument("--tp", type=int, default=4,
                    help="tensor-parallel ways (ranks = dp * sp * tp)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4,
                    help="global batch (must divide by --dp)")
    ap.add_argument("--seq", type=int, default=32,
                    help="sequence length (must divide by --sp)")
    ap.add_argument("--optim", choices=["sgd", "adam"], default="sgd")
    ap.add_argument("--mode", choices=["allgather", "leader"],
                    default="allgather",
                    help="leader = ZeRO-1 sharded optimizer state")
    ap.add_argument("--codec", default=None,
                    help="gradient codec (e.g. bf16, powersgd, topk)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--ffn", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=512)
    return ap.parse_args(argv)


def check_args(args) -> Optional[str]:
    """The JAX script's CLI checks, as its messages."""
    if args.batch % args.dp:
        return f"--batch {args.batch} must divide by --dp {args.dp}"
    if args.seq % args.sp:
        return f"--seq {args.seq} must divide by --sp {args.sp}"
    if args.heads % args.tp:
        return f"--heads {args.heads} must divide by --tp {args.tp}"
    if args.hidden % args.heads:
        return f"--hidden {args.hidden} must divide by --heads {args.heads}"
    if args.ffn % args.tp:
        return f"--ffn {args.ffn} must divide by --tp {args.tp}"
    return None


def global_params(args, seed: int = 0) -> Dict[str, Any]:
    """The block's global parameters (``emb``, ``pos``, ``attn``, ``mlp``,
    ``head``; TP leaves stacked ``[tp, ...]``), float32 on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    d, v = args.hidden, args.vocab
    return {
        "emb": 0.02 * torch.randn((v, d), generator=gen),
        "pos": 0.02 * torch.randn((args.seq, d), generator=gen),
        "attn": tpmod.init_tp_attention(gen, d, args.heads, args.tp),
        "mlp": tpmod.init_tp_mlp(gen, d, args.ffn, args.tp),
        "head": 0.02 * torch.randn((d, v), generator=gen),
    }


def param_specs(params) -> Dict[str, P]:
    """Flat ``name -> spec``: the TP leaves over ``model``."""
    specs = {"emb": P(), "pos": P(), "head": P()}
    for part in ("attn", "mlp"):
        for k, sp in tpmod.tp_param_spec(params[part], "model").items():
            specs[f"{part}.{k}"] = sp
    return specs


def make_tokens(args, seed: int = 1) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(1, args.vocab,
                                        size=(args.batch, args.seq)))


def make_loss_fn(args, mesh):
    """``loss_fn(flat_params, local_tokens)``: the local loss with the
    static global normalizer ``batch · seq`` (the ``param_specs``
    contract)."""
    l_local = args.seq // args.sp
    seq_axis = "seq" if args.sp > 1 else None

    def loss_fn(p, toks):
        offset = mesh.axis_index("seq") * l_local
        pos = p["pos"][offset + torch.arange(l_local, device=toks.device)]
        x = p["emb"][toks] + pos[None]
        attn = {k[5:]: v for k, v in p.items() if k.startswith("attn.")}
        mlp = {k[4:]: v for k, v in p.items() if k.startswith("mlp.")}
        x = x + tpmod.tp_self_attention(x, attn, "model", seq_axis=seq_axis,
                                        causal=False, local_grads=True,
                                        mesh=mesh)
        x = x + tpmod.tp_mlp(x, mlp, "model", local_grads=True, mesh=mesh)
        logits = x @ p["head"]
        ll = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(ll, -1, toks[..., None])[..., 0]
        return -ll.sum() / float(args.batch * args.seq)

    return loss_fn


def build(args, device: torch.device, mesh=None):
    """``(opt, loss_fn, tokens)`` for the flags on this rank."""
    if mesh is None:
        mesh = meshlib.make_mesh(shape=(args.dp, args.sp, args.tp),
                                 axis_names=("data", "seq", "model"))
    full = global_params(args)
    specs = param_specs(full)
    params = {k: mesh.shard(torch.from_numpy(a), specs[k]).to(device)
              for k, a in flat_from_jax(full).items()}
    agg = ("data", "seq") if args.sp > 1 else "data"
    batch_spec = P("data", "seq") if args.sp > 1 else P("data")
    opt = MPI_PS(params, optim=args.optim, lr=args.lr, mode=args.mode,
                 code=get_codec(args.codec) if args.codec else None,
                 mesh=mesh, axis_name=agg, param_specs=specs,
                 batch_spec=batch_spec, device=device)
    return opt, make_loss_fn(args, mesh), make_tokens(args).to(device)


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    err = check_args(args)
    if err:
        print(err, file=sys.stderr)
        sys.exit(2)
    n_need = args.dp * args.sp * args.tp
    if meshlib.world_size() != n_need:
        print(f"{meshlib.world_size()} rank(s) != dp*sp*tp={n_need}; start "
              "one process a rank through pytorch_ps_mpi_tpu_torch.launch",
              file=sys.stderr)
        sys.exit(2)
    device = meshlib.resolve_device(
        "cpu" if os.environ.get("PS_PLATFORM") == "cpu" else "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    opt, loss_fn, tokens = build(args, device)
    losses, step_ms = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        loss, data = opt.step(loss_fn=loss_fn, batch=tokens)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({
            "step": step, "loss": round(losses[-1], 4),
            "step_s": round(step_ms[-1] / 1e3, 3),
            "mesh": f"{args.dp}x{args.sp}x{args.tp}", "mode": args.mode,
            "codec": args.codec or "identity",
            "wire_lowering": data["wire_lowering"],
            "wire_bytes_per_worker": data["wire_bytes_per_worker"],
        }), flush=True)
    spec = opt.param_specs["mlp.w1"]
    summary = {"done": True, "tp_leaves_sharded_over": repr(spec),
               "losses": losses,
               "finite": bool(np.all(np.isfinite(losses))),
               "step_ms_median": float(np.median(step_ms))}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()

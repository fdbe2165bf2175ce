"""The comparison that decides ``correct``.

The program's first steps (:meth:`Program.first_steps`) against the
plain reference's, from the same weights, batches and codec seed. The
numbers (:data:`NUMBERS`):

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
  ``loss_first``: the first step's alone (the forward only);
- of each leaf's first gradient as the optimizer received it, over the
  larger of the reference's norm of that leaf and of the median leaf:
  the gap of the norms and the norm of the difference; ``grad_gap`` and
  ``grad_dist`` are their medians over the leaves, ``grad_worst`` and
  ``grad_dist_worst`` their largest;
- the same of each leaf's change after the steps (``change_*``), over
  the leaves whose raw first gradient in the reference is at least a
  thousandth of the median leaf's (the others move by round-off);
- ``head_dist``: where the codec gives back the gradient before it, the
  norm of the difference of the head leaves' first gradient over its
  norm. Gradients that pass back through a ReLU or a max-pool take
  another route wherever rounding moves an input across the kink, at a
  rate that grows with the rounding, so their distance grows with its
  square root; the head's gradient is a smooth function of the forward,
  and its distance grows with the rounding itself.

The cell's limits file (``limits/<workload>.json``) names the numbers
it holds and the limit of each; the others are reported beside them.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import torch

from portbench.harness import program
from portbench.reference import precision as prec

NUMBERS = ("loss_gap", "loss_first", "grad_gap", "grad_dist", "grad_worst",
           "grad_dist_worst", "change_gap", "change_dist", "change_worst",
           "change_dist_worst", "head_dist")
#: a leaf whose reference gradient is below this share of the median
#: leaf's is left out of the change
STILL = 1e-3
#: the steps compared; every limit in ``limits/`` was read at this many
FIRST_STEPS = 3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    vals = torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors.values()]).tolist()
    return dict(zip(tensors, vals))


def reference(cell, seed: int, device, order, precision: str = "fp32"
              ) -> dict:
    """The reference's readings of the first steps, in float32 with TF32
    off (``precision="fp32"``) or with its products' operands rounded to
    ``precision`` (a control)."""
    with prec.highest():
        return _reference(cell, seed, device, order, precision)


def _reference(cell, seed: int, device, order, precision: str) -> dict:
    fam, mix = cell.family, cell.mix
    w = program.weights(cell, seed, device)
    w = {k: w[k] for k in order}
    start = {k: t.clone() for k, t in w.items()}
    pool = program.batches(cell, seed, device)
    codec = cell.ref_codec.Reference(mix["codec_args"], mix["bucket_mb"],
                                     program.codec_seed(seed), device)
    opt = cell.ref_optimizer.Reference(w, mix["hyper"])
    losses, raw, grads, head = [], None, None, None
    for j in range(FIRST_STEPS):
        loss, g = fam.reference_loss_and_grads(cell.cfg, w, pool[j],
                                               precision)
        g = {k: g[k] for k in order}
        agg = codec.aggregate(g)
        if j == 0:
            raw, grads = _norms(g), agg
            head = {k: g[k] for k in fam.HEAD}
        opt.step(w, agg)
        losses.append(float(loss))
        del g, agg
    change = {k: w[k] - start[k] for k in order}
    return {"losses": losses, "grads": grads, "change": change,
            "raw_norms": raw, "head": head}


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               keys) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Each leaf's gap of norms and distance, each over the larger of the
    reference's norm of that leaf and of the median leaf."""
    dev = next(iter(want.values())).device
    ref = torch.stack([torch.linalg.vector_norm(want[k].float())
                       for k in keys])
    mine = torch.stack([torch.linalg.vector_norm(got[k].float())
                        for k in keys]).to(dev)
    dist = torch.stack([torch.linalg.vector_norm(
        got[k].to(dev).float() - want[k].float()) for k in keys])
    scale = torch.clamp(torch.maximum(ref, ref.median()), min=1e-30)
    gap = torch.where(torch.isfinite(mine), (mine - ref).abs() / scale,
                      torch.full_like(ref, math.inf))
    dist = torch.where(torch.isfinite(dist), dist / scale,
                       torch.full_like(ref, math.inf))
    return dict(zip(keys, gap.tolist())), dict(zip(keys, dist.tolist()))


def _median_leaf(gaps: Dict[str, float]) -> Tuple[float, str]:
    order = sorted(gaps, key=gaps.get)
    return statistics.median(gaps.values()), order[(len(order) - 1) // 2]


def gaps(got: dict, want: dict) -> Dict[str, dict]:
    """Every number the comparison can hold to a limit, each with the step
    or leaf where it is read: ``loss_gap`` (``loss_first`` of the first
    step alone); of the first gradient, the median leaf's gap of norms
    (``grad_gap``) and distance (``grad_dist``), and the worst leaf's
    (``grad_worst``, ``grad_dist_worst``); the same of the change
    (``change_*``); and where the codec gives back the gradient before it,
    ``head_dist``, the distance of the head leaves' first gradient over
    its norm."""
    loss = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(got["losses"], want["losses"])]
    keys = list(want["grads"])
    med = statistics.median(want["raw_norms"].values())
    moving = [k for k in keys if want["raw_norms"][k] >= STILL * med]
    out = {"loss_gap": {"value": max(loss),
                        "at": f"step {loss.index(max(loss)) + 1}"},
           "loss_first": {"value": loss[0], "at": "step 1"}}
    for name, leaves in (("grad", keys), ("change", moving)):
        gap, dist = _leaf_gaps(got[name if name == "change" else "grads"],
                               want[name if name == "change" else "grads"],
                               leaves)
        for kind, g in (("gap", gap), ("dist", dist)):
            value, at = _median_leaf(g)
            out[f"{name}_{kind}"] = {"value": value, "at": f"median {at}"}
            worst = max(g, key=g.get)
            tag = "worst" if kind == "gap" else "dist_worst"
            out[f"{name}_{tag}"] = {"value": g[worst], "at": worst}
    if got.get("head") is not None:
        dev = next(iter(want["head"].values())).device
        diff = torch.cat([(got["head"][k].to(dev) - want["head"][k]).reshape(-1)
                          for k in want["head"]])
        ref = torch.cat([want["head"][k].reshape(-1) for k in want["head"]])
        out["head_dist"] = {"value": float(torch.linalg.vector_norm(diff)
                                           / torch.linalg.vector_norm(ref)),
                            "at": "+".join(want["head"])}
    return out


def verdict(found: Dict[str, dict], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, compared)``: every number the cell holds to a limit at
    or under it."""
    compared = {k: {"value": found[k]["value"], "limit": v}
                for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared

"""One run of one cell: set-up, the first steps that the reference
checks, the timed window, with ``trace`` the traced stretches, then the
reference and the result line."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from portbench.harness import judge, trace, window
from portbench.harness.program import Program, launch_counts

#: steps after the compared ones and before the window
WARM_STEPS = 2
#: steps of the profiled stretch and of the instrument=True stretch
TRACE_STEPS = 5
STAGED_STEPS = 5
GIB = 2**30


def build_kernels(device: torch.device) -> None:
    """Every CUDA source of the port built at once (one nvcc each), so
    the first run of a checkout compiles in set-up; later runs find the
    libraries built."""
    if device.type == "cuda":
        from pytorch_ps_mpi_tpu_torch.ops import _build

        _build.build(*_build.SOURCES)


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def staged(prog, steps: int) -> dict:
    """``steps`` steps with ``instrument=True``, and whether the first
    launched the same kernels as the plain step before it."""
    before = launch_counts()
    prog.step()
    plain = _delta(launch_counts(), before)
    prog.opt.instrument = True
    try:
        before = launch_counts()
        data = [prog.step()[1]]
        stage = _delta(launch_counts(), before)
        data += [prog.step()[1] for _ in range(steps - 1)]
    finally:
        prog.opt.instrument = False
    return {"data": data, "units_match": plain == stage,
            "launches": {"plain": plain, "staged": stage}}


def end_to_end(cell, plain: dict, setup_s: float, peak: int) -> dict:
    values = {
        "train_samples_per_s": plain["steps"] * cell.family.samples(cell.mix)
        / plain["wall_s"],
        "step_ms_p95": window.p95(plain["intervals_ms"]),
        "peak_mem_gib": peak / GIB,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        card: str = "") -> dict:
    """The result line's object (``compared`` last), and under ``notes``
    the lines for standard error."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    notes: List[str] = []
    parts = {"imports": time.perf_counter() - t0}
    build_kernels(device)
    parts["kernels"] = time.perf_counter() - t0 - sum(parts.values())
    prog = Program(cell, seed, device)
    parts.update(prog.times)
    mine = prog.first_steps(seed, judge.FIRST_STEPS)
    for _ in range(WARM_STEPS):
        prog.step()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    parts["first_and_warm_steps"] = setup_s - sum(parts.values())
    notes.append("setup_s by part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    plain = window.run(prog, seconds)
    tr = stage = None
    if traced:
        one = trace.spanned_step(prog)
        if cuda:
            tr = trace.profiled(lambda: [one() for _ in range(TRACE_STEPS)])
            tr["steps"] = TRACE_STEPS
        stage = staged(prog, STAGED_STEPS)
        notes.append(f"launches a step: plain {stage['launches']['plain']}, "
                     f"instrument=True {stage['launches']['staged']}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    shapes = dict(prog.shapes)
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = judge.reference(cell, seed, device, list(shapes))
    found = judge.gaps(mine, ref)
    ok, compared = judge.verdict(found, cell.limits)
    if traced:
        ctx = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, family=cell.family,
                              shapes=shapes, plain=plain, trace=tr,
                              staged=stage, device=device)
        metrics = per_layer(cell, ctx)
    else:
        metrics = end_to_end(cell, plain, setup_s, peak)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": ok and plain["failed"] == 0,
           "attempted": plain["steps"], "failed": plain["failed"],
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = trace.breakdown(tr)
    out["first_steps"] = {"program": mine["losses"], "reference":
                          ref["losses"]}
    notes.append(f"setup_s {setup_s:.3f}, window {plain['steps']} steps in "
                 f"{plain['wall_s']:.3f} s, peak {peak / GIB:.3f} GiB")
    for name, v in found.items():
        if name not in compared:
            notes.append(f"{name} {v['value']!r} (at {v['at']}; not held "
                         f"to a limit)")
    for name, c in compared.items():
        notes.append(f"{name} {c['value']!r} limit {c['limit']!r} "
                     f"(at {found[name]['at']})")
    out["card"] = card
    out["compared"] = compared
    out["notes"] = notes
    return out

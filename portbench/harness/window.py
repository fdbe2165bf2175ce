"""The timed window: steps back to back for a fixed time.

After each ``step`` returns, a CUDA event is recorded on the current
stream; the window ends with the first step that returns after
``seconds``, and a ``torch.cuda.synchronize()``. A step interval is the
time between consecutive step-end events (the first from an event
recorded as the window opens). Off the card (the CPU tests) the host's
clock stands in for the events.

Python's collector is off over the window, with the heap of set-up
frozen before it: on the H100's host one full collection of that heap
took 122-147 ms, a whole step of the EF-top-k cell, at a point of the
window that moved from run to run.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import List

import torch


def p95(values: List[float]) -> float:
    """The 95th percentile, interpolated between the order statistics
    (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(prog, seconds: float) -> dict:
    """``steps``, ``wall_s``, every step interval (ms), every step's
    ``step_time`` (s), and ``failed``: steps whose loss is not finite."""
    cuda = prog.device.type == "cuda"
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _steps(prog, seconds, cuda)
    finally:
        gc.enable()
        gc.unfreeze()


def _steps(prog, seconds: float, cuda: bool) -> dict:
    _sync(prog.device)
    marks: list = []
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[0].record()
    t0 = time.perf_counter()
    if not cuda:
        marks.append(t0)
    losses, step_time = [], []
    while True:
        loss, data = prog.step()
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        losses.append(loss.detach())
        step_time.append(data["step_time"])
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(prog.device)
    wall = time.perf_counter() - t0
    if cuda:
        intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        intervals = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    failed = sum(not math.isfinite(v)
                 for v in torch.stack(losses).float().tolist())
    return {"steps": len(losses), "wall_s": wall, "intervals_ms": intervals,
            "step_time_s": step_time, "failed": failed}

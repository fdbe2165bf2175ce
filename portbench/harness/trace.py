"""The profiled stretch of a traced run, and what the trace gives: the
device's rows, busy time, idle share and the breakdown.

The trace opens with ``LEAD`` spin kernels, there to be dropped: late in
a long process the profiler on an H100 has dropped the first device
rows of a trace (the port's ``utils.tracing.profiled_rows`` guards
against it). A take is whole when some of the spins' rows are still in
it, so the rows lost, if any, were spins; a take that lost them all is
taken again. (Counting device rows against launch calls, as the port's
guard does, fails at small shapes, where some launch calls of cuDNN
leave no row: a cut-down ResNet's takes all came up short.)
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple

import torch

LEAD = 256
SPIN = "spin_kernel"
TAKES = 3
#: the benchmark's own spans
WINDOW, STEP, LOSS_FN = "bench.window", "bench.step", "bench.loss_fn"
TOP = 10


class ShortTrace(RuntimeError):
    """Every take lost device rows."""


def spanned_step(prog) -> Callable[[], None]:
    """One step of ``prog`` inside the benchmark's spans: the step, and
    the loss function inside it."""
    from torch.profiler import record_function

    def loss_fn(params, batch):
        with record_function(LOSS_FN):
            return prog.loss_fn(params, batch)

    def one():
        with record_function(STEP):
            prog.step(loss_fn=loss_fn)
    return one


def _annotation(e) -> bool:
    """A device row that is no device work: the lead spins, and the
    benchmark's spans mirrored onto the device's timeline."""
    return (SPIN in e.name or e.name.startswith("bench.")
            or getattr(e, "is_user_annotation", False))


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _take(thunk: Callable[[], None]):
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        for _ in range(LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            thunk()
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    return prof.events()


def profiled(thunk: Callable[[], None]) -> dict:
    """Run ``thunk`` under the profiler until a take is whole. Returns
    the device rows ``(name, start_us, end_us)`` inside the window span,
    the host's spans, the window's bounds, ``busy_s`` (the union of the
    rows), ``window_s`` and ``takes``."""
    cuda = torch.autograd.DeviceType.CUDA
    for take in range(1, TAKES + 1):
        events = _take(thunk)
        host = [e for e in events if e.device_type != cuda]
        win = [e for e in host if e.name == WINDOW]
        device = [e for e in events if e.device_type == cuda]
        rows = [(e.name, e.time_range.start, e.time_range.end)
                for e in device if not _annotation(e)]
        if win and rows and any(SPIN in e.name for e in device):
            break
    else:
        raise ShortTrace(f"{TAKES} profiler takes lost device rows")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    rows = [(n, max(s, w0), min(e, w1)) for n, s, e in rows
            if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in rows])
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in host
             if w0 <= e.time_range.start <= w1]
    return {"rows": rows, "spans": spans, "window": (w0, w1),
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6, "takes": take, "busy": busy}


def kernel_seconds(rows, *needles: str) -> Tuple[float, Dict[str, int]]:
    """Summed seconds of the rows whose name holds any of ``needles``,
    and the count of rows by needle."""
    total, counts = 0.0, collections.Counter()
    for name, s, e in rows:
        hit = [n for n in needles if n in name]
        if hit:
            total += (e - s) / 1e6
            counts[hit[0]] += 1
    return total, counts


def _label(spans, t: float) -> str:
    """What the host was doing at ``t``: the innermost benchmark span and
    the innermost other host operation around it."""
    around = [(e - s, n) for n, s, e in spans if s <= t <= e
              and n != WINDOW]
    ours = sorted(x for x in around if x[1].startswith("bench."))
    theirs = sorted(x for x in around if not x[1].startswith("bench."))
    parts = [ours[0][1] if ours else "outside a step"]
    if theirs:
        parts.append(theirs[0][1][:80])
    return " > ".join(parts)


def breakdown(tr: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps inside the window by what the host was doing, ``TOP`` each."""
    by_name: collections.Counter = collections.Counter()
    for name, s, e in tr["rows"]:
        by_name[name[:100]] += (e - s) / 1e6
    w0, w1 = tr["window"]
    edges = [w0] + [x for iv in tr["busy"] for x in iv] + [w1]
    gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(reverse=True)
    return {"device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[_label(tr["spans"], (a + b) / 2), d / 1e6]
                          for d, a, b in gaps[:TOP]]}

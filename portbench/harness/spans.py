"""The program's stage spans in the profiled stretch of a traced run, and
what the card and the host did under them.

``MPI_PS.step`` puts its stages in ``record_function`` ranges when the
profiler is on (the port's ``utils.tracing.STEP_SPANS``), so they lie in
the stretch's host events (``trace.profiled``'s ``spans``) on the clock
of its device rows, beside the runtime calls. A step is split into
:data:`STAGES`, in that order; a moment under two of their ranges counts
to the first, and a moment under none to ``entry`` (the step's glue,
``ps.wait`` and the time between steps). Time goes to a stage by the
host's clock, whatever the thread: backward runs on autograd's device
thread while the main thread sits in ``ps.grad``, so its launch calls
count to ``grad``. Every number is a mean a profiled step; a stretch
with no ``ps.*`` range gives None (a program without the spans).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from portbench.harness.trace import _union

#: the program's span names and launch calls, frozen (the port's
#: ``utils.tracing.STEP_SPANS`` and ``LAUNCH_CALLS``)
STEP_SPANS = ("ps.step", "ps.grad", "ps.aggregate", "ps.update",
              "ps.numerics", "ps.wait")
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                "cudaMemcpy", "cuMemcpy")
#: a step's stages and their spans, in the order overlaps are given
STAGES = {"grad": "ps.grad", "codec": "ps.aggregate", "update": "ps.update"}
ENTRY = "entry"

Intervals = List[Tuple[float, float]]


def spans(tr) -> list:
    """The host events ``(name, start_us, end_us)`` that start in the
    window: the program's ``ps.*`` ranges and the runtime calls among
    them."""
    return tr["spans"]


def busy(tr) -> Intervals:
    """The union of the device rows, inside the window."""
    return tr["busy"]


def window(tr) -> Tuple[float, float]:
    return tr["window"]


def steps(tr) -> int:
    return tr["steps"]


def _minus(a: Intervals, b: Intervals) -> Intervals:
    """``a`` less ``b``, both sorted and disjoint."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def _length(iv: Intervals) -> float:
    return sum(e - s for s, e in iv)


def regions(tr) -> Optional[Dict[str, Intervals]]:
    """Each stage's part of the window, and ``entry`` the rest: disjoint,
    together the window. None without a trace or a ``ps.*`` range."""
    if not tr or not any(n in STEP_SPANS for n, _, _ in spans(tr)):
        return None
    w0, w1 = window(tr)
    taken: Intervals = []
    out: Dict[str, Intervals] = {}
    for stage, name in STAGES.items():
        mine = _union([(max(s, w0), min(e, w1)) for n, s, e in spans(tr)
                       if n == name and e > w0 and s < w1])
        out[stage] = _minus(mine, taken)
        taken = _union(taken + mine)
    out[ENTRY] = _minus([(w0, w1)], taken)
    return out


def idle_ms(tr, stage: str) -> Optional[float]:
    """Device idle (the window less :func:`busy`) inside ``stage``'s part
    of the window, in ms a step."""
    parts = regions(tr)
    if parts is None:
        return None
    return _length(_minus(parts[stage], busy(tr))) / 1e3 / steps(tr)


def launch_calls(tr, stage: str) -> Optional[float]:
    """Runtime calls that put a row on the device (:data:`LAUNCH_CALLS`)
    starting inside ``stage``'s part of the window, a step."""
    parts = regions(tr)
    if parts is None:
        return None
    iv = parts[stage]
    starts = [s for s, _ in iv]
    n = 0
    for name, s, _ in spans(tr):
        if name.startswith(LAUNCH_CALLS):
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s < iv[i][1]
    return n / steps(tr)

"""Profiler integration (``pytorch_ps_mpi_tpu/utils/tracing.py``) on
``torch.profiler``: the layer under the per-step metrics dicts that sees
what host clocks cannot, the kernels a step puts on the card.

- :func:`trace` writes a Chrome trace of a region (``export_chrome_trace``)
  into a directory; :func:`annotate` names a region in it
  (``record_function``) and in the flight recorder. It is the one span
  helper of ``MPI_PS.step``, whose stages are :data:`STEP_SPANS`; with
  neither the profiler nor a recorder on, a span costs two checks.
- :func:`profiled_device_split` runs a thunk under the profiler and splits
  the card's time into communication (NCCL kernels) and compute, with the
  top kernels by time; it backs ``MPI_PS.step(profile=True)``.
- :func:`profiled_overlap` measures how much of the communication ran
  concurrently with compute.
- :func:`profiled_rows` is the guard every trace of the card here goes
  through. Late in a long process the profiler on an H100 has dropped the
  first device rows of a trace while it still recorded every runtime
  launch call, which leaves a short trace empty or partial. So a trace
  opens with :data:`LEAD` spin kernels, there to be dropped, and is whole
  only when its other device rows number at least the launch calls made
  after them; a short trace is taken again, :data:`TAKES` times in all,
  and then the call fails. A short split is never returned.

Off the card there are no device rows: the split is zeros with
``devices=0`` (the JAX package's answer for a backend without device
events), and nothing is retaken.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from pytorch_ps_mpi_tpu_torch.telemetry.recorder import get_recorder

#: spin kernels that open a trace of the card, there to be dropped
LEAD = 256
#: runtime calls that put one row on the device
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                "cudaMemcpy", "cuMemcpy")
#: traces taken before a short one fails the call
TAKES = 5
#: the spans of one ``MPI_PS.step``: the whole call; forward, backward
#: and the loss's reduce; every encode, the exchange and the decode-sum;
#: average, clip, the optimizer and taking the new parameters; the
#: on-device statistics (``numerics=True``); the host waiting for the
#: card at the step's end
STEP_SPANS = ("ps.step", "ps.grad", "ps.aggregate", "ps.update",
              "ps.numerics", "ps.wait")

# kernel names that are interconnect work: NCCL's kernels, and the JAX
# package's collective names for traces of other origin
_COMM_SUBSTRINGS = (
    "nccl", "psum", "all-reduce", "allreduce", "all-gather", "allgather",
    "reduce-scatter", "reducescatter", "collective", "ppermute",
    "all-to-all", "alltoall",
)


class ShortTraceError(RuntimeError):
    """Every take of a trace of the card lost device rows."""


def _is_comm(name: str) -> bool:
    low = name.lower()
    return any(s in low for s in _COMM_SUBSTRINGS)


def on_card(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a Chrome trace of the region (host operators, and the
    card's kernels where there is a card) into ``log_dir``, viewable in
    Perfetto. On the card the trace opens with the :data:`LEAD` spin
    kernels (a region cannot be taken again; :func:`_device_rows` leaves
    them out):

    >>> with trace('/tmp/torch-trace'):
    ...     opt.step(loss_fn=loss_fn, batch=batch)
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    if torch.cuda.is_available():
        for _ in range(LEAD):
            torch.cuda._sleep(1)
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


_OFF = contextlib.nullcontext()


def annotate(name: str, step: Optional[int] = None, record: bool = True):
    """Named region (a context manager): a ``record_function`` range when
    the profiler is on, so it lies in the profiler's trace on the device
    rows' clock; a span of the installed flight recorder, carrying
    ``step``, unless ``record`` is false. With neither on it is a shared
    null context, the cost of the two checks."""
    rec = get_recorder() if record else None
    if rec is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _span(name, step, rec)


@contextlib.contextmanager
def _span(name: str, step: Optional[int], rec) -> Iterator[None]:
    with contextlib.ExitStack() as stack:
        if torch.autograd._profiler_enabled():
            stack.enter_context(torch.profiler.record_function(name))
        if rec is not None:
            stack.enter_context(rec.span(name, step=step))
        yield


def open_trace(device=None):
    """Start a profiler on the card and put the :data:`LEAD` spin kernels
    first; returns the entered profile (close it with ``__exit__``)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    for _ in range(LEAD):
        torch.cuda._sleep(1)
    torch.cuda.synchronize(device)
    return prof


def trace_rows(prof) -> Tuple[list, int]:
    """``(rows, launched)`` of a closed :func:`open_trace` profile: the
    device rows other than the spin kernels, in start order, and the
    launch calls made after the spins."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    rows = sorted((e for e in events if e.device_type == cuda
                   and "spin_kernel" not in e.name),
                  key=lambda e: e.time_range.start)
    launched = sum(e.name.startswith(LAUNCH_CALLS)
                   for e in events if e.device_type != cuda) - LEAD
    return rows, launched


def profiled_rows(thunk: Callable[[], Any], *, device=None,
                  reset: Optional[Callable] = None,
                  before: Optional[Callable] = None, exact: bool = False,
                  agree: Optional[Callable[[bool], bool]] = None):
    """Run ``thunk()`` under the profiler on the card until a take is
    whole: ``(thunk result, rows, launched)``. ``reset()`` runs before
    every retake (a step restores the state the short take advanced),
    ``before()`` before every take, outside the trace (an L2 flush);
    ``exact``: whole means as many rows as launches, else at least as
    many; ``agree(whole)`` gives every rank's verdict where the thunk
    runs collectives, so that all ranks retake together or none does.
    Raises :class:`ShortTraceError` after :data:`TAKES` short takes."""
    rows, launched = [], 0
    for i in range(TAKES):
        if i and reset is not None:
            reset()
        if before is not None:
            before()
        torch.cuda.synchronize(device)
        prof = open_trace(device)
        try:
            out = thunk()
            torch.cuda.synchronize(device)
        finally:
            prof.__exit__(None, None, None)
        rows, launched = trace_rows(prof)
        whole = bool(rows) and (len(rows) == launched if exact
                                else len(rows) >= launched)
        if agree is not None:
            whole = agree(whole)
        if whole:
            return out, rows, launched
    raise ShortTraceError(f"{TAKES} profiler traces lost device rows: "
                          f"{len(rows)} of {launched} launched")


def _row_tuples(rows) -> List[Tuple[Any, str, float, float]]:
    """``(device, name, start_ns, dur_ns)`` of profiler device rows."""
    return [(e.device_index, e.name, e.time_range.start * 1e3,
             (e.time_range.end - e.time_range.start) * 1e3) for e in rows]


def _empty_split() -> Dict[str, Any]:
    return {"devices": 0, "device_busy_s": 0.0, "comm_s": 0.0,
            "compute_s": 0.0, "top_ops": []}


def device_split(events) -> Dict[str, Any]:
    """Per-device mean seconds of ``(device, name, start_ns, dur_ns)``
    rows: ``device_busy_s`` (the rows' summed time), ``comm_s`` (NCCL and
    other collective kernels), ``compute_s`` (the rest), ``devices`` and
    ``top_ops``, every kernel name as ``(name, seconds)`` by time, most
    first (the JAX package's list stops at eight; a step's hand kernels
    are fewer than its library kernels, so the port keeps them all)."""
    per_dev: Dict[Any, list] = collections.defaultdict(lambda: [0.0, 0.0])
    top: collections.Counter = collections.Counter()
    for dev, name, _start, dur in events:
        per_dev[dev][1] += dur
        top[name] += dur
        if _is_comm(name):
            per_dev[dev][0] += dur
    ndev = len(per_dev)
    if not ndev:
        return _empty_split()
    scale = 1e9 * ndev
    comm = sum(v[0] for v in per_dev.values()) / scale
    busy = sum(v[1] for v in per_dev.values()) / scale
    return {"devices": ndev, "device_busy_s": busy, "comm_s": comm,
            "compute_s": busy - comm,
            "top_ops": [(name, ns / 1e9) for name, ns in top.most_common()]}


def profiled_device_split(thunk: Callable[[], Any], *, device=None,
                          reset: Optional[Callable] = None,
                          agree: Optional[Callable[[bool], bool]] = None
                          ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``thunk()`` under the profiler and split the card's kernel time
    into communication and compute: ``(thunk result, split)`` with
    per-device mean seconds ``device_busy_s``, ``comm_s``, ``compute_s``,
    plus ``devices`` and ``top_ops`` (the JAX package's keys), and on the
    card ``device_rows``, ``memcpy_dtoh`` (the device-to-host copies
    among them) and ``takes`` (the times the thunk ran). On the card the
    trace goes through :func:`profiled_rows`' guard (``reset`` before a
    retake, ``agree`` across ranks) and a short one raises; off the card
    the thunk runs once and the split is zeros with ``devices=0``."""
    if not on_card(device):
        return thunk(), _empty_split()
    takes = 0

    def take():
        nonlocal takes
        takes += 1
        return thunk()

    out, rows, _ = profiled_rows(take, device=device, reset=reset,
                                 agree=agree)
    split = device_split(_row_tuples(rows))
    split["takes"] = takes
    split["device_rows"] = len(rows)
    split["memcpy_dtoh"] = sum(1 for e in rows
                               if "memcpy dtoh" in e.name.lower())
    return out, split


def _interval_union(intervals):
    """Merge [start, end) intervals; returns disjoint sorted list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _interval_intersection_len(a, b):
    """Total length of the intersection of two disjoint sorted interval
    lists (outputs of :func:`_interval_union`)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_split(events) -> Dict[str, Any]:
    """Per-device mean seconds of how communication rows overlapped
    compute rows: ``comm_s``/``compute_s`` (union lengths), ``overlap_s``
    (their intersection), ``overlap_frac`` (overlap over comm),
    ``busy_union_s`` and ``serial_equiv_s`` (comm + compute)."""
    comm_iv: Dict[Any, list] = collections.defaultdict(list)
    comp_iv: Dict[Any, list] = collections.defaultdict(list)
    for dev, name, start, dur in events:
        (comm_iv if _is_comm(name) else comp_iv)[dev].append(
            (start, start + dur))
    devs = sorted(set(comm_iv) | set(comp_iv), key=str)
    n = len(devs)
    if not n:
        return {"devices": 0, "comm_s": 0.0, "compute_s": 0.0,
                "overlap_s": 0.0, "overlap_frac": 0.0,
                "busy_union_s": 0.0, "serial_equiv_s": 0.0}
    comm = compute = overlap = busy = 0.0
    for dev in devs:
        cu = _interval_union(comm_iv.get(dev, []))
        pu = _interval_union(comp_iv.get(dev, []))
        comm += sum(e - s for s, e in cu)
        compute += sum(e - s for s, e in pu)
        overlap += _interval_intersection_len(cu, pu)
        busy += sum(e - s for s, e in _interval_union(
            list(comm_iv.get(dev, [])) + list(comp_iv.get(dev, []))))
    scale = 1e9 * n
    comm_s, compute_s = comm / scale, compute / scale
    overlap_s = overlap / scale
    return {"devices": n, "comm_s": comm_s, "compute_s": compute_s,
            "overlap_s": overlap_s,
            "overlap_frac": overlap_s / comm_s if comm_s > 0 else 0.0,
            "busy_union_s": busy / scale,
            "serial_equiv_s": comm_s + compute_s}


def profiled_overlap(thunk: Callable[[], Any]
                     ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``thunk()`` under the profiler and measure how much of the
    communication time ran concurrently with compute on the card
    (:func:`overlap_split`); the same guard as
    :func:`profiled_device_split` (a short trace runs the thunk again,
    so it must be one that can run twice), and zeros off the card."""
    if not on_card(None):
        return thunk(), overlap_split([])
    out, rows, _ = profiled_rows(thunk)
    return out, overlap_split(_row_tuples(rows))


def _trace_files(trace_path: str) -> Iterator[List[dict]]:
    """The event list of each Chrome trace ``torch.profiler`` wrote
    (``export_chrome_trace``): ``trace_path`` is the file, or a directory
    whose ``*.json`` files are read."""
    paths = ([trace_path] if os.path.isfile(trace_path) else sorted(
        glob.glob(os.path.join(trace_path, "**", "*.json"), recursive=True)))
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        yield doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def _device_rows(events: List[dict]):
    """``(device, name, start_ns, dur_ns)`` of every kernel, memcpy and
    memset row of one trace's events, the spin kernels left out."""
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset") or \
                "spin_kernel" in str(e.get("name")):
            continue
        dur = float(e.get("dur", 0.0))
        if dur <= 0:
            continue
        dev = (e.get("args") or {}).get("device", e.get("pid"))
        yield dev, str(e.get("name")), float(e["ts"]) * 1e3, dur * 1e3


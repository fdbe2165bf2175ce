"""Merged host+device Chrome/Perfetto trace export.

Host side: :class:`~.recorder.FlightRecorder` spans/events (from live
recorders or their JSONL dumps — several processes' files merge into one
timeline on the ``wall`` clock each record carries). Device side: the
kernel, memcpy and memset rows of the Chrome trace ``torch.profiler``
writes (``export_chrome_trace``, as :func:`~pytorch_ps_mpi_tpu_torch.
utils.tracing.trace` does), read a file at a time through
:func:`pytorch_ps_mpi_tpu_torch.utils.tracing._device_rows`.

Clock honesty: host rows are placed by their ``wall`` timestamps (one
clock across processes, NTP-grade alignment). When gradient lineage is
armed, worker-process rows are additionally shifted by the per-worker
clock offsets :func:`~.lineage.clock_offsets_from_rows` fits from the
frame (send_wall, recv_wall) timestamp pairs — see
:func:`apply_clock_offsets` — so worker and server spans line up to
~min-wire-latency accuracy even across hosts with skewed clocks. Device
ops carry the profiler's own timebase. Each profiler trace that holds
``MPI_PS.step``'s ``ps.step`` ranges is put on the wall clock by the
recorder's rows of the same steps (:func:`step_clock_offset`: the
steps matched in order, the median of their offsets), to within the
few µs between a range's start and its row's, so a kernel lands inside
the recorder's stage span that launched it. A trace without those
ranges, or whose steps the recorder does not hold, is placed relative
to the wall time at which the capture started (``device_t0_wall``,
recorded by the caller at ``start_trace``; defaults to the host
timeline's start), which is approximate at the ~ms level.

Cross-process causality: pass ``lineage_rows`` (the ``publish``/``drop``
rows of a ``lineage-*.jsonl``) and every composed push whose worker
``worker.push_grad`` span and server ``serve.consume`` span both made it
into the recorder dumps gets a Chrome **flow event** pair (``ph: "s"``
→ ``ph: "f"``, id = the push's ``worker/step/seq`` trace ID) — the
arrows Perfetto draws from the worker's push to the server's consume.

Output is standard Chrome ``traceEvents`` JSON: load it at
``ui.perfetto.dev`` or ``chrome://tracing``.
"""

from __future__ import annotations

import collections
import json
import statistics
from typing import Any, Dict, Iterable, List, Optional, Tuple

HOST_PID = 1
DEVICE_PID_BASE = 1000
#: the recorder's rows of one whole ``MPI_PS`` step
STEP_ROWS = ("ps.step", "ps.step_accumulate")


def apply_clock_offsets(
    events: Iterable[Dict[str, Any]],
    offsets: Optional[Dict[Any, float]],
) -> List[Dict[str, Any]]:
    """Shift each record's ``wall`` by its worker's estimated clock
    offset (``server_clock - worker_clock``, from
    :func:`~.lineage.clock_offsets_from_rows`), moving every worker
    process onto the server's clock. Records from workers without an
    estimate (and the server's own, which is the reference) pass
    through untouched. Returns shifted copies — inputs are not
    mutated."""
    if not offsets:
        return list(events)
    out = []
    for e in events:
        off = offsets.get(e.get("worker"))
        if off and "wall" in e:
            e = dict(e)
            e["wall"] = e["wall"] + off
        out.append(e)
    return out


def _host_events(
    events: Iterable[Dict[str, Any]], t0_wall: float
) -> Tuple[List[Dict[str, Any]], Dict[Tuple, Tuple[int, float, float]]]:
    """Returns ``(trace_events, span_index)`` where ``span_index`` maps
    a push trace ID to the (tid, ts_us, dur_us) of its worker push span
    (key ``("push", worker, step, seq)``) or server consume span
    (key ``("consume", worker, step, seq)``) — the anchors flow events
    attach to."""
    out: List[Dict[str, Any]] = []
    tids = {}
    span_index: Dict[Tuple, Tuple[int, float, float]] = {}
    for e in events:
        wall = e.get("wall")
        if wall is None:
            continue
        worker = e.get("worker", "host")
        tid = tids.setdefault(worker, len(tids) + 1)
        args = dict(e.get("attrs") or {})
        for k in ("step", "staleness", "worker"):
            if k in e:
                args[k] = e[k]
        ts_us = (wall - t0_wall) * 1e6
        if e.get("kind") == "span":
            # span rows stamp their START time (every producer passes
            # ts=t0 to FlightRecorder.event; the span() context manager
            # does so itself)
            dur_us = float(e.get("dur", 0.0)) * 1e6
            out.append({
                "ph": "X", "name": e["name"], "cat": "host",
                "pid": HOST_PID, "tid": tid,
                "ts": ts_us, "dur": dur_us,
                "args": args,
            })
            if e["name"] == "worker.push_grad" and "seq" in args:
                span_index[("push", e.get("worker"), e.get("step"),
                            args["seq"])] = (tid, ts_us, dur_us)
            elif e["name"] == "serve.consume" and "seq" in args:
                span_index[("consume", args.get("src_worker"),
                            e.get("step"), args["seq"])] = (
                    tid, ts_us, dur_us)
        else:
            out.append({
                "ph": "i", "s": "t", "name": e["name"], "cat": "host",
                "pid": HOST_PID, "tid": tid, "ts": ts_us, "args": args,
            })
    for worker, tid in tids.items():
        out.append({
            "ph": "M", "name": "thread_name", "pid": HOST_PID, "tid": tid,
            "args": {"name": f"worker {worker}"},
        })
    out.append({
        "ph": "M", "name": "process_name", "pid": HOST_PID,
        "args": {"name": "host (FlightRecorder)"},
    })
    return out, span_index


def _flow_events(
    span_index: Dict[Tuple, Tuple[int, float, float]],
    lineage_rows: Iterable[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """One ``s``→``f`` flow pair per composed push whose BOTH anchor
    spans landed in the recorder dumps (a bounded recorder may have
    evicted either side — missing anchors are skipped, never guessed).
    The flow binds to its enclosing slices by (pid, tid, ts): the start
    sits mid-push-span on the worker's track, the finish mid-consume-
    span on the server's track."""
    from pytorch_ps_mpi_tpu_torch.telemetry.lineage import trace_id

    out: List[Dict[str, Any]] = []
    for row in lineage_rows:
        pushes = list(row.get("pushes") or [])
        if "push" in row:
            pushes.append(row["push"])
        for p in pushes:
            key = (p.get("worker"), p.get("step"), p.get("seq"))
            src = span_index.get(("push",) + key)
            dst = span_index.get(("consume",) + key)
            if src is None or dst is None:
                continue
            # the ONE canonical id form — must match the lineage rows'
            # own trace strings so trace.json cross-references them
            fid = trace_id(*key)
            for ph, (tid, ts, dur), extra in (
                    ("s", src, {}), ("f", dst, {"bp": "e"})):
                out.append({
                    "ph": ph, "cat": "lineage", "name": "grad push",
                    "id": fid, "pid": HOST_PID, "tid": tid,
                    "ts": ts + dur * 0.5, **extra,
                })
    return out


def step_clock_offset(ranges: List[Tuple[float, float]],
                      host_events: Iterable[Dict[str, Any]]
                      ) -> Optional[float]:
    """Seconds that put a profiler trace's clock on the wall clock:
    ``ranges`` are the trace's ``ps.step`` ranges ``(start_us, dur_us)``,
    matched in order to as many consecutive step rows of one worker in
    ``host_events`` (:data:`STEP_ROWS`): of every such run, the one whose
    offsets and durations agree best. Returns the median of its offsets
    (``wall - start_us / 1e6``), or None where no worker has rows
    enough."""
    if not ranges:
        return None
    ranges = sorted(ranges)
    n = len(ranges)
    rows: Dict[Any, list] = collections.defaultdict(list)
    for e in host_events:
        if e.get("kind") == "span" and e.get("name") in STEP_ROWS \
                and "wall" in e:
            rows[e.get("worker")].append((e["wall"], e.get("dur", 0.0)))
    best = None
    for walls in rows.values():
        walls.sort()
        for j in range(len(walls) - n + 1):
            run = walls[j:j + n]
            offs = [w - s / 1e6 for (w, _), (s, _) in zip(run, ranges)]
            score = max(offs) - min(offs) + sum(
                abs(d - du / 1e6) for (_, d), (_, du) in zip(run, ranges)
            ) / n
            if best is None or score < best[0]:
                best = (score, statistics.median(offs))
    return None if best is None else best[1]


def _device_events(
    trace_dir: str, t0_wall: float, device_t0_wall: Optional[float],
    host_t0_wall: float, host_events: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    from pytorch_ps_mpi_tpu_torch.utils.tracing import (_device_rows,
                                                        _trace_files)

    placed: List[Tuple[Any, str, float, float]] = []  # ts in µs
    loose: List[Tuple[Any, str, float, float]] = []   # start in ns
    for events in _trace_files(trace_dir):
        rows = list(_device_rows(events))
        steps = [(float(e["ts"]), float(e.get("dur", 0.0)))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == "ps.step"]
        off = step_clock_offset(steps, host_events)
        if off is None:
            loose.extend(rows)
            continue
        base_us = (off - t0_wall) * 1e6
        placed.extend((dev, name, base_us + start / 1e3, dur)
                      for dev, name, start, dur in rows)
    if loose:
        min_ns = min(start for _, _, start, _ in loose)
        anchor = (device_t0_wall if device_t0_wall is not None
                  else host_t0_wall)
        base_us = (anchor - t0_wall) * 1e6
        placed.extend((dev, name, base_us + (start - min_ns) / 1e3, dur)
                      for dev, name, start, dur in loose)
    out: List[Dict[str, Any]] = []
    pids: Dict[Any, int] = {}
    for dev, name, ts_us, dur_ns in placed:
        pid = pids.setdefault(dev, DEVICE_PID_BASE + len(pids))
        out.append({
            "ph": "X", "name": name, "cat": "device",
            "pid": pid, "tid": 1, "ts": ts_us, "dur": dur_ns / 1e3,
        })
    for dev, pid in pids.items():
        out.append({
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": f"device {dev} (torch.profiler)"},
        })
    return out


def merged_trace_events(
    host_events: Iterable[Dict[str, Any]],
    device_trace_dir: Optional[str] = None,
    device_t0_wall: Optional[float] = None,
    lineage_rows: Optional[Iterable[Dict[str, Any]]] = None,
    clock_offsets: Optional[Dict[Any, float]] = None,
    freshness_rows: Optional[Iterable[Dict[str, Any]]] = None,
    hop_rows: Optional[Iterable[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """FlightRecorder records (+ an optional torch.profiler Chrome trace,
    a file or a directory of them, each put on the wall clock by its
    ``ps.step`` ranges where the records hold those steps) → Chrome
    ``traceEvents`` list, all timestamps relative to the earliest host
    record. ``clock_offsets`` (per-worker, from lineage) are applied to
    worker records first; ``lineage_rows`` add cross-process flow
    events linking push spans to consume spans; ``freshness_rows``
    (delivery rows from ``freshness-*.jsonl``) add read-path flow
    arrows from the root publish through each follower hop to the edge
    reader, joined to write-path lineage when both are given;
    ``hop_rows`` (``hop_round`` rows from ``hop-*.jsonl``) add one
    track per tree leader with the hop's sub-stage spans, whose fold
    spans the composed pushes' lineage arrows thread through (flow
    STEP events, joined by the leaders' lineage hop rows)."""
    host_events = apply_clock_offsets(host_events, clock_offsets)
    walls = [e["wall"] for e in host_events if "wall" in e]
    t0_wall = min(walls) if walls else (device_t0_wall or 0.0)
    out, span_index = _host_events(host_events, t0_wall)
    if lineage_rows is not None:
        lineage_rows = list(lineage_rows)
        out.extend(_flow_events(span_index, lineage_rows))
    if freshness_rows is not None:
        from pytorch_ps_mpi_tpu_torch.telemetry.freshness import (
            freshness_flow_events,
        )

        out.extend(freshness_flow_events(
            freshness_rows, lineage_rows, t0_wall=t0_wall
        ))
    if hop_rows is not None:
        from pytorch_ps_mpi_tpu_torch.telemetry.hop_anatomy import (
            hop_trace_events,
        )

        out.extend(hop_trace_events(
            hop_rows, lineage_rows, t0_wall=t0_wall
        ))
    if device_trace_dir is not None:
        out.extend(_device_events(
            device_trace_dir, t0_wall, device_t0_wall, t0_wall, host_events
        ))
    return out


def export_chrome_trace(
    path: str,
    host_events: Iterable[Dict[str, Any]],
    device_trace_dir: Optional[str] = None,
    device_t0_wall: Optional[float] = None,
    lineage_rows: Optional[Iterable[Dict[str, Any]]] = None,
    clock_offsets: Optional[Dict[Any, float]] = None,
    freshness_rows: Optional[Iterable[Dict[str, Any]]] = None,
    hop_rows: Optional[Iterable[Dict[str, Any]]] = None,
) -> Tuple[str, Dict[str, int]]:
    """Write the merged timeline to ``path``; returns ``(path, {"host":
    n, "device": m, "flow": k, "fresh_flow": j, "hop": h})`` so callers
    can assert every side actually landed in the artifact (``flow``
    counts the lineage flow START events — each is half of one
    cross-process arrow; ``fresh_flow`` the read-path publish→edge flow
    starts; ``hop`` the leader-track sub-stage spans)."""
    events = merged_trace_events(
        host_events, device_trace_dir, device_t0_wall,
        lineage_rows=lineage_rows, clock_offsets=clock_offsets,
        freshness_rows=freshness_rows, hop_rows=hop_rows,
    )
    counts = {
        "host": sum(1 for e in events
                    if e.get("cat") == "host" and e["ph"] != "M"),
        "device": sum(1 for e in events
                      if e.get("cat") == "device" and e["ph"] != "M"),
        "flow": sum(1 for e in events if e.get("ph") == "s"
                    and e.get("cat") != "freshness"),
        "fresh_flow": sum(1 for e in events if e.get("ph") == "s"
                          and e.get("cat") == "freshness"),
        "hop": sum(1 for e in events
                   if e.get("cat") == "hop" and e["ph"] == "X"),
    }
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path, counts

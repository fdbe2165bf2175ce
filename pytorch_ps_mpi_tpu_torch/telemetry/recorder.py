"""FlightRecorder: bounded, thread-safe structured event/span log.

Every record is one flat dict (the JSONL row):

``name``       event/span name (``"ps.step"``, ``"worker.push_grad"``)
``kind``       ``"span"`` (has ``dur``) or ``"event"`` (a point)
``ts``         seconds, ``time.monotonic()`` — ordering/duration truth
               within one process
``wall``       seconds, ``time.time()`` — the cross-process alignment
               hint (monotonic epochs differ between processes)
``dur``        span duration in seconds (spans only)
``worker``     worker id (recorder default, overridable per record)
``step``       training/serve step the record belongs to
``staleness``  gradient staleness, when the record is about one gradient
``attrs``      everything else (free-form, JSON-serializable)

The buffer is a ``deque(maxlen=capacity)``: recording never blocks on
I/O and never grows without bound — old records are evicted and counted
in ``dropped`` (surfaced in the JSONL header row so a truncated recording
is never mistaken for a complete one).

A process-global recorder is installed with :func:`configure`; call
sites guard on :func:`get_recorder` returning ``None`` — the disabled
cost is one module attribute read, which is what lets the recorder ride
inside every training mode unconditionally.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

_HEADER_KIND = "recorder_meta"


class FlightRecorder:
    """Bounded thread-safe event/span log with JSONL export."""

    def __init__(self, capacity: int = 65536,
                 worker: Optional[Any] = None) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.worker = worker
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self._t0_monotonic = time.monotonic()
        self._t0_wall = time.time()

    # -- recording --------------------------------------------------------
    def event(
        self,
        name: str,
        *,
        kind: str = "event",
        ts: Optional[float] = None,
        dur: Optional[float] = None,
        step: Optional[int] = None,
        worker: Optional[Any] = None,
        staleness: Optional[int] = None,
        **attrs: Any,
    ) -> None:
        """Append one record. ``ts`` defaults to now (monotonic); pass an
        explicit start time (also ``time.monotonic()``-based) when the
        duration was measured by the caller."""
        now_m = time.monotonic()
        rec: Dict[str, Any] = {
            "name": name,
            "kind": kind,
            "ts": now_m if ts is None else float(ts),
            # wall derived from the same instant so the two clocks in one
            # record always describe the same moment
            "wall": self._t0_wall + ((ts if ts is not None else now_m)
                                     - self._t0_monotonic),
        }
        if dur is not None:
            rec["dur"] = float(dur)
        if step is not None:
            rec["step"] = int(step)
        w = worker if worker is not None else self.worker
        if w is not None:
            rec["worker"] = w
        if staleness is not None:
            rec["staleness"] = int(staleness)
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, *, step: Optional[int] = None,
             worker: Optional[Any] = None, **attrs: Any) -> Iterator[None]:
        """Context manager recording a ``kind="span"`` row on exit with
        the measured duration (exceptions still record the span)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.event(name, kind="span", ts=t0,
                       dur=time.monotonic() - t0, step=step, worker=worker,
                       **attrs)

    # -- reading ----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- JSONL ------------------------------------------------------------
    def dump_jsonl(self, path: str) -> str:
        """Write the buffer to ``path`` as JSONL: one meta header row
        (kind ``recorder_meta`` — capacity, dropped count, clock epochs)
        then one row per record. Returns ``path``."""
        rows = self.events()
        header = {
            "kind": _HEADER_KIND,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "n_events": len(rows),
            "worker": self.worker,
            "t0_monotonic": self._t0_monotonic,
            "t0_wall": self._t0_wall,
        }
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for rec in rows:
                f.write(json.dumps(rec, default=_json_default) + "\n")
        return path


def _json_default(obj: Any) -> Any:
    """Last-resort serializer: numpy scalars/arrays and anything else a
    call site stuffed into attrs degrade to floats/strings, never crash
    the export."""
    try:
        import numpy as np

        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
    except Exception:
        pass
    return str(obj)


def load_jsonl(path: str):
    """Read a recorder JSONL back: returns ``(meta, events)`` where
    ``meta`` is the header row (``{}`` for a headerless file) and
    ``events`` the record list — the inverse of
    :meth:`FlightRecorder.dump_jsonl`."""
    meta: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == _HEADER_KIND and not events and not meta:
                meta = rec
            else:
                events.append(rec)
    return meta, events


# -- process-global recorder ------------------------------------------------

_recorder: Optional[FlightRecorder] = None


def configure(capacity: int = 65536,
              worker: Optional[Any] = None) -> FlightRecorder:
    """Install (and return) the process-global recorder. Call sites all
    over the codebase pick it up via :func:`get_recorder`."""
    global _recorder
    _recorder = FlightRecorder(capacity=capacity, worker=worker)
    return _recorder


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Install an existing recorder as the process-global one — the
    re-enable path (``disable()`` then ``install(rec)`` pauses and
    resumes one buffer without discarding it, unlike ``configure``
    which starts fresh)."""
    global _recorder
    _recorder = recorder
    return recorder


def disable() -> None:
    """Remove the process-global recorder; instrumented paths return to
    their zero-cost guard."""
    global _recorder
    _recorder = None


def get_recorder() -> Optional[FlightRecorder]:
    """The process-global recorder, or None when telemetry is disabled —
    the one branch every instrumented hot path pays."""
    return _recorder


def record_event(name: str, **kw: Any) -> None:
    """Module-level convenience: record on the global recorder, no-op
    when disabled."""
    rec = _recorder
    if rec is not None:
        rec.event(name, **kw)


@contextlib.contextmanager
def span(name: str, **kw: Any) -> Iterator[None]:
    """Module-level span on the global recorder; a plain (cheap) yield
    when disabled."""
    rec = _recorder
    if rec is None:
        yield
    else:
        with rec.span(name, **kw):
            yield

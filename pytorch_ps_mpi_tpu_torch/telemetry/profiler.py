"""SamplingProfiler: always-on low-overhead continuous profiling (the JAX
package's ``telemetry/profiler.py``). The sampler is a host thread that
reads Python frames only: it makes no CUDA call, so it never syncs the
card.

The recorder spans time what the code *chose* to instrument;
this module answers "where does the time actually go" without touching
the instrumented paths at all: a daemon thread samples every Python
thread's stack (``sys._current_frames()``) at ~100 Hz and aggregates
the walks into collapsed-stack flamegraph text (Brendan Gregg's
``stack;frames;deepest count`` format — feed ``profile-*.txt`` straight
to ``flamegraph.pl`` or speedscope) plus a top-N self-time table.

Safety and cost:

- the sampler reads **Python frame objects only** — it never touches a
  native transport handle, so it coexists with the serve loop's
  same-thread pump discipline (the sampled threads don't cooperate or
  even know);
- a **hard self-overhead budget**: the wall cost of every sampling pass
  is measured, and when the running overhead fraction exceeds
  ``max_frac`` the sampling interval doubles (down to ``min_hz``) until
  it fits — the profiler throttles itself before it can distort what it
  measures. The achieved rate and overhead ride :meth:`snapshot` and
  the profile header, so a throttled profile is visibly throttled.

Native half: the C++ hot paths (``wirecodec.cpp`` folds, ``tcpps.cpp``
batched ingest) are invisible to a Python stack sampler — they run
inside one opaque ``ctypes`` call. They keep their own cycle counters
(calls / elements / nanoseconds), read through
:func:`native_counters` the same "refresh a plain tuple, never hand the
scrape thread a native handle" way as ``_native_read_stats``, and ride
the profile header + report table.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: tuning knobs and their defaults (overridable via ``cfg["profile_kw"]``)
PROFILER_KNOBS: Dict[str, Any] = {
    "hz": 100.0,        # target sampling rate
    "min_hz": 5.0,      # throttle floor
    "max_frac": 0.02,   # hard self-overhead budget (fraction of wall)
    "max_stack": 48,    # frames kept per sample (deepest first)
    "adjust_every": 64,  # samples between overhead re-checks
}


def profile_path(profile_dir: str, name: str) -> str:
    return os.path.join(profile_dir, f"profile-{name}.txt")


def _frame_label(frame) -> str:
    code = frame.f_code
    return f"{code.co_name} ({os.path.basename(code.co_filename)})"


class SamplingProfiler:
    """Collapsed-stack sampling profiler for the current process.

    ``start()``/``stop()`` bound the capture; ``write()`` lands
    ``profile-<name>.txt`` (header comment lines + collapsed stacks).
    ``threads="all"`` samples every live thread rooted at its thread
    name; pass a thread ident iterable to restrict."""

    def __init__(self, name: str = "server", dir: Optional[str] = None,
                 threads: Any = "all", **overrides: Any):
        self.knobs = dict(PROFILER_KNOBS)
        self.knobs.update(overrides)
        self.name = str(name)
        self.dir = dir
        self._only = (None if threads == "all"
                      else {int(t) for t in threads})
        self.counts: Dict[str, int] = {}
        self.samples = 0
        self.sample_cost_s = 0.0
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self._interval = 1.0 / float(self.knobs["hz"])
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- capture ----------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self.started_at = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"profiler:{self.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
        self.stopped_at = time.monotonic()

    def _run(self) -> None:
        me = threading.get_ident()
        max_stack = int(self.knobs["max_stack"])
        adjust_every = int(self.knobs["adjust_every"])
        while not self._stop.is_set():
            t0 = time.perf_counter()
            # self-cost in THREAD CPU time (wall above only paces the
            # loop): a preempted pass on an oversubscribed box costs
            # milliseconds of wall but ~100 us of CPU, and the budget
            # gates what the sampler actually takes from the machine
            c0 = time.thread_time()
            names = {t.ident: t.name for t in threading.enumerate()}
            try:
                frames = sys._current_frames()
            except Exception:
                frames = {}
            for tid, frame in frames.items():
                if tid == me:
                    continue
                if self._only is not None and tid not in self._only:
                    continue
                tname = names.get(tid, f"thread-{tid}")
                if tname.startswith(("metrics-http", "profiler:")):
                    continue  # idle endpoint poll loops are noise
                stack: List[str] = []
                while frame is not None and len(stack) < max_stack:
                    stack.append(_frame_label(frame))
                    frame = frame.f_back
                stack.append(tname)  # root = thread name
                key = ";".join(reversed(stack))
                with self._lock:
                    self.counts[key] = self.counts.get(key, 0) + 1
            self.samples += 1
            self.sample_cost_s += time.thread_time() - c0
            if self.samples % adjust_every == 0:
                self._adjust()
            # sleep whatever is left of the interval (never negative)
            left = self._interval - (time.perf_counter() - t0)
            if left > 0:
                self._stop.wait(left)

    def _adjust(self) -> None:
        """Enforce the self-overhead budget: double the interval while
        the measured fraction is over budget; creep back toward the
        target rate when comfortably under it."""
        frac = self.self_overhead_frac()
        base = 1.0 / float(self.knobs["hz"])
        max_int = 1.0 / float(self.knobs["min_hz"])
        if frac > float(self.knobs["max_frac"]):
            self._interval = min(max_int, self._interval * 2.0)
        elif frac < float(self.knobs["max_frac"]) / 4.0 \
                and self._interval > base:
            self._interval = max(base, self._interval / 2.0)

    # -- readout ----------------------------------------------------------
    def self_overhead_frac(self) -> float:
        t0 = self.started_at
        if t0 is None:
            return 0.0
        end = self.stopped_at if self.stopped_at is not None \
            else time.monotonic()
        wall = max(end - t0, 1e-9)
        return self.sample_cost_s / wall

    def hz_effective(self) -> float:
        t0 = self.started_at
        if t0 is None or not self.samples:
            return 0.0
        end = self.stopped_at if self.stopped_at is not None \
            else time.monotonic()
        return self.samples / max(end - t0, 1e-9)

    def collapsed(self) -> str:
        """The flamegraph text: one ``root;...;leaf count`` line per
        distinct stack, sorted for stable diffs."""
        with self._lock:
            items = sorted(self.counts.items())
        return "\n".join(f"{k} {n}" for k, n in items)

    def top(self, n: int = 15) -> List[Dict[str, Any]]:
        with self._lock:
            counts = dict(self.counts)
        return top_frames(counts, n)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "armed": True,
            "name": self.name,
            "samples": self.samples,
            "stacks": len(self.counts),
            "hz_effective": round(self.hz_effective(), 2),
            "interval_s": round(self._interval, 5),
            "overhead_frac": round(self.self_overhead_frac(), 6),
            "budget_frac": float(self.knobs["max_frac"]),
            "top": self.top(8),
            "native": native_counters(),
        }

    def write(self, path: Optional[str] = None) -> Optional[str]:
        """Land ``profile-<name>.txt``: ``# meta`` + ``# native`` header
        comments, then the collapsed stacks."""
        if path is None:
            if not self.dir:
                return None
            os.makedirs(self.dir, exist_ok=True)
            path = profile_path(self.dir, self.name)
        meta = {k: v for k, v in self.snapshot().items()
                if k not in ("top", "native")}
        with open(path, "w") as f:
            f.write("# meta " + json.dumps(meta) + "\n")
            f.write("# native " + json.dumps(native_counters()) + "\n")
            body = self.collapsed()
            if body:
                f.write(body + "\n")
        return path


# ---------------------------------------------------------------------------
# collapsed-profile files: load / merge (telemetry_report's profile section)
# ---------------------------------------------------------------------------

def load_profile(path: str) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """``profile-*.txt`` → (meta, {stack: count}). Meta merges the
    ``# meta`` and ``# native`` header docs; malformed lines skipped."""
    meta: Dict[str, Any] = {}
    counts: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("# meta "):
                try:
                    meta.update(json.loads(line[len("# meta "):]))
                except ValueError:
                    pass
                continue
            if line.startswith("# native "):
                try:
                    meta["native"] = json.loads(line[len("# native "):])
                except ValueError:
                    pass
                continue
            if line.startswith("#"):
                continue
            stack, _, n = line.rpartition(" ")
            if not stack:
                continue
            try:
                counts[stack] = counts.get(stack, 0) + int(n)
            except ValueError:
                continue
    return meta, counts


def merge_profiles(paths: List[str]) -> Dict[str, int]:
    merged: Dict[str, int] = {}
    for p in paths:
        for stack, n in load_profile(p)[1].items():
            merged[stack] = merged.get(stack, 0) + n
    return merged


def top_frames(counts: Dict[str, int], n: int = 15
               ) -> List[Dict[str, Any]]:
    """Self-time table from collapsed counts: the LEAF frame of each
    stack is billed its count (self), every frame anywhere on the stack
    is billed cumulative."""
    self_c: Dict[str, int] = {}
    cum_c: Dict[str, int] = {}
    total = 0
    for stack, c in counts.items():
        frames = stack.split(";")
        total += c
        if frames:
            self_c[frames[-1]] = self_c.get(frames[-1], 0) + c
        for fr in set(frames):
            cum_c[fr] = cum_c.get(fr, 0) + c
    rows = [{"frame": fr, "self": c, "cum": cum_c.get(fr, c),
             "self_frac": round(c / total, 4) if total else 0.0}
            for fr, c in self_c.items()]
    rows.sort(key=lambda r: (-r["self"], r["frame"]))
    return rows[:n]


# ---------------------------------------------------------------------------
# native cycle counters (wirecodec folds, tcpps batched ingest)
# ---------------------------------------------------------------------------

def native_counters() -> Dict[str, Any]:
    """Process-global C++ hot-path counters, read from libraries that
    are ALREADY loaded (never triggers a build): ``wc_*`` fold kernels
    and ``tps_*`` epoll pump. Empty dict when nothing native is armed."""
    out: Dict[str, Any] = {}
    try:
        from pytorch_ps_mpi_tpu_torch.utils import native as _wc

        stats = _wc.fold_profile_stats()
        if stats is not None:
            out["wirecodec"] = stats
    except Exception:
        pass
    try:
        from pytorch_ps_mpi_tpu_torch.parallel import tcp as _tcp

        stats = _tcp.native_profile_stats()
        if stats is not None:
            out["tcpps"] = stats
    except Exception:
        pass
    return out

"""Numerics observability: gradient statistics, codec fidelity, quarantine.

The systems layers (telemetry, resilience, diagnosis) can
say *who* is slow and *which* frames were corrupt — but nothing in the
stack could say whether the numbers themselves were sane: a single
worker emitting NaNs silently poisoned the aggregate, and none of the
lossy codecs reported what they actually do to the gradients they
compress ("On the Utility of Gradient Compression in Distributed
Training Systems" shows those wins evaporate or corrupt convergence
depending on regime — only safe to run when measured online). This
module is the numerics layer, three legs:

- **On-device gradient statistics.** :func:`tree_stats` reduces each
  leaf on its own device with torch (finite sum-of-squares and the
  non-finite count) and fetches ONE small vector per call — no
  per-element host work ever, and no copy of the gradient to the host. The sync optimizers take the same
  reductions inside their step (``MPI_PS(numerics=True)``
  → ``grad_norm`` / ``nonfinite_total`` / ``update_ratio`` /
  ``bucket_grad_norms`` in every step's metrics dict); the async serve
  loop calls it per consumed push.
- **Online codec-fidelity probes.** ``Codec.fidelity_probe`` (decode-
  after-encode relative L2 error, cosine similarity, achieved
  bits-per-parameter; ``ErrorFeedback`` adds its residual norm) runs in
  each worker every ``probe_every`` steps on the PRE-encode gradient —
  the only place the true input exists; re-encoding the server's decoded
  gradient would measure ~0 for sign-like codecs — and the rows land in
  ``numerics-<worker>.jsonl`` files the :class:`NumericsMonitor` tails
  at tick cadence (the beacon pattern from :mod:`.diagnosis`).
- **Non-finite quarantine + divergence postmortems.** The monitor
  validates every consumed push BEFORE it can touch the optimizer:
  a non-finite push is counted per worker (through the resilience
  ``_reject_frame`` machinery when not applied), the worker is
  quarantined after ``quarantine_after`` offenses, and the configured
  ``policy`` decides the frame's fate — ``skip`` (drop it, keep
  serving), ``zero`` (sanitize the non-finite elements, apply the
  rest), or ``abort`` (stop the serve loop cleanly). A NaN or a
  grad-norm spike (``spike_factor``× the fleet EWMA) trips a
  **postmortem capture**: the last-``ring`` step-stats rows, a per-leaf
  snapshot of the offending gradient, and the tail of the flight
  recorder, written as ``postmortem-*.json`` into the telemetry dir for
  ``tools/telemetry_report.py`` to triage.

Metrics surface: ``grad_norm`` / ``nonfinite_total`` / ``update_ratio``
/ ``codec_rel_error`` / ``ef_residual_norm`` join the canonical
``PS_SERVER_METRIC_KEYS`` on both transports, scrape as
``ps_grad_norm`` / ``ps_nonfinite_total`` / ``ps_update_ratio`` /
``ps_codec_rel_error`` / ``ps_ef_residual_norm`` (plus per-worker
``ps_worker_nonfinite_total`` labeled series), and ride ``/health`` as
the ``numerics`` section rendered by ``tools/ps_top.py``.

Zero-cost-when-disabled, like every other telemetry layer: the serve
loop pays one ``None``-check per gradient when numerics is off.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

#: tuning knobs and their defaults (overridable via ``cfg["numerics_kw"]``)
NUMERICS_KNOBS: Dict[str, Any] = {
    "policy": "skip",        # non-finite push fate: skip | zero | abort
    "quarantine_after": 1,   # non-finite pushes before the worker is marked
    "spike_factor": 20.0,    # grad_norm > factor * fleet EWMA => postmortem
    "spike_min_samples": 20,  # EWMA warmup before the spike gate arms
    "spike_floor": 1e-6,     # absolute norm below which spikes are noise
    "ring": 64,              # last-k step-stats rows kept for postmortems
    "probe_every": 25,       # worker probe / server trajectory cadence
    "max_postmortems": 4,    # disk-write bound per serve call
    "cooldown_pushes": 50,   # min pushes between two spike postmortems
    "ewma_alpha": 0.25,
    "recorder_tail": 200,    # flight-recorder events embedded per dump
}

POLICIES = ("skip", "zero", "abort")


def _tensor_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tree's leaves (``jax.tree.leaves`` order) as tensors; numpy
    leaves are wrapped on the CPU without a copy."""
    from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

    return [x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            for x in tree_flatten(tree)[0]]


def flat_f32(tensors) -> torch.Tensor:
    """The tensors' elements as one float32 vector (one copy, one op
    whatever their count: the statistics below cost a few launches a
    call, not a few a leaf)."""
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def leaf_sums(flat: torch.Tensor, sizes, p: int) -> torch.Tensor:
    """The ``p``-norm of each consecutive segment of ``flat`` (``sizes``
    elements each), one multi-tensor launch; ``p=1`` of a 0/1 vector is a
    count, exact in float32 below 2**24 a segment."""
    return torch.stack(torch._foreach_norm(list(torch.split(flat, sizes)),
                                           p))


def tree_stats(tree: PyTree) -> Tuple[np.ndarray, np.ndarray]:
    """Per-leaf ``(finite_sumsq[f32], nonfinite_count[i32])`` vectors of
    a gradient tree, reduced on the leaves' device (empty trees get empty
    vectors): the leaves in one float32 vector, the non-finite elements
    masked to 0, and each leaf's norm and count taken by a multi-tensor
    reduction, a few launches whatever the leaf count. The two vectors
    travel as ONE float64 vector, one device-to-host copy a call: the
    float32 sums convert exactly, and a count stays exact past float32's
    2**24 (BERT's embedding leaf holds 23M elements; its segment count
    is a float32 sum, exact to 2**24). The finite sum-of-squares keeps
    the norm meaningful even on a poisoned gradient — a plain sumsq would
    be NaN and say nothing about the healthy part."""
    leaves = _tensor_leaves(tree)
    if not leaves:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    sizes = [x.numel() for x in leaves]
    with torch.no_grad():
        flat = flat_f32(leaves)
        finite = torch.isfinite(flat)
        clean = torch.where(finite, flat, torch.zeros_like(flat))
        sumsq = torch.square(leaf_sums(clean, sizes, 2))
        nonf = leaf_sums((~finite).to(torch.float32), sizes, 1)
        v = torch.cat([sumsq.to(torch.float64),
                       nonf.to(torch.float64)]).cpu().numpy()
    n = len(leaves)
    return v[:n].astype(np.float32), np.rint(v[n:]).astype(np.int32)


def sanitize_tree(tree: PyTree) -> PyTree:
    """The ``zero`` policy's sanitizer: non-finite elements become 0,
    everything else passes through (one ``where`` per leaf, on the
    leaf's device)."""
    from pytorch_ps_mpi_tpu_torch.comms import tree_map

    def clean(x):
        if not torch.is_tensor(x):
            x = np.asarray(x)
            return np.where(np.isfinite(x), x, np.zeros_like(x))
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

    with torch.no_grad():
        return tree_map(clean, tree)


def update_weight_ratio(old_params: PyTree, new_params: PyTree) -> float:
    """``||new - old|| / ||old||`` over a whole tree — the
    update-to-weight ratio, the classic divergence early-warning (healthy
    training sits around 1e-3; approaching 1 means the optimizer is
    rewriting the model every step). Reduced on the device over the
    leaves as one vector each, two scalars fetched in one copy."""
    old, new = _tensor_leaves(old_params), _tensor_leaves(new_params)
    if not old:
        return 0.0
    with torch.no_grad():
        o = flat_f32(old)
        up = torch.sum(torch.square(flat_f32(new) - o))
        v = torch.sqrt(torch.stack([up, torch.sum(torch.square(o))]))
        v = v.cpu().numpy()
    return float(v[0]) / max(float(v[1]), 1e-30)


def numerics_path(numerics_dir: str, worker) -> str:
    """Per-worker probe trajectory file (``numerics-<worker>.jsonl`` —
    the ``numerics-`` prefix keeps it out of recorder-JSONL merges, like
    ``beacon-``/``faults-``)."""
    return os.path.join(numerics_dir, f"numerics-{worker}.jsonl")


class ProbeWriter:
    """Worker-process half of the codec-fidelity leg: appends one JSONL
    row per probe (rel error, cosine, bits/param, EF residual) into
    ``numerics_path(dir, worker)``, flushed so the server-side monitor
    can tail it live — the :class:`~.diagnosis.BeaconWriter` pattern."""

    def __init__(self, numerics_dir: str, worker):
        os.makedirs(numerics_dir, exist_ok=True)
        self.path = numerics_path(numerics_dir, worker)
        self.worker = worker
        self._f = open(self.path, "a")

    def write(self, step: int, row: Dict[str, Any]) -> None:
        self._f.write(json.dumps({
            "worker": self.worker, "step": int(step), "t": time.time(),
            **{k: (round(v, 8) if isinstance(v, float) else v)
               for k, v in row.items()},
        }) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            f, self._f = self._f, None
            f.close()


class _WorkerNumerics:
    __slots__ = ("nonfinite", "nonfinite_elems", "quarantined",
                 "norm_ewma", "last_norm", "probe", "probe_offset")

    def __init__(self):
        self.nonfinite = 0        # non-finite pushes (frames)
        self.nonfinite_elems = 0  # non-finite elements across them
        self.quarantined = False
        self.norm_ewma: Optional[float] = None
        self.last_norm = 0.0
        self.probe: Optional[Dict[str, Any]] = None
        self.probe_offset = 0


class NumericsMonitor:
    """Derives the numerics verdicts for one PS serve call.

    Feed points (all same-thread with the serve loop):

    - :meth:`observe_push` on every consumed gradient BEFORE it is
      applied — returns the action the policy demands (``"apply"`` /
      ``"skip"`` / ``"zero"`` / ``"abort"``) and does all counting,
      quarantine, and postmortem capture;
    - :meth:`observe_update` at probe cadence with the params before and
      after an applied update — the update-to-weight ratio;
    - :meth:`tick` at the serve loop's tick cadence — tails the worker
      probe files in the numerics dir.

    ``server`` is any PS server carrying the
    :class:`~pytorch_ps_mpi_tpu_torch.telemetry.registry.PSServerTelemetry`
    surface; passing it attaches the monitor (``server.numerics_monitor``
    — the canonical-schema and ``/health`` source) and registers the
    scrape instruments. Tests may pass ``num_workers`` and drive the
    feed points directly.
    """

    def __init__(self, server=None, cfg: Optional[Dict[str, Any]] = None,
                 *, num_workers: Optional[int] = None, **overrides):
        cfg = cfg or {}
        self.knobs = dict(NUMERICS_KNOBS)
        self.knobs.update(cfg.get("numerics_kw") or {})
        self.knobs.update(overrides)
        if self.knobs["policy"] not in POLICIES:
            raise ValueError(
                f"numerics policy must be one of {POLICIES}, "
                f"got {self.knobs['policy']!r}"
            )
        # a zero/negative cadence would turn probe modulos into division
        # errors in the workers — clamp once, at the one config seam
        self.knobs["probe_every"] = max(1, int(self.knobs["probe_every"]))
        self.server = server
        if num_workers is None:
            if server is None:
                raise ValueError("need a server or num_workers")
            num_workers = int(server.num_workers)
        self.num_workers = int(num_workers)
        # postmortems + the server-side trajectory rows land here; the
        # worker probe files are tailed from the same place (one dir is
        # the whole numerics surface on disk)
        self.dir = cfg.get("numerics_dir") or cfg.get("telemetry_dir")
        self._w = [_WorkerNumerics() for _ in range(self.num_workers)]
        self.pushes = 0
        self.nonfinite_frames_total = 0
        self.nonfinite_elems_total = 0
        self.readmissions = 0
        self.last_grad_norm = 0.0
        self.norm_ewma: Optional[float] = None
        self._norm_samples = 0
        self.update_ratio: Optional[float] = None
        self.postmortems: List[str] = []
        self.aborted: Optional[Dict[str, Any]] = None
        self._ring: deque = deque(maxlen=int(self.knobs["ring"]))
        self._last_spike_push = -(10 ** 9)
        self._traj_f = None
        if server is not None:
            server.numerics_monitor = self
            self.register(server.scrape_registry())

    # -- feed points ------------------------------------------------------
    def observe_push(self, worker: int, grad: PyTree,
                     applied: int = 0) -> str:
        """Validate one consumed push; returns the action: ``"apply"``
        (healthy), ``"zero"`` (sanitize via :func:`sanitize_tree`, then
        apply), ``"skip"`` (do not apply), ``"abort"`` (stop serving).
        All statistics, quarantine flags, rejection counts, and
        postmortems happen here."""
        if not 0 <= worker < self.num_workers:
            return "apply"  # rogue ids are the frame layer's problem
        self.pushes += 1
        leaf_sumsq, leaf_nonf = tree_stats(grad)
        nonf = int(leaf_nonf.sum())
        gnorm = float(np.sqrt(float(leaf_sumsq.sum())))
        h = self._w[worker]
        h.last_norm = gnorm
        a = self.knobs["ewma_alpha"]
        h.norm_ewma = gnorm if h.norm_ewma is None else (
            h.norm_ewma + a * (gnorm - h.norm_ewma))
        self._ring.append({
            "push": self.pushes, "applied": int(applied),
            "worker": int(worker), "grad_norm": round(gnorm, 8),
            "nonfinite": nonf, "t": time.time(),
        })
        if nonf:
            return self._handle_nonfinite(
                worker, h, nonf, leaf_sumsq, leaf_nonf, grad, applied)
        if h.quarantined and self.knobs["policy"] == "skip":
            # a quarantined worker is untrusted wholesale under the skip
            # policy: its FINITE pushes are dropped too (counted under
            # their own rejection reason), so quarantine actually
            # isolates the worker — and in sync-barrier mode its pushes
            # never pile up in a pending queue the barrier excludes
            if self.server is not None:
                self.server._reject_frame(worker, "quarantined")
            return "skip"
        # healthy push: fleet norm EWMA + the spike gate
        self.last_grad_norm = gnorm
        prev = self.norm_ewma
        self.norm_ewma = gnorm if prev is None else (
            prev + a * (gnorm - prev))
        self._norm_samples += 1
        k = self.knobs
        if (prev is not None
                and self._norm_samples > int(k["spike_min_samples"])
                and gnorm > max(k["spike_factor"] * prev, k["spike_floor"])
                and self.pushes - self._last_spike_push
                >= int(k["cooldown_pushes"])):
            self._last_spike_push = self.pushes
            self._record("numerics.spike", worker=worker, grad_norm=gnorm,
                         ewma=prev)
            self.write_postmortem(
                "norm_spike", worker, grad,
                leaf_sumsq=leaf_sumsq, leaf_nonf=leaf_nonf,
                applied=applied,
                detail={"grad_norm": gnorm, "fleet_ewma": prev,
                        "spike_factor": k["spike_factor"]},
            )
        return "apply"

    def _handle_nonfinite(self, worker: int, h: _WorkerNumerics, nonf: int,
                          leaf_sumsq, leaf_nonf, grad: PyTree,
                          applied: int) -> str:
        k = self.knobs
        h.nonfinite += 1
        h.nonfinite_elems += nonf
        self.nonfinite_frames_total += 1
        self.nonfinite_elems_total += nonf
        first = h.nonfinite == 1
        if h.nonfinite >= int(k["quarantine_after"]):
            h.quarantined = True
        self._record("numerics.nonfinite", worker=worker, elems=nonf,
                     policy=k["policy"])
        policy = k["policy"]
        if policy in ("skip", "abort") and self.server is not None:
            # the resilience layer's rejection machinery: a dropped-for-numerics frame
            # is counted per worker exactly like a corrupt one
            self.server._reject_frame(worker, "nonfinite")
        if first or policy == "abort":
            self.write_postmortem(
                "nonfinite", worker, grad,
                leaf_sumsq=leaf_sumsq, leaf_nonf=leaf_nonf,
                applied=applied,
                detail={"nonfinite_elems": nonf, "policy": policy,
                        "worker_nonfinite_pushes": h.nonfinite},
            )
        if policy == "abort":
            self.aborted = {"reason": "nonfinite", "worker": int(worker),
                            "postmortem": (self.postmortems[-1]
                                           if self.postmortems else None)}
            return "abort"
        return "zero" if policy == "zero" else "skip"

    def observe_update(self, old_params: PyTree, new_params: PyTree,
                       applied: int = 0) -> float:
        """Update-to-weight ratio of one applied update (serve calls this
        at probe cadence — the old params are only retained on probe
        steps); also appends the server-side trajectory row."""
        self.update_ratio = update_weight_ratio(old_params, new_params)
        self._trajectory_row(applied)
        return self.update_ratio

    def tick(self) -> None:
        """Tail the worker probe files (file reads only — same contract
        as the diagnosis beacon tail)."""
        if not self.dir:
            return
        from pytorch_ps_mpi_tpu_torch.telemetry.diagnosis import read_beacon_rows

        for wid in range(self.num_workers):
            h = self._w[wid]
            rows, h.probe_offset = read_beacon_rows(
                numerics_path(self.dir, wid), h.probe_offset)
            if rows:
                # a probe taken on a poisoned gradient carries NaN values
                # (Python's json round-trips them, strict parsers don't):
                # sanitize to None so /health stays RFC-valid JSON
                h.probe = {
                    k: (None if isinstance(v, float)
                        and not np.isfinite(v) else v)
                    for k, v in rows[-1].items()
                }

    # -- postmortems ------------------------------------------------------
    def write_postmortem(self, reason: str, worker: int, grad: PyTree,
                         *, leaf_sumsq=None, leaf_nonf=None,
                         applied: int = 0,
                         detail: Optional[Dict[str, Any]] = None
                         ) -> Optional[str]:
        """Capture the divergence context to disk: the last-``ring``
        step-stats rows, a per-leaf snapshot of the offending gradient
        (shape, finite norm, non-finite count, a few leading values of
        the worst leaf), and the tail of the flight recorder. Returns
        the path, or None when unarmed (no dir) or the per-run bound
        (``max_postmortems``) is spent."""
        if not self.dir or len(self.postmortems) >= int(
                self.knobs["max_postmortems"]):
            return None
        if leaf_sumsq is None or leaf_nonf is None:
            leaf_sumsq, leaf_nonf = tree_stats(grad)
        leaves = _tensor_leaves(grad)
        leaf_rows = [
            {"leaf": i, "shape": list(np.shape(l)),
             "finite_norm": round(float(np.sqrt(leaf_sumsq[i])), 8),
             "nonfinite": int(leaf_nonf[i])}
            for i, l in enumerate(leaves)
        ]
        worst = max(range(len(leaves)), default=None,
                    key=lambda i: int(leaf_nonf[i]))
        sample = None
        if worst is not None:
            flat = leaves[worst].reshape(-1)[:8].to(
                torch.float32).cpu().numpy()
            sample = {"leaf": worst,
                      "values": [float(v) for v in flat[:8]]}
        events = []
        from pytorch_ps_mpi_tpu_torch.telemetry.recorder import get_recorder

        rec = get_recorder()
        if rec is not None:
            events = rec.events()[-int(self.knobs["recorder_tail"]):]
        doc = {
            "kind": "numerics_postmortem",
            "reason": reason,
            "worker": int(worker),
            "applied": int(applied),
            "t_wall": time.time(),
            "policy": self.knobs["policy"],
            "detail": detail or {},
            "step_stats_ring": list(self._ring),
            "offending": {"leaves": leaf_rows, "sample": sample},
            "fleet": {
                "grad_norm_ewma": self.norm_ewma,
                "nonfinite_frames_total": self.nonfinite_frames_total,
                "update_ratio": self.update_ratio,
            },
            "recorder_tail": events,
        }
        lt = getattr(self.server, "lineage_tracker", None)
        if lt is not None:
            # the causal half of the capture (telemetry.lineage): the
            # offending push's trace ID, the offender's recent composed
            # pushes, and the pushes that composed the last published
            # version — "which worker pushes made this version bad"
            # answered from data, not inference
            doc["lineage"] = {
                "offending_push": getattr(self.server, "last_push_meta",
                                          None),
                "offender_recent": lt.recent(8, worker=worker),
                "last_publish": lt.last_publish,
            }
        os.makedirs(self.dir, exist_ok=True)
        import glob as _glob

        # number against the FILES already on disk, not this monitor's
        # list: a supervised restart builds a fresh monitor in the same
        # dir, and restarting at 00 would clobber the pre-crash capture
        n_disk = len(_glob.glob(os.path.join(self.dir, "postmortem-*.json")))
        path = os.path.join(
            self.dir, f"postmortem-{n_disk:02d}-{reason}.json",
        )
        with open(path, "w") as f:
            json.dump(doc, f)
        self.postmortems.append(path)
        self._record("numerics.postmortem", worker=worker, reason=reason,
                     path=path)
        return path

    def _trajectory_row(self, applied: int) -> None:
        """Server-side grad-norm/update-ratio trajectory: one row per
        probe cadence into ``numerics-server.jsonl`` (same dir as the
        worker probe files — ``telemetry_report`` plots them together)."""
        if not self.dir:
            return
        if self._traj_f is None:
            os.makedirs(self.dir, exist_ok=True)
            self._traj_f = open(numerics_path(self.dir, "server"), "a")
        self._traj_f.write(json.dumps({
            "worker": "server", "applied": int(applied), "t": time.time(),
            "grad_norm": round(self.last_grad_norm, 8),
            "grad_norm_ewma": (None if self.norm_ewma is None
                               else round(self.norm_ewma, 8)),
            "update_ratio": (None if self.update_ratio is None
                             else round(self.update_ratio, 10)),
            "nonfinite_total": self.nonfinite_frames_total,
        }) + "\n")
        self._traj_f.flush()

    def close(self) -> None:
        if self._traj_f is not None:
            f, self._traj_f = self._traj_f, None
            f.close()

    @staticmethod
    def _record(name: str, **kw) -> None:
        from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

        record_event(name, **kw)

    def readmit(self, worker: int) -> bool:
        """Probation readmission (the control plane's verdict→action
        loop): clear the worker's quarantine AND its offense count, so
        its next pushes are validated on merit — one fresh non-finite
        push re-quarantines it at ``quarantine_after`` offenses exactly
        like a first offense. Returns False when the worker was not
        quarantined. Counted in ``readmissions`` (the controller's
        probation backoff is what keeps this from flapping)."""
        if not 0 <= worker < self.num_workers:
            return False
        h = self._w[worker]
        if not h.quarantined:
            return False
        h.quarantined = False
        h.nonfinite = 0
        self.readmissions += 1
        self._record("numerics.readmit", worker=worker)
        return True

    # -- read side --------------------------------------------------------
    def is_quarantined(self, worker: int) -> bool:
        return (0 <= worker < self.num_workers
                and self._w[worker].quarantined)

    def worker_nonfinite(self, worker: int) -> int:
        return self._w[worker].nonfinite

    def _latest_probe(self, key: str) -> float:
        """Max of the workers' latest probe values for ``key`` (0.0 when
        no probes landed yet) — the conservative fleet summary the
        gauges export. Non-finite probe values (a probe that landed on a
        poisoned gradient) are excluded rather than poisoning the gauge."""
        vals = []
        for h in self._w:
            if h.probe is None or h.probe.get(key) is None:
                continue
            v = float(h.probe[key])
            if np.isfinite(v):
                vals.append(v)
        return max(vals) if vals else 0.0

    @property
    def codec_rel_error(self) -> float:
        return self._latest_probe("rel_error")

    @property
    def ef_residual_norm(self) -> float:
        return self._latest_probe("ef_residual_norm")

    def snapshot(self) -> Dict[str, Any]:
        """The ``numerics`` section of ``/health`` and of the serve
        call's returned metrics. Pure reads — scrape-safe."""
        workers = []
        for wid in range(self.num_workers):
            h = self._w[wid]
            workers.append({
                "worker": wid,
                "verdict": "quarantined" if h.quarantined else "ok",
                "nonfinite": h.nonfinite,
                "nonfinite_elems": h.nonfinite_elems,
                "grad_norm_ewma": h.norm_ewma,
                "last_grad_norm": h.last_norm,
                "probe": h.probe,
            })
        return {
            "armed": True,
            "policy": self.knobs["policy"],
            "pushes": self.pushes,
            "nonfinite_total": self.nonfinite_frames_total,
            "nonfinite_elems_total": self.nonfinite_elems_total,
            "quarantined": [w["worker"] for w in workers
                            if w["verdict"] == "quarantined"],
            "readmissions": self.readmissions,
            "grad_norm": {"last": self.last_grad_norm,
                          "ewma": self.norm_ewma},
            "update_ratio": self.update_ratio,
            "codec_rel_error": self.codec_rel_error,
            "ef_residual_norm": self.ef_residual_norm,
            "postmortems": list(self.postmortems),
            "aborted": self.aborted,
            "workers": workers,
        }

    # -- scrape registry --------------------------------------------------
    def register(self, registry) -> None:
        """Mirror the numerics state into scrape instruments — unlabeled
        fleet gauges plus the per-worker ``ps_worker_nonfinite_total``
        labeled series (same no-unlabeled-sibling discipline as the
        diagnosis instruments)."""

        def collect(r) -> None:
            r.counter(
                "ps_nonfinite_total",
                "gradient pushes containing NaN/Inf (any worker)",
            ).set(float(self.nonfinite_frames_total))
            r.gauge(
                "ps_grad_norm",
                "L2 norm of the last healthy consumed gradient "
                "(finite elements)",
            ).set(self.last_grad_norm)
            r.gauge(
                "ps_update_ratio",
                "update-to-weight ratio ||dp||/||p|| at the last probe",
            ).set(self.update_ratio or 0.0)
            r.gauge(
                "ps_codec_rel_error",
                "decode-after-encode relative L2 error of the wire codec "
                "(latest worker probe, max over workers)",
            ).set(self.codec_rel_error)
            r.gauge(
                "ps_ef_residual_norm",
                "error-feedback residual-memory norm (latest probe)",
            ).set(self.ef_residual_norm)
            for wid in range(self.num_workers):
                h = self._w[wid]
                lab = {"worker": str(wid)}
                r.counter(
                    "ps_worker_nonfinite_total",
                    "non-finite gradient pushes from this worker",
                    labels=lab).set(float(h.nonfinite))
                r.gauge(
                    "ps_worker_quarantined",
                    "1 when the worker is numerics-quarantined",
                    labels=lab).set(1.0 if h.quarantined else 0.0)

        registry.add_collector(collect)

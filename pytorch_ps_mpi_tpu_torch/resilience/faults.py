"""Seeded, deterministic fault injection for the async PS stack
(``pytorch_ps_mpi_tpu/resilience/faults.py``). Host-only numpy.

A **fault plan** is a JSON-able list of entries::

    {"at_step": 5, "worker": 1, "kind": "crash_worker"}
    {"at_step": 3, "worker": 0, "kind": "corrupt"}
    {"at_step": 20, "worker": "server", "kind": "crash_server"}

``worker`` is a worker id (matched against the worker loop's step) or a
role: ``"server"`` (matched against the serve loop's global applied
count, so a resumed server never re-fires a fault behind its restored
``applied_total``), ``"leader<g>"`` or ``"reader<j>"``. The kinds:

- ``drop``: the worker computes but skips the push;
- ``delay``: sleep ``delay_ms`` (default 100) before the push;
- ``wire_delay``: sleep ``delay_ms`` inside the push, after the frame is
  sealed;
- ``duplicate``: push the same gradient twice with the same version;
- ``corrupt``: XOR-flip ``corrupt_bytes`` (default 8) bytes of the sealed
  frame, at positions from (seed, fault id) alone;
- ``nan``: poison the step's gradient with NaNs before the encode;
- ``crash_worker``: ``os._exit`` mid-step (no ``finally`` runs);
- ``crash_server``: raise :class:`InjectedServerCrash` out of the serve
  loop after the matching applied update;
- ``slow_leader`` (``"leader<g>"``) and ``reader_storm``
  (``"reader<j>"``): role faults, validated here; this module only
  decides when they fire.

Two runs with the same plan and seed fire the same faults and log the
same rows ``{id, kind, worker, at_step}`` (:attr:`FaultInjector.events`,
and with ``cfg["fault_log_dir"]`` a JSONL file a role, written before a
crash kind takes the process down). A respawned worker restarts at step
0; the supervisor lists fired crash faults in ``cfg["fault_fired"]``,
which :meth:`FaultInjector.from_cfg` excludes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

FAULT_KINDS = ("drop", "delay", "wire_delay", "duplicate", "corrupt",
               "nan", "crash_worker", "crash_server",
               "slow_leader", "reader_storm")

#: exit code of an injected worker crash (``os._exit``)
CRASH_EXIT_CODE = 97


class InjectedServerCrash(RuntimeError):
    """Raised out of the serve loop by a ``crash_server`` fault; carries
    the fault entry so a supervisor can mark it fired before restarting
    the server from its checkpoint."""

    def __init__(self, fault: Dict[str, Any]):
        super().__init__(f"injected server crash (fault id={fault['id']} "
                         f"at applied={fault['at_step']})")
        self.fault = fault


def normalize_plan(plan: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Validate a fault plan and give each entry a stable ``id`` (its
    index unless it has one), used for fired-marking and corrupt seeds."""
    out = []
    for i, f in enumerate(plan):
        kind = f.get("kind")
        if kind not in FAULT_KINDS:
            raise ValueError(f"fault {i}: unknown kind {kind!r} "
                             f"(one of {FAULT_KINDS})")
        worker = f.get("worker", "server" if kind == "crash_server" else None)
        if worker is None:
            raise ValueError(f"fault {i}: missing worker")
        if kind == "crash_server" and worker != "server":
            raise ValueError(f"fault {i}: crash_server must target 'server'")
        for role_kind, role in (("slow_leader", "leader<g>"),
                                ("reader_storm", "reader<j>")):
            if kind == role_kind and not (
                    isinstance(worker, str)
                    and worker.startswith(role[:-3])):
                raise ValueError(f"fault {i}: {role_kind} must target a "
                                 f"'{role}' role, got {worker!r}")
        entry = dict(f)
        entry["id"] = int(f.get("id", i))
        entry["at_step"] = int(f["at_step"])
        if isinstance(worker, str) and not worker.lstrip("-").isdigit():
            entry["worker"] = worker
        else:
            entry["worker"] = int(worker)
        entry["kind"] = kind
        out.append(entry)
    if len({f["id"] for f in out}) != len(out):
        raise ValueError("fault plan ids must be unique")
    return out


class FaultInjector:
    """Consults a normalized fault plan for one role (a worker id or a
    role string), fires matching faults and logs every injection."""

    def __init__(self, plan: Sequence[Dict[str, Any]], seed: int = 0,
                 role: Union[int, str] = "server",
                 fired: Iterable[int] = (),
                 log_path: Optional[str] = None):
        self.plan = normalize_plan(plan)
        self.seed = int(seed)
        self.role = role
        self.fired = set(int(i) for i in fired)
        self.log_path = log_path
        self.events: List[Dict[str, Any]] = []
        self._mine = [f for f in self.plan if f["worker"] == role]

    @classmethod
    def from_cfg(cls, cfg: Dict[str, Any],
                 role: Union[int, str] = "server"
                 ) -> Optional["FaultInjector"]:
        """From the job's cfg keys ``fault_plan``, ``fault_seed``,
        ``fault_fired`` and ``fault_log_dir``; None without a plan."""
        plan = cfg.get("fault_plan")
        if not plan:
            return None
        log_path = None
        if cfg.get("fault_log_dir"):
            os.makedirs(cfg["fault_log_dir"], exist_ok=True)
            log_path = os.path.join(cfg["fault_log_dir"],
                                    f"faults-{role}.jsonl")
        return cls(plan, seed=int(cfg.get("fault_seed", 0)), role=role,
                   fired=cfg.get("fault_fired") or (), log_path=log_path)

    def faults_at(self, step: int) -> List[Dict[str, Any]]:
        """Unfired faults of this role scheduled at ``step``."""
        return [f for f in self._mine
                if f["at_step"] == step and f["id"] not in self.fired]

    def faults_between(self, lo: int, hi: int) -> List[Dict[str, Any]]:
        """Unfired faults of this role with ``lo < at_step <= hi`` (a sync
        round advances the applied count by several at once)."""
        return [f for f in self._mine
                if lo < f["at_step"] <= hi and f["id"] not in self.fired]

    def fire(self, fault: Dict[str, Any]) -> Dict[str, Any]:
        """Mark ``fault`` fired and log its deterministic row, to the
        list, flushed and synced at once to the fault log, and to the
        flight recorder when one is installed."""
        self.fired.add(fault["id"])
        event = {"id": fault["id"], "kind": fault["kind"],
                 "worker": fault["worker"], "at_step": fault["at_step"]}
        self.events.append(event)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(event, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

        record_event("fault.injected", **event)
        return event

    def corrupt(self, fault: Dict[str, Any], buf: np.ndarray) -> None:
        """XOR-flip ``corrupt_bytes`` positions of ``buf`` in place, from
        (seed, fault id) only."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + 7919 * (fault["id"] + 1)) % 2**32)
        n = max(1, int(fault.get("corrupt_bytes", 8)))
        idx = rng.randint(0, buf.nbytes, size=n)
        buf[idx] ^= 0xFF

    def make_tamper(self, fault: Dict[str, Any]):
        """A one-shot hook for a transport worker's ``_tamper`` slot: it
        fires the fault and corrupts the next push's sealed bytes."""

        def tamper(buf: np.ndarray) -> None:
            self.fire(fault)
            self.corrupt(fault, buf)

        return tamper


def load_fault_log(path: str) -> List[Dict[str, Any]]:
    """One fault log's rows (a missing file: none fired)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]

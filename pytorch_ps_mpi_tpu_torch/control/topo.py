"""Structural actuators — topology as a control action (the JAX
package's ``control/topo.py``).

The :class:`~pytorch_ps_mpi_tpu_torch.control.controller.ControlEngine`'s
``topo`` rule decides *that* the fleet should reshape; this
module is *how*.  Three actuators, one shared publication document:

``control-topo.json``
    The structural counterpart of ``control-epoch.json`` — an atomic
    (write-temp + rename), monotone-``seq`` document the worker fleet
    polls once per step (:func:`poll_topo`, one ``os.stat``).  It
    carries the leader re-assignment map (``assign: {wid: addr}``,
    consumed by ``TreeWorkerConn.repoint``) and the planned shard count
    (``shards``, consumed by :func:`planned_shards` at the next
    sharded-server generation — shard moves are never live migrations).

:class:`TreeTopoActuator`
    Lives inside ``run_tree`` (the only process holding the leader
    supervision lists).  ``request_replan`` moves HALF the hot group's
    members behind a freshly spawned leader; the spawn is asynchronous
    (``pump()`` on the serve loop's tick reaps the hello) so the serve
    thread never blocks on a child boot.  The new leader lands in the
    same ``leaders``/``leader_ports`` lists the existing respawn loop
    supervises, so from the moment of its hello it is pinned-port
    respawned like any boot-time leader.  Migrated members repoint on
    their next topo poll; the old leader's degrade/flush machinery
    folds their already-queued pushes (exact composed accounting — no
    push is lost or double-counted across the transition).
    ``request_merge`` reassigns the members back and lets the split
    leader idle-exit clean (rc 0 is never respawned); its group slot is
    recycled by the next split so the root's spare-wid headroom stays
    bounded by ``replan_max``.

:class:`ReplicaScaler`
    The elastic read tier: spawns/retires ``python -m
    pytorch_ps_mpi_tpu_torch.serve_readonly --follow-endpoint`` replica
    processes (the port's own read-only server, on the CPU).  Replicas self-register
    fleet cards (``replica-<pid>``) and re-parent by subscribing to the
    endpoint the scaler hands them; retirement removes the card first
    so the pane never shows a corpse, then terminates the process.

:class:`HopTailer`
    Live feed for the anatomy advisor: tails the leaders'
    ``lineage-leader<g>.jsonl`` sidecars (offset-tracked, torn-line
    safe) and replays each hop row into ``RoundAnatomy.observe_hop`` —
    the same rows the offline profiler reads, so the live advisor's
    ``leader_fold`` ranking (and the engine's ``hot_group`` input)
    match the post-hoc one.

Everything here is a *live* actuator: determinism lives in the engine
(every action row already carries its verdict and replays
byte-identical from TSDB rows); these classes only carry actions out
and are free to fail — the controller counts failures in
``exec_errors`` without perturbing the action log.
"""

from __future__ import annotations

import glob
import json
import os
import select
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# the topology document (control-topo.json)
# ---------------------------------------------------------------------------


def topo_path(control_dir: str) -> str:
    return os.path.join(control_dir, "control-topo.json")


def read_topo(control_dir: str) -> Optional[Dict[str, Any]]:
    """Best-effort read of the current topology document (None when
    absent or torn — the atomic rename makes torn reads transient)."""
    try:
        with open(topo_path(control_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def update_topo(control_dir: str, **fields: Any) -> Dict[str, Any]:
    """Merge ``fields`` into ``control-topo.json`` and publish it
    atomically with a bumped monotone ``seq`` (the worker poll's
    freshness gate).  ``assign`` maps MERGE key-wise — a shard-plan
    update must not clobber a standing leader re-assignment."""
    os.makedirs(control_dir, exist_ok=True)
    doc = read_topo(control_dir) or {}
    assign = dict(doc.get("assign") or {})
    if "assign" in fields:
        assign.update(fields.pop("assign") or {})
    doc.update(fields)
    doc["assign"] = assign
    doc["seq"] = int(doc.get("seq", 0)) + 1
    path = topo_path(control_dir)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc


def poll_topo(control_dir: str, state: Dict[str, Any]
              ) -> Optional[Dict[str, Any]]:
    """Worker-side topology poll, modeled on ``poll_epoch``: one
    ``os.stat`` per call, parse only on change, return only documents
    with a NEWER ``seq`` than ``state`` has seen.  ``state`` is the
    caller's mutable ``{"seq": int, "mtime": int}``."""
    path = topo_path(control_dir)
    try:
        st = os.stat(path)
    except OSError:
        return None
    if st.st_mtime_ns == state.get("mtime"):
        return None
    doc = read_topo(control_dir)
    if doc is None:
        # transient read failure: do NOT latch the mtime — the next
        # poll must retry or this worker would miss the re-assignment
        return None
    state["mtime"] = st.st_mtime_ns
    if int(doc.get("seq", 0)) <= int(state.get("seq", 0)):
        return None
    state["seq"] = int(doc.get("seq", 0))
    return doc


def write_shard_plan(control_dir: str, n_shards: int,
                     verdict: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Record the engine's shard split/merge decision as a PLAN: the
    next sharded-server generation reads it through
    :func:`planned_shards`.  Shard moves rehash the whole key space, so
    they are never applied to a live generation."""
    return update_topo(control_dir, shards=int(n_shards),
                       shard_verdict=verdict or {})


def planned_shards(control_dir: Optional[str], default: int) -> int:
    """The shard count the next server generation should boot with:
    the planned value when a topo document carries one, else
    ``default`` (the cfg value).  Clamped to >= 1."""
    if control_dir:
        doc = read_topo(control_dir)
        if doc is not None and "shards" in doc:
            try:
                return max(1, int(doc["shards"]))
            except (TypeError, ValueError):
                pass
    return max(1, int(default))


# ---------------------------------------------------------------------------
# live hop feed (leaders' lineage sidecars -> anatomy advisor)
# ---------------------------------------------------------------------------


class HopTailer:
    """Offset-tracked tailer for the leaders' ``lineage-leader*.jsonl``
    sidecars: each ``poll()`` reads only the bytes appended since the
    last one, parses complete lines (a torn tail line is left for the
    next poll), and hands every row to ``sink`` — normally
    ``RoundAnatomy.observe_hop``, which itself filters for hop rows."""

    def __init__(self, dir: str, sink: Callable[[Dict[str, Any]], Any],
                 pattern: str = "lineage-leader*.jsonl"):
        self.dir = dir
        self.sink = sink
        self.pattern = pattern
        self._offsets: Dict[str, int] = {}
        self.rows = 0

    def poll(self) -> int:
        """Drain new complete rows from every matching sidecar; returns
        the number of rows fed this call. Sink exceptions are swallowed
        (a malformed row must not take down the serve loop's tick)."""
        fed = 0
        for path in sorted(glob.glob(os.path.join(self.dir,
                                                  self.pattern))):
            off = self._offsets.get(path, 0)
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(1 << 20)
            except OSError:
                continue
            if not chunk:
                continue
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue  # torn tail only; re-read next poll
            self._offsets[path] = off + last_nl + 1
            for line in chunk[:last_nl].splitlines():
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(row, dict):
                    continue
                try:
                    self.sink(row)
                except Exception:
                    pass
                fed += 1
        self.rows += fed
        return fed


# ---------------------------------------------------------------------------
# tree re-planning (group split / merge)
# ---------------------------------------------------------------------------


class TreeTopoActuator:
    """Carries the engine's ``group_replan``/``group_merge`` actions
    out inside ``run_tree``.  Owns no policy: which group is hot, the
    cooldowns, and the latch all live in the engine; this class only
    splits/merges membership through the supervisor's own lists.

    Split protocol (all asynchronous — nothing here blocks the serve
    thread):

    1. ``request_replan(verdict)`` spawns a new leader for the LATER
       half of the hot group's members (port 0 — the pin happens at
       first respawn like any boot leader) and parks it as pending.
    2. ``pump()`` (called from the supervisor's ``on_tick``) reaps the
       hello without blocking.  On hello: the new leader joins the
       ``leaders``/``leader_ports``/``respawns`` lists (so the existing
       rc!=0 respawn loop supervises it), the group lists are updated,
       and the re-assignment map is published through
       ``control-topo.json`` for the moved members' next topo poll.
    3. Moved members ``repoint`` to the new leader; the old leader's
       degrade/flush machinery folds their queued pushes, then marks
       them dead — every acked push is composed exactly once.

    Merge reassigns the members back and empties the split group; the
    split leader idle-exits rc 0 (never respawned) and its group slot
    is recycled by the next split, keeping the root's spare-wid
    headroom bounded by ``replan_max``.
    """

    def __init__(self, *, cfg: Dict[str, Any], groups: List[List[int]],
                 leaders: List[Any], leader_ports: List[int],
                 leader_addrs: List[str], respawns: List[int],
                 root_addr: str, control_dir: Optional[str] = None,
                 leader_env: Optional[Dict[str, str]] = None,
                 spawn_fn: Optional[Callable[..., Any]] = None):
        self.cfg = cfg
        self.groups = groups
        self.leaders = leaders
        self.leader_ports = leader_ports
        self.leader_addrs = leader_addrs
        self.respawns = respawns
        self.root_addr = root_addr
        self.control_dir = control_dir or cfg.get("control_dir") \
            or cfg.get("telemetry_dir")
        self.leader_env = leader_env
        self._spawn = spawn_fn
        self._pending: Optional[Dict[str, Any]] = None
        self._split: Optional[Dict[str, Any]] = None
        self._free_gids: List[int] = []
        self.events: List[Dict[str, Any]] = []

    # -- requests (called from the controller's execute path) -------------
    def request_replan(self, verdict: Dict[str, Any]) -> bool:
        """Begin splitting the group the verdict names. Returns False
        (and records why) when the request cannot be honored — a split
        already pending/active, an unknown group, or one too small to
        split; the engine's action row stands either way (replay sees
        the decision, ``exec`` truth lives in the event rows)."""
        if self._pending is not None or self._split is not None:
            self._event("replan_skipped", reason="split_active")
            return False
        gid = int(verdict.get("group", -1))
        if not (0 <= gid < len(self.groups)) or len(self.groups[gid]) < 2:
            self._event("replan_skipped", reason="bad_group", group=gid)
            return False
        members = list(self.groups[gid])
        stay, moved = members[:len(members) // 2], \
            members[len(members) // 2:]
        new_gid = self._free_gids.pop() if self._free_gids \
            else len(self.groups)
        if self._spawn is None:
            from pytorch_ps_mpi_tpu_torch.parallel.tree import spawn_leader
            self._spawn = spawn_leader
        try:
            proc = self._spawn([self.root_addr], new_gid, moved, self.cfg,
                               env=self.leader_env)
        except Exception as e:
            if new_gid < len(self.groups):
                self._free_gids.append(new_gid)
            self._event("replan_failed", reason=f"spawn: {e}", group=gid)
            return False
        self._pending = {"proc": proc, "gid": new_gid, "from": gid,
                         "stay": stay, "moved": moved,
                         "verdict": verdict, "t0": time.time()}
        self._event("replan_spawned", group=gid, new_group=new_gid,
                    moved=list(moved), verdict=verdict)
        return True

    def request_merge(self, verdict: Dict[str, Any]) -> bool:
        """Reverse the active split: moved members repoint back to
        their original leader; the split leader idle-exits clean."""
        sp = self._split
        if sp is None:
            self._event("merge_skipped", reason="no_split")
            return False
        src = int(sp["from"])
        self.groups[src] = list(sp["stay"]) + list(sp["moved"])
        self.groups[sp["gid"]] = []
        self._free_gids.append(int(sp["gid"]))
        if self.control_dir:
            update_topo(self.control_dir,
                        assign={str(w): self.leader_addrs[src]
                                for w in sp["moved"]})
        self._event("merged", group=src, from_group=sp["gid"],
                    moved=list(sp["moved"]), verdict=verdict)
        self._split = None
        return True

    # -- supervisor tick ---------------------------------------------------
    def pump(self) -> None:
        """Non-blocking: reap a pending split leader's hello and, once
        it arrives, commit the membership change. Safe to call every
        serve-loop tick."""
        p = self._pending
        if p is None:
            return
        proc = p["proc"]
        if proc.poll() is not None:
            self._pending = None
            if int(p["gid"]) < len(self.groups):
                self._free_gids.append(int(p["gid"]))
            self._event("replan_failed", reason=f"rc={proc.returncode}",
                        group=p["from"])
            return
        if proc.stdout is None:
            return
        try:
            r, _, _ = select.select([proc.stdout], [], [], 0)
        except (OSError, ValueError):
            return
        if not r:
            if time.time() - p["t0"] > 120.0:
                self._pending = None
                try:
                    proc.terminate()
                except Exception:
                    pass
                self._event("replan_failed", reason="hello_timeout",
                            group=p["from"])
            return
        line = proc.stdout.readline()
        if not line:
            return
        try:
            hello = json.loads(line)
        except ValueError:
            return
        addr = hello["addr"]
        port = 0 if addr.startswith("shm:") \
            else int(addr.rsplit(":", 1)[1])
        gid, src = int(p["gid"]), int(p["from"])
        if gid == len(self.groups):  # fresh slot
            self.groups.append(list(p["moved"]))
            self.leaders.append(proc)
            self.leader_addrs.append(addr)
            self.leader_ports.append(port)
            self.respawns.append(0)
        else:  # recycled slot from an earlier merge
            self.groups[gid] = list(p["moved"])
            self.leaders[gid] = proc
            self.leader_addrs[gid] = addr
            self.leader_ports[gid] = port
            self.respawns[gid] = 0
        self.groups[src] = list(p["stay"])
        if self.control_dir:
            update_topo(self.control_dir,
                        assign={str(w): addr for w in p["moved"]})
        self._split = {"gid": gid, "from": src, "stay": p["stay"],
                       "moved": p["moved"], "addr": addr}
        self._pending = None
        self._event("replanned", group=src, new_group=gid, addr=addr,
                    moved=list(p["moved"]), verdict=p["verdict"])

    # -- surfaces ----------------------------------------------------------
    @property
    def active_groups(self) -> int:
        return sum(1 for g in self.groups if g)

    @property
    def split_active(self) -> bool:
        return self._split is not None or self._pending is not None

    def _event(self, act: str, **fields: Any) -> None:
        row = {"t": time.time(), "act": act, **fields}
        self.events.append(row)
        if self.control_dir:
            try:
                from pytorch_ps_mpi_tpu_torch.control.controller import (
                    actions_path,
                )

                with open(actions_path(self.control_dir, "topo"),
                          "a") as f:
                    f.write(json.dumps(row, sort_keys=True) + "\n")
            except OSError:
                pass


# ---------------------------------------------------------------------------
# elastic read tier (replica scale-out / scale-in)
# ---------------------------------------------------------------------------

#: the port's read-only server, run as a module of this checkout
_SERVE_READONLY = "pytorch_ps_mpi_tpu_torch.serve_readonly"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaScaler:
    """Spawns and retires ``serve_readonly --follow-endpoint`` replica
    processes (``python -m pytorch_ps_mpi_tpu_torch.serve_readonly``,
    on the CPU: a replica holds host snapshots only) to track the engine's replica target.  A replica
    self-registers its fleet card (``replica-<pid>``) and subscribes to
    the upstream endpoint it is handed; retirement is LIFO — newest
    replica first — and removes the fleet card *before* terminating the
    process so the pane never polls a corpse."""

    def __init__(self, host: str, port: int, *, dir: Optional[str] = None,
                 fleet_dir: Optional[str] = None,
                 extra_args: Optional[List[str]] = None):
        self.host = host
        self.port = int(port)
        self.dir = dir
        self.fleet_dir = fleet_dir
        self.extra_args = list(extra_args or ())
        self.procs: List[Any] = []
        self.events: List[Dict[str, Any]] = []

    # split out so tests can fake the process boundary
    def _spawn_replica(self) -> Any:
        cmd = [sys.executable, "-m", _SERVE_READONLY,
               "--follow-endpoint", f"{self.host}:{self.port}",
               "--read-port", "0"]
        if self.fleet_dir:
            # the fleet card rides the replica's own /metrics endpoint —
            # without an HTTP port the card is never registered
            cmd += ["--fleet-dir", self.fleet_dir, "--metrics-port", "0"]
        if self.dir:
            cmd += ["--control-dir", self.dir]
        cmd += self.extra_args
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        env.setdefault("OMP_NUM_THREADS", "1")
        env["PS_PLATFORM"] = "cpu"  # a replica holds host snapshots
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)

    def _retire_replica(self, proc: Any) -> None:
        if self.fleet_dir is not None and proc.pid is not None:
            try:
                from pytorch_ps_mpi_tpu_torch.telemetry.fleet import (
                    deregister_endpoint,
                )

                deregister_endpoint(self.fleet_dir,
                                    f"replica-{proc.pid}")
            except Exception:
                pass
        try:
            proc.terminate()
        except Exception:
            pass

    def _prune(self) -> None:
        self.procs = [p for p in self.procs if p.poll() is None]

    @property
    def live(self) -> int:
        self._prune()
        return len(self.procs)

    def scale_to(self, n: int, verdict: Optional[Dict[str, Any]] = None
                 ) -> int:
        """Spawn/retire until ``live == n`` (clamped >= 0). Returns the
        resulting live count; each transition appends one event row."""
        n = max(0, int(n))
        self._prune()
        while len(self.procs) < n:
            proc = self._spawn_replica()
            self.procs.append(proc)
            self.events.append({"t": time.time(), "act": "spawn",
                                "pid": proc.pid, "n": len(self.procs),
                                "verdict": verdict or {}})
        while len(self.procs) > n:
            proc = self.procs.pop()
            self._retire_replica(proc)
            self.events.append({"t": time.time(), "act": "retire",
                                "pid": proc.pid, "n": len(self.procs),
                                "verdict": verdict or {}})
        return len(self.procs)

    def hellos(self, timeout: float = 30.0) -> List[Dict[str, Any]]:
        """Block (bounded) until every live replica has printed its
        hello; returns the parsed hello docs. A smoke/test convenience
        — the controller itself never waits on replica boot."""
        out = []
        deadline = time.time() + timeout
        for p in list(self.procs):
            if getattr(p, "_hello", None) is not None:
                out.append(p._hello)
                continue
            if p.stdout is None:
                continue
            while time.time() < deadline:
                r, _, _ = select.select([p.stdout], [], [], 0.25)
                if r:
                    line = p.stdout.readline()
                    if line:
                        try:
                            p._hello = json.loads(line)
                            out.append(p._hello)
                        except ValueError:
                            continue
                        break
                if p.poll() is not None:
                    break
        return out

    def close(self) -> None:
        while self.procs:
            self._retire_replica(self.procs.pop())

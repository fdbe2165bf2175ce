"""Keep an async PS job alive through worker and server death
(``pytorch_ps_mpi_tpu/resilience/supervisor.py``).

:class:`Supervisor` owns the server's lifecycle and watches the fleet:

- it builds the server from the job's ``cfg`` (shm or TCP; the TCP port
  is pinned after the first bind, so workers always reach the same
  address), runs :func:`serve`, and when the serve loop crashes
  (:class:`InjectedServerCrash`, or a transport or checkpoint error)
  closes that server, which releases its tensors, its shm segment and
  its port, and starts a new one with ``resume=True`` from the checkpoint
  cadence: the publish version stays monotonic by the crash-window jump;
- from inside the serve loop (``on_tick``: no second thread touches the
  native handles) it respawns a worker that exited non-zero, with the
  same id, after clearing its shm mailbox and marking its crash fault
  fired so a deterministic plan cannot crash-loop the replacement; a
  worker past ``max_worker_respawns`` is abandoned;
- it stops when every worker has exited cleanly or been abandoned and
  the queue has drained (``stop_when``): drop, duplicate and corrupt
  faults make exact push counts unknowable.

The counters of each retiring server are absorbed into the run's totals.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from pytorch_ps_mpi_tpu_torch.resilience.faults import InjectedServerCrash
from pytorch_ps_mpi_tpu_torch.telemetry.recorder import record_event

Tree = Any


class _WorkerRec:
    __slots__ = ("wid", "proc", "spawned_at", "respawns", "done",
                 "abandoned")

    def __init__(self, wid: int, proc, now: float):
        self.wid = wid
        self.proc = proc
        self.spawned_at = now
        self.respawns = 0
        self.done = False
        self.abandoned = False


class Supervisor:
    """Run one supervised async-PS job to completion. ``cfg`` is the
    shared job cfg (:func:`make_problem`'s keys and the transport, codec,
    resilience and fault keys); the supervisor keeps its
    ``fault_fired`` list across respawns and restarts."""

    def __init__(self, cfg: Dict[str, Any], n_workers: int, *,
                 shm_name: Optional[str] = None, port: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 10,
                 sync_barrier: bool = False,
                 timeout: float = 300.0,
                 max_worker_respawns: int = 3,
                 max_server_restarts: int = 3,
                 straggler_timeout: float = 5.0):
        import os

        self.cfg = dict(cfg)
        self.cfg.setdefault("fault_fired", [])
        if self.cfg.get("resilient"):
            # a failover shows only when a push times out: short op
            # timeouts, the retry loop supplies the patience
            self.cfg.setdefault("push_timeout", 10.0)
        self.n_workers = int(n_workers)
        self.transport = self.cfg.get("transport", "shm")
        self.shm_name = shm_name or f"/psq_sup_torch_{os.getpid()}"
        self._port = int(port)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.sync_barrier = bool(sync_barrier)
        self.timeout = float(timeout)
        self.max_worker_respawns = int(max_worker_respawns)
        self.max_server_restarts = int(max_server_restarts)
        self.straggler_timeout = float(straggler_timeout)
        self.worker_respawns = 0
        self.server_restarts = 0
        self.worker_reconnects = 0
        self.phase_versions: List[int] = []
        self._recs: Dict[int, _WorkerRec] = {}
        self._reconnect_credit: set = set()
        # run totals across server generations
        self._rejected_by_worker: Dict[int, int] = {}
        self._rejected_total = 0
        self._reject_reasons: Dict[str, int] = {}
        self._grads_received = 0
        self._decodes_done = 0
        self.recovery_times: Dict[str, List[float]] = {
            "worker_respawn_s": [], "server_restart_s": []}
        self._respawn_watch: Dict[int, float] = {}
        self._restart_watch: Optional[float] = None

    # -- the server's lifecycle ---------------------------------------------
    def _make_server(self, template: Tree):
        from pytorch_ps_mpi_tpu_torch.parallel.async_train import _codec

        kw = dict(num_workers=self.n_workers, template=template,
                  max_staleness=int(self.cfg.get("max_staleness", 4)),
                  code=_codec(self.cfg),
                  bucket_mb=float(self.cfg.get("bucket_mb", 0.0)),
                  frame=bool(self.cfg.get("frame_check")),
                  device=self.cfg.get("device", "cuda"))
        if self.transport == "tcp":
            from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer

            server = TcpPSServer(self._port, **kw)
            self._port = server.port  # replacements bind the same port
            return server
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer

        return ShmPSServer(self.shm_name, **kw)

    def _absorb_server_counts(self, server) -> None:
        """Fold a retiring server's counters into the run's totals."""
        for w, n in server.frames_rejected.items():
            self._rejected_by_worker[w] = (
                self._rejected_by_worker.get(w, 0) + int(n))
        self._rejected_total += int(server.frames_rejected_total)
        for r, n in server.__dict__.get("reject_reasons", {}).items():
            self._reject_reasons[r] = self._reject_reasons.get(r, 0) + n
        self._grads_received += int(server.grads_received)
        self._decodes_done += int(server.decodes_done)

    def addr(self) -> str:
        """The address workers connect to, stable across restarts."""
        if self.transport == "tcp":
            return f"127.0.0.1:{self._port}"
        return self.shm_name

    # -- the workers' lifecycle ---------------------------------------------
    def _spawn(self, wid: int) -> None:
        from pytorch_ps_mpi_tpu_torch.parallel.async_train import \
            spawn_worker

        cfg = dict(self.cfg)
        cfg["fault_fired"] = sorted(self.cfg["fault_fired"])
        proc = spawn_worker(self.addr(), wid, cfg)
        now = time.time()
        if wid in self._recs:
            self._recs[wid].proc = proc
            self._recs[wid].spawned_at = now
        else:
            self._recs[wid] = _WorkerRec(wid, proc, now)

    def _mark_crash_fault_fired(self, wid: int) -> None:
        """The earliest unfired crash fault of ``wid`` is marked fired:
        its replacement restarts at step 0."""
        fired = set(self.cfg["fault_fired"])
        plan = list(self.cfg.get("fault_plan", ()))
        crashes = sorted(
            (f for f in plan if f.get("kind") == "crash_worker"
             and int(f.get("worker", -1)) == wid),
            key=lambda f: int(f["at_step"]))
        for f in crashes:
            fid = int(f.get("id", plan.index(f)))
            if fid not in fired:
                fired.add(fid)
                break
        self.cfg["fault_fired"] = sorted(fired)

    def _tick(self, server) -> None:
        """Respawn dead workers and note post-restart reconnects; called
        from inside the serve loop."""
        for rec in self._recs.values():
            if rec.done or rec.abandoned:
                continue
            rc = rec.proc.poll()
            if rc is None:
                continue
            if rc == 0:
                rec.done = True
                self._reconnect_credit.discard(rec.wid)
                continue
            if rec.respawns >= self.max_worker_respawns:
                rec.abandoned = True
                record_event("supervisor.worker_abandoned", worker=rec.wid,
                             exit_code=rc)
                continue
            self._mark_crash_fault_fired(rec.wid)
            if hasattr(server, "reset_worker_slot"):
                try:
                    server.reset_worker_slot(rec.wid)
                except Exception:
                    pass  # the slot is clean, or the segment replaced
            rec.respawns += 1
            self.worker_respawns += 1
            self._reconnect_credit.discard(rec.wid)
            record_event("supervisor.worker_respawn", worker=rec.wid,
                         exit_code=rc, respawns=rec.respawns)
            self._spawn(rec.wid)
            self._respawn_watch[rec.wid] = time.time()
        for wid, t0 in list(self._respawn_watch.items()):
            seen = server.last_seen.get(wid, 0.0)
            if seen > t0:  # the replacement's first frame landed
                self.recovery_times["worker_respawn_s"].append(seen - t0)
                del self._respawn_watch[wid]
        if self._restart_watch is not None and server.grads_received > 0:
            self.recovery_times["server_restart_s"].append(
                time.time() - self._restart_watch)
            self._restart_watch = None
        for wid in sorted(self._reconnect_credit):
            if wid in server.last_seen:
                self._reconnect_credit.discard(wid)
                self.worker_reconnects += 1
                record_event("supervisor.worker_reconnected", worker=wid)

    def _workers_done(self) -> bool:
        return all(r.done or r.abandoned for r in self._recs.values())

    def _ckpt_exists(self) -> bool:
        if not self.checkpoint_dir:
            return False
        from pytorch_ps_mpi_tpu_torch.utils.checkpoint import \
            CheckpointManager

        return CheckpointManager(self.checkpoint_dir).latest_step() \
            is not None

    # -- the supervised run ---------------------------------------------------
    def run(self) -> Tuple[Tree, Dict[str, Any]]:
        """Serve, and serve again across server crashes, until every
        worker finished: ``(params, metrics)``, the last serve phase's
        metrics with the run's recovery totals."""
        from pytorch_ps_mpi_tpu_torch.parallel.async_train import (
            join_workers, make_problem, serve)

        device = self.cfg.get("device", "cuda")
        prob = make_problem(self.cfg, device)
        template = prob.template
        deadline = time.time() + self.timeout
        resume = bool(self.cfg.get("resume"))
        # the run's first loss: a crash loses the first phase's metrics
        run_loss_initial = None
        if not (resume and self._ckpt_exists()):
            run_loss_initial = prob.eval_loss()
        del prob
        params, metrics, phases = None, {}, 0
        try:
            while True:
                server = self._make_server(template)
                if not self._recs:  # the first phase launches the fleet
                    for wid in range(self.n_workers):
                        self._spawn(wid)
                try:
                    params, metrics = serve(
                        server, self.cfg, total_grads=10**18,
                        sync_barrier=self.sync_barrier,
                        timeout=max(1.0, deadline - time.time()),
                        checkpoint_dir=self.checkpoint_dir,
                        checkpoint_every=self.checkpoint_every,
                        resume=resume and self._ckpt_exists(),
                        on_tick=lambda: self._tick(server),
                        stop_when=self._workers_done)
                    phases += 1
                    self.phase_versions.append(int(server.version))
                    break
                except (InjectedServerCrash, RuntimeError, OSError) as e:
                    phases += 1
                    self.phase_versions.append(int(server.version))
                    if isinstance(e, InjectedServerCrash):
                        self.cfg["fault_fired"] = sorted(
                            set(self.cfg["fault_fired"]) | {e.fault["id"]})
                    self.server_restarts += 1
                    self._reconnect_credit = {
                        r.wid for r in self._recs.values()
                        if not (r.done or r.abandoned)}
                    self._restart_watch = time.time()
                    resume = True
                    record_event("supervisor.server_restart",
                                 fault_id=getattr(e, "fault", {}).get("id"),
                                 error=str(e),
                                 restarts=self.server_restarts)
                    if self.server_restarts > self.max_server_restarts:
                        raise
                    if not self.checkpoint_dir:
                        raise RuntimeError(
                            "the server crashed and no checkpoint_dir is "
                            "set: nothing to restart from") from e
                finally:
                    self._absorb_server_counts(server)
                    server.close()
                if time.time() > deadline:
                    raise TimeoutError("the supervised run passed its "
                                       "deadline")
        except BaseException:
            # never leak the fleet on a failed run
            join_workers([r.proc for r in self._recs.values()], timeout=5.0)
            raise
        exit_codes = join_workers([r.proc for r in self._recs.values()],
                                  timeout=max(1.0, deadline - time.time()))
        metrics = dict(metrics)
        metrics.update(
            worker_respawns=float(self.worker_respawns),
            server_restarts=float(self.server_restarts),
            worker_reconnects=float(self.worker_reconnects),
            workers_abandoned=float(
                sum(1 for r in self._recs.values() if r.abandoned)),
            supervised_phases=float(phases),
            worker_exit_codes=exit_codes,
            versions_monotonic=all(b > a for a, b in zip(
                self.phase_versions, self.phase_versions[1:])),
            frames_rejected=float(self._rejected_total),
            frames_rejected_by_worker=dict(self._rejected_by_worker),
            reject_reasons_all_phases=dict(self._reject_reasons),
            grads_received_all_phases=float(self._grads_received),
            decodes_done_all_phases=float(self._decodes_done),
            recovery_times={k: [round(v, 3) for v in vs]
                            for k, vs in self.recovery_times.items()})
        if run_loss_initial is not None:
            metrics["run_loss_initial"] = run_loss_initial
        return params, metrics

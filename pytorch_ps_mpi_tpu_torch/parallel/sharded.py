"""Sharded parameter servers (``pytorch_ps_mpi_tpu/parallel/sharded.py``).

Li et al.'s key-sharded parameter server (OSDI'14): the flat parameter
vector (the JAX leaves in order and layout, ``dcn.flatten_params``) is
split into S contiguous slices, and each slice has its own server
process over the TCP wire. A shard server keeps its slice and its
optimizer state on the card, decodes each push there and publishes
with one D2H. A worker computes its gradient on the card, flattens it
there in the same order, slices it by :func:`shard_plan`, encodes each
slice on the card and pushes it to its shard, tagged with that shard's
snapshot version: each shard advances its own version, so the versions a
worker reads may disagree across shards.

SGD (with momentum) and Adam are elementwise, so a slice's update is the
whole vector's update on that slice: sharding changes where the state
lives, never the math (a 1-shard and a 2-shard run from the same seed
agree when run synchronously).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Any

def shard_plan(n_total: int, n_shards: int) -> List[Tuple[int, int]]:
    """Balanced contiguous [start, stop) slices of a length-``n_total``
    vector; earlier shards take the remainder (sizes differ by <= 1)."""
    if not 1 <= n_shards <= n_total:
        raise ValueError(f"need 1 <= n_shards <= {n_total}, got {n_shards}")
    base, rem = divmod(n_total, n_shards)
    plan, start = [], 0
    for s in range(n_shards):
        stop = start + base + (1 if s < rem else 0)
        plan.append((start, stop))
        start = stop
    return plan


def planned_shards(control_dir: Optional[str], default: int) -> int:
    """The shard count a new server generation boots with
    (``sharded.py:62``): the controller's split or merge plan in
    ``control_dir``'s ``control-topo.json`` (a plan, never applied to a
    live generation: a shard move rehashes the key space), else
    ``default``."""
    from pytorch_ps_mpi_tpu_torch.control.topo import \
        planned_shards as _planned

    return _planned(control_dir, default)


def _slice_template(n: int) -> Tree:
    return {"flat": np.zeros((n,), np.float32)}


def _codec(cfg: Dict[str, Any]):
    from pytorch_ps_mpi_tpu_torch.parallel.async_train import _codec as c

    return c(cfg)


def server_main(shard_id: int, n_shards: int, port: int,
                cfg: Dict[str, Any], out_path: str) -> None:
    """One shard server's process body (``sharded.py:78``): own slice
    ``shard_id``, apply the updates in arrival order with shard-local
    bounded staleness, and at the end write the final slice and the
    metrics to ``out_path`` (.npz). It stops after consuming the fleet's
    pushes (one a worker a step; in tree mode, the composed count).
    ``cfg["server_slow_ms"][str(shard_id)]`` sleeps after each update (a
    slow shard). With ``cfg["checkpoint_dir"]`` the shard saves its slice
    and optimizer state under ``<dir>/shard<i>`` every
    ``cfg["checkpoint_every"]`` applied updates; ``cfg["resume"]``
    restores them with the crash-window version jump. With
    ``cfg["idle_share"]`` the card's idle share from the first push on is
    measured (:class:`IdleMeter`). With ``cfg["serving"]`` or
    ``cfg["read_port"]`` the shard serves its slice through a read tier
    of its own under the tenant ``shard<i>`` (``sharded.py:178-248``): the
    read port is always picked free (S shards share a host) and printed
    in the hello line as ``read_port``.

    Per-shard telemetry (``sharded.py:143-200``): ``health``,
    ``health_dir``, ``health_port`` or ``metrics_port`` arm the shard's
    own :class:`HealthMonitor`, and a port its own ``/metrics`` and
    ``/health`` endpoint, always on a free port, printed in the hello
    line as ``health_port``; ``lineage`` on a framed wire bills each of
    the shard's versions to its pushes (``lineage-shard<i>.jsonl``) with
    the round anatomy (``anatomy-shard<i>.jsonl``); ``freshness`` and
    ``hop_anatomy`` go through ``arm_observability``, as do the history,
    SLO and profiler keys and, with ``fleet_dir``, the shard's fleet card
    (``shard<i>``, role ``shard``; a free endpoint is bound for it). The
    controller (``control``/``control_kw``/``control_dir``) runs its
    per-worker and read-tier rules on the shard's own verdicts
    (``control-shard<i>.jsonl``), its codec rule off. The metrics file
    then carries ``health``, ``lineage``, ``slo`` and ``control``."""
    from pytorch_ps_mpi_tpu_torch.mesh import resolve_device
    from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer
    from pytorch_ps_mpi_tpu_torch.serving import ServingCore

    device = resolve_device(cfg.get("device", "cuda"))
    prob = at.make_problem(cfg, device)
    flat0 = prob.flat_params()
    start, stop = shard_plan(flat0.numel(), n_shards)[shard_id]
    flat = flat0[start:stop].clone()
    del prob, flat0
    params = {"flat": flat}
    hyper_cls, init_state, update_fn = OPTIMIZERS[cfg.get("optim", "sgd")]
    h = hyper_cls(**cfg.get("hyper", {"lr": 0.05}))
    state = init_state(params)
    n_workers = int(cfg["n_workers"])
    expected = sum(at.worker_cfg(cfg, w)[1] for w in range(n_workers))
    slow = cfg.get("server_slow_ms")
    slow_ms = float(slow.get(str(shard_id), 0.0)) \
        if isinstance(slow, dict) else 0.0
    # tree composition: the pushers are group leaders past n_workers
    tree_mode = bool(cfg.get("tree"))
    tree_slots = int(cfg.get("tree_slots", 0) or 0) if tree_mode else 0
    id_space = n_workers + len(cfg.get("tree_members") or ())
    server = TcpPSServer(port, num_workers=id_space,
                         template=_slice_template(stop - start),
                         max_staleness=int(cfg.get("max_staleness", 4)),
                         code=_codec(cfg), frame=bool(cfg.get("frame_check")),
                         tree_slots=tree_slots, device=device)
    ckpt, applied_before = None, 0
    checkpoint_every = int(cfg.get("checkpoint_every", 50))
    if cfg.get("resume") and not cfg.get("checkpoint_dir"):
        raise ValueError("cfg['resume'] requires cfg['checkpoint_dir']")
    if cfg.get("checkpoint_dir"):
        from pytorch_ps_mpi_tpu_torch.utils.checkpoint import \
            CheckpointManager

        ckpt = CheckpointManager(os.path.join(cfg["checkpoint_dir"],
                                              f"shard{shard_id}"))
        if cfg.get("resume"):
            restored, applied_before, server.version = \
                at._restore_ps_checkpoint(
                    ckpt, {"flat": flat, "opt_state": state, "version": 0,
                           "applied_total": 0, "checkpoint_every": 0},
                    checkpoint_every)
            flat.copy_(restored["flat"])
            state = restored["opt_state"]
    # per-shard diagnosis: S shards cannot share one pinned port, so the
    # endpoint's port is picked free and rides the hello line
    monitor = health_port = None
    if (cfg.get("health") or cfg.get("health_dir")
            or cfg.get("health_port") is not None
            or cfg.get("metrics_port") is not None):
        from pytorch_ps_mpi_tpu_torch.telemetry.diagnosis import \
            HealthMonitor

        monitor = HealthMonitor(server, cfg)
        if (cfg.get("health_port") is not None
                or cfg.get("metrics_port") is not None):
            health_port = server.start_metrics_http(0)
    # per-shard lineage: staleness is shard-local, so lineage is too
    tracker = None
    if ((cfg.get("lineage") or cfg.get("lineage_dir"))
            and cfg.get("frame_check")):
        from pytorch_ps_mpi_tpu_torch.telemetry.lineage import \
            LineageTracker

        tracker = LineageTracker(server, cfg, name=f"shard{shard_id}")
        if cfg.get("anatomy", "auto") not in (False, "off", 0):
            from pytorch_ps_mpi_tpu_torch.telemetry.anatomy import \
                RoundAnatomy

            tracker.anatomy = RoundAnatomy(server, cfg,
                                           name=f"shard{shard_id}")
    scfg = dict(cfg)
    if cfg.get("read_port") is not None:
        scfg["read_port"] = 0
    # the shard's monitors are its own (built above)
    core = ServingCore(server, scfg, tenant=f"shard{shard_id}",
                       monitors=False)
    # the shard's fleet plane (``sharded.py:195-221``): history, SLO and
    # profiler, and with a fleet_dir this shard's card under shard<i> (a
    # restarted shard rejoins under its name), which needs a live
    # endpoint; the controller's codec rule stays off, since one shard
    # cannot move the fleet's fingerprint alone
    if (cfg.get("fleet_dir") or cfg.get("fleet")) and health_port is None:
        health_port = server.start_metrics_http(0)
    ocfg = dict(cfg)
    ocfg["fleet_role"] = "shard"
    ocfg.pop("fleet_name", None)
    server.arm_observability(ocfg, name=f"shard{shard_id}")
    ctl = None
    if cfg.get("control") or cfg.get("control_kw") or cfg.get("control_dir"):
        from pytorch_ps_mpi_tpu_torch.control import Controller

        ctl = Controller(server, {**cfg, "control_kw": {
            **(cfg.get("control_kw") or {}), "ladder": None}},
            core=core, name=f"shard{shard_id}")
    # the coordinator reads the bound ports from this line
    hello = {"shard": shard_id, "port": server.port}
    if health_port is not None:
        hello["health_port"] = health_port
    if core.read_port is not None:
        hello["read_port"] = core.read_port
    print(json.dumps(hello), flush=True)
    times = {"update_s": 0.0, "publish_s": 0.0}

    def publish() -> None:
        t0 = time.perf_counter()
        core.publish_device(flat)
        times["publish_s"] += time.perf_counter() - t0

    launches0 = at.kernel_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    meter = at.IdleMeter(device) if cfg.get("idle_share") else None
    try:
        publish()
        applied = 0
        cadence = (at._PSCheckpointCadence(ckpt, checkpoint_every,
                                           applied_before) if ckpt else None)
        # a replacement server expects the whole job's pushes: workers
        # restart from step 0 beside it
        deadline = time.time() + float(cfg.get("server_timeout", 300.0))

        def consumed() -> int:
            return server.tree_composed if tree_mode else \
                server.grads_received

        next_tick = 0.0
        tick_s = float(cfg.get("tick_interval", at.TICK_S))
        while consumed() < expected and time.time() < deadline:
            now = time.monotonic()
            if now >= next_tick:
                next_tick = now + tick_s
                if server.timeseries_db is not None:
                    server.observability_tick()  # history and SLO
                if ctl is not None:
                    ctl.tick()
            item = server.poll_grad()
            if item is None:
                time.sleep(0.0005)
                continue
            if meter is not None:
                meter.start()  # from the first push on
            wid, ver, grad = item
            staleness = max(0, server.version - ver)
            if monitor is not None:
                monitor.observe_grad(wid, staleness)
            if ctl is not None:
                ctl.observe_push(wid, staleness)
            up_t0 = time.perf_counter()
            g = grad["flat"]
            comp_n = 1
            if tree_slots:
                comp_n = (server._composed_queue.popleft()
                          if server._composed_queue else 1)
            wgt = ctl.push_weight(wid) if ctl is not None else 1.0
            if wgt != 1.0:
                g = g * wgt / comp_n  # the shard-local staleness weight
            elif comp_n > 1:
                g = g / comp_n  # a leader's frame: its group's mean
            t0 = time.perf_counter()
            _, state = update_fn(params, {"flat": g}, state, h)
            at._sync(device)
            times["update_s"] += time.perf_counter() - t0
            applied += 1
            if slow_ms:
                time.sleep(slow_ms / 1e3)
            server.grad_publishes += 1
            publish()
            if tracker is not None:
                tracker.observe_publish(server.version,
                                        time.perf_counter() - up_t0)
            if cadence:
                cadence.maybe_save({"flat": flat, "opt_state": state},
                                   server, applied_before + applied)
        idle = meter.stop() if meter is not None else {}
        if cadence:
            cadence.final_save({"flat": flat, "opt_state": state}, server,
                               applied_before + applied)
        m = server.metrics()
        np.savez(
            out_path, flat=flat.cpu().numpy(), start=start, stop=stop,
            version=server.version, applied_total=applied_before + applied,
            applied=applied, grads_received=m["grads_received"],
            stale_drops=m["stale_drops"], decodes_done=server.decodes_done,
            tree_composed=m["tree_composed"],
            compression_ratio=m["compression_ratio"],
            staleness_hist=json.dumps({int(k): int(v) for k, v in
                                       server.staleness_seen.items()}),
            launches=json.dumps({k: v - launches0[k] for k, v in
                                 at.kernel_launches().items()}),
            times=json.dumps(times), idle=json.dumps(idle),
            serving=json.dumps(core.serving_snapshot() if core.armed
                               else {}),
            health=(monitor.render_json() if monitor is not None else "{}"),
            lineage=json.dumps(tracker.snapshot()
                               if tracker is not None else {}),
            slo=json.dumps(server.slo_watchdog.snapshot()
                           if server.slo_watchdog is not None else {}),
            control=json.dumps(ctl.snapshot() if ctl is not None else {}),
            peak_bytes=at._peak_bytes(device))
    finally:
        if ctl is not None:
            ctl.close()
        if tracker is not None:
            if tracker.anatomy is not None:
                tracker.anatomy.close()
            tracker.close()
        server.close()


def worker_main_sharded(addrs: Sequence[str], worker_id: int,
                        cfg: Dict[str, Any],
                        out_path: Optional[str] = None) -> int:
    """A worker against S shard servers (``sharded.py:367``): each step
    reads every shard (one version each), loads the assembled vector
    with one H2D, computes the gradient, flattens it on the card, and
    pushes each slice, encoded on the card, to its shard tagged with that
    shard's version. Writes the steps, the largest version spread seen,
    its kernel launches, times and peak memory to ``out_path``."""
    from pytorch_ps_mpi_tpu_torch.mesh import resolve_device
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSWorker

    device = resolve_device(cfg.get("device", "cuda"))
    prob = at.make_problem(cfg, device)
    flat_n = sum(p.numel() for p in prob.params)
    plan = shard_plan(flat_n, len(addrs))
    timeout = float(cfg.get("open_timeout", 60.0))
    conns = []
    for (start, stop), addr in zip(plan, addrs):
        host, port = addr.rsplit(":", 1)
        tmpl = _slice_template(stop - start)

        def make_conn(host=host, port=int(port), tmpl=tmpl):
            return TcpPSWorker(host, port, worker_id, tmpl, code=_codec(cfg),
                               timeout=timeout,
                               frame=bool(cfg.get("frame_check")),
                               seed=int(cfg.get("seed", 0)), device=device)

        if cfg.get("resilient"):
            # each shard's connection recovers on its own
            from pytorch_ps_mpi_tpu_torch.resilience.worker import \
                ResilientWorker

            conns.append(ResilientWorker(
                make_conn, worker_id=worker_id,
                seed=int(cfg.get("fault_seed", cfg.get("seed", 0))),
                **cfg.get("resilience_kw", {})))
        else:
            conns.append(make_conn())
    slow_ms, steps = at.worker_cfg(cfg, worker_id)
    push_timeout = float(cfg.get("push_timeout", 60.0))
    host_flat = torch.empty(flat_n, dtype=torch.float32,
                            pin_memory=device.type == "cuda")
    times: Dict[str, list] = {"read_s": [], "grad_s": [], "encode_s": [],
                              "push_s": []}
    launches0 = at.kernel_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pushed = spread = 0
    try:
        for step in range(steps):
            t0 = time.perf_counter()
            versions = []
            for (start, stop), w in zip(plan, conns):
                sl, ver = w.read_flat(timeout=timeout)
                host_flat[start:stop] = torch.from_numpy(sl)
                versions.append(ver)
            spread = max(spread, max(versions) - min(versions))
            prob.load_flat(host_flat.to(device))
            t1 = time.perf_counter()
            _, grads = prob.grad_leaves(prob.batch_fn(step, worker_id))
            g_flat = torch.cat([g.reshape(-1) for g in grads])
            at._sync(device)
            t2 = time.perf_counter()
            if slow_ms:
                time.sleep(slow_ms / 1e3)
            enc = push = 0.0
            for (start, stop), ver, w in zip(plan, versions, conns):
                t3 = time.perf_counter()
                payload = w.encode([g_flat[start:stop]])
                t4 = time.perf_counter()
                # one push a shard a step: the step is its seq too
                w.push_payload(payload, ver, timeout=push_timeout,
                               lineage=(step, step))
                enc += t4 - t3
                push += time.perf_counter() - t4
            times["read_s"].append(t1 - t0)
            times["grad_s"].append(t2 - t1)
            times["encode_s"].append(enc)
            times["push_s"].append(push)
            pushed += 1
    finally:
        for w in conns:
            w.close()
    if out_path:
        Path(out_path).write_text(json.dumps({
            "worker": worker_id, "pushed": pushed,
            "max_version_spread": spread, **times,
            "launches": {k: v - launches0[k]
                         for k, v in at.kernel_launches().items()},
            "peak_bytes": at._peak_bytes(device)}))
    return pushed


def assemble(paths: Sequence[str], template: Tree) -> Tree:
    """The whole parameter tree from the shards' .npz files; raises
    unless the slices tile the flat vector exactly."""
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import (flat_size,
                                                       unflatten_params)

    flat = np.empty(flat_size(template), np.float32)
    covered = np.zeros(flat.size, bool)
    total = 0
    for p in paths:
        z = np.load(p, allow_pickle=False)
        start, stop = int(z["start"]), int(z["stop"])
        flat[start:stop] = z["flat"]
        covered[start:stop] = True
        total += stop - start
    if total != flat.size or not covered.all():
        raise ValueError(f"shards cover {int(covered.sum())} of "
                         f"{flat.size} elements in {total}")
    return unflatten_params(flat, template)


def spawn_shard_server(shard_id: int, n_shards: int, cfg: Dict[str, Any],
                       out_path: str,
                       env: Optional[Dict[str, str]] = None,
                       port: int = 0) -> subprocess.Popen:
    """``server_main`` in a fresh interpreter on ``port`` (0: a free
    one); it prints ``{"shard": i, "port": p}`` (:func:`read_server_port`).
    A port given up front lets its workers start beside it."""
    src = ("import json, sys\n"
           "from pytorch_ps_mpi_tpu_torch.parallel.sharded import "
           "server_main\n"
           "server_main(int(sys.argv[1]), int(sys.argv[2]), "
           "int(sys.argv[5]), json.loads(sys.argv[3]), sys.argv[4])\n")
    from pytorch_ps_mpi_tpu_torch.parallel.async_train import spawn_python

    return spawn_python(src, [str(shard_id), str(n_shards), json.dumps(cfg),
                              out_path, str(port)], env,
                        stdout=subprocess.PIPE)


def read_server_hello(proc, timeout: float = 120.0) -> Dict[str, Any]:
    """Block until a spawned shard server prints its hello line:
    ``{"shard": i, "port": p}``, with ``"read_port"`` when its read tier
    is armed."""
    import select

    deadline = time.time() + timeout
    while time.time() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 0.5)
        if r:
            line = proc.stdout.readline()
            if line:
                return json.loads(line)
        if proc.poll() is not None:
            raise RuntimeError(f"shard server exited early: "
                               f"{proc.returncode}")
    raise TimeoutError("shard server never reported its port")


def read_server_port(proc, timeout: float = 120.0) -> int:
    """Block until a spawned shard server prints its port line."""
    return int(read_server_hello(proc, timeout)["port"])


def spawn_sharded_worker(addrs: Sequence[str], worker_id: int,
                         cfg: Dict[str, Any], out_path: str,
                         env: Optional[Dict[str, str]] = None
                         ) -> subprocess.Popen:
    """``worker_main_sharded`` in a fresh interpreter."""
    src = ("import json, sys\n"
           "from pytorch_ps_mpi_tpu_torch.parallel.sharded import "
           "worker_main_sharded\n"
           "sys.exit(0 if worker_main_sharded(json.loads(sys.argv[1]), "
           "int(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4]) >= 0 "
           "else 1)\n")
    from pytorch_ps_mpi_tpu_torch.parallel.async_train import spawn_python

    return spawn_python(src, [json.dumps(list(addrs)), str(worker_id),
                              json.dumps(cfg), out_path], env)

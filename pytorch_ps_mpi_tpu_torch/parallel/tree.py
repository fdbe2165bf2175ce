"""Hierarchical aggregation: the parameter server as a tree
(``pytorch_ps_mpi_tpu/parallel/tree.py``).

Workers are split into groups, each with a leader process that

1. folds its group's payloads on the host with a :class:`WireAggregator`
   straight from the validated frame bytes, so no push is decoded
   mid-tree (the leader's ``decodes_done`` stays 0);
2. finalizes once a round, copies the aggregate to the card once, and
   re-encodes it there for the upstream hop behind per-hop error
   feedback (:class:`HopErrorFeedback`);
3. pushes one frame upstream, a frame a root shard, carrying the trace
   IDs of the worker pushes it composes in the frame's lineage trailer.

The leaf hop (worker -> leader) defaults to the ``identity`` codec, an
exact local reduce; the leader -> root hop takes ``cfg["codec"]``.
Leaders push group sums and the root divides each round by the total
composed count from the trailers, so degraded groups, ragged groups and
direct-to-root pushes all weight exactly. When a leader dies, its
group's :class:`TreeWorkerConn` pushes to the root directly, composing
itself, and probes the leader's pinned address to rejoin;
:func:`run_tree` respawns the leader on that port. With
``cfg["hop_anatomy"]`` a leader drains the native interval rings (the
TCP ingest's validate stamps, the host folds' spans) into its hop rows;
with ``cfg["topo_actions"]`` the controller at the root splits a hot
group behind a freshly spawned leader and merges it back
(:class:`~pytorch_ps_mpi_tpu_torch.control.topo.TreeTopoActuator`), the
moved workers repointing through ``control-topo.json``.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Any

#: the leader loop's knobs and their defaults (``cfg["leader_kw"]``)
LEADER_KNOBS: Dict[str, Any] = {
    "group_transport": "tcp",  # leaf-hop wire: "tcp" | "shm"
    "group_codec": "identity",  # leaf-hop codec (exact local reduce)
    "group_codec_kw": {},       # its constructor kwargs
    "read_poll_s": 0.02,        # upstream snapshot poll cadence
    "degrade_after": 3.0,       # round wait before excluding dead members
    "flush_after": 6.0,         # round wait before a partial fold
    "startup_grace": 120.0,     # member start-up window before idle exit
    "idle_exit_s": 3.0,         # quiet time (members gone) before exit
    "timeout": 600.0,           # the leader's lifetime bound
    "rejoin_every": 8,          # fallback pushes between leader probes
    "probe_timeout": 1.0,       # leader-probe connect timeout (fallback)
    "crash_at_round": None,     # test hook: os._exit before this round
    "max_respawns": 3,          # run_tree: a leader's respawn budget
}
#: a crashed leader's exit code
LEADER_CRASH_EXIT_CODE = 77


def group_plan(n_workers: int, group_size: int) -> List[List[int]]:
    """Worker ids 0..n-1 in contiguous groups of ``group_size`` (the last
    group takes the remainder, however small)."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    return [list(range(i, min(i + group_size, n_workers)))
            for i in range(0, n_workers, group_size)]


def leader_wid(n_workers: int, group_id: int) -> int:
    """The id a group's leader pushes upstream under: leaders take ids
    ``n_workers ..``, so leaf ids stay free for fallback pushes."""
    return int(n_workers) + int(group_id)


def tree_slot_capacity(n_workers: int, group_size: int) -> int:
    """The trailer capacity of every push to the root: the largest
    group's size."""
    return min(int(group_size), int(n_workers))


class _HopLog:
    """Buffered JSONL writer for ``lineage-leader<g>.jsonl`` (``tree.py:100``),
    the leader's half of cross-hop lineage: one ``hop`` row an upstream
    push (the composed trace IDs, the versions, the fold, encode and
    push seconds and the hop EF's probe), ``leader_consume`` rows marked
    ``lost`` for pushes that never went upstream, ``hop_partial`` for a
    round that reached some shards only, and ``upstream_lost``."""

    def __init__(self, dir: Optional[str], group_id: int,
                 flush_every: int = 32):
        self._f = None
        self._pending = 0
        self.flush_every = int(flush_every)
        if dir:
            os.makedirs(dir, exist_ok=True)
            self._f = open(
                os.path.join(dir, f"lineage-leader{group_id}.jsonl"), "a")

    def row(self, doc: Dict[str, Any]) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps(doc) + "\n")
        self._pending += 1
        if self._pending >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._f is not None and self._pending:
            self._f.flush()
            self._pending = 0

    def close(self) -> None:
        if self._f is not None:
            self.flush()
            self._f.close()
            self._f = None


def _leader_knobs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    kw = dict(LEADER_KNOBS)
    kw.update(cfg.get("leader_kw") or {})
    return kw


def _upstream_codec(cfg: Dict[str, Any]):
    from pytorch_ps_mpi_tpu_torch.parallel.async_train import _codec

    return _codec(cfg)


def _group_codec(kw: Dict[str, Any]):
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    return get_codec(kw["group_codec"], **(kw.get("group_codec_kw") or {}))


# -- the leader process --------------------------------------------------------

def leader_main(upstream: Sequence[str], group_id: int,
                group: Sequence[int], cfg: Dict[str, Any],
                port: int = 0) -> int:
    """One leader's process body (``tree.py:161``): a group-facing server
    (compressed ingest, no per-push decode), one upstream connection a
    root shard, and between them the fold, the card re-encode behind hop
    error feedback and one frame upstream a round. ``port`` pins the
    group server's port so a respawn is rejoinable. With
    ``cfg["stats_dir"]`` it writes ``leader-<g>-<pid>.json`` there (at
    exit, and before an injected crash): its upstream pushes, the trace
    IDs it lost, its decodes, kernel launches, stage times and peak
    memory. Returns the upstream pushes.

    Telemetry (``tree.py:240-300``): with ``cfg["lineage_dir"]`` or
    ``cfg["telemetry_dir"]`` the leader writes :class:`_HopLog`'s
    ``lineage-leader<g>.jsonl``; ``cfg["hop_anatomy"]`` arms a
    :class:`~pytorch_ps_mpi_tpu_torch.telemetry.hop_anatomy.HopAnatomy`
    fed one round of sub-stage seconds a push (``hop-leader<g>.jsonl``,
    which the root tails); ``metrics_port``/``health_port`` give the
    leader a ``/metrics`` endpoint of its own on a free port."""
    from pytorch_ps_mpi_tpu_torch.codecs.error_feedback import \
        HopErrorFeedback
    from pytorch_ps_mpi_tpu_torch.mesh import resolve_device
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer
    from pytorch_ps_mpi_tpu_torch.parallel.sharded import (_slice_template,
                                                           shard_plan)
    from pytorch_ps_mpi_tpu_torch.parallel.tcp import (TcpPSServer,
                                                       TcpPSWorker)
    from pytorch_ps_mpi_tpu_torch.resilience.faults import FaultInjector
    from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

    kw = _leader_knobs(cfg)
    device = resolve_device(cfg.get("device", "cuda"))
    group = [int(w) for w in group]
    n_workers = int(cfg["n_workers"])
    slots = int(cfg.get("tree_slots")
                or tree_slot_capacity(n_workers, len(group)))
    template = at.make_problem(cfg, device).template
    shapes = [tuple(np.shape(x)) for x in tree_flatten(template)[0]]
    lid = leader_wid(n_workers, group_id)
    stale = int(cfg.get("max_staleness", 4))
    if kw["group_transport"] == "shm":
        shm_name = f"/psq_tree_torch_{os.getppid()}_{group_id}"
        server = ShmPSServer(shm_name, n_workers, template,
                             max_staleness=stale, code=_group_codec(kw),
                             frame=True, device=device)
        addr = f"shm:{shm_name}"
    else:
        server = TcpPSServer(int(port), n_workers, template,
                             max_staleness=stale, code=_group_codec(kw),
                             frame=True, device=device)
        addr = f"127.0.0.1:{server.port}"
    gwire = server.wire
    if not gwire.agg_supported:
        raise ValueError(f"group codec {kw['group_codec']!r} has no "
                         "compressed-domain aggregation: a leader would "
                         "decode every push, which the tree forbids")
    sharded = len(upstream) > 1
    flat_n = sum(int(np.prod(s)) for s in shapes)
    plan = shard_plan(flat_n, len(upstream)) if sharded else [(0, flat_n)]
    conns: List[Any] = []
    hops: List[HopErrorFeedback] = []
    for (start, stop), a in zip(plan, upstream):
        host, p = a.rsplit(":", 1)
        c = TcpPSWorker(host, int(p), lid,
                        _slice_template(stop - start) if sharded
                        else template,
                        code=_upstream_codec(cfg),
                        timeout=float(cfg.get("open_timeout", 60.0)),
                        bucket_mb=(0.0 if sharded
                                   else float(cfg.get("bucket_mb", 0.0))),
                        frame=True, tree_slots=slots, device=device)
        conns.append(c)
        if c.wire is None:
            raise ValueError("the tree's upstream hop needs a codec wire "
                             "(cfg['codec']; 'identity' ships raw floats)")
        hops.append(HopErrorFeedback(c.wire,
                                     enabled=bool(cfg.get("hop_ef", True))))
    inj = FaultInjector.from_cfg(cfg, role=f"leader{group_id}")
    if (cfg.get("metrics_port") is not None
            or cfg.get("health_port") is not None):
        server.start_metrics_http(0)
    server.arm_observability(cfg, name=f"leader{group_id}")
    # the hop's sub-stages (``tree.py:250-267``): the native interval
    # rings behind the stage walls, per-frame validate stamps (TCP) and
    # per-fold-call spans; both drop and count on overflow, and neither
    # arms under PS_NO_NATIVE or on shm, where validate stays inside
    # ingest_wait
    from pytorch_ps_mpi_tpu_torch.utils import native as wc_native

    hop_an = server.hop_anatomy
    hop_stamps_on = hop_spans_on = False
    if hop_an is not None:
        ring_cap = int(hop_an.knobs["ring_capacity"])
        stamp_arm = getattr(server, "hop_stamps_arm", None)
        hop_stamps_on = bool(stamp_arm(ring_cap)) if stamp_arm else False
        hop_spans_on = wc_native.fold_spans_arm(ring_cap)
    log = _HopLog(cfg.get("lineage_dir") or cfg.get("telemetry_dir"),
                  group_id)
    print(json.dumps({"leader": int(group_id), "addr": addr, "wid": lid}),
          flush=True)
    stats: Dict[str, Any] = {
        "group": int(group_id), "upstream_pushes": 0, "rounds": 0,
        "partial_rounds": 0, "composed": 0, "lost": [],
        "times": collections.defaultdict(float)}
    launches0 = at.kernel_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    staged = torch.empty(flat_n, dtype=torch.float32,
                         pin_memory=device.type == "cuda")

    def write_stats() -> None:
        if not cfg.get("stats_dir"):
            return
        doc = {**stats, "decodes_done": int(server.decodes_done),
               "grads_received": int(server.grads_received),
               "launches": {k: v - launches0[k]
                            for k, v in at.kernel_launches().items()},
               "peak_bytes": at._peak_bytes(device),
               "hop": hops[0].probe()}
        path = os.path.join(cfg["stats_dir"],
                            f"leader-{group_id}-{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(doc, f)

    pending: Dict[int, collections.deque] = collections.defaultdict(
        collections.deque)
    v_map: Dict[int, List[int]] = {}
    dead: set = set()
    crash_at = kw.get("crash_at_round")
    if isinstance(crash_at, dict):
        crash_at = crash_at.get(str(group_id), crash_at.get(int(group_id)))
    slow_fold_s = 0.0
    up_seq = 0
    t_start = time.monotonic()
    deadline = t_start + float(kw["timeout"])
    round_t0 = last_activity = time.monotonic()
    next_read = 0.0
    can_connect = hasattr(server, "connected")
    batch_poll = getattr(server, "poll_grad_batch", None)
    upstream_down = False

    def read_upstream(timeout: float) -> Tuple[np.ndarray, List[int]]:
        if not sharded:
            flat, v = conns[0].read_flat(timeout=timeout)
            return flat, [int(v)]
        flat = np.empty(flat_n, np.float32)
        vs = []
        for (start, stop), c in zip(plan, conns):
            sl, v = c.read_flat(timeout=timeout)
            flat[start:stop] = sl
            vs.append(int(v))
        return flat, vs

    def republish(timeout: float = 2.0) -> None:
        nonlocal upstream_down
        try:
            flat, vs = read_upstream(timeout)
        except TimeoutError:
            return  # upstream slow, not provably dead
        except (RuntimeError, OSError):
            upstream_down = True  # the root is gone: drain out below
            return
        if v_map and v_map[max(v_map)] == vs:
            return  # unchanged upstream
        server.publish_flat(flat)
        v_map[server.version] = vs
        while len(v_map) > 64:
            v_map.pop(min(v_map))

    def consume(item, meta) -> None:
        nonlocal last_activity
        wid, v_local, payload = item
        if not gwire.payload_finite(payload):
            server._reject_frame(wid, "nonfinite")
            return
        vs = v_map.get(int(v_local)) or (v_map[max(v_map)] if v_map
                                         else [0] * len(conns))
        pending[wid].append((np.copy(payload), dict(meta or {}), vs))
        dead.discard(wid)
        last_activity = time.monotonic()

    def pump_ingest() -> int:
        if batch_poll is not None:
            batch = batch_poll(raw=True)
            if batch is not None:
                # every item's meta, aligned (the views die at the next
                # batched pop, consume copies them)
                for it, meta in zip(batch, server.last_batch_metas):
                    consume(it, meta)
                return len(batch)
        item = server.poll_grad(raw=True)
        if item is None:
            return 0
        consume(item, server.last_push_meta)
        return 1

    def mark_dead() -> None:
        silent = (None if can_connect
                  else server.stragglers(float(kw["degrade_after"])))
        for w in group:
            if w in dead or pending[w] or w not in server.last_seen:
                continue
            if not (server.connected(w) if can_connect else w not in silent):
                dead.add(w)

    def lose(entries, reason: Optional[str] = None) -> None:
        for e in entries:
            stats["lost"].append([e["worker"], e["step"], e["seq"]])
            row = {"kind": "leader_consume", "lost": True}
            if reason is not None:
                row["reason"] = reason
            row.update(worker=e["worker"], step=e["step"], seq=e["seq"])
            log.row(row)

    def trace(w, meta) -> Dict[str, Any]:
        return {"worker": int(meta.get("worker", w)),
                "step": int(meta.get("step", 0)),
                "seq": int(meta.get("seq", 0)),
                "send_wall": float(meta.get("send_wall", 0.0))}

    def hop_push(active: List[int]) -> None:
        """Fold one queued payload a listed member, copy the sum to the
        card, re-encode it behind hop EF and push one frame a shard."""
        nonlocal up_seq, round_t0, slow_fold_s, upstream_down
        rounds = stats["rounds"]
        if inj is not None and slow_fold_s == 0.0:
            for f in inj.faults_between(-1, rounds):
                if f["kind"] == "slow_leader":
                    inj.fire(f)
                    slow_fold_s = float(f.get("slow_ms", 20.0)) / 1e3
        t0 = time.perf_counter()
        t_fold0 = time.monotonic()
        agg = gwire.agg_begin()
        entries, root_vs = [], []
        for w in active:
            payload, meta, vs = pending[w].popleft()
            agg.fold(payload)
            if slow_fold_s:
                time.sleep(slow_fold_s)
            entries.append(trace(w, meta))
            root_vs.append(vs)
        t_fin0 = time.monotonic()
        np.concatenate([x.reshape(-1) for x in agg.finalize_leaves()],
                       out=staged.numpy())
        t1 = time.perf_counter()
        fin_s = time.monotonic() - t_fin0
        fold_s = t1 - t0
        dev = staged.to(device, non_blocking=True)  # the one H2D a round
        if sharded:
            units = [[dev[start:stop]] for start, stop in plan]
        else:
            off, leaves = 0, []
            for s in shapes:
                n = int(np.prod(s))
                leaves.append(dev[off:off + n].view(s))
                off += n
            units = [leaves]
        payloads = [hop.encode(u) for hop, u in zip(hops, units)]
        t2 = time.perf_counter()
        # the oldest snapshot any folded gradient was computed against
        v_up = [min(vs[i] for vs in root_vs) for i in range(len(conns))]
        pushed = 0
        try:
            for c, p, v in zip(conns, payloads, v_up):
                c.push_payload(p, v,
                               timeout=float(cfg.get("push_timeout", 60.0)),
                               lineage=(rounds, up_seq), composed=entries)
                pushed += 1
        except (TimeoutError, RuntimeError, OSError):
            upstream_down = True
            if not pushed:
                lose(entries, "upstream_lost")  # nothing reached a shard
            else:
                # earlier shards composed these entries: a partial row,
                # not lost ones
                log.row({"kind": "hop_partial", "leader": int(group_id),
                         "round": rounds, "up_seq": up_seq,
                         "pushed_shards": pushed, "n_shards": len(conns),
                         "composed": entries, "t": time.time()})
            log.flush()
            return
        t3 = time.perf_counter()
        times = stats["times"]
        times["fold_s"] += fold_s
        times["h2d_encode_s"] += t2 - t1
        times["push_s"] += t3 - t2
        stats["upstream_pushes"] += len(conns)
        stats["composed"] += len(entries)
        if len(active) < len([w for w in group if w not in dead]) or dead:
            stats["partial_rounds"] += 1
        log.row({"kind": "hop", "leader": int(group_id), "round": rounds,
                 "leader_wid": int(lid), "up_seq": up_seq, "t": time.time(),
                 "composed": entries, "versions": v_up,
                 "fold_s": round(fold_s, 6), "encode_s": round(t2 - t1, 6),
                 "push_s": round(t3 - t2, 6), **hops[0].probe()})
        log.flush()
        if hop_an is not None:
            # the round's window opens where the previous push ended; the
            # rings are drained on this thread, which pumps and folds
            validate_s, drops, fold_calls, fold_busy_s = 0.0, 0, 0, 0.0
            got = server.drain_hop_stamps() if hop_stamps_on else None
            if got is not None:
                validate_s = sum(st[1] for st in got[0]) / 1e9
                drops += got[1]
            got = wc_native.fold_spans_drain() if hop_spans_on else None
            if got is not None:
                fold_calls = len(got[0])
                fold_busy_s = sum(e - b for b, e, _ in got[0]) / 1e9
                drops += got[1]
            hop_an.observe_round(
                leader=int(group_id), round=rounds, frames=len(entries),
                stages={"ingest_wait": max(t_fold0 - round_t0 - validate_s,
                                           0.0),
                        "validate": validate_s,
                        "fold": max(fold_s - fin_s, 0.0),
                        "finalize": fin_s, "encode": t2 - t1,
                        "upstream_push": t3 - t2},
                round_s=max(time.monotonic() - round_t0, 0.0),
                drops=drops, native=bool(hop_stamps_on or hop_spans_on),
                fold_calls=fold_calls, fold_busy_s=fold_busy_s)
            hop_an.flush()  # the root's tailer reads the rows live
        stats["rounds"] += 1
        up_seq += 1
        round_t0 = time.monotonic()

    try:
        # the first read blocks until the root's first publish
        republish(timeout=float(cfg.get("open_timeout", 60.0)))
        while time.monotonic() < deadline:
            now = time.monotonic()
            if now >= next_read:
                next_read = now + float(kw["read_poll_s"])
                republish()
            if upstream_down:
                # the root is gone: what is queued is positively lost
                for w in group:
                    lose([trace(w, meta) for _, meta, _ in pending[w]],
                         "upstream_lost")
                log.row({"kind": "upstream_lost", "t": time.time()})
                break
            if pump_ingest():
                continue
            # the crash hook fires mid-fold: pushes consumed and acked,
            # the round not yet upstream, so they are lost
            if (crash_at is not None and stats["rounds"] >= int(crash_at)
                    and any(pending[w] for w in group)):
                for w in group:
                    lose([trace(w, meta) for _, meta, _ in pending[w]])
                write_stats()
                log.close()
                os._exit(LEADER_CRASH_EXIT_CODE)
            active = [w for w in group if w not in dead]
            if active and all(pending[w] for w in active):
                hop_push(active)
                continue
            waited = time.monotonic() - round_t0
            queued = [w for w in group if pending[w]]
            if queued and waited > float(kw["degrade_after"]):
                mark_dead()
                active = [w for w in group if w not in dead]
                if active and all(pending[w] for w in active):
                    hop_push(active)
                    continue
                if waited > float(kw["flush_after"]):
                    hop_push(queued)  # a partial fold: liveness first
                    continue
            if not queued:
                round_t0 = time.monotonic()
                # idle exit: every member that ever pushed is gone again
                # (one never seen may still be starting up)
                up = time.monotonic() - t_start
                seen = [w for w in group if w in server.last_seen]
                if can_connect:
                    gone = bool(seen) and all(not server.connected(w)
                                              for w in seen)
                else:
                    silent = server.stragglers(float(kw["idle_exit_s"]))
                    gone = bool(seen) and all(w in silent for w in seen)
                if (gone and (len(seen) == len(group)
                              or up > float(kw["startup_grace"]))
                        and (time.monotonic() - last_activity
                             > float(kw["idle_exit_s"]))):
                    break
                if not seen and up > float(kw["startup_grace"]):
                    break
            time.sleep(0.0005)
    finally:
        write_stats()
        log.close()
        for c in conns:
            c.close()
        server.close()
    return int(stats["upstream_pushes"])


# -- the worker's side ---------------------------------------------------------

class TreeWorkerConn:
    """A worker's transport in a tree job (``tree.py:689``): push to the
    group leader; when it dies, push to the root directly (the upstream
    codec, composing itself in the trailer) and probe the leader's
    pinned address every ``rejoin_every`` pushes to rejoin. It has the
    worker surface ``worker_main`` uses; a payload encoded for one
    connection is encoded again when a failover moves the push to
    another."""

    _ERRORS = (TimeoutError, RuntimeError, OSError)

    def __init__(self, worker_id: int, template: Tree, cfg: Dict[str, Any],
                 device="cuda"):
        self.worker_id = int(worker_id)
        self.template = template
        self.cfg = cfg
        self.device = device
        self.kw = _leader_knobs(cfg)
        self.leader_addr = cfg["tree_leader"]
        self.root_addr = cfg.get("tree_fallback")  # single root only
        self.slots = int(cfg.get("tree_slots", 1) or 1)
        self.retries = self.reconnects = self.fallback_pushes = 0
        self.root_encodes = 0  # encodes with the upstream codec
        self._mode = "leader"
        self._leader = self._root = None
        self._since_fallback = 0
        self._tamper = None
        self._grad = None
        self._enc: Tuple[Any, Optional[np.ndarray]] = (None, None)
        self._connect_leader(float(cfg.get("open_timeout", 60.0)),
                             initial=True)

    @property
    def _conn(self):
        return self._leader if self._mode == "leader" else self._root

    @property
    def wire(self):
        return getattr(self._conn, "wire", None)

    def set_tamper(self, fn) -> None:
        self._tamper = fn
        if self._conn is not None:
            self._conn._tamper = fn

    def set_wire_delay(self, delay_s: float) -> None:
        if self._conn is not None:
            self._conn._wire_delay_s = float(delay_s)

    def renegotiate(self, code, bucket_mb: float = 0.0, key=None) -> bool:
        """Decline a codec renegotiation (``tree.py:734``): the group
        codec and the root's trailer wire are the tree's own agreement,
        which the leader re-encodes; the leaf keeps its epoch."""
        return False

    def repoint(self, addr: str) -> bool:
        """Re-parent this leaf to the leader at ``addr`` (a group split
        or merge, ``tree.py:744``). Idempotent; a failed connect takes
        the failover path (root fallback, or the pinned-address retry),
        whose rejoin probe then aims at the new address."""
        addr = str(addr)
        if (addr == self.leader_addr and self._mode == "leader"
                and self._leader is not None):
            return True
        self.leader_addr = addr
        old, self._leader = self._leader, None
        if old is not None:
            try:
                old.close()
            except Exception:
                pass
        if self._connect_leader(float(self.kw["probe_timeout"])):
            self.reconnects += 1
            return True
        self._failover()
        return False

    def _connect_leader(self, timeout: float, initial: bool = False) -> bool:
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSWorker
        from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSWorker

        kw = dict(timeout=timeout, code=_group_codec(self.kw),
                  seed=int(self.cfg.get("seed", 0)), frame=True,
                  device=self.device)
        try:
            if self.leader_addr.startswith("shm:"):
                w = ShmPSWorker(self.leader_addr[4:], self.worker_id,
                                self.template, **kw)
            else:
                host, port = self.leader_addr.rsplit(":", 1)
                w = TcpPSWorker(host, int(port), self.worker_id,
                                self.template, **kw)
        except self._ERRORS:
            if initial:
                if self.root_addr is None:
                    raise
                # the leader is down already: start on the fallback path
                self.reconnects += 1
                self._mode = "root"
                self._connect_root()
            return False
        if self._leader is not None:
            self._leader.close()
        self._leader = w
        w._tamper = self._tamper
        self._mode = "leader"
        self._since_fallback = 0
        if self._root is not None:
            # an open root socket would keep this worker in the root
            # barrier's membership
            self._root.close()
            self._root = None
        return True

    def _connect_root(self):
        from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSWorker

        if self.root_addr is None:
            raise RuntimeError("group leader unreachable and no "
                               "tree_fallback root configured")
        if self._root is None:
            host, port = self.root_addr.rsplit(":", 1)
            self._root = TcpPSWorker(
                host, int(port), self.worker_id, self.template,
                code=_upstream_codec(self.cfg),
                timeout=float(self.cfg.get("open_timeout", 60.0)),
                bucket_mb=float(self.cfg.get("bucket_mb", 0.0)),
                frame=True, tree_slots=self.slots,
                seed=int(self.cfg.get("seed", 0)), device=self.device)
            self._root._tamper = self._tamper
        return self._root

    def _failover(self) -> None:
        """The leader is unreachable: push to the root, or (a sharded
        tree, whose leaf cannot slice its pushes) wait for the leader's
        respawn on its pinned address."""
        self.reconnects += 1
        self._since_fallback = 0
        if self._leader is not None:
            try:
                self._leader.close()
            except Exception:
                pass
            self._leader = None
        if self.root_addr is None:
            deadline = time.time() + float(self.cfg.get("open_timeout",
                                                        60.0))
            while time.time() < deadline:
                if self._connect_leader(float(self.kw["probe_timeout"])):
                    return
                time.sleep(0.5)
            raise TimeoutError("group leader unreachable and never back "
                               "within open_timeout")
        self._mode = "root"
        self._connect_root()

    # -- the worker's surface ----------------------------------------------
    def read_flat(self, timeout: float = 30.0):
        if self._mode == "leader":
            try:
                return self._leader.read_flat(timeout=timeout)
            except self._ERRORS:
                self.retries += 1
                self._failover()
            if self._mode == "leader":  # reconnected (a respawn)
                return self._leader.read_flat(timeout=timeout)
        return self._connect_root().read_flat(timeout=timeout)

    def _encode_for(self, conn, grad) -> np.ndarray:
        self.root_encodes += conn is self._root
        self._enc = (conn, conn.encode(grad))
        return self._enc[1]

    def encode(self, grad) -> np.ndarray:
        """The payload for the current connection's wire; ``grad`` is kept
        to encode again if the push moves to another connection."""
        self._grad = grad
        return self._encode_for(self._conn, grad)

    def _bytes_for(self, conn) -> np.ndarray:
        if self._enc[0] is not conn:
            return self._encode_for(conn, self._grad)
        return self._enc[1]

    def _push(self, conn, version, timeout, lineage) -> None:
        conn.push_payload(self._bytes_for(conn), version, timeout=timeout,
                          lineage=lineage)
        self._tamper = conn._tamper  # a push consumes a one-shot tamper

    def push_payload(self, flat: np.ndarray, version: int,
                     timeout: float = 30.0, lineage=None,
                     composed=None) -> None:
        if self._enc[1] is not flat:
            self._enc = (self._conn, flat)
        if self._mode == "root":
            self._since_fallback += 1
            if self._since_fallback >= int(self.kw["rejoin_every"]):
                if self._connect_leader(float(self.kw["probe_timeout"])):
                    # the leader's versions are its own: read again so
                    # this push is tagged in its domain
                    try:
                        _, version = self._leader.read_flat(timeout=timeout)
                    except self._ERRORS:
                        self._failover()
                else:
                    self._since_fallback = 0
        if self._mode == "leader":
            try:
                self._push(self._leader, version, timeout, lineage)
                return
            except self._ERRORS:
                self.retries += 1
                self._failover()
            if self._mode == "leader":  # reconnected (a respawn)
                self._push(self._leader, version, timeout, lineage)
                return
        # direct to the root, tagged with a root version
        root = self._connect_root()
        try:
            _, version = root.read_flat(timeout=timeout)
        except self._ERRORS:
            self.retries += 1
        self._push(root, version, timeout, lineage)
        self.fallback_pushes += 1
        self._since_fallback += 1

    def close(self) -> None:
        for w in (self._leader, self._root):
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass
        self._leader = self._root = None


# -- orchestration ---------------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_leader(upstream: Sequence[str], group_id: int,
                 group: Sequence[int], cfg: Dict[str, Any], port: int = 0,
                 env: Optional[Dict[str, str]] = None):
    """``leader_main`` in a fresh interpreter; it prints a hello line
    with its group-facing address (:func:`read_leader_hello`)."""
    import subprocess

    from pytorch_ps_mpi_tpu_torch.parallel.async_train import spawn_python

    src = ("import json, sys\n"
           "from pytorch_ps_mpi_tpu_torch.parallel.tree import leader_main\n"
           "up, gid, grp, cfg, port = (json.loads(sys.argv[1]), "
           "int(sys.argv[2]), json.loads(sys.argv[3]), "
           "json.loads(sys.argv[4]), int(sys.argv[5]))\n"
           "sys.exit(0 if leader_main(up, gid, grp, cfg, port) >= 0 "
           "else 1)\n")
    return spawn_python(src, [json.dumps(list(upstream)), str(group_id),
                              json.dumps([int(w) for w in group]),
                              json.dumps(cfg), str(port)], env,
                        stdout=subprocess.PIPE)


def read_leader_hello(proc, timeout: float = 120.0) -> Dict[str, Any]:
    """Block until a spawned leader prints its hello line."""
    import select

    deadline = time.time() + timeout
    while time.time() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 0.5)
        if r:
            line = proc.stdout.readline()
            if line:
                return json.loads(line)
        if proc.poll() is not None:
            raise RuntimeError(f"leader exited early: {proc.returncode}")
    raise TimeoutError("leader never reported its address")


def run_tree(cfg: Dict[str, Any], *, total_pushes: Optional[int] = None,
             timeout: float = 300.0,
             worker_env: Optional[Dict[str, str]] = None,
             leader_env: Optional[Dict[str, str]] = None
             ) -> Tuple[Tree, Dict[str, Any]]:
    """Drive a whole tree (``tree.py:976``): the root (``serve`` in this
    process, on ``cfg["device"]``), a leader a group and a worker a
    worker, fresh interpreters. A crashed leader is respawned on its
    pinned port, without its crash hook, up to ``max_respawns`` times.
    The root stops when ``total_pushes`` worker pushes are composed, or
    when every worker and leader has exited. Returns the root's
    ``(params, metrics)`` with ``metrics["tree"]``: the groups, leader
    respawns, exit codes and the composed trace IDs. With
    ``cfg["hop_anatomy"]`` the root tails the leaders' ``hop-*.jsonl``
    rows into its own :class:`HopAnatomy` (``tree.py:1055-1068``), the
    fleet's hop scoreboard in its metrics' ``hop`` section. With
    ``cfg["topo_actions"]`` (and the controller's cfg) the root holds a
    :class:`~pytorch_ps_mpi_tpu_torch.control.topo.TreeTopoActuator` over
    these supervision lists, ``replan_max`` spare worker ids, and the
    shape bulletin ``root.topo_state``; ``metrics["tree"]["topo_events"]``
    lists what it did."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer

    cfg = dict(cfg)
    n_workers = int(cfg["n_workers"])
    group_size = int(cfg.get("group_size", 4))
    kw = _leader_knobs(cfg)
    groups = group_plan(n_workers, group_size)
    slots = tree_slot_capacity(n_workers, group_size)
    cfg.update(tree=True, tree_slots=slots,
               tree_members=[leader_wid(n_workers, g)
                             for g in range(len(groups))])
    code = _upstream_codec(cfg)
    if code is None:
        raise ValueError("run_tree needs cfg['codec'] (the upstream hop; "
                         "'identity' ships raw floats)")
    device = cfg.get("device", "cuda")
    template = at.make_problem(cfg, device).template
    # each group split promotes one new leader worker id
    spare = (int((cfg.get("control_kw") or {}).get("replan_max", 1))
             if cfg.get("topo_actions") else 0)
    root = TcpPSServer(0, n_workers + len(groups) + spare, template,
                       max_staleness=int(cfg.get("max_staleness", 4)),
                       code=code, bucket_mb=float(cfg.get("bucket_mb", 0.0)),
                       frame=True, tree_slots=slots, device=device)
    root.composed_log = []
    root_addr = f"127.0.0.1:{root.port}"
    cfg["tree_fallback"] = root_addr
    # the leaders' addresses are fixed up front (a port picked here, or
    # the shm name a leader derives from this process's pid), so every
    # leader and worker starts at once; a respawn binds the same address
    shm = kw["group_transport"] == "shm"
    ports = [0 if shm else _free_port() for _ in groups]
    addrs = [f"shm:/psq_tree_torch_{os.getpid()}_{g}" if shm
             else f"127.0.0.1:{ports[g]}" for g in range(len(groups))]
    leaders: List[Any] = []
    respawns = [0] * len(groups)
    workers: List[Any] = []
    try:
        leaders = [spawn_leader([root_addr], g, grp, cfg, port=ports[g],
                                env=leader_env)
                   for g, grp in enumerate(groups)]
        workers = [at.spawn_worker(root_addr, w,
                                   {**cfg, "tree_leader": addrs[g]},
                                   env=worker_env)
                   for g, grp in enumerate(groups) for w in grp]
        for g, p in enumerate(leaders):
            hello = read_leader_hello(p)
            if hello["addr"] != addrs[g]:
                raise RuntimeError(f"leader {g} listens on {hello['addr']}, "
                                   f"not {addrs[g]}")
        from pytorch_ps_mpi_tpu_torch.control.topo import (HopTailer,
                                                          TreeTopoActuator)

        hop_tailer = None
        hop_dir = cfg.get("lineage_dir") or cfg.get("telemetry_dir")
        if cfg.get("hop_anatomy") and hop_dir:
            hop_tailer = HopTailer(
                hop_dir,
                lambda row: (root.hop_anatomy.observe_row(row)
                             if root.hop_anatomy is not None else None),
                pattern="hop-*.jsonl")
        respawn_cfg = dict(cfg)
        respawn_cfg["leader_kw"] = {
            k: v for k, v in (cfg.get("leader_kw") or {}).items()
            if k != "crash_at_round"}  # crash hooks are one-shot
        actuator = tailer = None
        if cfg.get("topo_actions"):
            # structural control (``tree.py:1046-1090``): the actuator
            # splits and merges groups through these supervision lists,
            # so a promoted leader is respawned like a boot one; the
            # leaders' lineage rows feed the live advisor's hot group
            actuator = TreeTopoActuator(
                cfg=respawn_cfg, groups=groups, leaders=leaders,
                leader_ports=ports, leader_addrs=addrs, respawns=respawns,
                root_addr=root_addr, leader_env=leader_env)
            root.topo_actuator = actuator
            if hop_dir:
                tailer = HopTailer(
                    hop_dir,
                    lambda row: (root.anatomy.observe_hop(row)
                                 if root.anatomy is not None else None))
            root.topo_state = {"groups": len(groups), "leader_respawns": 0,
                               "hot_churn_group": -1}

        def on_tick():
            if hop_tailer is not None:
                hop_tailer.poll()
            for g, p in enumerate(leaders):
                rc = p.poll()
                if rc not in (None, 0) and respawns[g] < int(
                        kw["max_respawns"]):
                    respawns[g] += 1
                    leaders[g] = spawn_leader([root_addr], g, groups[g],
                                              respawn_cfg, port=ports[g],
                                              env=leader_env)
            if actuator is not None:
                actuator.pump()  # reaps a split leader's hello, no wait
                root.topo_state = {
                    "groups": actuator.active_groups,
                    "leader_respawns": max(respawns),
                    "hot_churn_group": (
                        max(range(len(respawns)), key=respawns.__getitem__)
                        if max(respawns) > 0 else -1)}
            if tailer is not None:
                tailer.poll()

        def stop_when():
            done = ((total_pushes is not None
                     and root.tree_composed >= total_pushes)
                    or (all(p.poll() is not None for p in workers)
                        and all(p.poll() is not None for p in leaders)))
            if done and hop_tailer is not None:
                hop_tailer.poll()  # the last rows before the snapshot
            return done

        params, m = at.serve(root, cfg, total_grads=10**9, timeout=timeout,
                             sync_barrier=not cfg.get("tree_async", False),
                             on_tick=on_tick, stop_when=stop_when)
        m["tree"] = {
            "groups": groups, "tree_slots": slots,
            "leader_wids": cfg["tree_members"],
            "leader_respawns": sum(respawns),
            "worker_codes": at.join_workers(workers, timeout=60.0),
            "leader_codes": at.join_workers(leaders, timeout=60.0),
            "composed_ids": [[e["worker"], e["step"], e["seq"]]
                             for e in root.composed_log]}
        if actuator is not None:
            m["tree"]["topo_events"] = list(actuator.events)
        return params, m
    finally:
        # a split leader still booting is in no list yet
        pending = getattr(root, "topo_actuator", None)
        pending = pending._pending if pending is not None else None
        extra = [pending["proc"]] if pending is not None else []
        for p in workers + leaders + extra:
            if p.poll() is None:
                p.terminate()
        at.join_workers(workers + leaders + extra, timeout=10.0)
        root.close()

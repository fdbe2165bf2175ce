"""Async parameter-server training across processes
(``pytorch_ps_mpi_tpu/parallel/async_train.py``).

The AsySG-InCon stack with real compute in every process (the
reference's ``README.md:61-81``):

  worker process:  read the latest parameters (inconsistent read)
                   -> forward and backward on the card
                   -> the gradient in the JAX layout, encoded on the card
                      with the codec's kernels (``parallel.dcn.CodecWire``)
                   -> payload bytes into the shm mailbox or the socket
  server process:  poll the pushes in arrival order
                   -> decode on the card (or fold the bytes on the host)
                   -> the optimizer update on the card -> publish

Two disciplines, for the async-versus-sync comparison the algorithm
exists for: ``serve(..., sync_barrier=False)`` applies each gradient as
it arrives, so throughput follows the fast workers;
``sync_barrier=True`` collects one gradient from every worker a round and
applies their mean, so throughput follows the slowest. Under the
barrier, a codec wire whose algebra allows it (``cfg["agg"]``:
``"auto"``, ``"on"``, ``"off"``) folds the rounds' payloads in the
compressed domain on the host (the native folds) and decodes once a
published version.

Every process rebuilds the same problem from the same ``cfg``
(:func:`make_problem`); the workers are fresh interpreters
(:func:`spawn_worker`), never forks of a process that has started CUDA.

Resilience (``resilience/``): ``cfg["fault_plan"]`` injects seeded
faults into the workers and the server, ``cfg["resilient"]`` wraps the
worker's transport in a :class:`ResilientWorker`, and the sync barrier
completes a round over the surviving workers once it has waited
``cfg["degraded_round_after"]`` seconds. With ``cfg["tree"]`` the server
is an aggregation tree's root (``parallel/tree.py``): its pushers are
group leaders whose frames compose several worker pushes, and each round
is averaged by the composed count. ``cfg["serving"]`` or
``cfg["read_port"]`` (0 picks a free port) arms the read tier
(``serving/``) on the server, tuned by ``cfg["serving_kw"]``.

The per-process telemetry (``telemetry/``) arms from the same cfg, in the
server and in every worker: ``telemetry_dir`` (the flight recorder, its
JSONL dumps and ``metrics.prom``), ``metrics_port``/``health_port`` (the
``/metrics`` and ``/health`` endpoint), ``health``/``health_dir`` (worker
beacons and the :class:`HealthMonitor`), ``numerics``/``numerics_dir``/
``numerics_kw`` (every consumed push checked on the card before it can
touch the update, the skip/zero/abort policy, and the workers'
codec-fidelity probes), ``lineage``/``lineage_dir``/``trace`` (trace IDs
billed to each published version) with ``anatomy`` (``"auto"``: armed
with lineage), ``freshness`` and ``hop_anatomy``.

The fleet observability plane (``telemetry/{timeseries,slo,profiler,
fleet}.py``) arms from ``timeseries``/``timeseries_kw``, ``slo``/
``slo_kw``, ``profile``/``profile_dir`` (the sampling profiler, in the
server and every worker) and ``fleet``/``fleet_dir``; the self-driving
controller (``control/``) from ``control``/``control_kw``/``control_dir``
and, for structural actions, ``topo_actions``.
"""

from __future__ import annotations

import collections
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_ps_mpi_tpu_torch.mesh import resolve_device
from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
from pytorch_ps_mpi_tpu_torch.ps import _inverse

Tree = Any

#: seconds between two calls of ``serve``'s ``on_tick``
TICK_S = 0.2

# update/wait latency buckets (seconds): sub-ms updates through
# multi-second straggler waits
_LATENCY_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                    5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _telemetry_from_cfg(cfg: Dict[str, Any], worker: Any):
    """The switch that costs nothing when off (``async_train.py:52``):
    ``cfg["telemetry_dir"]`` installs the process-global flight recorder,
    in the server and in every spawned worker (the cfg rides the spawn's
    argv, so one key arms the fleet). Returns the recorder or None."""
    from pytorch_ps_mpi_tpu_torch import telemetry

    rec = telemetry.get_recorder()
    if rec is None and cfg.get("telemetry_dir"):
        rec = telemetry.configure(
            capacity=int(cfg.get("telemetry_capacity", 65536)),
            worker=worker)
    return rec


def _dump_recorder(cfg: Dict[str, Any], rec, filename: str) -> Optional[str]:
    tdir = cfg.get("telemetry_dir")
    if rec is None or not tdir:
        return None
    os.makedirs(tdir, exist_ok=True)
    return rec.dump_jsonl(os.path.join(tdir, filename))


def _arm_lineage(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``cfg["trace"]`` is the CLI's name for lineage (``--trace``,
    ``train_async.py:349``); the trace IDs ride the frames, so the
    server's transport must be framed (``frame_check``)."""
    if cfg.get("trace") and not cfg.get("lineage"):
        cfg = {**cfg, "lineage": True}
    return cfg


def check_cfg(cfg: Dict[str, Any]) -> None:
    """Raise ``ValueError`` for a model the fleet does not know."""
    if cfg.get("model") not in ("mlp", "resnet18", "resnet50", "gpt"):
        raise ValueError(f"unknown model {cfg.get('model')!r}")


class Problem:
    """A model, its data and its loss, rebuilt alike in every process
    from ``cfg`` (``async_train.py:101``): ``mlp`` (a regression on a
    fixed random linear teacher), ``resnet18`` and ``resnet50``
    (``small_inputs``; images with a learnable class signal), and ``gpt``
    (``gpt_tiny`` at fleet-test size, every ``model_kw`` knob forwarded:
    a causal LM on a bigram Markov chain whose table comes from
    ``cfg["seed"]``, ``cfg["seq_len"]`` tokens, 32 by default). The wire
    template is the JAX parameter tree (:attr:`template`), its leaves the
    parameters in the JAX package's order and layout."""

    def __init__(self, cfg: Dict[str, Any], device):
        from pytorch_ps_mpi_tpu_torch import models
        from pytorch_ps_mpi_tpu_torch.utils.interop import (jax_leaf_order,
                                                            params_to_jax)

        check_cfg(cfg)
        self.device = resolve_device(device)
        name = cfg["model"]
        kw = dict(cfg.get("model_kw", {}))
        self.in_shape = tuple(cfg.get("in_shape", (8,)))
        self.batch = int(cfg.get("batch", 32))
        self.seed = int(cfg.get("seed", 0))
        if name == "mlp":
            self.n_out = tuple(kw.get("features", (32, 8)))[-1]
            model = models.MLP(features=tuple(kw.get("features", (32, 8))),
                               in_features=math.prod(self.in_shape),
                               seed=self.seed, device=self.device)
        elif name == "gpt":
            from pytorch_ps_mpi_tpu_torch.data import markov_table
            from pytorch_ps_mpi_tpu_torch.models.gpt import GPTLM, gpt_tiny

            if isinstance(kw.get("dtype"), str):  # a cfg crosses as JSON
                kw["dtype"] = getattr(torch, kw["dtype"])
            model = GPTLM(gpt_tiny(**{
                "vocab_size": 256, "hidden_size": 64, "num_layers": 2,
                "num_heads": 4, "intermediate_size": 128,
                "max_position": 64, **kw}), seed=self.seed,
                device=self.device)
            self.seq = int(cfg.get("seq_len", 32))
            if self.seq > model.cfg.max_position:
                raise ValueError(
                    f"seq_len={self.seq} exceeds the model's max_position="
                    f"{model.cfg.max_position}: positions past it would be "
                    "silently clamped to one embedding")
            self._cum = markov_table(model.cfg.vocab_size, self.seed)
        elif name in ("resnet18", "resnet50"):
            self.n_out = int(kw.get("num_classes", 10))
            ctor = models.ResNet18 if name == "resnet18" else models.ResNet50
            model = ctor(num_classes=self.n_out,
                         num_filters=int(kw.get("num_filters", 64)),
                         small_inputs=True, in_channels=self.in_shape[-1],
                         seed=self.seed, device=self.device)
        else:
            raise ValueError(f"unknown model {name!r}")
        self.model = model
        self.kind = name
        named = dict(model.named_parameters())
        self.names = jax_leaf_order(model)
        self.params = [named[n] for n in self.names]
        self.perms = [getattr(p, "codec_view", None) for p in self.params]
        self.template = params_to_jax(model)
        rng = np.random.RandomState(self.seed)
        if name == "gpt":
            pass
        elif name == "mlp":
            d_in = math.prod(self.in_shape)
            self._teacher = torch.from_numpy(
                (rng.randn(d_in, self.n_out) / math.sqrt(d_in))
                .astype(np.float32)).to(self.device)
        else:
            self._class_means = (rng.randn(self.n_out, *self.in_shape)
                                 .astype(np.float32) * 0.5)

    def batch_fn(self, step: int, worker: int):
        """Worker ``worker``'s batch at ``step`` on the device, from a seed
        sequence that cannot collide across (worker, step)."""
        ss = np.random.SeedSequence([self.seed, worker, step])
        rng = np.random.RandomState(ss.generate_state(1)[0])
        if self.kind == "gpt":
            from pytorch_ps_mpi_tpu_torch.data import sample_markov

            return torch.from_numpy(sample_markov(
                self._cum, self.batch, self.seq, rng)).to(self.device)
        x = rng.randn(self.batch, *self.in_shape).astype(np.float32)
        if self.kind == "mlp":
            xt = torch.from_numpy(x).to(self.device)
            return xt, xt.reshape(self.batch, -1) @ self._teacher
        labels = rng.randint(0, self.n_out, size=(self.batch,))
        x = x + self._class_means[labels]
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(labels.astype(np.int64)).to(self.device))

    def loss(self, batch) -> torch.Tensor:
        if self.kind == "gpt":
            from pytorch_ps_mpi_tpu_torch.models.gpt import causal_lm_loss

            return causal_lm_loss(self.model(batch), batch)
        x, y = batch
        out = self.model(x)
        if self.kind == "mlp":
            return torch.mean((out - y) ** 2)
        return torch.nn.functional.cross_entropy(out, y)

    def grad_leaves(self, batch) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``(loss, grads)``: the gradient's leaves in the JAX order and
        layout (each tagged conv or linear kernel permuted with its
        ``codec_view``; the copy is one read and one write of it)."""
        for p in self.params:
            p.grad = None
        loss = self.loss(batch)
        loss.backward()
        return loss.detach(), [p.grad.permute(v).contiguous() if v else p.grad
                               for p, v in zip(self.params, self.perms)]

    @torch.no_grad()
    def flat_params(self) -> torch.Tensor:
        """The parameters as the published float32 vector (JAX layout)."""
        return torch.cat([(p.permute(v) if v else p).reshape(-1)
                          .to(torch.float32)
                          for p, v in zip(self.params, self.perms)])

    @torch.no_grad()
    def load_flat(self, flat: torch.Tensor) -> None:
        """Set the model's parameters from a published vector."""
        off = 0
        for p, v in zip(self.params, self.perms):
            shape = tuple(p.permute(v).shape) if v else tuple(p.shape)
            n = p.numel()
            seg = flat[off:off + n].view(shape)
            p.copy_(seg.permute(_inverse(v)) if v else seg)
            off += n

    @torch.no_grad()
    def eval_loss(self) -> float:
        """The loss on a batch no worker draws."""
        return float(self.loss(self.batch_fn(10**6, 10**6)))


def make_problem(cfg: Dict[str, Any], device="cuda") -> Problem:
    return Problem(cfg, device)


def worker_cfg(cfg: Dict[str, Any], worker_id: int) -> Tuple[float, int]:
    """Per-worker ``(slow_ms, steps)`` from the job's cfg."""
    slow = cfg.get("slow_ms")
    slow_ms = float(slow.get(str(worker_id), 0.0)) \
        if isinstance(slow, dict) else 0.0
    per = cfg.get("worker_steps")
    steps = int(per.get(str(worker_id), cfg.get("steps", 10))) \
        if isinstance(per, dict) else int(cfg.get("steps", 10))
    return slow_ms, steps


def kernel_launches() -> Dict[str, int]:
    """The codec kernels' launch counts in this process."""
    from pytorch_ps_mpi_tpu_torch.ops import quant, sign, tern, topk

    return {"encode_signs": sign.encode_signs.launches,
            "unpack_signs_sum": sign.unpack_signs_sum.launches,
            "quantize_int8": quant.quantize_int8.launches,
            "dequant_sum": quant.dequant_sum.launches,
            "tern_encode": tern.tern_encode.launches,
            "tern_scale": tern.tern_scale.launches,
            "tern_pack": tern.tern_pack.launches,
            "tern_unpack_sum": tern.tern_unpack_sum.launches,
            "exact_topk": topk.exact_topk.launches}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_bytes(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


class IdleMeter:
    """The card's idle share over a span of this process's work: one
    minus the union of the device rows ``torch.profiler`` records, over
    the span's wall time. A no-op off the card.

    The span cannot be taken again, so :mod:`utils.tracing`'s guard is
    applied without retakes: the trace opens with
    :data:`~pytorch_ps_mpi_tpu_torch.utils.tracing.LEAD` spin kernels
    (late in a long process the profiler on an H100 has dropped a
    trace's first device rows while still recording every launch call),
    and a reading holds an idle share only when the other device rows
    number at least the launch calls made after them."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        if self.device.type != "cuda" or self._prof is not None:
            return
        from pytorch_ps_mpi_tpu_torch.utils.tracing import open_trace

        self._prof = open_trace(self.device)
        self._t0 = time.perf_counter()

    def stop(self) -> Dict[str, float]:
        """``device_rows``, ``launched``, ``profiled_wall_ms`` and, when
        the trace holds a device row for every launch, ``device_busy_ms``
        and ``idle_share`` (empty when nothing was profiled)."""
        if self._prof is None:
            return {}
        from pytorch_ps_mpi_tpu_torch.utils.tracing import trace_rows

        torch.cuda.synchronize(self.device)
        wall = (time.perf_counter() - self._t0) * 1e3
        self._prof.__exit__(None, None, None)
        rows, launched = trace_rows(self._prof)
        spans = [(e.time_range.start, e.time_range.end) for e in rows]
        self._prof = None
        busy, cur_s, cur_e = 0.0, None, None
        for a, b in spans:
            if cur_e is None or a > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        if cur_e is not None:
            busy += cur_e - cur_s
        out = {"device_rows": float(len(spans)), "launched": float(launched),
               "profiled_wall_ms": wall}
        if spans and len(spans) >= launched and wall:
            busy /= 1e3
            out.update(device_busy_ms=busy,
                       idle_share=max(0.0, 1.0 - busy / wall))
        return out


def _codec(cfg: Dict[str, Any]):
    if not cfg.get("codec"):
        return None
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    return get_codec(cfg["codec"], **cfg.get("codec_kw", {}))


def make_worker(name: str, worker_id: int, cfg: Dict[str, Any], template,
                device: torch.device):
    """The worker's transport from ``cfg`` (``async_train.py:244-287``):
    the group leader's connection with its root fallback
    (``cfg["tree_leader"]``, :class:`parallel.tree.TreeWorkerConn`), a
    :class:`ResilientWorker` around the transport (``cfg["resilient"]``),
    or the transport itself, shm or TCP (``name`` ``"host:port"``)."""
    code = _codec(cfg)
    kw = dict(code=code, timeout=float(cfg.get("open_timeout", 60.0)),
              bucket_mb=float(cfg.get("bucket_mb", 0.0)),
              frame=bool(cfg.get("frame_check")), device=device,
              seed=int(cfg.get("seed", 0)))

    def make_transport():
        if cfg.get("transport", "shm") == "tcp":
            from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSWorker

            host, port = name.rsplit(":", 1)
            return TcpPSWorker(host, int(port), worker_id, template, **kw)
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSWorker

        return ShmPSWorker(name, worker_id, template, **kw)

    if cfg.get("tree_leader"):
        from pytorch_ps_mpi_tpu_torch.parallel.tree import TreeWorkerConn

        return TreeWorkerConn(worker_id, template, cfg, device)
    if cfg.get("resilient"):
        from pytorch_ps_mpi_tpu_torch.resilience.worker import \
            ResilientWorker

        return ResilientWorker(
            make_transport, worker_id=worker_id,
            seed=int(cfg.get("fault_seed", cfg.get("seed", 0))),
            **cfg.get("resilience_kw", {}))
    return make_transport()


def worker_main(name: str, worker_id: int, cfg: Dict[str, Any]) -> int:
    """Worker process body (``async_train.py:197``): read, forward and
    backward, encode, push. ``cfg["transport"]`` is ``"shm"`` (``name``
    the segment) or ``"tcp"`` (``name`` is ``"host:port"``);
    ``cfg["frame_check"]`` seals every push in a PSF2 frame;
    ``cfg["device"]`` is the card unless it says ``"cpu"``;
    :func:`make_worker` reads ``tree_leader`` and ``resilient``.
    ``cfg["fault_plan"]`` fires this worker's faults at its steps
    (``async_train.py:345-419``): ``drop``, ``delay``, ``wire_delay``,
    ``duplicate``, ``corrupt``, ``nan`` (the gradient poisoned before the
    encode) and ``crash_worker`` (``os._exit`` with
    :data:`CRASH_EXIT_CODE`). With ``cfg["stats_dir"]`` the worker
    writes its per-push times, encodes, kernel launches and peak memory
    to ``worker-<id>.json`` there (the times a list, one a push).

    Telemetry (``async_train.py:252-495``): ``cfg["telemetry_dir"]``
    records the read, grad, straggle and push spans into
    ``worker-<id>.jsonl``; ``cfg["health_dir"]`` appends one beacon row a
    step (compute and wire seconds) for the server's
    :class:`HealthMonitor`; ``cfg["numerics_dir"]`` probes the wire's
    codec fidelity on the pre-encode gradient every ``probe_every``
    steps (``numerics_kw``), on the card through the codec's kernels,
    into ``numerics-<id>.jsonl``. ``cfg["profile"]``/``profile_dir``
    runs the sampling profiler (``profile-worker-<id>.txt``).

    The controller's worker half (``async_train.py:283-352``): with
    ``control``/``control_kw``/``topo_actions`` (or ``control_dir``) the
    worker polls ``control-epoch.json`` between steps and switches its
    wire to a renegotiated codec (:func:`~pytorch_ps_mpi_tpu_torch.control.
    apply_epoch`: a malformed document is ignored, a kernel build or
    load failure raises), and a tree leaf polls ``control-topo.json``
    and repoints to the leader its ``assign`` map names. With
    ``stats_dir`` the stats record ``switches``: for each switch, the
    pushes before it and the kernel launches up to it. Returns the steps
    made."""
    from pytorch_ps_mpi_tpu_torch.resilience.faults import (CRASH_EXIT_CODE,
                                                            FaultInjector)

    device = resolve_device(cfg.get("device", "cuda"))
    prob = make_problem(cfg, device)
    slow_ms, steps = worker_cfg(cfg, worker_id)
    rec = _telemetry_from_cfg(cfg, worker=worker_id)
    w = make_worker(name, worker_id, cfg, prob.template, device)
    inj = FaultInjector.from_cfg(cfg, role=worker_id)
    control_dir = cfg.get("control_dir") or (
        cfg.get("telemetry_dir")
        if (cfg.get("control") or cfg.get("control_kw")
            or cfg.get("topo_actions")) else None)
    epoch_state: Dict[str, Any] = {"epoch": 0, "mtime": 0}
    topo_state: Dict[str, Any] = {"seq": 0, "mtime": 0}
    switches: List[Dict[str, Any]] = []
    ladder = (cfg.get("control_kw") or {}).get("ladder")
    if control_dir is not None and ladder:
        # every rung's wire is built now, not in the step that switches
        # (whose staleness the controller's lr rule reads)
        from pytorch_ps_mpi_tpu_torch import control as _control

        _control.prepare_ladder(w, ladder, boot=_control.rung_key(
            cfg) if cfg.get("codec") else None)
    wprof = None
    prof_dir = cfg.get("profile_dir") or (cfg.get("telemetry_dir")
                                          if cfg.get("profile") else None)
    if prof_dir:
        # the serve loop's sampler, one profile-worker-<id>.txt a worker
        from pytorch_ps_mpi_tpu_torch.telemetry.profiler import \
            SamplingProfiler

        wprof = SamplingProfiler(name=f"worker-{worker_id}", dir=prof_dir,
                                 **(cfg.get("profile_kw") or {})).start()
    prober, probe_every = None, 0
    if cfg.get("numerics_dir") and getattr(w, "wire", None) is not None:
        # the codec-fidelity half of the numerics layer runs here, on the
        # pre-encode gradient: the server only sees decoded values
        from pytorch_ps_mpi_tpu_torch.telemetry.numerics import (
            NUMERICS_KNOBS, ProbeWriter)

        probe_every = max(1, int((cfg.get("numerics_kw") or {}).get(
            "probe_every", NUMERICS_KNOBS["probe_every"])))
        prober = ProbeWriter(cfg["numerics_dir"], worker_id)
    beacon = None
    if cfg.get("health_dir"):
        # one row a step with the durations the recorder spans measure,
        # so the server attributes a straggle to compute or wire live
        from pytorch_ps_mpi_tpu_torch.telemetry.diagnosis import \
            BeaconWriter

        beacon = BeaconWriter(cfg["health_dir"], worker_id)
    push_timeout = float(cfg.get("push_timeout", 60.0))
    times = collections.defaultdict(list)
    launches0 = kernel_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pushed = encodes = push_seq = 0
    try:
        for step in range(steps):
            t_step0 = time.monotonic()
            if control_dir is not None:
                from pytorch_ps_mpi_tpu_torch import control as _control

                doc = _control.poll_epoch(control_dir, epoch_state)
                # a malformed document returns False; a kernel fault raises
                if doc is not None and _control.apply_epoch(w, doc):
                    switches.append({
                        "epoch": int(doc["epoch"]), "codec": doc["codec"],
                        "pushes_before": pushed,
                        "launches_before": {
                            k: v - launches0[k]
                            for k, v in kernel_launches().items()}})
                if hasattr(w, "repoint"):
                    from pytorch_ps_mpi_tpu_torch.control.topo import \
                        poll_topo

                    tdoc = poll_topo(control_dir, topo_state)
                    addr = ((tdoc or {}).get("assign") or {}).get(
                        str(worker_id))
                    if addr:
                        w.repoint(addr)
            drop = duplicate = poison = False
            for f in (inj.faults_at(step) if inj is not None else ()):
                kind = f["kind"]
                if kind == "crash_worker":
                    inj.fire(f)  # logged before the process dies
                    _dump_recorder(cfg, rec, f"worker-{worker_id}.jsonl")
                    os._exit(CRASH_EXIT_CODE)
                elif kind == "corrupt":
                    w.set_tamper(inj.make_tamper(f))  # fires at the push
                    continue
                inj.fire(f)
                if kind == "delay":
                    time.sleep(float(f.get("delay_ms", 100.0)) / 1e3)
                elif kind == "wire_delay":
                    w.set_wire_delay(float(f.get("delay_ms", 100.0)) / 1e3)
                elif kind == "drop":
                    drop = True
                elif kind == "duplicate":
                    duplicate = True
                elif kind == "nan":
                    poison = True
            if drop:
                # a dropped push is neither corrupted nor delayed: the
                # one-shot hooks must not leak onto the next step's push
                w.set_tamper(None)
                w.set_wire_delay(0.0)
            t0 = time.perf_counter()
            m0 = time.monotonic()
            flat, version = w.read_flat()
            prob.load_flat(torch.from_numpy(flat).to(device))
            t1 = time.perf_counter()
            if rec is not None:
                rec.event("worker.read_params", kind="span", ts=m0,
                          dur=time.monotonic() - m0, step=step)
            m1 = time.monotonic()
            _, grads = prob.grad_leaves(prob.batch_fn(step, worker_id))
            if poison:
                grads = [torch.full_like(g, float("nan")) for g in grads]
            _sync(device)
            t2 = time.perf_counter()
            compute_s = time.monotonic() - m1
            if rec is not None:
                rec.event("worker.grad", kind="span", ts=m1, dur=compute_s,
                          step=step, version=version)
            if prober is not None and step % probe_every == 0:
                try:
                    prober.write(step, w.wire.probe_fidelity(grads))
                except Exception:
                    pass  # a probe must never take a worker down
            straggle_s = 0.0
            if slow_ms:
                m2 = time.monotonic()
                time.sleep(slow_ms / 1e3)  # a deliberate straggler
                straggle_s = time.monotonic() - m2
                if rec is not None:
                    rec.event("worker.straggle", kind="span", ts=m2,
                              dur=straggle_s, step=step)
            if not drop:
                t3 = time.perf_counter()
                m3 = time.monotonic()
                seq0 = push_seq
                payload = w.encode(grads)  # on the card, D2H, one sync
                encodes += 1
                t4 = time.perf_counter()
                for _ in range(2 if duplicate else 1):
                    w.push_payload(payload, version, timeout=push_timeout,
                                   lineage=(step, push_seq))
                    push_seq += 1
                t5 = time.perf_counter()
                times["encode_s"].append(t4 - t3)
                times["push_s"].append(t5 - t4)
                if rec is not None:
                    # seq joins the span so the trace export ties this
                    # push to the server's consume span (a flow arrow)
                    rec.event("worker.push_grad", kind="span", ts=m3,
                              dur=time.monotonic() - m3, step=step,
                              version=version, seq=seq0)
            times["read_s"].append(t1 - t0)
            times["grad_s"].append(t2 - t1)
            pushed += 1
            if beacon is not None:
                # the deliberate straggler sleep emulates slow compute;
                # reads, pushes, retries and delay faults are the wire's
                wire_s = max(0.0, (time.monotonic() - t_step0) - compute_s
                             - straggle_s)
                beacon.step(step, compute_s + straggle_s, wire_s, straggle_s,
                            retries=getattr(w, "retries", 0),
                            reconnects=getattr(w, "reconnects", 0))
        if rec is not None and hasattr(w, "reconnects"):
            rec.event("resilience.summary", worker=worker_id,
                      retries=w.retries, reconnects=w.reconnects)
    finally:
        w.close()
        _dump_recorder(cfg, rec, f"worker-{worker_id}.jsonl")
        if wprof is not None:
            wprof.stop()
            wprof.write()
        if prober is not None:
            prober.close()
        if beacon is not None:
            beacon.close(retries=getattr(w, "retries", 0),
                         reconnects=getattr(w, "reconnects", 0))
    if cfg.get("stats_dir"):
        launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
        stats = {"worker": worker_id, "pushes": pushed, "encodes": encodes,
                 "sent": push_seq, **times, "launches": launches,
                 "peak_bytes": _peak_bytes(device),
                 "retries": getattr(w, "retries", 0),
                 "reconnects": getattr(w, "reconnects", 0),
                 "fallback_pushes": getattr(w, "fallback_pushes", 0),
                 "root_encodes": getattr(w, "root_encodes", 0),
                 "wire_bytes": w.wire.wire_bytes if w.wire else None,
                 "switches": switches}
        path = Path(cfg["stats_dir"]) / f"worker-{worker_id}.json"
        path.write_text(json.dumps(stats))
    return pushed


def _restore_ps_checkpoint(ckpt, template: Dict[str, Any],
                           checkpoint_every: int):
    """``(state, applied_before, version)`` from the latest PS checkpoint
    (``async_train.py:501``). The version jumps past anything a surviving
    worker could have read before the crash: the saved run's cadence
    bounds it."""
    restored = ckpt.restore(template)
    applied_before = int(restored["applied_total"])
    ckpt._last_ps_step = applied_before
    jump = max(int(restored["checkpoint_every"]), int(checkpoint_every), 0)
    return restored, applied_before, int(restored["version"]) + jump + 1


class _PSCheckpointCadence:
    """Save when the applied count has moved ``checkpoint_every`` past the
    last save, and once at the end (``async_train.py:521``)."""

    def __init__(self, ckpt, checkpoint_every: int, applied_before: int):
        self.ckpt = ckpt
        self.every = int(checkpoint_every)
        self.last_saved = int(applied_before)

    def _save(self, state, server, applied_total: int) -> None:
        if getattr(self.ckpt, "_last_ps_step", None) == applied_total:
            return
        self.ckpt.save(applied_total, {
            **state, "version": server.version,
            "applied_total": applied_total,
            "checkpoint_every": self.every})
        self.ckpt._last_ps_step = applied_total

    def maybe_save(self, state, server, applied_total: int) -> None:
        if self.every and applied_total - self.last_saved >= self.every:
            self._save(state, server, applied_total)
            self.last_saved = applied_total

    def final_save(self, state, server, applied_total: int) -> None:
        self._save(state, server, applied_total)


def _agg_armed(cfg: Dict[str, Any], server, sync_barrier: bool,
               numerics_armed: bool = False) -> bool:
    """The JAX arming rule (``async_train.py:864-916``): a sync barrier,
    a codec wire whose every unit aggregates, no numerics monitor (its
    check of each push needs the decoded gradient), and an exact algebra
    unless ``cfg["agg"] == "on"`` opts into an approximate one."""
    req = str(cfg.get("agg", "auto")).lower()
    if req not in ("auto", "on", "off"):
        raise ValueError(f"cfg['agg'] must be auto/on/off, got {req!r}")
    wire = server.wire
    armed = (req != "off" and sync_barrier and wire is not None
             and wire.agg_supported and not numerics_armed
             and (req == "on" or wire.code.agg_exact))
    if req == "on" and not armed:
        why = ("no sync barrier" if not sync_barrier
               else "no codec wire" if wire is None
               else "codec lacks an aggregation algebra"
               if not wire.agg_supported
               else "numerics monitor armed")
        print(f"compressed-domain aggregation requested but not armed "
              f"({why}); falling back to decode-sum", flush=True)
    return armed


def serve(server, cfg: Dict[str, Any], total_grads: int, *,
          sync_barrier: bool = False, total_received: Optional[int] = None,
          timeout: float = 300.0, checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0, resume: bool = False,
          on_tick=None, stop_when=None) -> Tuple[Tree, Dict[str, Any]]:
    """Server body (``async_train.py:560``): poll, decode (or fold),
    update on the card, publish. Runs until ``total_grads`` gradients
    were applied, or, with ``total_received``, until that many were
    consumed (applied or dropped as stale). Returns the final parameters
    (the JAX template's tree of numpy arrays) and the metrics: the
    server's canonical counters, the keys of ``async_train.py:1371-1384``
    and, per applied update, the server's decode, update and publish
    times.

    ``checkpoint_dir`` saves the PS state (flat parameters, optimizer
    state, publish version, applied count) every ``checkpoint_every``
    applied gradients and at the end; ``resume=True`` restores the latest
    and keeps the version monotonic.

    Resilience hooks (``async_train.py:745-765``): ``on_tick`` is called
    at most every ``cfg["tick_interval"]`` seconds (default
    :data:`TICK_S`) from inside the loop; ``stop_when``, checked at the
    same cadence, drains what is queued and returns once it is true.
    ``cfg["fault_plan"]``'s server faults fire when the applied count
    crosses their ``at_step``: ``crash_server`` raises
    :class:`InjectedServerCrash` without the final save. Under the sync
    barrier, a round that has waited ``cfg["degraded_round_after"]``
    seconds (default 5) leaves out the workers that are dead (no socket
    on TCP, silent on shm) with nothing queued and completes over the
    rest; a dead worker's next push brings it back.

    Tree mode (``cfg["tree"]``, ``async_train.py:926-960``): the
    barrier's members are the leaders ``cfg["tree_members"]`` and the
    leaf workers seen pushing to the root directly, and each round is
    divided by the composed worker-push count the frames' trailers carry
    (one a direct push), in the JAX package's order of operations.
    ``cfg["idle_share"]`` adds the card's idle share from the first
    update on (:class:`IdleMeter`) to the metrics.

    The read tier (``async_train.py:805-813``, ``:1017-1024``): the loop
    publishes through a :class:`~pytorch_ps_mpi_tpu_torch.serving.
    ServingCore` on the server. Armed (``cfg["serving"]`` or
    ``cfg["read_port"]``), each version is copied from the device into a
    host array of its own, which the core's snapshot ring adopts, and
    the metrics carry ``serving``, ``read_port`` and the publish's split
    (``server_times``: ``publish_alloc_s``, ``publish_d2h_s``,
    ``publish_transport_s``, ``publish_ring_put_s``,
    ``publish_pre_encode_s``); the read server stays up until
    ``server.close()``. Unarmed, the loop publishes from one pinned
    buffer straight to the transport (``ServingCore.publish_device``).

    The per-process telemetry (``async_train.py:597-700``) is the core's
    (:meth:`ServingCore._build_monitors`) and this loop's: the recorder's
    ``serve.grad``/``serve.update`` rows and ``ps_update_seconds``,
    ``ps_poll_wait_seconds``, ``ps_applied_total`` and
    ``ps_degraded_rounds_total`` on the scrape registry; the health
    monitor fed each consumed push and each round; the numerics monitor's
    check of each decoded push, on the card, before the update (a
    quarantined worker leaves the barrier under ``skip``; ``abort`` ends
    the loop with ``numerics_abort``) and its update-to-weight ratio at
    probe cadence; each publish billed to its pushes (lineage) and its
    round anatomy. The metrics then carry ``metrics_port``, ``health``,
    ``numerics``, ``lineage``, ``anatomy``, ``freshness``/``hop`` and,
    with ``telemetry_dir``, ``metrics_prom`` and ``telemetry_jsonl``.

    The observability plane (``async_train.py:701-731``) arms through
    the core (``server.arm_observability``): the history is sampled and
    the SLO rules evaluated at the tick, from host counters; the
    metrics gain ``history``, ``slo`` and ``profile``. The controller
    (``cfg["control"]``, ``control_kw``, ``control_dir``) is fed at the
    tick and at each consumed push (``async_train.py:827-849``): it
    renegotiates the codec through a wire-epoch bump (aggregation is
    suspended across it, and a push queued before it is decoded with the
    wire it was encoded with), weights each push by its worker's
    staleness scale, evicts churning workers from the barrier and
    readmits quarantined ones, and tunes the read tier; the metrics gain
    ``control`` (with ``epoch_old_frames``)."""
    from pytorch_ps_mpi_tpu_torch.resilience.faults import (
        FaultInjector, InjectedServerCrash)
    from pytorch_ps_mpi_tpu_torch.serving import ServingCore

    cfg = _arm_lineage(cfg)
    device = server.device
    prob = make_problem(cfg, device)
    if tuple(np.shape(x) for x in _leaves(prob.template)) != tuple(
            np.shape(x) for x in _leaves(server.template)):
        raise ValueError("the server's template is not cfg's model")
    hyper_cls, init_state, update_fn = OPTIMIZERS[cfg.get("optim", "sgd")]
    h = hyper_cls(**cfg.get("hyper", {"lr": 0.05}))
    flat = prob.flat_params()
    # SGD and Adam are elementwise: one update over the flat vector;
    # Adafactor factors each leaf's shape, so it takes them leaf by leaf
    if cfg.get("optim", "sgd") == "adafactor":
        layout, off = {}, 0
        for i, x in enumerate(_leaves(prob.template)):
            layout[str(i)] = (off, tuple(np.shape(x)))
            off += int(np.prod(np.shape(x)))
    else:
        layout = {"flat": (0, (flat.numel(),))}
    params = _views(flat, layout)
    state = init_state(params)
    ckpt, applied_before = None, 0
    if resume and not checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir")
    if checkpoint_dir:
        from pytorch_ps_mpi_tpu_torch.utils.checkpoint import \
            CheckpointManager

        ckpt = CheckpointManager(checkpoint_dir)
        if resume:
            restored, applied_before, server.version = _restore_ps_checkpoint(
                ckpt, {"flat": flat, "opt_state": state, "version": 0,
                       "applied_total": 0, "checkpoint_every": 0},
                checkpoint_every)
            flat.copy_(restored["flat"])
            state = restored["opt_state"]
    inj = FaultInjector.from_cfg(cfg, role="server")
    rec = _telemetry_from_cfg(cfg, worker="server")
    reg = server.scrape_registry()
    h_update = reg.histogram(
        "ps_update_seconds", _LATENCY_BUCKETS,
        "optimizer update + publish wall per applied round")
    h_wait = reg.histogram(
        "ps_poll_wait_seconds", _LATENCY_BUCKETS,
        "idle poll time preceding each consumed gradient (straggler wait)")
    g_applied = reg.gauge("ps_applied_total",
                          "gradients applied this serve call")
    c_degraded = reg.counter(
        "ps_degraded_rounds_total",
        "sync-barrier rounds completed over a partial fleet "
        "(transport-dead workers excluded)")
    # the core builds the monitors and the endpoint before the arming
    # rule below reads them
    core = ServingCore(server, cfg)
    monitor, numon, lint = core.health, core.numerics, core.lineage
    probe_every = int(numon.knobs["probe_every"]) if numon else 0
    # the controller before the aggregation arming: a restarted
    # generation may restore the fleet's wire epoch, which the arming
    # must see
    ctl = None
    if cfg.get("control") or cfg.get("control_kw") or cfg.get("control_dir"):
        from pytorch_ps_mpi_tpu_torch.control import Controller

        ctl = Controller(server, cfg, core=core)
    agg_armed = _agg_armed(cfg, server, sync_barrier, numon is not None)
    server.agg_mode = 1.0 if agg_armed else 0.0
    if ctl is not None:
        ctl.set_agg(agg_armed)
    if agg_armed:
        from pytorch_ps_mpi_tpu_torch.utils import native

        native.fold_lib()  # built before the first round, not in it
    agg_req = str(cfg.get("agg", "auto")).lower()
    boot_wire = server.wire

    def agg_now() -> bool:
        """Folding in the compressed domain is live unless the controller
        suspended it around a renegotiation, an old epoch may still be in
        flight, or a renegotiated wire lacks the algebra under the boot
        arming's exactness rule (``async_train.py:892-906``)."""
        if not agg_armed:
            return False
        if ctl is not None and ctl.agg_suspended:
            return False
        if getattr(server, "_epoch_table", None):
            return False
        w = server.wire
        if w is not boot_wire:
            ok = w.__dict__.get("_agg_ok")
            if ok is None:
                ok = w.agg_supported and (agg_req == "on"
                                          or w.code.agg_exact)
                w.__dict__["_agg_ok"] = ok
            return ok
        return True
    times = collections.defaultdict(float)
    marks: List[Tuple[float, int]] = []  # (seconds, applied) an update

    def publish() -> None:
        t0 = time.perf_counter()
        core.publish_device(flat)
        times["publish_s"] += time.perf_counter() - t0

    prob.load_flat(flat)
    loss0 = prob.eval_loss()
    launches0 = kernel_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    publish()
    applied = degraded_rounds = 0
    last_applied_total = applied_before
    cadence = (_PSCheckpointCadence(ckpt, checkpoint_every, applied_before)
               if ckpt else None)
    n_workers = server.num_workers
    tree_mode = bool(cfg.get("tree"))
    tree_members = set(int(w) for w in (cfg.get("tree_members") or ()))
    tree_joined: set = set()
    composed_queue = (getattr(server, "_composed_queue", None)
                      if tree_mode else None)
    # a FIFO a worker: a fast worker may deliver several gradients before
    # a straggler's first, and each enters exactly one round
    pending: Dict[int, collections.deque] = collections.defaultdict(
        collections.deque)
    # when each worker first had a gradient queued in the current round:
    # the health monitor's critical-path bookkeeping
    round_ready: Dict[int, float] = {}
    numerics_stop = False
    next_probe = 0  # the applied count of the next update-ratio probe
    dead_workers: set = set()
    degrade_after = float(cfg.get("degraded_round_after", 5.0))
    tick_interval = float(cfg.get("tick_interval", TICK_S))
    batch_poll = getattr(server, "poll_grad_batch", None)
    inbox: collections.deque = collections.deque()
    t_start = time.perf_counter()
    deadline = t_start + timeout
    next_tick = 0.0
    round_t0 = wait_t0 = t_start
    draining = False

    def keep_going() -> bool:
        if total_received is not None:
            return server.grads_received < total_received
        return applied < total_grads

    def next_item():
        # each item rides with the wire it was validated against at poll
        # time (None: decoded), so a suspension or an epoch bump in the
        # middle of the inbox never misreads a payload
        if inbox:
            return inbox.popleft()
        raw = agg_now()
        enc = server.wire if raw else None
        if batch_poll is not None:
            batch = batch_poll(raw=raw)
            if batch is not None:
                inbox.extend((it, enc) for it in batch)
                return inbox.popleft() if inbox else None
        item = server.poll_grad(raw=raw)
        return None if item is None else (item, enc)

    # cfg["idle_share"]: the card's idle share from the first update on
    meter = IdleMeter(device) if cfg.get("idle_share") else None

    def fire_server_faults() -> None:
        """Server faults whose at_step the applied count crossed
        (``async_train.py:1000-1018``); a crash raises after all fired."""
        nonlocal last_applied_total
        hi = applied_before + applied
        if inj is None or hi == last_applied_total:
            return
        crash = None
        for f in inj.faults_between(last_applied_total, hi):
            inj.fire(f)
            if f["kind"] == "crash_server":
                crash = f
            elif f["kind"] == "delay":
                time.sleep(float(f.get("delay_ms", 100.0)) / 1e3)
        last_applied_total = hi
        if crash is not None:
            if meter is not None:
                meter.stop()  # a crash ends the trace, not the process
            raise InjectedServerCrash(crash)

    def apply(grad_flat: torch.Tensor, n_contrib: int, up_t0: float,
              lineage_workers=None) -> None:
        nonlocal applied, state, next_probe
        if meter is not None:
            meter.start()
        probe = numon is not None and applied >= next_probe
        old = flat.clone() if probe else None
        t0 = time.perf_counter()
        _, state = update_fn(params, _views(grad_flat, layout), state, h)
        _sync(device)
        times["update_s"] += time.perf_counter() - t0
        applied += n_contrib
        if probe:
            # ||dp||/||p|| at probe cadence only: the old parameters are
            # kept just long enough for one reduction on the card
            numon.observe_update([old], [flat], applied_before + applied)
            next_probe = applied + probe_every
        server.grad_publishes += 1
        publish()
        up_dur = time.perf_counter() - up_t0
        h_update.observe(up_dur)
        g_applied.set(float(applied))
        if rec is not None:
            rec.event("serve.update", kind="span",
                      ts=time.monotonic() - up_dur, dur=up_dur,
                      step=applied, version=server.version)
        if lint is not None:
            # bill the published version with its composing pushes (one
            # a worker of the round; the push just applied in async mode)
            lint.observe_publish(server.version, up_dur,
                                 workers=lineage_workers)
        marks.append((time.perf_counter() - t_start, applied))
        if cadence:
            cadence.maybe_save({"flat": flat, "opt_state": state}, server,
                               applied_before + applied)
        fire_server_faults()

    def mark_dead_workers() -> None:
        """The liveness sweep of a round that waited ``degrade_after``
        (``async_train.py:1041-1075``): TCP's open socket, shm's silence.
        A worker with a queued gradient, or never seen, is never marked;
        a fallen-back leaf whose root socket closed (it went back to its
        leader) leaves the tree barrier instead."""
        can_connect = hasattr(server, "connected")
        silent = None if can_connect else server.stragglers(degrade_after)
        for w in range(n_workers):
            if w in dead_workers or pending[w] or w not in server.last_seen:
                continue
            alive = server.connected(w) if can_connect else w not in silent
            if not alive:
                if tree_mode and w not in tree_members and w in tree_joined:
                    tree_joined.discard(w)
                    continue
                dead_workers.add(w)

    def try_round(only_queued: bool = False) -> bool:
        """One sync round over the active workers, if each has a gradient
        queued (``async_train.py:1077-1180``); ``only_queued`` (the tree
        drain) completes a partial round over what is queued. A worker
        quarantined under the numerics ``skip`` policy leaves the
        barrier, as a dead one does."""
        nonlocal degraded_rounds, round_t0, wait_t0
        if tree_mode:
            active = [w for w in sorted(tree_members | tree_joined)
                      if w not in dead_workers]
            if only_queued:
                active = [w for w in active if pending[w]]
        else:
            active = [w for w in range(n_workers) if w not in dead_workers]
        if numon is not None and numon.knobs["policy"] == "skip":
            active = [w for w in active if not numon.is_quarantined(w)]
        if ctl is not None:
            # controller-evicted workers leave the barrier as quarantined
            # ones do; the backoff readmission brings them back
            active = [w for w in active if not ctl.is_evicted(w)]
        if not active or any(not pending[w] for w in active):
            return False
        up_t0 = time.perf_counter()
        entries = [pending[w].popleft() for w in active]
        total_comp = sum(e[1] for e in entries)
        t0 = time.perf_counter()
        cur_wire = server.wire
        if agg_now() and all(e[3] is cur_wire for e in entries):
            # the round's payloads folded on the host, one decode; the
            # controller's weights cannot scale a compressed payload
            agg = cur_wire.agg_begin()
            for buf, *_ in entries:
                agg.fold(buf)
            leaves = agg.finalize_leaves()
            server.decodes_done += 1
            inv = np.float32(1.0 / total_comp)
            summed = torch.from_numpy(np.concatenate(
                [x.reshape(-1) for x in leaves]) * inv).to(device)
            times["fold_s"] += time.perf_counter() - t0
        else:
            grads, wgts = [], []
            for g, _, wgt, enc in entries:
                if enc is not None:
                    # queued raw before a suspension or an epoch bump:
                    # decoded now with the wire it was encoded with
                    g = torch.cat([x.reshape(-1) for x in _leaves(
                        server._decode_payload(g, wire=enc))])
                grads.append(g)
                wgts.append(float(wgt))
            if all(wt == 1.0 for wt in wgts):
                summed = grads[0].clone()
                for g in grads[1:]:
                    summed += g
            else:
                # staleness-aware weights (AsySG-InCon): the denominator
                # stays the composed count, so a weight only shrinks the
                # stale worker's step
                summed = grads[0] * wgts[0]
                for g, wt in zip(grads[1:], wgts[1:]):
                    summed += g * wt
            summed /= total_comp
        if monitor is not None:
            # bill the round's critical path to the last-ready worker,
            # then reopen the book for workers already queued again
            monitor.observe_round(round_ready, active)
            round_ready.clear()
            for w2 in range(n_workers):
                if pending[w2]:
                    round_ready[w2] = up_t0
        if (bool(dead_workers) if tree_mode
                else len(entries) < n_workers):
            degraded_rounds += 1
            c_degraded.inc()
            if rec is not None:
                rec.event("serve.degraded_round", step=applied,
                          absent=sorted(dead_workers))
        apply(summed, len(entries), up_t0, lineage_workers=active)
        round_t0 = wait_t0 = time.perf_counter()
        return True

    while keep_going() and time.perf_counter() < deadline:
        now = time.perf_counter()
        if now >= next_tick:
            next_tick = now + tick_interval
            if on_tick is not None:
                on_tick()
            core.tick()  # the monitors' tails, the history and the SLO
            if ctl is not None:
                # the verdict -> action sweep (self-throttled): one input
                # row persisted, the engine run, its actions executed
                ctl.tick()
                if agg_armed:
                    server.agg_mode = 1.0 if agg_now() else 0.0
            if stop_when is not None and not draining and stop_when():
                draining = True  # consume what is queued, then return
            if sync_barrier and now - round_t0 > degrade_after:
                mark_dead_workers()
                while try_round():
                    pass
        t0 = time.perf_counter()
        pair = next_item()
        if pair is None:
            if draining:
                break
            time.sleep(0.0005)
            continue
        (wid, grad_version, grad), item_wire = pair
        # the frame's composed count, queued by the consume in item order
        comp_n = (composed_queue.popleft()
                  if composed_queue is not None else 1)
        if item_wire is not None:
            if not item_wire.payload_finite(grad):
                server._reject_frame(wid, "nonfinite")
                if lint is not None:
                    lint.discard_last(wid, reason="nonfinite")
                wait_t0 = time.perf_counter()
                continue
            grad = np.copy(grad)  # the view dies at the next poll
        elif agg_req == "on" and not agg_armed:
            server.agg_fallbacks += 1
        wait_s = time.perf_counter() - wait_t0
        h_wait.observe(wait_s)
        staleness = max(0, server.version - grad_version)
        if rec is not None:
            rec.event("serve.grad", worker=wid, staleness=staleness,
                      step=applied, version=grad_version)
        if monitor is not None:
            monitor.observe_grad(wid, staleness, wait_s)
        if ctl is not None:
            # per-worker staleness: the lr_scale rule's input when
            # lineage's exact windows are off
            ctl.observe_push(wid, staleness)
        if numon is not None:
            # the decoded push checked on the card before it can touch
            # the update; the policy decides its fate
            action = numon.observe_push(wid, grad, applied_before + applied)
            if action == "abort":
                numerics_stop = True
                if lint is not None:
                    lint.discard_last(wid, reason="numerics")
                break
            if action == "skip":
                if lint is not None:
                    lint.discard_last(wid, reason="numerics")
                wait_t0 = time.perf_counter()
                continue
            if action == "zero":
                from pytorch_ps_mpi_tpu_torch.telemetry.numerics import \
                    sanitize_tree

                grad = sanitize_tree(grad)
        if item_wire is None:
            grad = torch.cat([x.reshape(-1) for x in _leaves(grad)])
            if agg_armed and not bool(torch.isfinite(grad).all()):
                # aggregation suspended around a renegotiation: the push
                # arrived decoded, and with the numerics monitor off (the
                # arming rule) the non-finite screen follows it here
                server._reject_frame(wid, "nonfinite")
                if lint is not None:
                    lint.discard_last(wid, reason="nonfinite")
                wait_t0 = time.perf_counter()
                continue
        times["ingest_s"] += time.perf_counter() - t0
        if sync_barrier:
            dead_workers.discard(wid)  # a push proves it alive
            if tree_mode:
                tree_joined.add(wid)
            if ctl is not None and ctl.is_evicted(wid):
                # an evicted worker's pushes are dropped, not queued: a
                # backlog would re-apply stale gradients after the
                # readmission (no rejection count, which feeds the churn
                # verdict)
                if lint is not None:
                    lint.discard_last(wid, reason="evicted")
                if rec is not None:
                    rec.event("serve.evicted_drop", worker=wid)
                wait_t0 = time.perf_counter()
                continue
            pending[wid].append((
                grad, comp_n,
                ctl.push_weight(wid) if ctl is not None else 1.0,
                item_wire))
            if monitor is not None and wid not in round_ready:
                round_ready[wid] = time.perf_counter()
            if not try_round():
                wait_t0 = time.perf_counter()
        else:
            up_t0 = time.perf_counter()
            wgt = ctl.push_weight(wid) if ctl is not None else 1.0
            if wgt != 1.0:
                # the controller's staleness weight, the group mean folded
                # into the same product
                grad = grad * wgt / comp_n
            elif comp_n > 1:
                # a composed frame carries its group's sum: its mean
                grad = grad / comp_n
            apply(grad, 1, up_t0)
            wait_t0 = time.perf_counter()
    if tree_mode and sync_barrier:
        # consumed frames still queued compose one partial round each
        while try_round(only_queued=True):
            pass
    wall = time.perf_counter() - t_start
    idle = meter.stop() if meter is not None else {}
    # the rate from the first update to the last: the workers' start-up
    # (spawn, device, model) stays out of it
    steady = ((marks[-1][1] - marks[0][1]) / (marks[-1][0] - marks[0][0])
              if len(marks) > 1 and marks[-1][0] > marks[0][0] else 0.0)
    if cadence:
        cadence.final_save({"flat": flat, "opt_state": state}, server,
                           applied_before + applied)
    if numon is not None:
        # the workers' last probe rows land after the loop's last tick:
        # drain them before any metrics snapshot reads the gauges, and
        # close the trajectory on the final state
        numon.tick()
        numon._trajectory_row(applied_before + applied)
    prob.load_flat(flat)
    if core.armed:
        for k, v in core.publish_times.items():
            times[f"publish_{k}"] = v
    m = dict(server.metrics())
    m.update(
        applied=float(applied),
        applied_total=float(applied_before + applied),
        wall_s=wall,
        updates_per_sec=applied / wall if wall > 0 else 0.0,
        steady_updates_per_sec=steady,
        loss_initial=loss0,
        loss_final=prob.eval_loss(),
        staleness_hist={int(k): int(v)
                        for k, v in server.staleness_seen.items()},
        publish_version=float(server.version),
        degraded_rounds=float(degraded_rounds),
        frames_rejected_by_worker={int(k): int(v) for k, v in
                                   server.frames_rejected.items()},
        reject_reasons=dict(server.__dict__.get("reject_reasons", {})),
        decodes_done=float(server.decodes_done),
        server_times=dict(times),
        server_launches={k: v - launches0[k]
                         for k, v in kernel_launches().items()},
        server_peak_bytes=_peak_bytes(device),
        **idle,
    )
    if hasattr(server, "native_batches"):
        m["native_batches"] = float(server.native_batches)
        m["native_batch_frames"] = float(server.native_batch_frames)
    if core.armed:
        m["serving"] = core.serving_snapshot()
        if core.read_port is not None:
            m["read_port"] = core.read_port
    if core.metrics_http_port is not None:
        # the endpoint stays up until server.close()
        m["metrics_port"] = core.metrics_http_port
    if monitor is not None:
        m["health"] = monitor.snapshot()
    if numon is not None:
        m["numerics"] = numon.snapshot()
        if numerics_stop:
            m["numerics_abort"] = numon.aborted
        numon.close()
    if lint is not None:
        m["lineage"] = lint.snapshot()
        lint.close()
    if core.anatomy is not None:
        # per-stage critical-path shares and the ranked what-if advisor
        m["anatomy"] = core.anatomy.snapshot()
        core.anatomy.close()
    if ctl is not None:
        snap = ctl.snapshot()
        # every old-epoch frame consumed across a renegotiation: they
        # would have been "config" rejections without the epoch table
        snap["epoch_old_frames"] = int(server.epoch_old_frames)
        m["control"] = snap
        ctl.close()
    if server.timeseries_db is not None:
        # one closing sample on the final counters (forced past the
        # ingest throttle)
        server.timeseries_db.sample(server.metrics(), force=True)
    m.update(server.finalize_observability())
    if cfg.get("telemetry_dir"):
        # the final scrape beside the recorder dumps, for offline readers
        prom_path = os.path.join(cfg["telemetry_dir"], "metrics.prom")
        os.makedirs(cfg["telemetry_dir"], exist_ok=True)
        with open(prom_path, "w") as f:
            f.write(server.prometheus_text())
        m["metrics_prom"] = prom_path
    jsonl = _dump_recorder(cfg, rec, "server.jsonl")
    if jsonl is not None:
        m["telemetry_jsonl"] = jsonl
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import unflatten_params

    return unflatten_params(flat.cpu().numpy(), server.template), m


def _leaves(tree) -> list:
    from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

    return tree_flatten(tree)[0]


def _views(vec: torch.Tensor, layout: Dict[str, Tuple[int, tuple]]
           ) -> Dict[str, torch.Tensor]:
    """``name -> view`` of a flat vector, each at its (offset, shape)."""
    return {k: vec[off:off + math.prod(shape)].view(shape)
            for k, (off, shape) in layout.items()}


def spawn_python(src: str, args: List[str],
                 env: Optional[Dict[str, str]] = None,
                 stdout=None) -> subprocess.Popen:
    """``python -c src args...`` in a fresh interpreter that imports this
    checkout: never a fork of a process that has started CUDA. With
    ``stdout=subprocess.PIPE`` its output is read as text."""
    root = str(Path(__file__).resolve().parents[2])
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in e.get("PYTHONPATH", "").split(os.pathsep) if p])
    e.update(env or {})
    return subprocess.Popen([sys.executable, "-c", src, *args], env=e,
                            stdout=stdout, text=stdout is not None)


def spawn_worker(name: str, worker_id: int, cfg: Dict[str, Any],
                 env: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """``worker_main`` in a fresh interpreter (``async_train.py:1449``)."""
    src = ("import json, sys\n"
           "from pytorch_ps_mpi_tpu_torch.parallel.async_train import "
           "worker_main\n"
           "name, wid, cfg = sys.argv[1], int(sys.argv[2]), "
           "json.loads(sys.argv[3])\n"
           "sys.exit(0 if worker_main(name, wid, cfg) >= 0 else 1)\n")
    return spawn_python(src, [name, str(worker_id), json.dumps(cfg)], env)


def join_workers(procs, timeout: float = 120.0) -> List[Optional[int]]:
    """Reap a fleet of spawned workers without leaking one: wait up to
    ``timeout`` seconds in all, then terminate (escalating to kill) what
    is still running. Returns the exit codes in ``procs`` order."""
    codes: List[Optional[int]] = [None] * len(procs)
    deadline = time.time() + timeout
    try:
        for i, p in enumerate(procs):
            left = deadline - time.time()
            if left <= 0:
                break
            try:
                codes[i] = p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                pass
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        pass
            if codes[i] is None:
                codes[i] = p.returncode
    return codes

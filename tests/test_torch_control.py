"""The port's controller (``control/``) held against the JAX package's: the
pure :class:`ControlEngine` fed the same numpy-made input rows gives
byte-identical action rows for every rule, and so does each package's
``Controller.replay``; each package reads the other's ``control-epoch.json``
and ``control-topo.json``; a renegotiated wire's fingerprint is the JAX
wire's. Then the live transports: a world-2 shm renegotiation consumes
every frame, TCP bypasses and re-arms its native batched ingest, an
oversized rung is refused, a kernel fault in ``apply_epoch`` raises while
a malformed document is ignored, and a two-worker MLP fleet downshifts
identity -> int8 through ``serve``. No test decides by a wall-clock race:
the engine tests feed rows, and every join is bounded."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.control import controller as jctl
from pytorch_ps_mpi_tpu.control import topo as jtopo
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.control import controller as tctl
from pytorch_ps_mpi_tpu_torch.control import topo as ttopo
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.parallel import dcn
from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer, TcpPSWorker
from pytorch_ps_mpi_tpu_torch.resilience import frames

LIMIT = 120
TEMPLATE = {"a": np.zeros((64, 8), np.float32), "b": np.zeros(32, np.float32)}


def _knobs(**over):
    base = {"warmup_s": 1.0, "cooldown_s": 2.0, "window_s": 3.0,
            "settle_s": 2.0, "probation_s": 1.0, "evict_backoff_s": 2.0,
            "read_p95_target_ms": 100.0,
            "ladder": [{"codec": "identity"}, {"codec": "int8"}],
            "topo_actions": True, "replan_max": 1, "replan_cooldown_s": 2.0,
            "leader_fold_hot_frac": 0.2, "leader_churn_replan": 2.0,
            "replica_min": 0, "replica_max": 2, "replica_cooldown_s": 1.0,
            "replica_shed_per_s": 2.0, "replica_lag_hi": 4.0,
            "shard_cooldown_s": 1.0, "shard_split_skew": 0.5,
            "shard_merge_skew": 0.1}
    base.update(over)
    return base


def _row(t, n, rng, **over):
    """One input row: a healthy fleet with a little seeded noise."""
    row = {"ts": t, "wire_s": 0.0, "compute_s": 0.01, "stale_p50": 1.0,
           "stale_p95": 1.0, "stale_drops": 0.0, "grads_received": t,
           "frames_rejected": 0.0, "push_e2e_p95_ms": 5.0,
           "reads_shed": 0.0, "read_p95_ms": float(rng.uniform(1, 3)),
           "ring_ageouts": 0.0, "serving": 1.0, "epoch_pending": 0.0,
           "decodes_per_publish": 1.0, "regime_src": 0.0,
           "tree_groups": 2.0, "hot_group": -1.0, "hot_churn_group": -1.0,
           "leader_respawns": 0.0, "lf_top": 0.0, "lf_saving_frac": 0.0,
           "hop_rounds": 0.0, "hop_busy_frac": 0.0,
           "hop_headroom_ratio": 1.0, "replicas_live": 0.0,
           "replica_lag_max": 0.0, "edge_age_ms": 0.0, "shards_n": 0.0,
           "shard_skew": 0.0, "shard_skew_hot": 0.0}
    for w in range(n):
        row.update({f"w{w}_stale": 1.0, f"w{w}_quar": 0.0,
                    f"w{w}_nonfinite": 0.0, f"w{w}_churn": 0.0,
                    f"w{w}_grads": float(t)})
    row.update(over)
    return row


def _scenario(rule: str, seed: int = 0, n: int = 3):
    """Rows that drive ``rule`` on and back off (a ramp, a plateau, a
    recovery), with seeded noise on the healthy keys."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(60):
        t = 100.0 + 0.5 * i
        hot = 8 <= i < 30
        over = {}
        if rule == "codec":
            frac = rng.uniform(0.8, 0.95) if hot else rng.uniform(0, 0.1)
            over = {"wire_s": float(frac), "compute_s": float(1 - frac),
                    "epoch_pending": 1.0 if i in (9, 10) else 0.0}
        elif rule == "lr_scale":
            over = {"w1_stale": float(rng.randint(6, 9)) if hot else 1.0}
        elif rule == "evict":
            over = {"w2_churn": float(4 * i) if hot else 4.0 * 30,
                    "w0_quar": 1.0 if 5 <= i < 12 else 0.0,
                    "w0_nonfinite": 2.0 if i >= 5 else 0.0}
        elif rule == "read_tier":
            over = {"reads_shed": float(10 * min(i, 30)),
                    "ring_ageouts": float(5 * i),
                    "read_p95_ms": 500.0 if 40 <= i < 46 else 2.0}
        elif rule == "topo":
            over = {"lf_top": 1.0 if hot else 0.0,
                    "hot_group": 1.0 if hot else -1.0,
                    "lf_saving_frac": 0.4 if hot else 0.0,
                    "reads_shed": float(5 * min(i, 20)),
                    "replica_lag_max": 6.0 if i > 40 else 0.0,
                    "shards_n": 2.0,
                    "shard_skew": 0.7 if hot else 0.05,
                    "shard_skew_hot": 1.0 if hot else 0.0}
        rows.append(_row(t, n, rng, **over))
    return rows


RULES = ("codec", "lr_scale", "evict", "read_tier", "topo")


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("agg", [False, True])
def test_engine_action_rows_match_jax(rule, agg):
    knobs = _knobs()
    rows = _scenario(rule, seed=RULES.index(rule))
    engines = [mod.ControlEngine(knobs, 3, agg_capable=agg, depth=8, ring=4)
               for mod in (jctl, tctl)]
    out = [[], []]
    for r in rows:
        for k, eng in enumerate(engines):
            out[k].extend(eng.step(dict(r)))
    assert json.dumps(out[1]) == json.dumps(out[0])
    assert [a for a in out[1] if a["rule"] == rule], rule
    assert json.dumps(engines[1].snapshot()) == json.dumps(
        engines[0].snapshot())
    assert engines[1].flaps == 0


def test_replay_matches_jax_over_every_rule(tmp_path):
    """The rows of every scenario in one sequence, persisted through the
    port's TSDB as the live controller persists them: each package's
    replay re-derives the port engine's live actions byte for byte."""
    rows = []
    for k, rule in enumerate(RULES):
        for r in _scenario(rule, seed=10 + k):
            rows.append({**r, "ts": r["ts"] + 40.0 * k})
    from pytorch_ps_mpi_tpu_torch.telemetry.timeseries import (
        MetricsHistory, load_timeseries_rows)

    knobs = _knobs()
    hist = MetricsHistory(dir=str(tmp_path), name="control-server")
    live = tctl.ControlEngine(knobs, 3, depth=8, ring=4)
    acts = []
    for r in rows:
        assert hist.sample(r, now=r["ts"], force=True)
        acts.extend(live.step(r))
    hist.close()
    persisted = load_timeseries_rows(
        str(tmp_path / "timeseries-control-server.jsonl"))
    assert len(persisted) == len(rows)
    cfg = {"control_kw": knobs}
    for mod in (tctl, jctl):
        replayed = mod.Controller.replay(persisted, num_workers=3, cfg=cfg,
                                         depth=8, ring=4)
        assert json.dumps(replayed) == json.dumps(acts)
    assert {a["rule"] for a in acts} == set(RULES)


def test_epoch_and_topo_documents_cross_read(tmp_path):
    pairs = ((tctl, jctl, ttopo, jtopo), (jctl, tctl, jtopo, ttopo))
    for i, (wctl, rctl, wtopo, rtopo) in enumerate(pairs):
        d = str(tmp_path / str(i))
        state = {"epoch": 0, "mtime": 0}
        assert rctl.poll_epoch(d, state) is None
        wctl.write_epoch(d, {"epoch": 1, "codec": "int8", "codec_kw": {},
                             "bucket_mb": 0.0})
        doc = rctl.poll_epoch(d, state)
        assert doc == {"epoch": 1, "codec": "int8", "codec_kw": {},
                       "bucket_mb": 0.0}
        assert rctl.poll_epoch(d, state) is None  # mtime-gated
        tstate = {"seq": 0, "mtime": 0}
        wtopo.update_topo(d, assign={"2": "127.0.0.1:7001"})
        wtopo.write_shard_plan(d, 3, {"kind": "shard_skew", "id": 7})
        doc = rtopo.poll_topo(d, tstate)
        assert doc["seq"] == 2 and doc["shards"] == 3
        assert doc["assign"] == {"2": "127.0.0.1:7001"}
        assert rtopo.planned_shards(d, 2) == 3


def test_planned_shards_split_and_merge(tmp_path):
    from pytorch_ps_mpi_tpu_torch.parallel import sharded

    d = str(tmp_path)
    eng = tctl.ControlEngine(_knobs(ladder=None), 2)
    for r in _scenario("topo"):
        for a in eng.step(r):
            if a["action"] in ("shard_split", "shard_merge"):
                ttopo.write_shard_plan(d, int(a["new"]), a["verdict"])
                want = 3 if a["action"] == "shard_split" else 2
                assert sharded.planned_shards(d, 2) == want
    kinds = [a["action"] for a in eng.actions
             if a["action"].startswith("shard")]
    assert kinds == ["shard_split", "shard_merge"]
    assert sharded.planned_shards(d, 5) == 2  # the plan wins over cfg


@pytest.mark.parametrize("codec", ["int8", "sign", "identity"])
def test_renegotiated_fingerprint_matches_jax(codec):
    import jax.numpy as jnp

    from pytorch_ps_mpi_tpu.codecs import get_codec as jget
    from pytorch_ps_mpi_tpu.parallel.dcn import CodecWire as JWire
    from pytorch_ps_mpi_tpu.resilience import frames as jframes

    jtmpl = {k: jnp.zeros(v.shape) for k, v in TEMPLATE.items()}
    want = jframes.wire_fingerprint(JWire(jget(codec), jtmpl), jtmpl)
    srv = TcpPSServer(0, 1, TEMPLATE, code=get_codec("identity"),
                      frame=True, device="cpu")
    try:
        if codec != "identity":
            srv.renegotiate_wire(get_codec(codec))
        assert srv._fingerprint == want
        w = dcn.CodecWire(get_codec(codec), TEMPLATE, device="cpu")
        assert frames.wire_fingerprint(w, TEMPLATE) == want
    finally:
        srv.close()


def _grad(rng):
    return {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in TEMPLATE.items()}


def test_shm_world2_renegotiation_loses_no_frame():
    name = f"/psq_torch_reneg_{os.getpid()}"
    srv = dcn.ShmPSServer(name, 2, TEMPLATE, max_staleness=10 ** 9,
                          code=get_codec("identity"), frame=True,
                          device="cpu")
    ws = []
    try:
        ws = [dcn.ShmPSWorker(name, i, TEMPLATE, code=get_codec("identity"),
                              frame=True, device="cpu") for i in range(2)]
        srv.publish(TEMPLATE)
        rng = np.random.RandomState(0)
        pushed, got = 0, []

        def drain():
            while True:
                item = srv.poll_grad()
                if item is None:
                    return
                got.append(item)

        for step in range(6):
            if step == 2:
                srv.renegotiate_wire(get_codec("int8"))
            if step == 3:  # worker 0 follows at once, worker 1 a step late
                assert tctl.apply_epoch(ws[0], {"epoch": 1,
                                                "codec": "int8"})
            if step == 4:
                assert tctl.apply_epoch(ws[1], {"epoch": 1,
                                                "codec": "int8"})
            for w in ws:
                g = _grad(rng)
                w.push_grad(g, 1, lineage=(step, step))
                pushed += 1
                if step == 2 and w.worker_id == 0:
                    continue  # a frame in flight across the bump
                drain()
        drain()
        assert len(got) == pushed and not srv.frames_rejected
        assert srv.epoch_old_frames == 3  # the boot epoch's, after it
        assert srv.epoch_frames == {0: {0: 3, 1: 3}, 1: {0: 4, 1: 2}}
        assert getattr(srv, "epoch_regressions", 0) == 0
        srv.finish_renegotiation()
        assert srv._epoch_table == {}
    finally:
        for w in ws:
            w.close()
        srv.close()


def test_tcp_renegotiation_bypasses_and_rearms_native_batch():
    import threading

    srv = TcpPSServer(0, 2, TEMPLATE, max_staleness=10 ** 9,
                      code=get_codec("identity"), frame=True, device="cpu")
    ws = []
    try:
        ws = [TcpPSWorker("127.0.0.1", srv.port, i, TEMPLATE,
                          code=get_codec("identity"), frame=True,
                          device="cpu", timeout=LIMIT) for i in range(2)]
        srv.publish(TEMPLATE)
        rng = np.random.RandomState(1)

        def push_and_consume(workers):
            # a push waits for its ack, which the server's pump sends:
            # the pushes run beside the consuming loop
            grads = [_grad(rng) for _ in workers]
            threads = [threading.Thread(target=w.push_grad, args=(g, 1),
                                        kwargs={"timeout": LIMIT})
                       for w, g in zip(workers, grads)]
            for t in threads:
                t.start()
            got, deadline = [], time.time() + LIMIT
            while len(got) < len(workers) and time.time() < deadline:
                batch = srv.poll_grad_batch()
                if batch is None:
                    item = srv.poll_grad()
                    batch = [] if item is None else [item]
                got.extend(batch)
                time.sleep(0.001)
            for t in threads:
                t.join(timeout=LIMIT)
            return got

        assert len(push_and_consume(ws)) == 2
        before = srv.native_batches
        assert before >= 1  # the batched ingest at boot
        srv.renegotiate_wire(get_codec("int8"))
        assert srv.poll_grad_batch() is None  # bypassed mid-transition
        assert tctl.apply_epoch(ws[1], {"epoch": 1, "codec": "int8"})
        # worker 0 still on the old epoch, worker 1 on the new one
        assert len(push_and_consume(ws)) == 2
        assert srv.native_batches == before
        assert srv.epoch_old_frames == 1 and not srv.frames_rejected
        assert tctl.apply_epoch(ws[0], {"epoch": 1, "codec": "int8"})
        srv.finish_renegotiation()
        assert len(push_and_consume(ws)) == 2
        assert srv.native_batches > before  # re-armed on the new wire
        assert not srv.frames_rejected
        assert srv.epoch_frames == {0: {0: 2, 1: 1}, 1: {0: 1, 1: 2}}
    finally:
        for w in ws:
            w.close()
        srv.close()


def test_oversized_rung_is_refused(tmp_path):
    srv = TcpPSServer(0, 1, TEMPLATE, code=get_codec("int8"), frame=True,
                      device="cpu")
    try:
        with pytest.raises(ValueError, match="boot wire"):
            srv.renegotiate_wire(get_codec("identity"))
        with pytest.raises(ValueError, match="boot wire"):
            tctl.Controller(srv, {"control_dir": str(tmp_path),
                                  "control_kw": {"ladder": [
                                      {"codec": "int8"},
                                      {"codec": "identity"}]}})
        srv.renegotiate_wire(get_codec("sign"))  # within the boot frame
        assert srv._epoch == 1
    finally:
        srv.close()


def test_apply_epoch_raises_on_a_kernel_fault_and_ignores_malformed(
        monkeypatch):
    name = f"/psq_torch_apply_{os.getpid()}"
    srv = dcn.ShmPSServer(name, 1, TEMPLATE, code=get_codec("identity"),
                          frame=True, device="cpu")
    w = None
    try:
        w = dcn.ShmPSWorker(name, 0, TEMPLATE, code=get_codec("identity"),
                            frame=True, device="cpu")
        boot = w.wire
        for doc in ({"epoch": 1, "codec": "nope"}, {"epoch": 1},
                    {"epoch": 1, "codec": "int8", "bucket_mb": "x"},
                    {"epoch": 1, "codec": "int8", "codec_kw": {"bad": 1}}):
            assert tctl.apply_epoch(w, doc) is False
            assert w.wire is boot
        # a kernel that cannot be built or loaded is no malformed
        # document: it raises, and the worker stays visibly on its wire

        def fail(self):
            raise RuntimeError("nvcc failed on csrc/quant.cu")

        monkeypatch.setattr(dcn.CodecWire, "load_kernels", fail)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            tctl.apply_epoch(w, {"epoch": 1, "codec": "int8"})
        assert w.wire is boot
        # and at boot, where the worker builds its ladder's wires
        with pytest.raises(RuntimeError, match="nvcc failed"):
            tctl.prepare_ladder(w, [{"codec": "identity"},
                                    {"codec": "int8"}],
                                boot=tctl.rung_key({"codec": "identity"}))
        assert w.wire is boot and not w._prepared
    finally:
        if w is not None:
            w.close()
        srv.close()


def test_prepared_rung_is_swapped_in_at_its_epoch():
    """``prepare_ladder`` builds each rung but the boot one at the
    worker's boot; the epoch then swaps that very wire in, with the
    fingerprint a wire built at the switch has."""
    name = f"/psq_torch_prep_{os.getpid()}"
    srv = dcn.ShmPSServer(name, 1, TEMPLATE, code=get_codec("identity"),
                          frame=True, device="cpu")
    w = None
    try:
        w = dcn.ShmPSWorker(name, 0, TEMPLATE, code=get_codec("identity"),
                            frame=True, device="cpu")
        ladder = [{"codec": "identity"}, {"codec": "int8"},
                  {"codec": "nope"}, {"codec": "sign", "bucket_mb": 1.0}]
        assert tctl.prepare_ladder(
            w, ladder, boot=tctl.rung_key({"codec": "identity"})) == 2
        int8 = w._prepared[tctl.rung_key({"codec": "int8"})]
        assert tctl.apply_epoch(w, {"epoch": 1, "codec": "int8"})
        assert w.wire is int8
        fresh = dcn.CodecWire(get_codec("int8"), TEMPLATE, seed=w._seed,
                              device="cpu")
        assert w._fingerprint == frames.wire_fingerprint(fresh, TEMPLATE)
        srv.renegotiate_wire(get_codec("int8"))
        srv.publish(TEMPLATE)
        w.push_grad(_grad(np.random.RandomState(0)), 1)
        assert srv.poll_grad() is not None
        assert not srv.frames_rejected
    finally:
        if w is not None:
            w.close()
        srv.close()


def test_controller_raises_on_a_server_kernel_fault(tmp_path, monkeypatch):
    """The server half of the kernel-fault rule: a renegotiation whose
    codec's kernels do not build or load raises out of the controller
    (and so out of ``serve``), at an action and at a restart's epoch
    restore; any other failed execution is counted."""
    cfg = {"control_dir": str(tmp_path), "control_kw": {"ladder": [
        {"codec": "identity"}, {"codec": "int8"}]}}
    srv = TcpPSServer(0, 1, TEMPLATE, code=get_codec("identity"),
                      frame=True, device="cpu")
    try:
        ctl = tctl.Controller(srv, cfg)
        ctl.engine.ladder_idx, ctl.engine.epoch = 1, 1
        act = {"rule": "codec", "action": "renegotiate"}

        def refuse(self, code, bucket_mb=0.0):
            raise ValueError("renegotiated wire needs more than the boot")

        monkeypatch.setattr(TcpPSServer, "renegotiate_wire", refuse)
        ctl._execute(act)  # counted: not a kernel fault
        assert ctl.exec_errors == 1
        monkeypatch.undo()

        def fail(self):
            raise dcn.KernelLoadError("quant.cu did not build")

        monkeypatch.setattr(dcn.CodecWire, "load_kernels", fail)
        with pytest.raises(dcn.KernelLoadError, match="quant.cu"):
            ctl._execute(act)
        assert getattr(srv, "_epoch", 0) == 0 and not os.path.exists(
            tctl.epoch_path(str(tmp_path)))
        ctl.close()
        # a restarted generation restoring the fleet's epoch raises too
        tctl.write_epoch(str(tmp_path), {"epoch": 1, "codec": "int8",
                                         "codec_kw": {}, "bucket_mb": 0.0})
        with pytest.raises(dcn.KernelLoadError):
            tctl.Controller(srv, cfg)
    finally:
        srv.close()


def test_load_kernels_loads_each_library_the_codec_uses(monkeypatch):
    from pytorch_ps_mpi_tpu_torch.ops import quant, sign, tern, topk

    loaded = []
    for mod in (quant, sign, tern, topk):
        monkeypatch.setattr(mod, "_lib",
                            lambda _n=mod.__name__: loaded.append(_n))
    for code, want in (("int8", {"quant"}), ("sign", {"sign"}),
                       ("terngrad", {"tern"}), ("identity", set())):
        loaded.clear()
        w = dcn.CodecWire(get_codec(code), TEMPLATE, device="cpu")
        w.load_kernels()  # nothing to load for the CPU's plain versions
        assert loaded == []
        w.device = torch.device("cuda")  # as a wire on the card sees it
        w.load_kernels()
        assert {n.rsplit(".", 1)[1] for n in loaded} == want, code
    loaded.clear()
    w = dcn.CodecWire(get_codec("ef", inner=get_codec("topk", fraction=0.1)),
                      TEMPLATE, device="cpu")
    w.device = torch.device("cuda")
    w.load_kernels()  # through the error-feedback wrapper
    assert {n.rsplit(".", 1)[1] for n in loaded} == {"topk"}

    def broken():
        raise OSError("libquant.so: cannot open shared object file")

    monkeypatch.setattr(quant, "_lib", broken)
    w = dcn.CodecWire(get_codec("int8"), TEMPLATE, device="cpu")
    w.device = torch.device("cuda")
    with pytest.raises(dcn.KernelLoadError, match="libquant.so"):
        w.load_kernels()


def test_serve_downshifts_identity_to_int8_without_losing_a_frame(
        tmp_path):
    """A two-worker MLP fleet with the ladder identity -> int8 and the
    wire threshold below any measured share, so the first evaluation with
    a regime downshifts; the run then checks the transition's accounting,
    not its timing."""
    tdir = tmp_path / "t"
    steps = 24
    cfg = {"model": "mlp", "model_kw": {"features": (32, 8)},
           "in_shape": [8], "batch": 16, "seed": 0, "optim": "sgd",
           "hyper": {"lr": 0.05}, "steps": steps, "open_timeout": LIMIT,
           "push_timeout": LIMIT, "device": "cpu", "frame_check": True,
           "codec": "identity", "telemetry_dir": str(tdir),
           "health_dir": str(tdir), "control": True,
           "control_dir": str(tdir), "stats_dir": str(tmp_path),
           "slow_ms": {"0": 60.0, "1": 60.0}, "tick_interval": 0.02,
           "max_staleness": 10 ** 6,
           "control_kw": {"ladder": [{"codec": "identity"},
                                     {"codec": "int8"}],
                          "wire_hi": -1.0, "wire_lo": -2.0,
                          "warmup_s": 0.0, "eval_every_s": 0.02,
                          "cooldown_s": 0.05, "settle_min_s": 0.05,
                          "settle_s": 60.0,
                          "pin": ("lr_scale", "evict", "read_tier")}}
    os.makedirs(tdir)
    tmpl = at.make_problem(cfg, "cpu").template
    name = f"/psq_torch_down_{os.getpid()}"
    server = dcn.ShmPSServer(name, 2, tmpl, max_staleness=10 ** 6,
                             code=get_codec("identity"), frame=True,
                             device="cpu")
    procs = []
    try:
        procs = [at.spawn_worker(name, i, cfg, env={"OMP_NUM_THREADS": "1"})
                 for i in range(2)]
        _, m = at.serve(server, cfg, total_grads=0,
                        total_received=2 * steps, timeout=LIMIT)
        assert at.join_workers(procs, timeout=LIMIT) == [0, 0]
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
    ctl = m["control"]
    assert ctl["epoch"] == 1 and ctl["ladder_idx"] == 1
    acts = [json.loads(x) for x in open(tdir / "control-server.jsonl")]
    assert [a["action"] for a in acts] == ["renegotiate", "epoch_retire"]
    assert m["grads_received"] == 2 * steps and m["frames_rejected"] == 0
    assert ctl["flaps"] == 0 and ctl["exec_errors"] == 0
    for i in range(2):
        stats = json.loads((tmp_path / f"worker-{i}.json").read_text())
        (sw,) = stats["switches"]
        assert sw["codec"] == "int8" and sw["epoch"] == 1
        # every push after the switch is on the new epoch, none before
        want = {0: sw["pushes_before"], 1: steps - sw["pushes_before"]}
        assert server.epoch_frames[i] == {e: n for e, n in want.items()
                                          if n}
    assert getattr(server, "epoch_regressions", 0) == 0
    assert np.isfinite(m["loss_final"])
    # the port's replay over its own persisted rows
    from pytorch_ps_mpi_tpu_torch.telemetry.timeseries import \
        load_timeseries_rows

    rows = load_timeseries_rows(
        str(tdir / "timeseries-control-server.jsonl"))
    replayed = tctl.Controller.replay(rows, num_workers=2, cfg=cfg,
                                      depth=64, ring=8)
    assert [json.dumps(a) for a in replayed] == [json.dumps(a)
                                                 for a in acts]

"""The port's aggregation tree (``parallel/tree.py``, the lineage trailer
of ``resilience/frames.py``, ``HopErrorFeedback`` and ``serve``'s tree
mode) against the JAX package's, on the CPU.

- plans: ``group_plan``, ``leader_wid`` and ``tree_slot_capacity`` equal
  JAX's over a grid;
- wire: trailer frames are the same bytes, fingerprints with
  ``tree_slots`` are the same numbers, and malformed trailers are
  rejected for the same reasons;
- ``HopErrorFeedback`` over 8 rounds of the same aggregates: int8 and
  identity payloads and residuals bit for bit; sign to rtol 1e-6 (its
  scale is a float sum in another order, ROADMAP queue 3 item 2), with
  an atol of 1e-6 of the scale where a residual cancels to ~0;
- tree-mode ``serve`` given the same frames (JAX ``tests/test_tree.py``,
  ``test_serve_tree_mode_weights_rounds_by_composed_count``) from the
  same parameters: ``tree_composed``, the rounds and the final
  parameters equal JAX's bit for bit (at a power-of-two learning rate,
  see ``TREE_SERVE_CFG``);
- interop: a port pusher's trailer frame is taken by a JAX root, and a
  JAX pusher's by a port root, over TCP and shm;
- one spawned tree on an MLP, a leader crashing mid-fold: every worker
  push is composed at the root or positively lost, never both, and the
  crashed group's workers push to the root meanwhile.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.codecs.error_feedback import \
    HopErrorFeedback as JaxHop
from pytorch_ps_mpi_tpu.parallel import async_train as jat
from pytorch_ps_mpi_tpu.parallel import dcn as jdcn
from pytorch_ps_mpi_tpu.parallel import tcp as jtcp
from pytorch_ps_mpi_tpu.parallel import tree as jtree
from pytorch_ps_mpi_tpu.resilience import frames as jframes
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.codecs.error_feedback import HopErrorFeedback
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.parallel import dcn as tdcn
from pytorch_ps_mpi_tpu_torch.parallel import tcp as ttcp
from pytorch_ps_mpi_tpu_torch.parallel import tree
from pytorch_ps_mpi_tpu_torch.resilience import frames as tframes
from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

LIMIT = 90.0  # seconds for the spawned tree, spawn to join


def _template():
    rng = np.random.RandomState(11)
    return {"params": {
        "Conv_0": {"kernel": rng.randn(3, 3, 8, 16).astype(np.float32)},
        "Dense_0": {"kernel": rng.randn(64, 32).astype(np.float32),
                    "bias": rng.randn(32).astype(np.float32)}}}


def _aggregate(tmpl, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*np.shape(x)) * 3).astype(np.float32)
            for x in jax.tree.leaves(tmpl)]


# -- plans -----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_group_plan_leader_wid_and_slots_match_jax(n):
    for g in range(1, 10):
        groups = tree.group_plan(n, g)
        assert groups == jtree.group_plan(n, g)
        assert tree.tree_slot_capacity(n, g) == \
            jtree.tree_slot_capacity(n, g)
        assert [tree.leader_wid(n, i) for i in range(len(groups))] == \
            [jtree.leader_wid(n, i) for i in range(len(groups))]
    for mod in (tree, jtree):
        with pytest.raises(ValueError):
            mod.group_plan(n, 0)


# -- the wire ---------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 3, 4])
@pytest.mark.parametrize("n_entries", [0, 1, 3, 6])
def test_trailer_frames_are_the_same_bytes(slots, n_entries):
    payload = np.arange(40, dtype=np.uint8)
    entries = [(w, 5 + w, 7 + w, 1.5 * w) if w % 2 else
               {"worker": w, "step": 5 + w, "seq": 7 + w,
                "send_wall": 1.5 * w} for w in range(n_entries)]
    size = jframes.HEADER_BYTES + 40 + jframes.trailer_bytes(slots)
    assert tframes.trailer_bytes(slots) == jframes.trailer_bytes(slots)
    j = jframes.seal_frame(np.full(size, 7, np.uint8), payload, 0xFEED,
                           step=3, seq=4, send_wall=2.0, composed=entries,
                           tree_slots=slots)
    t = tframes.seal_frame(np.full(size, 9, np.uint8), payload, 0xFEED,
                           step=3, seq=4, send_wall=2.0, composed=entries,
                           tree_slots=slots)
    assert bytes(t) == bytes(j)
    body, err = tframes.open_frame(t, 0xFEED,
                                   40 + tframes.trailer_bytes(slots))
    assert err is None
    assert tframes.read_composed(body, 40, slots) == \
        jframes.read_composed(body, 40, slots)


@pytest.mark.parametrize("name", [None, "identity", "int8", "sign"])
def test_tree_slot_fingerprints_match_jax(name):
    tmpl = _template()
    twire = None if name is None else tdcn.CodecWire(
        get_codec(name), tmpl, device="cpu")
    jwire = None if name is None else jdcn.CodecWire(jax_codec(name), tmpl)
    prints = set()
    for slots in (0, 1, 2, 4):
        fp = tframes.wire_fingerprint(twire, tmpl, tree_slots=slots)
        assert fp == jframes.wire_fingerprint(jwire, tmpl, tree_slots=slots)
        prints.add(fp)
    assert len(prints) == 4  # any slot drift is a "config" rejection


class _FakeServer:
    """What the consume paths read of a server."""
    max_staleness = 10**9
    version = 1
    tree_slots = 2
    _wire_payload_bytes = 8

    def __init__(self):
        import collections

        self.last_seen, self.staleness_seen, self.rejects = {}, {}, []
        self.tree_composed = self.grads_received = 0
        self.bytes_received = self.stale_drops = 0
        self._composed_queue = collections.deque()

    def _reject_frame(self, w, reason):
        self.rejects.append((w, reason))


def _trailer_payload(entries, count=None, magic=None, extra=0):
    buf = np.zeros(8 + jframes.trailer_bytes(2) + extra, np.uint8)
    buf[:8] = np.arange(8, dtype=np.uint8)
    jframes.pack_trailer(buf, 8, entries, 2)
    if count is not None:
        buf[12:16] = np.frombuffer(np.uint32(count).tobytes(), np.uint8)
    if magic is not None:
        buf[8] ^= 0xFF
    return buf


MALFORMED = {
    "magic": _trailer_payload([(1, 2, 3, 4.0)], magic=True),
    "count 0": _trailer_payload([]),
    "count above slots": _trailer_payload([(1, 2, 3, 4.0)], count=3),
    "size": _trailer_payload([(1, 2, 3, 4.0)], extra=4),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_trailers_rejected_as_jax_rejects_them(case):
    bad = MALFORMED[case]
    assert tframes.read_composed(bad, 8, 2) is None
    assert jframes.read_composed(bad, 8, 2) is None
    good = _trailer_payload([(0, 3, 3, 1.0), (5, 9, 9, 2.0)])
    got = {}
    for name, mod in (("port", tframes), ("jax", jframes)):
        srv = _FakeServer()
        items = [(0, 1, 0, good, 3, 3, 1.0), (1, 1, 0, bad, 9, 9, 1.0)]
        out = mod.framed_batch_consume(srv, iter(items), raw=True)
        got[name] = ([w for w, _, _ in out], srv.rejects, srv.tree_composed,
                     list(srv._composed_queue),
                     [bytes(g) for _, _, g in out],
                     [m["composed"] for m in srv.last_batch_metas])
    assert got["port"] == got["jax"]
    assert got["port"][1] == [(1, "trailer")] and got["port"][2] == 2


def test_servers_require_frames_for_tree_slots():
    tmpl = _template()
    with pytest.raises(ValueError, match="frame"):
        tdcn.ShmPSServer(f"/psq_torch_tree_{os.getpid()}", 1, tmpl,
                         tree_slots=2, device="cpu")
    with pytest.raises(ValueError, match="frame"):
        ttcp.TcpPSServer(0, 1, tmpl, tree_slots=2, device="cpu")


# -- hop error feedback -----------------------------------------------------------

@pytest.mark.parametrize("name", ["int8", "identity", "sign"])
@pytest.mark.parametrize("enabled", [True, False])
def test_hop_error_feedback_matches_jax(name, enabled):
    tmpl = _template()
    twire = tdcn.CodecWire(get_codec(name), tmpl, device="cpu")
    jwire = jdcn.CodecWire(jax_codec(name), tmpl)
    thop = HopErrorFeedback(twire, enabled=enabled)
    jhop = JaxHop(jwire, enabled=enabled)
    treedef = jax.tree.structure(tmpl)
    for r in range(8):
        agg = _aggregate(tmpl, 100 + r)
        tbytes = np.array(thop.encode([torch.from_numpy(a) for a in agg]))
        jbytes = np.array(jhop.encode(jax.tree.unflatten(treedef, agg)))
        if name == "sign":
            t_p, j_p = (w.payloads_from_bytes(b) for w, b in
                        ((twire, tbytes), (jwire, jbytes)))
            for a, b in zip(t_p, j_p):
                np.testing.assert_array_equal(a["packed"], b["packed"])
                np.testing.assert_allclose(a["scale"], b["scale"],
                                           rtol=1e-6)
        else:
            np.testing.assert_array_equal(tbytes, jbytes)
        if not enabled:
            assert thop.residual is None
            continue
        for tr, jr in zip(thop.residual, jhop._residual):
            tr = tr.numpy()
            if name == "sign":
                np.testing.assert_allclose(
                    tr, jr, rtol=1e-6, atol=1e-6 * np.abs(jr).max())
            else:
                np.testing.assert_array_equal(tr, jr)
    assert thop.rounds == jhop.rounds == 8
    assert thop.probe().keys() == jhop.probe().keys()
    if enabled and name == "identity":
        assert thop.residual_norm == 0.0
    elif enabled:
        assert thop.residual_norm == pytest.approx(jhop.residual_norm,
                                                   rel=1e-5)


# -- tree-mode serve ---------------------------------------------------------------

#: a power-of-two lr makes lr * g exact, so the jitted JAX update's FMA
#: (ROADMAP queue 3 item 4) rounds as the port's two operations do, and
#: the comparison sees the tree's weighting alone
TREE_SERVE_CFG = {
    "model": "mlp", "model_kw": {"features": (4, 2)}, "in_shape": [4],
    "batch": 8, "seed": 1, "codec": "identity", "optim": "sgd",
    "hyper": {"lr": 0.125}, "frame_check": True,
    "tree": True, "tree_members": [5, 0], "tree_slots": 3,
    "max_staleness": 10**9,
}
STEPS = 4


def _grad(leaves, wid, step, composed_of):
    """A deterministic group sum of ``composed_of`` worker gradients."""
    rng = np.random.RandomState(1000 * wid + step)
    return [(rng.randn(*np.shape(x)) * composed_of).astype(np.float32)
            for x in leaves]


def _run_tree_serve(side, cfg, pushers, params0, tag):
    name = f"/psq_torch_tree_{os.getpid()}_{side}_{tag}"
    if side == "jax":
        server = jdcn.ShmPSServer(name, num_workers=6, template=params0,
                                  max_staleness=10**9,
                                  code=jax_codec("identity"), frame=True,
                                  tree_slots=3)
    else:
        server = tdcn.ShmPSServer(name, num_workers=6, template=params0,
                                  max_staleness=10**9,
                                  code=get_codec("identity"), frame=True,
                                  tree_slots=3, device="cpu")
    leaves, treedef = jax.tree.flatten(params0)
    errors = []

    def pusher(wid, composed_of):
        try:
            if side == "jax":
                w = jdcn.ShmPSWorker(name, wid, params0, frame=True,
                                     code=jax_codec("identity"),
                                     tree_slots=3)
            else:
                w = tdcn.ShmPSWorker(name, wid, params0, frame=True,
                                     code=get_codec("identity"),
                                     tree_slots=3, device="cpu")
            try:
                for s in range(STEPS):
                    if side == "jax":
                        _, v = w.read_params()
                    else:
                        _, v = w.read_flat()
                    g = _grad(leaves, wid, s, composed_of)
                    comp = [(100 + i, s, s, 1.0) for i in range(composed_of)]
                    grad = (jax.tree.unflatten(treedef, g) if side == "jax"
                            else [torch.from_numpy(x) for x in g])
                    w.push_grad(grad, v, lineage=(s, s), composed=comp)
            finally:
                w.close()
        except Exception as e:  # raised in the main thread's assert
            errors.append(e)

    threads = [threading.Thread(target=pusher, args=p) for p in pushers]
    for t in threads:
        t.start()
    try:
        serve = jat.serve if side == "jax" else at.serve
        params, m = serve(server, cfg, total_grads=0,
                          total_received=len(pushers) * STEPS,
                          sync_barrier=cfg.get("sync", True), timeout=60.0)
    finally:
        for t in threads:
            t.join(timeout=30)
        server.close()
    assert not errors, errors
    return [np.asarray(x) for x in jax.tree.leaves(params)], m


@pytest.mark.parametrize("mode", ["sync", "sync-agg-off", "async"])
def test_tree_serve_matches_jax_on_the_same_frames(mode, monkeypatch):
    cfg = dict(TREE_SERVE_CFG)
    # 2 + 1 composed: a round divides by 3, where x / 3 and x * f32(1/3)
    # round differently (JAX divides on the decode path and multiplies on
    # the fold path)
    pushers = [(5, 2), (0, 1)]
    if mode == "sync-agg-off":
        cfg["agg"] = "off"
    if mode == "async":
        # one pusher, so the arrival order (and the update order) is fixed
        cfg.update(sync=False, tree_members=[5])
        pushers = [(5, 3)]
    _, params0, _, _ = jat.make_problem(cfg)
    flat0 = jdcn._flatten(params0)

    def problem_from_jax(c, device="cuda"):
        prob = at.Problem(c, device)
        prob.load_flat(torch.from_numpy(flat0))
        return prob

    monkeypatch.setattr(at, "make_problem", problem_from_jax)
    jp, jm = _run_tree_serve("jax", cfg, pushers, params0, mode)
    tp, tm = _run_tree_serve("port", cfg, pushers, params0, mode)
    for key in ("tree_composed", "applied", "publish_version",
                "grads_received", "agg_mode"):
        assert tm[key] == jm[key], key
    assert tm["tree_composed"] == STEPS * sum(c for _, c in pushers)
    assert tm["publish_version"] == STEPS + 1
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(np.concatenate([x.ravel() for x in tp]), flat0)


# -- interop -------------------------------------------------------------------------

@pytest.mark.parametrize("pusher", ["port", "jax"])
@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_trailer_frames_interoperate(pusher, transport, monkeypatch):
    """A leader's int8 frame with a 2-slot trailer, pushed by one package
    into the other's root: taken, counted and decoded alike."""
    monkeypatch.setenv("PS_NO_NATIVE", "0")
    tmpl = _template()
    agg = _aggregate(tmpl, 5)
    entries = [(0, 7, 7, 1.25), (1, 7, 8, 2.5)]
    name = f"/psq_torch_tree_io_{os.getpid()}_{pusher}"
    port_root = pusher == "jax"
    kw = dict(code=(get_codec("int8") if port_root else jax_codec("int8")),
              frame=True, tree_slots=2)
    if port_root:
        kw["device"] = "cpu"
    mod = (ttcp if transport == "tcp" else tdcn) if port_root else \
        (jtcp if transport == "tcp" else jdcn)
    server = (mod.TcpPSServer(0, 3, tmpl, **kw) if transport == "tcp"
              else mod.ShmPSServer(name, 3, tmpl, **kw))
    server.publish(tmpl)
    errors = []

    def push():
        try:
            wkw = dict(code=(jax_codec("int8") if port_root
                             else get_codec("int8")),
                       frame=True, tree_slots=2, timeout=30.0)
            if not port_root:
                wkw["device"] = "cpu"
            wmod = (jtcp if transport == "tcp" else jdcn) if port_root \
                else (ttcp if transport == "tcp" else tdcn)
            w = (wmod.TcpPSWorker("127.0.0.1", server.port, 2, tmpl, **wkw)
                 if transport == "tcp"
                 else wmod.ShmPSWorker(name, 2, tmpl, **wkw))
            _, v = w.read_params()
            grad = (jax.tree.unflatten(jax.tree.structure(tmpl), agg)
                    if port_root else [torch.from_numpy(a) for a in agg])
            w.push_grad(grad, v, lineage=(7, 9), composed=entries)
            w.close()
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=push)
    t.start()
    try:
        item, deadline = None, time.time() + 60
        while item is None and time.time() < deadline and not errors:
            item = server.poll_grad()
            time.sleep(0.002)
        t.join(timeout=30)
        assert not errors, errors
        assert item is not None and item[0] == 2
        assert server.tree_composed == 2 and list(
            server._composed_queue) == [2]
        assert server.frames_rejected_total == 0
        assert server.last_push_meta["composed"] == [
            {"worker": w, "step": s, "seq": q, "send_wall": t}
            for w, s, q, t in entries]
        got = tree_flatten(item[2])[0] if port_root else \
            jax.tree.leaves(item[2])
        jwire = jdcn.CodecWire(jax_codec("int8"), tmpl)
        want = jax.tree.leaves(jwire.decode_from_bytes(np.array(
            jwire.encode_to_bytes(jax.tree.unflatten(
                jax.tree.structure(tmpl), agg)))))
        for g, w in zip(got, want):
            g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
            np.testing.assert_array_equal(g, w)
    finally:
        server.close()


# -- a spawned tree ------------------------------------------------------------------

def test_run_tree_accounts_every_push_through_a_leader_crash(tmp_path):
    """2 groups of 2 MLP workers, int8 upstream with hop EF, leader 1
    crashing mid-fold at its round 2 and respawned; its members fall
    back to the root. Exact accounting: the root's composed trace IDs and
    the leaders' lost ones partition the pushes."""
    steps = 6
    cfg = {"model": "mlp", "model_kw": {"features": (16, 4)},
           "in_shape": [8], "batch": 32, "seed": 3, "codec": "int8",
           "optim": "sgd", "hyper": {"lr": 0.05}, "frame_check": True,
           "max_staleness": 10**9, "device": "cpu", "steps": steps,
           "n_workers": 4, "group_size": 2, "stats_dir": str(tmp_path),
           "open_timeout": LIMIT, "push_timeout": LIMIT,
           "degraded_round_after": 1.0, "slow_ms": {"2": 300, "3": 300},
           "leader_kw": {"crash_at_round": {"1": 2}, "rejoin_every": 2,
                         "degrade_after": 1.0, "flush_after": 2.0,
                         "idle_exit_s": 1.0}}
    one = {"OMP_NUM_THREADS": "1"}
    _, m = tree.run_tree(cfg, timeout=LIMIT, worker_env=one, leader_env=one)
    t = m["tree"]
    assert t["worker_codes"] == [0, 0, 0, 0]
    assert t["leader_respawns"] >= 1 and t["leader_codes"][0] == 0
    composed = [tuple(e) for e in t["composed_ids"]]
    assert len(set(composed)) == len(composed) == m["tree_composed"]
    leaders = [json.load(open(p))
               for p in glob.glob(str(tmp_path / "leader-*.json"))]
    lost = [tuple(e) for d in leaders for e in d["lost"]]
    expect = {(w, s, s) for w in range(4) for s in range(steps)}
    assert set(composed) | set(lost) == expect
    assert not set(composed) & set(lost) and len(lost) == len(set(lost))
    # no leader decoded a push; the root decoded once a round
    assert all(d["decodes_done"] == 0 for d in leaders)
    assert m["agg_mode"] == 1.0 and m["decodes_per_publish"] == 1.0
    # the crashed group's workers reached the root directly (their rejoin
    # waits on the respawn's start-up, which the suite's load stretches:
    # chip_smoke.py's T2 asserts it)
    workers = [json.load(open(tmp_path / f"worker-{w}.json"))
               for w in (2, 3)]
    assert sum(w["fallback_pushes"] for w in workers) >= 1
    assert m["loss_final"] < m["loss_initial"]

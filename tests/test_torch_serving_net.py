"""The port's read tier over sockets: its native and Python loops answer
with the same bytes (shed replies included), and those are the JAX
package's loop's bytes; a JAX ``ServingReader`` reads the port's server
and a port reader the JAX server, bit for bit, exact and int8-lossy; the
follower chain holds the root's versions bit for bit across a root
restart; ``serve`` with ``read_port=0`` keeps each published version's
bytes in the ring while a reader reads; a shard server serves its slice
under its tenant; ``python -m pytorch_ps_mpi_tpu_torch.serve_readonly``
serves a checkpoint. Every comparison is bit for bit."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.serving import ServingCore as JServingCore
from pytorch_ps_mpi_tpu.serving import ServingReader as JServingReader
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.parallel import dcn
from pytorch_ps_mpi_tpu_torch.serving import (FollowerLoop, ReadClient,
                                              ServingCore, ServingReader)
from pytorch_ps_mpi_tpu_torch.serving import net as tnet
from pytorch_ps_mpi_tpu_torch.serving.native_read import get_read_lib
from pytorch_ps_mpi_tpu_torch.utils.native import fast_path_disabled

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 120.0
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
TMPL = {"a": np.zeros((700, 4), np.float32), "b": np.zeros((13,), np.float32)}
N = 700 * 4 + 13
KW = {"ring": 4, "admission_depth": 64, "retry_after_s": 0.005,
      "delta_bucket_mb": 0.002}


def flat_of(seed) -> np.ndarray:
    return np.random.RandomState(seed).randn(N).astype(np.float32)


def flat_tree(tree) -> np.ndarray:
    return np.concatenate([np.asarray(tree[k]).reshape(-1)
                           for k in sorted(tree)])


def same_bits(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


def make_core(kw=KW, **cfg_extra):
    cfg = {"serving": True, "read_port": 0, "serving_kw": dict(kw),
           "device": "cpu"}
    cfg.update(cfg_extra)
    return ServingCore(None, cfg, template=TMPL)


def _recv_exact(sock, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("server closed connection")
        out += chunk
    return bytes(out)


def raw_reply(port, have_version=0, want_delta=True, tenant="",
              raw=None) -> bytes:
    """One request over a raw socket; the whole reply (header, payload)."""
    with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
        s.sendall(raw if raw is not None
                  else tnet.pack_request(have_version, want_delta, tenant))
        hdr = _recv_exact(s, tnet._REP.size)
        return hdr + _recv_exact(s, tnet._REP.unpack(hdr)[7])


native_only = pytest.mark.skipif(
    fast_path_disabled() or get_read_lib() is None,
    reason="the native read tier is off (PS_NO_NATIVE) or did not build")


def _history(cores):
    v1 = flat_of(0)
    v2 = v1.copy()
    v2[::97] += 0.25
    for core in cores:
        core.publish(flat=v1.copy())
        core.publish(flat=v2.copy())


@native_only
def test_native_python_and_jax_loops_reply_the_same_bytes():
    nat = make_core(read_native=True)
    py = make_core(read_native=False)
    jax_py = JServingCore(None, {"serving": True, "read_port": 0,
                                 "read_native": False,
                                 "serving_kw": dict(KW)}, template=TMPL)
    assert (nat.read_native, py.read_native) == (True, False)
    cores = (nat, py, jax_py)
    try:
        kinds = {}

        def compare(label, **kw):
            a, b, c = (raw_reply(core.read_port, **kw) for core in cores)
            assert a == b == c, label
            kinds[label] = tnet._REP.unpack(a[:tnet._REP.size])[1]

        compare("retry before a publish", have_version=0)
        _history(cores)
        compare("full", have_version=0)
        compare("delta", have_version=1)
        compare("not modified", have_version=2)
        compare("full, delta declined", have_version=1, want_delta=False)
        compare("unknown tenant", tenant="ghost")
        assert kinds == {"retry before a publish": tnet.KIND_RETRY,
                         "full": tnet.KIND_FULL, "delta": tnet.KIND_DELTA,
                         "not modified": tnet.KIND_NOT_MODIFIED,
                         "full, delta declined": tnet.KIND_FULL,
                         "unknown tenant": tnet.KIND_ERROR}
        mn, mp = nat.read_metrics(), py.read_metrics()
        for key in ("reads_total", "reads_not_modified", "coalesce_hits"):
            assert mn[key] == mp[key] == jax_py.read_metrics()[key], key
        assert mn["reads_total"] == 4.0  # retry and error not counted
        st = nat.read_server.stats()
        assert (st["reads_full"], st["reads_delta"], st["reads_error"]) \
            == (2, 1, 1)
    finally:
        for core in cores:
            core.close()


@native_only
def test_shed_replies_are_the_same_bytes():
    kw = {**KW, "admission_depth": 0, "retry_after_s": 0.125}
    cores = [make_core(kw, read_native=rn) for rn in (True, False)]
    try:
        for core in cores:
            core.publish(flat=flat_of(0))
        a, b = (raw_reply(core.read_port) for core in cores)
        assert a == b
        _, kind, _, _, version, _, retry_after, plen = tnet._REP.unpack(a)
        assert (kind, version, retry_after, plen) \
            == (tnet.KIND_RETRY, 1, 0.125, 0)
        for core in cores:
            m = core.read_metrics()
            assert (m["reads_shed"], m["reads_total"]) == (1.0, 0.0)
    finally:
        for core in cores:
            core.close()


def test_shed_then_retry_and_torn_frames_on_the_python_loop():
    core = make_core({**KW, "admission_depth": 1}, read_native=False)
    core.publish(flat=flat_of(0))
    readers = [ServingReader("127.0.0.1", core.read_port, TMPL,
                             serving_kw=KW, device="cpu") for _ in range(16)]
    try:
        for _ in range(10):  # until a burst overlaps the depth-1 backlog
            barrier = threading.Barrier(len(readers))

            def body(r):
                barrier.wait()
                r.read_params()

            ts = [threading.Thread(target=body, args=(r,)) for r in readers]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            if core.reads_shed:
                break
        assert core.reads_shed > 0
        assert sum(r.shed_retries for r in readers) > 0
        assert all(r.version == 1 for r in readers)
        bad = tnet._REQ.pack(0xDEADBEEF, tnet.OP_READ, 0, 0, 0)
        reply = raw_reply(core.read_port, raw=bad)
        assert tnet._REP.unpack(reply[:tnet._REP.size])[1] == tnet.KIND_ERROR
        with socket.create_connection(("127.0.0.1", core.read_port)) as s:
            s.sendall(tnet.pack_request(0)[:7])  # half a request, then EOF
        deadline = time.time() + 20
        while core.read_server.eof_mid_request != 1 \
                and time.time() < deadline:
            time.sleep(0.01)
        snap = core.serving_snapshot()
        assert (snap["rejected_frames"], snap["eof_mid_request"]) == (1, 1)
    finally:
        for r in readers:
            r.close()
        core.close()


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("native", [True, False])
def test_readers_of_each_package_read_the_other_server(codec, native):
    if native and (fast_path_disabled() or get_read_lib() is None):
        pytest.skip("the native read tier is off or did not build")
    kw = {**KW, "delta_codec": codec}
    flats = [flat_of(0)]
    rng = np.random.RandomState(5)
    for v in range(1, 4):
        nxt = flats[-1].copy()
        if codec is None:  # a few elements: sparse sections
            nxt[v * 11::53] += np.float32(0.001 * v)
        else:  # every element: the sections ship as int8
            nxt += rng.randn(N).astype(np.float32) * np.float32(1e-3)
        flats.append(nxt)
    servers = (make_core(kw, read_native=native),
               JServingCore(None, {"serving": True, "read_port": 0,
                                   "read_native": native,
                                   "serving_kw": dict(kw)}, template=TMPL))
    try:
        for server in servers:
            server.publish(flat=flats[0].copy())
        pairs = [(ServingReader("127.0.0.1", servers[1].read_port, TMPL,
                                serving_kw=kw, device="cpu"),
                  JServingReader("127.0.0.1", servers[1].read_port, TMPL,
                                 serving_kw=kw)),
                 (JServingReader("127.0.0.1", servers[0].read_port, TMPL,
                                 serving_kw=kw),
                  ServingReader("127.0.0.1", servers[0].read_port, TMPL,
                                serving_kw=kw, device="cpu"))]
        for step, want in enumerate(flats):
            if step:
                for server in servers:
                    server.publish(flat=want.copy())
            for a, b in pairs:
                ta, va = a.read_params()
                tb, vb = b.read_params()
                assert va == vb == step + 1
                # the two packages' readers hold the same bits
                assert same_bits(flat_tree(ta), flat_tree(tb))
                if codec is None:
                    assert same_bits(flat_tree(ta), want)
                else:  # int8 of 1e-3 steps: 3 x max|step| / 254 at most
                    err = np.abs(flat_tree(ta) - want).max()
                    assert err <= 6e-5, err
                assert a.fresh["version"] == b.fresh["version"] == step + 1
        for a, b in pairs:
            assert a.delta_reads == b.delta_reads == 3
            a.close()
            b.close()
    finally:
        for server in servers:
            server.close()


def test_follower_chain_is_bit_exact_and_survives_a_root_restart():
    flats = {1: flat_of(0)}
    for v in (2, 3):
        nxt = flats[v - 1].copy()
        nxt[::113] += 0.5 * v
        flats[v] = nxt
    root = make_core()
    root.publish(flat=flats[1].copy())
    root.publish(flat=flats[2].copy())
    root_port = root.read_port
    core_a, core_b = make_core(), make_core()
    rows = []
    fa = FollowerLoop(core_a, "127.0.0.1", root_port, template=TMPL,
                      poll_s=0.01, serving_kw=KW)
    fb = FollowerLoop(core_b, "127.0.0.1", core_a.read_port,
                      template=TMPL, poll_s=0.01, serving_kw=KW)
    reader = ServingReader("127.0.0.1", core_b.read_port, TMPL,
                           serving_kw=KW, device="cpu")
    root2 = None
    try:
        for v in (2, 3):
            if v == 3:
                root.publish(flat=flats[3].copy())
            rows.append(fa.step())
            assert rows[-1]["outcome"] == "republished"
            assert fb.step()["outcome"] == "republished"
            tree, ver = reader.read_params()
            assert ver == v and same_bits(flat_tree(tree), flats[v])
            # one FRS1 hop record a relay, the root's birth kept
            assert reader.fresh["hop_count"] == 2
            assert reader.fresh["version"] == v
        assert fa._reader.delta_reads >= 1 and fb._reader.delta_reads >= 1
        assert reader.delta_reads >= 1
        sleep_before = fa._sleep_s
        assert fa.step()["outcome"] == "not_modified"
        assert fa._sleep_s == 2 * sleep_before
        ma = core_a.read_metrics()
        assert ma["follower_bytes_relayed"] > 0
        assert 0.0 < ma["replica_lag_versions"] < 2.0  # an EWMA, decaying
        assert fa.step()["outcome"] == "not_modified"
        assert core_a.read_metrics()["replica_lag_versions"] \
            < ma["replica_lag_versions"]
        assert [r["version"] for r in rows] == [2, 3]
        assert core_b.read_metrics()["fresh_hop_count"] == 2.0
        # the root goes away: the replica keeps serving its last version
        root.close()
        fa.step()
        assert fa.last_error is not None and fa._reader is None
        with ReadClient("127.0.0.1", core_a.read_port) as c:
            kind, ver, _, _, payload = c.request()
        assert (kind, ver) == ("full", 3)
        assert same_bits(np.frombuffer(payload, np.float32), flats[3])
        reconnects = fa.reconnects
        deadline = time.time() + 30
        while root2 is None:  # the freed port may linger a moment
            try:
                root2 = make_core(read_port=root_port)
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        flats[5] = flats[3] + 1.0
        root2.publish(flat=flats[5].copy(), version=5)
        out = fa.step()
        if out["outcome"] == "retry":  # one more dial if the first raced
            out = fa.step()
        assert out["outcome"] == "republished"
        assert fa.reconnects == reconnects + 1
        assert fb.step()["outcome"] == "republished"
        tree, ver = reader.read_params()
        assert ver == 5 and same_bits(flat_tree(tree), flats[5])
    finally:
        reader.close()
        fa.close()
        fb.close()
        for core in (core_a, core_b, root, root2):
            if core is not None:
                core.close()


def test_serve_keeps_each_version_in_the_ring_while_a_reader_reads():
    cfg = {"model": "mlp", "model_kw": {"features": (16, 4)},
           "in_shape": [8], "batch": 16, "seed": 0, "optim": "sgd",
           "hyper": {"lr": 0.05}, "steps": 3, "open_timeout": LIMIT,
           "push_timeout": LIMIT, "device": "cpu", "frame_check": True,
           "codec": "identity", "read_port": 0, "serving_kw": {"ring": 8}}
    prob = at.make_problem(cfg, "cpu")
    tmpl = prob.template
    name = f"/psq_torch_serving_{os.getpid()}"
    server = dcn.ShmPSServer(name, 1, tmpl, code=get_codec("identity"),
                             frame=True, device="cpu")
    held = {}

    def read_while_serving():
        deadline = time.time() + LIMIT
        while server.serving_core is None and time.time() < deadline:
            time.sleep(0.01)
        r = ServingReader("127.0.0.1", server.serving_core.read_port, tmpl,
                          serving_kw=cfg["serving_kw"], device="cpu")
        while time.time() < deadline:
            tree, ver = r.read_params()
            held[ver] = dcn.flatten_params(tree)
            if ver == 4:
                break
            time.sleep(0.002)
        r.close()

    t = threading.Thread(target=read_while_serving)
    t.start()
    procs = []
    try:
        procs = [at.spawn_worker(name, 0, cfg, env=ONE_THREAD)]
        params, m = at.serve(server, cfg, total_grads=3, timeout=LIMIT)
        t.join(timeout=LIMIT)
        assert at.join_workers(procs, timeout=LIMIT) == [0]
        store = server.serving_core._stores["default"]
        assert store.versions() == [1, 2, 3, 4]
        snaps = [store.get(v).flat for v in store.versions()]
        # every version owns its bytes: no two ring entries alias, and
        # the first still holds the initial parameters
        assert len({s.__array_interface__["data"][0] for s in snaps}) == 4
        assert all(not same_bits(a, b) for a, b in zip(snaps, snaps[1:]))
        assert same_bits(snaps[0], prob.flat_params().numpy())
        assert same_bits(snaps[-1], dcn.flatten_params(params))
        for ver, flat in held.items():
            assert same_bits(flat, snaps[ver - 1]), ver
        assert 4 in held
        assert m["read_port"] == server.serving_core.read_port > 0
        assert m["serving"]["tenants"]["default"]["latest"] == 4
        assert m["reads_total"] >= len(held)
        assert {"publish_alloc_s", "publish_d2h_s", "publish_transport_s",
                "publish_ring_put_s",
                "publish_pre_encode_s"} <= set(m["server_times"])
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
        t.join(timeout=5)
    assert server.serving_core.read_server is None  # closed with the server


def test_shard_server_serves_its_slice_under_its_tenant(tmp_path):
    from pytorch_ps_mpi_tpu_torch.parallel import sharded
    from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSWorker

    cfg = {"model": "mlp", "model_kw": {"features": (16, 4)},
           "in_shape": [8], "batch": 16, "seed": 0, "optim": "sgd",
           "hyper": {"lr": 0.05}, "steps": 2, "n_workers": 1,
           "device": "cpu", "codec": "identity", "read_port": 0,
           "server_timeout": LIMIT}
    prob = at.make_problem(cfg, "cpu")
    n = sum(p.numel() for p in prob.params)
    a, b = sharded.shard_plan(n, 2)[1]
    out = str(tmp_path / "shard1.npz")
    proc = sharded.spawn_shard_server(1, 2, cfg, out, env=ONE_THREAD)
    try:
        hello = sharded.read_server_hello(proc, LIMIT)
        assert hello["shard"] == 1 and hello["read_port"] > 0
        tmpl = {"flat": np.zeros((b - a,), np.float32)}
        w = TcpPSWorker("127.0.0.1", hello["port"], 0, tmpl,
                        code=get_codec("identity"), timeout=LIMIT,
                        device="cpu")
        r = ServingReader("127.0.0.1", hello["read_port"], tmpl,
                          tenant="shard1", device="cpu")
        try:
            flat, ver = w.read_flat(timeout=LIMIT)
            tree, rver = r.read_params()  # no push yet: the same version
            assert rver == ver and same_bits(tree["flat"], flat)
            w.push_payload(w.encode([torch.ones(b - a)]), ver, timeout=LIMIT)
            while True:  # the update's version, through both reads
                tree, rver = r.read_params()
                if rver == ver + 1:
                    break
                time.sleep(0.005)
            flat2, ver2 = w.read_flat(timeout=LIMIT)
            assert ver2 == rver and same_bits(tree["flat"], flat2)
            assert not same_bits(flat, flat2)
            w.push_payload(w.encode([torch.ones(b - a)]), ver2,
                           timeout=LIMIT)
        finally:
            r.close()
            w.close()
        assert proc.wait(timeout=LIMIT) == 0
        z = np.load(out)
        serving = json.loads(str(z["serving"]))
        assert serving["tenants"]["shard1"]["latest"] == 3
        assert serving["reads_total"] >= 2
    finally:
        at.join_workers([proc], timeout=5.0)


def test_serve_readonly_serves_a_checkpoint(tmp_path):
    from pytorch_ps_mpi_tpu_torch.optim import OPTIMIZERS
    from pytorch_ps_mpi_tpu_torch.telemetry.fleet import list_endpoints
    from pytorch_ps_mpi_tpu_torch.serve_readonly import model_cfg
    from pytorch_ps_mpi_tpu_torch.utils.checkpoint import CheckpointManager

    tmpl = at.make_problem(model_cfg("mlp"), "cpu").template
    flat = torch.from_numpy(np.random.RandomState(4).randn(
        dcn.flat_size(tmpl)).astype(np.float32))
    _, init_state, _ = OPTIMIZERS["sgd"]
    CheckpointManager(str(tmp_path)).save(6, {
        "flat": flat, "opt_state": init_state({"flat": flat}),
        "version": 9, "applied_total": 6, "checkpoint_every": 3})
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.serve_readonly",
         "--checkpoint-dir", str(tmp_path), "--model", "mlp",
         "--read-port", "0", "--duration", "60", "--metrics-port", "0",
         "--fleet-dir", str(tmp_path / "fleet")],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT), "PS_PLATFORM": "cpu",
             **ONE_THREAD})
    try:
        hello = json.loads(proc.stdout.readline())
        assert (hello["version"], hello["checkpoint_step"]) == (9, 6)
        r = ServingReader("127.0.0.1", hello["read_port"], tmpl,
                          device="cpu")
        tree, ver = r.read_params()
        r.close()
        assert ver == 9
        assert same_bits(dcn.flatten_params(tree), flat.numpy())
        # --fleet-dir: the tier's card, on its own /metrics endpoint
        cards = list_endpoints(str(tmp_path / "fleet"))
        assert [(c["name"], c["role"]) for c in cards] == [("read-tier",
                                                            "read")]
        assert cards[0]["url"].endswith(f":{hello['metrics_port']}")
    finally:
        proc.send_signal(2)  # SIGINT: the final line, then exit 0
        out, _ = proc.communicate(timeout=LIMIT)
    assert proc.returncode == 0
    final = json.loads(out.strip().splitlines()[-1])["final_serving"]
    assert final["reads_total"] == 1
    assert list_endpoints(str(tmp_path / "fleet")) == []  # card removed

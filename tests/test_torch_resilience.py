"""The port's resilience layer on the CPU (``resilience/worker.py``,
``resilience/supervisor.py``, the fault hooks of
``parallel/async_train.py`` and ``train_async``'s flags).

- ``ResilientWorker`` survives a server restart, on shm (the orphaned
  mailbox times out, the reconnect finds the new segment) and on TCP
  (the socket's EOF, a reconnect to the pinned port);
- a TCP read that times out mid-reply leaves the port's worker whole
  (a new connection) where the JAX worker's next read fails;
- a corrupt fault's tampered frame is rejected as ``"corrupt"`` by the
  port's server and by the JAX package's, and a worker's wire delay
  sleeps after the seal;
- the sync barrier completes degraded rounds when a worker dies;
- ``join_workers`` reaps a stuck worker;
- one supervised chaos fleet (2 MLP workers over shm): a worker crash,
  a corrupt frame, a drop, a duplicate and a server crash all fire once,
  and the run recovers from each;
- the CLI refuses a fault plan without ``--supervise``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.parallel import dcn as jdcn
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.parallel import dcn as tdcn
from pytorch_ps_mpi_tpu_torch.parallel import tcp as ttcp
from pytorch_ps_mpi_tpu_torch.resilience import (FaultInjector,
                                                 ResilientWorker,
                                                 Supervisor, load_fault_log)

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 90.0


def _template():
    return {"w": np.zeros(8, np.float32)}


class _Pumper:
    """Polls a server on a thread (the serve loop's part), so a worker's
    blocking calls are answered."""

    def __init__(self, server):
        self.server, self.got = server, []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            item = self.server.poll_grad()
            if item is not None:
                self.got.append(item)
            time.sleep(0.002)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=10)


def _wait(pred, limit=30.0):
    deadline = time.time() + limit
    while not pred() and time.time() < deadline:
        time.sleep(0.005)
    return pred()


@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_resilient_worker_survives_a_server_restart(transport):
    tpl = _template()
    name = f"/psq_torch_rw_{os.getpid()}"

    def server(port=0):
        if transport == "shm":
            return tdcn.ShmPSServer(name, 1, tpl, max_staleness=10**9,
                                    device="cpu")
        return ttcp.TcpPSServer(port, 1, tpl, max_staleness=10**9,
                                device="cpu")

    a = server()
    port = getattr(a, "port", 0)
    a.publish({"w": np.zeros(8, np.float32)})
    pump = _Pumper(a)

    def factory():
        if transport == "shm":
            return tdcn.ShmPSWorker(name, 0, tpl, timeout=5.0, device="cpu")
        return ttcp.TcpPSWorker("127.0.0.1", port, 0, tpl, timeout=5.0,
                                device="cpu")

    w = ResilientWorker(factory, worker_id=0, backoff_base=0.01,
                        backoff_max=0.1, seed=5)
    b = None
    try:
        _, ver = w.read_flat(timeout=10)
        w.push_grad([torch.ones(8)], ver, timeout=5.0)
        assert _wait(lambda: len(pump.got) == 1)
        pump.stop()
        a.close()  # the crash: segment unlinked, socket closed
        b = server(port)
        b.version = 10  # a restored checkpoint's version jump
        b.publish({"w": np.full(8, 3.0, np.float32)})
        pump = _Pumper(b)
        # shm: the first push lands in the orphaned mailbox, the next
        # times out and reconnects; TCP: the dead socket's EOF reconnects
        for k in range(2 if transport == "shm" else 1):
            w.push_grad([torch.full((8,), 2.0)], ver, timeout=1.0)
        assert _wait(lambda: len(pump.got) >= 1)
        assert w.reconnects >= 1
        np.testing.assert_array_equal(pump.got[0][2]["w"].numpy(),
                                      np.full(8, 2.0, np.float32))
        flat, ver2 = w.read_flat(timeout=10)
        assert ver2 >= 11
        np.testing.assert_array_equal(flat, np.full(8, 3.0, np.float32))
    finally:
        pump.stop()
        w.close()
        for s in (a, b):
            if s is not None:
                s.close()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_a_read_that_times_out_mid_reply_leaves_no_desync(side):
    """A 64 MB snapshot whose reply the server sends only in part before
    the read times out: the port's worker opens a new connection, so its
    next read is whole; the JAX worker reads the rest of the old reply as
    its next header and fails (ROADMAP queue 3 item 17)."""
    from pytorch_ps_mpi_tpu.parallel import tcp as jtcp

    tpl = {"w": np.zeros(1 << 24, np.float32)}
    server = ttcp.TcpPSServer(0, 1, tpl, device="cpu")
    snap = np.arange(1 << 24, dtype=np.float32)
    server.publish({"w": snap})
    if side == "port":
        w = ttcp.TcpPSWorker("127.0.0.1", server.port, 0, tpl, timeout=5.0,
                             device="cpu")
        read = w.read_flat
    else:
        w = jtcp.TcpPSWorker("127.0.0.1", server.port, 0, tpl, timeout=5.0)
        read = w.read_params
    got = []

    def first():
        try:
            read(timeout=0.5)
        except Exception as e:
            got.append(e)

    t = threading.Thread(target=first)
    t.start()
    for _ in range(4):  # accept, read the request, send a part of 64 MB
        time.sleep(0.05)
        server._lib.tps_server_pump(server._h)
    t.join(timeout=10)
    pump = _Pumper(server)
    try:
        assert len(got) == 1 and isinstance(got[0], TimeoutError)
        if side == "port":
            flat, version = read(timeout=10)
            assert version == 1
            np.testing.assert_array_equal(flat, snap)
        else:
            with pytest.raises(RuntimeError):
                read(timeout=10)
    finally:
        pump.stop()
        w.close()
        server.close()


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_corrupt_fault_is_rejected_as_corrupt(server_side):
    # 1024 floats: seed 3's eight flips (the smallest at byte 456) all
    # land past the 36-byte header, in the CRC-checked payload
    tpl = {"w": np.zeros(1024, np.float32)}
    name = f"/psq_torch_corrupt_{os.getpid()}_{server_side}"
    server = (tdcn.ShmPSServer(name, 1, tpl, frame=True, device="cpu")
              if server_side == "port"
              else jdcn.ShmPSServer(name, 1, tpl, frame=True))
    try:
        server.publish(tpl)
        w = tdcn.ShmPSWorker(name, 0, tpl, frame=True, device="cpu")
        inj = FaultInjector([{"at_step": 0, "worker": 0, "kind": "corrupt"}],
                            seed=3, role=0)
        w.set_tamper(inj.make_tamper(inj.faults_at(0)[0]))
        w.set_wire_delay(0.05)
        t0 = time.perf_counter()
        w.push_grad([torch.ones(1024)], 1)
        assert time.perf_counter() - t0 >= 0.05
        assert [e["kind"] for e in inj.events] == ["corrupt"]
        assert server.poll_grad() is None
        assert server.frames_rejected_total == 1
        assert server.__dict__.get("reject_reasons", {"corrupt": 1}) == \
            {"corrupt": 1}
        # one-shot hooks: the next push is whole and on time
        w.push_grad([torch.ones(1024)], 1)
        assert _wait(lambda: server.poll_grad() is not None, 5.0) or \
            server.grads_received == 1
        w.close()
    finally:
        server.close()


def test_sync_barrier_degrades_when_a_worker_dies():
    cfg = {"model": "mlp", "model_kw": {"features": (4, 2)},
           "in_shape": [4], "batch": 8, "seed": 1, "optim": "sgd",
           "hyper": {"lr": 0.05}, "device": "cpu",
           "degraded_round_after": 0.5}
    tpl = at.make_problem(cfg, "cpu").template
    server = ttcp.TcpPSServer(0, 2, tpl, max_staleness=10**9, device="cpu")
    n = sum(x.size for x in __import__("jax").tree.leaves(tpl))
    errors = []

    def pusher(wid, pushes):
        try:
            w = ttcp.TcpPSWorker("127.0.0.1", server.port, wid, tpl,
                                 timeout=30.0, device="cpu")
            for _ in range(pushes):
                _, v = w.read_flat(timeout=30.0)
                w.push_payload(np.ones(n, np.float32), v, timeout=30.0)
                time.sleep(0.05)
            w.close()  # worker 1 dies after one push
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=pusher, args=a)
               for a in ((0, 4), (1, 1))]
    for t in threads:
        t.start()
    try:
        _, m = at.serve(server, cfg, total_grads=5, sync_barrier=True,
                        timeout=60.0)
    finally:
        for t in threads:
            t.join(timeout=30)
        server.close()
    assert not errors, errors
    assert m["applied"] == 5.0 and m["degraded_rounds"] >= 3.0
    assert m["publish_version"] == 1.0 + 4  # one full round, 3 degraded


def test_join_workers_reaps_a_stuck_worker():
    quick = subprocess.Popen([sys.executable, "-c", "print('ok')"])
    stuck = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
    t0 = time.time()
    codes = at.join_workers([quick, stuck], timeout=3.0)
    assert time.time() - t0 < 30.0
    assert codes[0] == 0 and codes[1] not in (0, None)
    assert stuck.poll() is not None


PLAN = [{"at_step": 2, "worker": 0, "kind": "corrupt"},
        {"at_step": 3, "worker": 0, "kind": "delay", "delay_ms": 50},
        {"at_step": 3, "worker": 1, "kind": "crash_worker"},
        {"at_step": 4, "worker": 0, "kind": "drop"},
        {"at_step": 5, "worker": 1, "kind": "duplicate"},
        {"at_step": 6, "kind": "crash_server"}]


def test_supervised_chaos_fleet_recovers_from_every_fault(tmp_path,
                                                          monkeypatch):
    cfg = {"model": "mlp", "model_kw": {"features": (32, 8)},
           "in_shape": [8], "batch": 16, "seed": 0, "optim": "sgd",
           "hyper": {"lr": 0.05}, "steps": 8, "device": "cpu",
           # paced, and worker 0 pushing 12 times, so it still pushes
           # when the server restarts: its own 6th applied push is its
           # step 7
           "slow_ms": {"0": 150.0, "1": 150.0}, "worker_steps": {"0": 12},
           "frame_check": True, "resilient": True, "open_timeout": LIMIT,
           "push_timeout": 5.0, "max_staleness": 10**9,
           "fault_plan": PLAN, "fault_seed": 4,
           "fault_log_dir": str(tmp_path / "faults")}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned workers'
    sup = Supervisor(cfg, 2, checkpoint_dir=str(tmp_path / "ckpt"),
                     checkpoint_every=4, timeout=LIMIT)
    _, m = sup.run()
    assert m["worker_exit_codes"] == [0, 0]
    assert m["worker_respawns"] == 1.0 and m["server_restarts"] == 1.0
    assert m["workers_abandoned"] == 0.0 and m["versions_monotonic"]
    assert m["worker_reconnects"] >= 1.0
    assert m["reject_reasons_all_phases"] == {"corrupt": 1}
    assert m["frames_rejected_by_worker"] == {0: 1}
    assert m["loss_final"] < m["run_loss_initial"]
    fired = sorted(
        (e["id"], e["kind"]) for role in ("0", "1", "server")
        for e in load_fault_log(str(tmp_path / "faults"
                                    / f"faults-{role}.jsonl")))
    assert fired == [(i, f["kind"]) for i, f in enumerate(PLAN)]


def test_cli_refuses_a_fault_plan_without_the_supervisor():
    from pytorch_ps_mpi_tpu_torch import train_async

    plan = '[{"at_step": 1, "worker": 0, "kind": "drop"}]'
    with pytest.raises(SystemExit):
        train_async.main(["--fault-plan", plan])
    with pytest.raises(SystemExit):
        train_async.main(["--supervise", "--fault-plan",
                          '[{"at_step": 1, "kind": "crash_server"}]'])
    with pytest.raises(SystemExit):
        train_async.main(["--supervise", "--fault-plan", "[{bad json"])

"""The async wire across the two packages: a port worker's framed push is
accepted by a JAX server, which decodes what the JAX package's own wire
decodes, and the reverse; the parameters one side publishes are the ones
the other reads. Over shared memory both ends run in this process (the
shm mailbox never blocks a push); over TCP, whose push waits for the
server's ack, the worker is a fresh interpreter and the server drains it
through the native batched ingest (``poll_grad_batch``)."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.parallel import dcn as jdcn
from pytorch_ps_mpi_tpu.parallel import tcp as jtcp
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import dcn as tdcn
from pytorch_ps_mpi_tpu_torch.parallel import tcp as ttcp
from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

ROOT = Path(__file__).resolve().parent.parent

#: the template, gradient and parameters, made alike by either process
_MAKE = """
import numpy as np
def template():
    rng = np.random.RandomState(11)
    return {"params": {
        "Conv_0": {"kernel": rng.randn(3, 3, 8, 16).astype(np.float32)},
        "Dense_0": {"kernel": rng.randn(40, 10).astype(np.float32),
                    "bias": rng.randn(10).astype(np.float32)}}}
def grads(tmpl, seed):
    rng = np.random.RandomState(seed)
    out = {"params": {}}
    for mod, leaves in tmpl["params"].items():
        out["params"][mod] = {k: rng.randn(*v.shape).astype(np.float32)
                              for k, v in leaves.items()}
    return out
"""
_ns: dict = {}
exec(_MAKE, _ns)
template, make_grads = _ns["template"], _ns["grads"]


def _jax_decode(name, grads):
    """What the JAX package's own wire decodes for a JAX worker's push."""
    wire = jdcn.CodecWire(jax_codec(name), template())
    return [np.asarray(x) for x in jax.tree.leaves(
        wire.decode_from_bytes(np.array(wire.encode_to_bytes(grads))))]


def _check_decode(name, got, grads):
    for g, w in zip(got, _jax_decode(name, grads)):
        g = g.detach().cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        if name == "sign":  # the scale sidecar (ROADMAP queue 3 item 2)
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["int8", "sign"])
def test_port_worker_to_jax_server_over_shm(name):
    tmpl = template()
    seg = f"/psq_interop_{os.getpid()}_{name}_a"
    server = jdcn.ShmPSServer(seg, 1, tmpl, code=jax_codec(name), frame=True)
    try:
        server.publish(tmpl)
        worker = tdcn.ShmPSWorker(seg, 0, tmpl, code=get_codec(name),
                                  frame=True, device="cpu")
        flat, version = worker.read_flat()
        np.testing.assert_array_equal(flat, jdcn._flatten(tmpl))
        grads = make_grads(tmpl, 5)
        worker.push_grad(jax.tree.map(torch.from_numpy, grads), version)
        wid, v, got = server.poll_grad()
        assert (wid, v) == (0, version) and server.frames_rejected_total == 0
        _check_decode(name, jax.tree.leaves(got), grads)
        worker.close()
    finally:
        server.close()


@pytest.mark.parametrize("name", ["int8", "sign"])
def test_jax_worker_to_port_server_over_shm(name):
    tmpl = template()
    seg = f"/psq_interop_{os.getpid()}_{name}_b"
    server = tdcn.ShmPSServer(seg, 1, tmpl, code=get_codec(name), frame=True,
                              device="cpu")
    try:
        server.publish(tmpl)
        worker = jdcn.ShmPSWorker(seg, 0, tmpl, code=jax_codec(name),
                                  frame=True)
        params, version = worker.read_params()
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tmpl)):
            np.testing.assert_array_equal(a, b)
        grads = make_grads(tmpl, 6)
        worker.push_grad(grads, version)
        wid, v, got = server.poll_grad()
        assert (wid, v) == (0, version) and server.frames_rejected_total == 0
        _check_decode(name, tree_flatten(got)[0], grads)
        # a frame of another configuration is a counted rejection
        other = jdcn.ShmPSWorker(seg, 0, tmpl, code=jax_codec("identity"),
                                 frame=True)
        other.push_payload(np.zeros(server.wire.wire_bytes, np.uint8),
                           version)
        assert server.poll_grad() is None
        assert server.frames_rejected_total == 1
        worker.close()
        other.close()
    finally:
        server.close()


_WORKER = """
import json, sys
import numpy as np
sys.path[:0] = [{root!r}]
{make}
side, port, name, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
tmpl = template()
g = grads(tmpl, 7)
if side == "port":
    import torch
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSWorker
    w = TcpPSWorker("127.0.0.1", port, 0, tmpl, code=get_codec(name),
                    frame=True, device="cpu", timeout=60.0)
    flat, version = w.read_flat(timeout=60.0)
    tg = {{"params": {{m: {{k: torch.from_numpy(v) for k, v in d.items()}}
                     for m, d in g["params"].items()}}}}
    w.push_grad(tg, version, timeout=60.0)
else:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pytorch_ps_mpi_tpu.codecs import get_codec
    from pytorch_ps_mpi_tpu.parallel import dcn
    from pytorch_ps_mpi_tpu.parallel.tcp import TcpPSWorker
    w = TcpPSWorker("127.0.0.1", port, 0, tmpl, code=get_codec(name),
                    frame=True, timeout=60.0)
    params, version = w.read_params(timeout=60.0)
    flat = dcn._flatten(params)
    w.push_grad(g, version, timeout=60.0)
np.save(out, flat)
w.close()
"""


def _tcp_round(server, side, name, tmp_path):
    tmpl = template()
    server.publish(tmpl)
    out = tmp_path / "read.npy"
    # one intra-op thread: the suite's other workers share the cores
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _WORKER.format(root=str(ROOT), make=_MAKE),
         side, str(server.port), name, str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        items, deadline = [], time.time() + 90
        while not items and time.time() < deadline:
            batch = server.poll_grad_batch()
            assert batch is not None  # frames on, the native path armed
            items.extend(batch)
            time.sleep(0.01)
        out_text = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0, out_text
    finally:
        proc.kill()
    assert len(items) == 1 and server.native_batches >= 1
    np.testing.assert_array_equal(np.load(out), jdcn._flatten(tmpl))
    return items[0], make_grads(tmpl, 7)


def test_port_worker_to_jax_server_over_tcp(tmp_path, monkeypatch):
    monkeypatch.setenv("PS_NO_NATIVE", "0")
    server = jtcp.TcpPSServer(0, 1, template(), code=jax_codec("int8"),
                              frame=True)
    try:
        (wid, _, got), grads = _tcp_round(server, "port", "int8", tmp_path)
        assert wid == 0 and server.frames_rejected_total == 0
        _check_decode("int8", jax.tree.leaves(got), grads)
    finally:
        server.close()


def test_jax_worker_to_port_server_over_tcp(tmp_path, monkeypatch):
    monkeypatch.setenv("PS_NO_NATIVE", "0")
    server = ttcp.TcpPSServer(0, 1, template(), code=get_codec("int8"),
                              frame=True, device="cpu")
    try:
        (wid, _, got), grads = _tcp_round(server, "jax", "int8", tmp_path)
        assert wid == 0 and server.frames_rejected_total == 0
        _check_decode("int8", tree_flatten(got)[0], grads)
    finally:
        server.close()

"""The port's grads-only ``SGD`` step at world 2, two processes over gloo,
against the JAX package's step on a 2-device mesh, on the same numpy
gradients of the width-32 ResNet-18, after 3 steps:

- ``sign``: the sign bits agree; parameters to rtol 1e-6 (atol 1e-7 for
  elements near zero), since the scale is a float sum in another order;
- ``int8``: the codes agree; parameters to rtol 1e-6, atol 1e-7, since
  the JAX einsum sums over ranks in XLA's order with fused multiply-adds;
- ``ef_topk``: error feedback around the exact top-k of 1% of each leaf.
  Both sides send the same elements, and the scatter-add sums the ranks
  in rank order on both. Parameters to rtol 1e-6, atol 1e-7: the jitted
  JAX step contracts the update into fused multiply-adds (the world-1
  int8 test in ``test_torch_ps.py`` shows this for the identity codec).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import (ROOT, STEPS, assert_params_close, jax_grads_only,
                          jax_resnet, stacked_grads, torch_grads,
                          torch_resnet)


_WORKER = """
import sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import SGD, mesh
from pytorch_ps_mpi_tpu_torch.codecs import get_codec

rank, world, port, src, dst, steps, codec = sys.argv[1:8]
rank, world, steps = int(rank), int(world), int(steps)
torch.set_num_threads(1)  # two ranks share the host's cores
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
data = np.load(src)
names = [k[2:] for k in data.files if k.startswith("p:")]
params = {n: torch.from_numpy(data["p:" + n].copy()) for n in names}
code = (get_codec("ef", inner=get_codec("topk", fraction=0.01, pallas=True))
        if codec == "ef_topk" else get_codec(codec))
opt = SGD(params, lr=0.01, momentum=0.9, code=code, device="cpu")
assert opt.size == world and opt.rank == rank
for s in range(steps):
    opt.step(grads={n: torch.from_numpy(data[f"g{s}:" + n]) for n in names})
if rank == 0:
    np.savez(dst, **{n: p.numpy() for n, p in params.items()})
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world2_run(tmp_path, codec: str) -> None:
    world = 2
    model = torch_resnet()
    _, variables = jax_resnet()
    arrays = {f"p:{n}": p.detach().numpy()
              for n, p in model.named_parameters()}
    for s in range(STEPS):
        for n, g in torch_grads(model,
                                 stacked_grads(variables, world, s)).items():
            arrays[f"g{s}:{n}"] = g.numpy()
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **arrays)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(port),
         str(src), str(dst), str(STEPS), codec], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, outs
    got = np.load(dst)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(got[n]))
    assert_params_close(model, jax_grads_only(world, codec), rtol=1e-6,
                        atol=1e-7)


def test_grads_only_sign_step_matches_jax_world2_gloo(tmp_path):
    _world2_run(tmp_path, "sign")


@pytest.mark.parametrize("codec", ["int8", "ef_topk"])
def test_grads_only_step_matches_jax_world2_gloo(tmp_path, codec):
    _world2_run(tmp_path, codec)

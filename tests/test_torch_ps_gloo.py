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

And ``Adam(code=terngrad(use_pallas=True))`` on the tiny BERT through
``step(loss_fn=...)`` at world 2, each rank on its own batch: both
ranks' payloads, run through the JAX codec's ``aggregate``/``agg_decode``
and the JAX ``adam_update``, give the port's parameters to rtol 1e-6
after 2 steps.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import (STEPS, assert_params_close, jax_bert,
                          jax_grads_only, jax_replay_terngrad_adam,
                          jax_resnet, spawn_ranks, stacked_grads, torch_bert,
                          torch_grads, torch_resnet)


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


_BERT_WORKER = """
import sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import Adam, mesh
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from torch_parity import (ADAM, TERN_KW, bert_batch, bert_loss_fn,
                          record_payloads)

rank, world, port, src, dst, steps = sys.argv[1:7]
rank, world, steps = int(rank), int(world), int(steps)
torch.set_num_threads(1)  # two ranks share the host's cores
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
model = tm.BertMLM(tm.BertConfig.tiny(attention="flash"), device="cpu")
data = np.load(src)
with torch.no_grad():
    for n, p in model.named_parameters():
        p.copy_(torch.from_numpy(data[n]))
sent = []
code = record_payloads(get_codec("terngrad", **TERN_KW), sent)
opt = Adam(model, code=code, device="cpu", seed=0, **ADAM)
for s in range(steps):
    opt.step(loss_fn=bert_loss_fn(model), batch=bert_batch(10 * s + rank))
out = {f"{i}:{k}": v for i, p in enumerate(sent) for k, v in p.items()}
if rank == 0:
    out.update({"p:" + n: p.detach().numpy() for n, p in opt.params.items()})
np.savez(f"{dst}.{rank}.npz", names=np.array(list(opt.params)), **out)
torch.distributed.destroy_process_group()
"""


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
    spawn_ranks(_WORKER, world, (src, dst, STEPS, codec))
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


def test_adam_terngrad_loss_fn_step_on_tiny_bert_matches_jax_world2_gloo(
        tmp_path):
    world, steps = 2, 2
    model = torch_bert()
    src, dst = tmp_path / "bert.npz", tmp_path / "sent"
    np.savez(src, **{n: p.detach().numpy()
                     for n, p in model.named_parameters()})
    spawn_ranks(_BERT_WORKER, world, (src, dst, steps))
    outs = [np.load(f"{dst}.{r}.npz") for r in range(world)]
    names = [str(n) for n in outs[0]["names"]]
    per_rank = [[{k: out[f"{i}:{k}"] for k in ("packed", "scale")}
                 for i in range(steps * len(names))] for out in outs]
    replay = [[ranks[s * len(names):(s + 1) * len(names)]
               for ranks in per_rank] for s in range(steps)]
    # the ranks drew their own bits from their own batches' gradients
    assert not np.array_equal(replay[0][0][0]["packed"],
                              replay[0][1][0]["packed"])
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(outs[0]["p:" + n]))
    assert_params_close(model, jax_replay_terngrad_adam(jax_bert()[1], names,
                                                        replay),
                        rtol=1e-6, atol=1e-7)

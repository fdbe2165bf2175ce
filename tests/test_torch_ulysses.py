"""The port's Ulysses attention (``parallel/ulysses.py``) over gloo at
worlds 2 and 4 against the JAX ``ulysses_attention`` under ``shard_map``
on a 2- or 4-device sub-mesh, on the same numpy inputs:

- the head/sequence exchange ``_seq_to_heads`` bit for bit, on tokens
  whose every value is distinct (a permuted row order would show);
- the output and the gradients of q, k and v, causal and not, on the
  flash path and on the dense path, in float32 to rtol 1e-5;
- two all-to-alls a forward (q, k, v stacked on the batch axis), two in
  the backward;
- the ``heads % n`` error, word for word.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from pytorch_ps_mpi_tpu.mesh import make_mesh as jax_make_mesh
from pytorch_ps_mpi_tpu.parallel import ulysses as jax_ulysses
from torch_parity import spawn_ranks

B, L, H, D = 2, 64, 4, 16
RTOL, ATOL = 1e-5, 1e-6

_WORKER = """
import json, sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import comms, mesh
from pytorch_ps_mpi_tpu_torch.parallel import ulysses

rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
m = mesh.make_mesh((world,), ("seq",))
data = np.load(src)
spec = mesh.P(None, "seq")
q, k, v, cot, ids = (torch.from_numpy(m.shard(data[n], spec).copy())
                     for n in ("q", "k", "v", "cot", "ids"))
out, calls = {}, {}
out["heads"] = ulysses._seq_to_heads(ids, m.group("seq")).numpy()
for flash in (True, False):
    for causal in (False, True):
        name = f"{int(flash)}{int(causal)}"
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        comms.reset_calls()
        o = ulysses.ulysses_attention(*leaves, "seq", causal=causal,
                                      use_flash=flash, mesh=m)
        fwd = comms.calls["all_to_all"]
        g = torch.autograd.grad((o * cot).sum(), leaves)
        calls[name] = [fwd, comms.calls["all_to_all"] - fwd]
        out[f"o{name}"] = o.detach().numpy()
        for n, t in zip("qkv", g):
            out[f"d{n}{name}"] = t.numpy()
try:
    ulysses.ulysses_attention(q[:, :, :1], k[:, :, :1], v[:, :, :1], "seq",
                              mesh=m)
    err = ""
except ValueError as e:
    err = str(e)
np.savez(f"{dst}.{rank}.npz", calls=json.dumps(calls), err=err, **out)
torch.distributed.destroy_process_group()
"""


def _inputs():
    rng = np.random.RandomState(11)
    data = {n: rng.randn(B, L, H, D).astype(np.float32)
            for n in ("q", "k", "v", "cot")}
    data["ids"] = np.arange(B * L * H * D, dtype=np.float32).reshape(
        B, L, H, D)
    return data


def _mesh(world):
    return jax_make_mesh(axis_names=("seq",), devices=jax.devices()[:world])


def _jax_heads(ids, world):
    spec = JP(None, "seq")
    fn = jax.shard_map(lambda x: jax_ulysses._seq_to_heads(x, "seq"),
                       mesh=_mesh(world), in_specs=spec,
                       out_specs=JP(None, None, "seq"), check_vma=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(ids)))


def _jax_ulysses(data, world, flash, causal):
    spec = JP(None, "seq")
    fn = jax.shard_map(
        lambda q, k, v: jax_ulysses.ulysses_attention(
            q, k, v, "seq", causal=causal, use_flash=flash),
        mesh=_mesh(world), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False)
    cot = jnp.asarray(data["cot"])

    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * cot), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(
        *(jnp.asarray(data[n]) for n in "qkv"))
    return [np.asarray(t) for t in (o, *g)]


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_matches_jax_over_gloo(tmp_path, world):
    data = _inputs()
    src = tmp_path / "in.npz"
    np.savez(src, **data)
    spawn_ranks(_WORKER, world, [src, tmp_path / "out"])
    ranks = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    # the exchange, bit for bit: rank r holds head group r, the whole
    # sequence in token order
    heads = np.concatenate([r["heads"] for r in ranks], axis=2)
    np.testing.assert_array_equal(heads, _jax_heads(data["ids"], world))
    np.testing.assert_array_equal(heads, data["ids"])
    for flash in (True, False):
        for causal in (False, True):
            name = f"{int(flash)}{int(causal)}"
            want = _jax_ulysses(data, world, flash, causal)
            for key, w in zip(("o", "dq", "dk", "dv"), want):
                got = np.concatenate([r[key + name] for r in ranks], axis=1)
                np.testing.assert_allclose(
                    got, w, rtol=RTOL, atol=ATOL,
                    err_msg=f"{key} flash={flash} causal={causal}")
            for r in ranks:
                assert json.loads(str(r["calls"]))[name] == [2, 2]
    want_err = (f"heads=1 must divide by axis size {world} for Ulysses SP "
                "(use ring attention when heads are scarce)")
    assert all(str(r["err"]) == want_err for r in ranks)


def test_one_rank_ulysses_is_flash_attention():
    from pytorch_ps_mpi_tpu_torch.ops.attention import flash_attention
    from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

    data = _inputs()
    q, k, v = (torch.from_numpy(data[n]) for n in "qkv")
    for causal in (False, True):
        torch.testing.assert_close(
            ulysses_attention(q, k, v, "seq", causal=causal),
            flash_attention(q, k, v, causal=causal), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="cannot tile"):
        ulysses_attention(q[:, :12], k[:, :12], v[:, :12], "seq",
                          use_flash=True)

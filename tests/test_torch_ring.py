"""The port's ring attention (``parallel/ring.py``) over gloo at worlds 2
and 4, one rank a sequence shard, against the JAX ``ring_attention``
under ``shard_map`` on a 2- or 4-device sub-mesh of the virtual CPU
mesh, on the same numpy q, k, v and output cotangent:

- the output and the gradients of q, k and v, causal and not, on the
  flash path (each block one flash call with its global offsets and
  ``return_lse=True``, the combine's lse cotangent in the backward; the
  JAX side runs its Pallas kernels in interpret mode) and on the dense
  path, in float32 to rtol 1e-5;
- the ring's collectives: 2 (n − 1) permutes a forward, as many in the
  backward.

Single-process: :func:`ring_combine` against the JAX ``step`` body on
blocks the causal mask covers whole (lse at the mask's floor), and the
ring at one rank equal to one flash call.
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
from pytorch_ps_mpi_tpu.parallel.ring import ring_attention as jax_ring
from torch_parity import spawn_ranks

B, L, H, D = 2, 64, 2, 16
CASES = [(flash, causal) for flash in (True, False) for causal in (False, True)]
RTOL, ATOL = 1e-5, 1e-6

_WORKER = """
import json, sys
import numpy as np
import torch
from pytorch_ps_mpi_tpu_torch import comms, mesh
from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_attention

rank, world, port, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
mesh.initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                            rank=rank, backend="gloo")
m = mesh.make_mesh((world,), ("seq",))
data = np.load(src)
spec = mesh.P(None, "seq")
q, k, v, cot = (torch.from_numpy(m.shard(data[n], spec).copy())
                for n in ("q", "k", "v", "cot"))
out, calls = {}, {}
for flash in (True, False):
    for causal in (False, True):
        name = f"{int(flash)}{int(causal)}"
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        comms.reset_calls()
        o = ring_attention(*leaves, "seq", causal=causal, use_flash=flash,
                           mesh=m)
        fwd = comms.calls["ring_permute"]
        g = torch.autograd.grad((o * cot).sum(), leaves)
        calls[name] = [fwd, comms.calls["ring_permute"] - fwd]
        out[f"o{name}"] = o.detach().numpy()
        for n, t in zip("qkv", g):
            out[f"d{n}{name}"] = t.numpy()
np.savez(f"{dst}.{rank}.npz", calls=json.dumps(calls), **out)
torch.distributed.destroy_process_group()
"""


def _inputs():
    rng = np.random.RandomState(7)
    return {n: rng.randn(B, L, H, D).astype(np.float32)
            for n in ("q", "k", "v", "cot")}


def _jax_ring(data, world: int, flash: bool, causal: bool):
    mesh = jax_make_mesh(axis_names=("seq",), devices=jax.devices()[:world])
    spec = JP(None, "seq")
    ring = jax.shard_map(
        lambda q, k, v: jax_ring(q, k, v, "seq", causal=causal,
                                 use_flash=flash),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    cot = jnp.asarray(data["cot"])

    def loss(q, k, v):
        o = ring(q, k, v)
        return jnp.sum(o * cot), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(
        *(jnp.asarray(data[n]) for n in "qkv"))
    return [np.asarray(t) for t in (o, *g)]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_over_gloo(tmp_path, world):
    data = _inputs()
    src = tmp_path / "in.npz"
    np.savez(src, **data)
    spawn_ranks(_WORKER, world, [src, tmp_path / "out"])
    ranks = [np.load(tmp_path / f"out.{r}.npz") for r in range(world)]
    for flash, causal in CASES:
        name = f"{int(flash)}{int(causal)}"
        want = _jax_ring(data, world, flash, causal)
        for key, w in zip(("o", "dq", "dk", "dv"), want):
            got = np.concatenate([r[key + name] for r in ranks], axis=1)
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{key} flash={flash} "
                                               f"causal={causal}")
        for r in ranks:
            assert json.loads(str(r["calls"]))[name] == [2 * (world - 1)] * 2


def test_combine_matches_the_jax_step_on_masked_blocks():
    from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_combine, ring_init

    rng = np.random.RandomState(3)
    q = rng.randn(1, 8, 2, 4).astype(np.float32)
    o_blks = [rng.randn(1, 2, 8, 4).astype(np.float32) for _ in range(3)]
    # a block the causal mask covers whole first (the kernels' masked-row
    # lse, -1e30 + log(1e-30)), then two live ones
    lses = [np.full((1, 2, 8), -1e30 + np.log(1e-30), np.float32),
            rng.randn(1, 2, 8).astype(np.float32),
            rng.randn(1, 2, 8).astype(np.float32)]
    num, den, mx = ring_init(torch.from_numpy(q))
    zq = jnp.transpose(jnp.asarray(q), (0, 2, 1, 3))
    z = jnp.where(jnp.isfinite(zq), zq * 0, 0.0)
    jn, jd, jm = z, z[..., 0], z[..., 0] - 1e30
    for o, lse in zip(o_blks, lses):
        num, den, mx = ring_combine(num, den, mx, torch.from_numpy(o),
                                    torch.from_numpy(lse))
        new = jnp.maximum(jm, lse)
        corr = jnp.exp(jm - new)
        w = jnp.where(lse > -1e29, jnp.exp(lse - new), 0.0)
        jn = jn * corr[..., None] + o * w[..., None]
        jd, jm = jd * corr + w, new
        for got, want in ((num, jn), (den, jd), (mx, jm)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
    assert float(den.min()) > 0  # the masked block added no weight


def test_one_rank_ring_is_one_flash_call():
    from pytorch_ps_mpi_tpu_torch.ops.attention import flash_attention, flash_fwd
    from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_attention

    data = _inputs()
    q, k, v = (torch.from_numpy(data[n]) for n in "qkv")
    for causal in (False, True):
        torch.testing.assert_close(
            ring_attention(q, k, v, "seq", causal=causal),
            flash_attention(q, k, v, causal=causal), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="cannot tile"):
        ring_attention(q[:, :12], k[:, :12], v[:, :12], "seq",
                       use_flash=True)
    assert flash_fwd.launches == 0  # CPU tensors take the plain version


def test_cpu_default_takes_the_dense_path_where_shards_do_not_tile():
    from pytorch_ps_mpi_tpu_torch.ops.attention import attention_ref
    from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_attention
    from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

    data = _inputs()
    q, k, v = (torch.from_numpy(data[n][:, :12]) for n in "qkv")
    for causal in (False, True):
        want = attention_ref(q, k, v, 0, 0, causal, D ** -0.5)[0]
        for fn in (ring_attention, ulysses_attention):
            torch.testing.assert_close(fn(q, k, v, "seq", causal=causal),
                                       want, rtol=RTOL, atol=ATOL)


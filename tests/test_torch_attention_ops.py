"""The port's ``flash_attention`` on the CPU (its plain versions of the
forward and backward kernels, joined by the autograd function) against
the JAX package's Pallas flash kernel in interpret mode
(``ops/attention_pallas.py``), in float32 on the same numpy inputs.
Tolerances are the JAX tests' own (``tests/test_attention_pallas.py``):
rtol 2e-5 for outputs and logsumexp (the JAX kernel's online softmax
rescales tile by tile, the plain version normalizes once), rtol 1e-4 /
atol 1e-5 for gradients. The CUDA kernels are held to the plain versions
in ``test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu.ops import attention_pallas as jattn
from pytorch_ps_mpi_tpu_torch.ops import attention as A


def _qkv(b=2, lq=32, lk=32, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, l, h, d).astype(np.float32)
                 for l in (lq, lk, lk))


CASES = {
    # name: (lq, lk, causal, q_offset, k_offset)
    "dense": (32, 32, False, 0, 0),
    "causal": (32, 32, True, 0, 0),
    "offsets": (16, 32, True, 16, 0),
    "masked_rows": (32, 32, True, 0, 8),       # rows 0..7 see no key
    "future_block": (16, 32, True, 0, 100),    # every row masked
    "rect": (16, 48, False, 0, 0),
}


def _port(q, k, v, causal, qo, ko, grad):
    ts = [torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v)]
    o, lse = A.flash_attention(*ts, causal=causal, q_offset=qo, k_offset=ko,
                               block_q=8, block_k=8, return_lse=True)
    return ts, o, lse


def _jax(q, k, v, causal, qo, ko):
    return jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=jnp.int32(qo), k_offset=jnp.int32(ko), block_q=8, block_k=8,
        return_lse=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_jax(case):
    lq, lk, causal, qo, ko = CASES[case]
    q, k, v = _qkv(lq=lq, lk=lk, seed=lq + lk)
    _, o, lse = _port(q, k, v, causal, qo, ko, grad=False)
    jo, jlse = _jax(q, k, v, causal, qo, ko)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)
    if case == "future_block":
        assert not o.abs().any()
        assert torch.equal(lse, torch.full_like(lse, -1e30 + np.log(1e-30)))


@pytest.mark.parametrize("case", ["dense", "causal", "offsets",
                                  "masked_rows"])
def test_gradients_with_the_lse_cotangent_match_jax(case):
    lq, lk, causal, qo, ko = CASES[case]
    q, k, v = _qkv(lq=lq, lk=lk, d=8, seed=3)
    ts, o, lse = _port(q, k, v, causal, qo, ko, grad=True)
    # the lse term exercises the lse cotangent (dm = D - g_lse)
    loss = (o ** 2).sum() + torch.sin(lse).sum()
    grads = torch.autograd.grad(loss, ts)

    def lf(q, k, v):
        o, lse = jattn.flash_attention(
            q, k, v, causal=causal, q_offset=jnp.int32(qo),
            k_offset=jnp.int32(ko), block_q=8, block_k=8, return_lse=True)
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(lse))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    # the loss is a sum of the forward's outputs: the forward's tolerance
    np.testing.assert_allclose(float(loss.detach()), float(lf(jq, jk, jv)),
                               rtol=2e-5)
    for got, want in zip(grads, jax.grad(lf, (0, 1, 2))(jq, jk, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_untileable_length_takes_the_dense_path_as_jax_does():
    q, k, v = _qkv(lq=12, lk=12, seed=5)
    before = (A.flash_fwd.launches, A.flash_bwd.launches)
    _, o, lse = _port(q, k, v, True, 0, 0, grad=False)
    jo, jlse = _jax(q, k, v, True, 0, 0)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)
    assert (A.flash_fwd.launches, A.flash_bwd.launches) == before


@pytest.mark.parametrize("args", [(512, 512, "float32"), (512, 512, "bfloat16"),
                                  (12, 12, "float32"), (24, 24, "bfloat16"),
                                  (100, 128, "float32"), (32, 40, "bfloat16")])
def test_tiling_rules_match_jax(args):
    lq, lk, dtype = args
    for target in (8, 64, 128):
        for length in (lq, lk):
            assert A._pick_block(length, target,
                                 A._min_block_for(getattr(torch, dtype))) == \
                jattn._pick_block(length, target,
                                  jattn._min_block_for(getattr(jnp, dtype)))
    assert A.flash_supported(lq, lk, dtype=getattr(torch, dtype)) == \
        jattn.flash_supported(lq, lk, dtype=getattr(jnp, dtype))


def test_plain_versions_round_p_and_ds_to_the_input_type():
    # in bf16 the plain forward rounds p before p @ v, as the kernel does:
    # equal to the float32 computation with p rounded by hand
    q, k, v = (torch.from_numpy(a).transpose(1, 2).reshape(4, 32, 16)
               for a in _qkv(seed=9))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = A.flash_fwd_ref(qb, kb, vb, 0, 0, False, 0.25)
    s = torch.matmul(qb.float(), kb.float().transpose(1, 2)) * 0.25
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    want = torch.matmul(p.to(torch.bfloat16).float(), vb.float()) / p.sum(
        -1, keepdim=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(o, want.to(torch.bfloat16))
    dq, dk, dv = A.flash_bwd_ref(qb, kb, vb, o, lse, torch.ones_like(o),
                                 torch.zeros_like(lse), 0, 0, False, 0.25)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_wrappers_check_their_inputs():
    q = torch.zeros(2, 32, 16)
    with pytest.raises(ValueError):
        A.flash_fwd(q, torch.zeros(2, 32, 8), torch.zeros(2, 32, 8), 0, 0,
                    False, 1.0)
    with pytest.raises(ValueError):
        A.flash_fwd(q, q.double(), q, 0, 0, False, 1.0)
    before = A.flash_fwd.launches
    A.flash_fwd(q, q, q, 0, 0, False, 1.0)
    assert A.flash_fwd.launches == before

"""The port's ``flash_attention`` on the CPU (its plain versions of the
forward and backward kernels, joined by the autograd function) against
the JAX package's Pallas flash kernel in interpret mode
(``ops/attention_pallas.py``), in float32 on the same numpy inputs.
Tolerances are the JAX tests' own (``tests/test_attention_pallas.py``):
rtol 2e-5 for outputs and logsumexp (the JAX kernel's online softmax
rescales tile by tile, the plain version normalizes once), rtol 1e-4 /
atol 1e-5 for gradients. The CUDA kernels are held to the plain versions
in ``test_torch_cuda_kernels.py``; which dtype takes which source, the
wrappers' checks and the views they hand to TMA are checked here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_ps_mpi_tpu.ops import attention_pallas as jattn
from pytorch_ps_mpi_tpu_torch.ops import _build
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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", A.HEAD_DIMS)
def test_forward_and_lse_match_jax_at_every_kernel_head_dim(d, causal):
    # every head dim the CUDA kernels are built for (8 is zero-padded to 16
    # on the tensor cores), held here through the plain versions
    q, k, v = _qkv(lq=16, lk=32, h=1, d=d, seed=d)
    _, o, lse = _port(q, k, v, causal, 16, 0, grad=False)
    jo, jlse = _jax(q, k, v, causal, 16, 0)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("d", A.HEAD_DIMS)
def test_gradients_match_jax_at_every_kernel_head_dim(d):
    q, k, v = _qkv(b=1, lq=16, lk=16, h=1, d=d, seed=d + 1)
    ts, o, _ = _port(q, k, v, True, 0, 0, grad=True)
    grads = torch.autograd.grad((o ** 2).sum(), ts)

    def lf(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, causal=True, block_q=8,
                                             block_k=8) ** 2)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    # dp = dO·vᵀ and dm = rowsum(dO·o) reduce over d and then cancel in
    # dp − dm: the gradients' absolute tolerance, 1e-5 up to d = 16 as in
    # the JAX tests, grows with d
    atol = 1e-5 * max(1, d // 16)
    for got, want in zip(grads, jax.grad(lf, (0, 1, 2))(jq, jk, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=atol)


def _float64_grads(q, k, v, causal: bool):
    """dq, dk, dv of sum(o²) by dense attention in float64 (autograd)."""
    ts = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", ts[0], ts[1]) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -torch.inf)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), ts[2])
    return torch.autograd.grad((o ** 2).sum(), ts)


@pytest.mark.parametrize("seed", [129, 7, 11])
def test_gradients_at_d128_hold_to_float64(seed):
    # both float32 sides against a float64 evaluation, at the JAX tests'
    # atol 1e-5 (the gradients' largest magnitudes are 8–16): the port's
    # plain backward and the Pallas _bwd_dq_kernel/_bwd_dkv_kernel
    # (interpret mode). With dp and dm in float32 the port's drifted by
    # up to 1.9e-5, the Pallas kernels' by 8.3e-6.
    q, k, v = _qkv(b=1, lq=16, lk=16, h=1, d=128, seed=seed)
    ts, o, _ = _port(q, k, v, True, 0, 0, grad=True)
    port = torch.autograd.grad((o ** 2).sum(), ts)

    def lf(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, causal=True, block_q=8,
                                             block_k=8) ** 2)

    pallas = jax.grad(lf, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for got, ref, want in zip(port, pallas, _float64_grads(q, k, v, True)):
        want = want.numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(ref), want, rtol=0, atol=1e-5)


def test_each_dtype_takes_its_kernels():
    # bf16 on the tensor cores, float32 on the CUDA cores (not TF32)
    assert A.kernel_source(torch.bfloat16) == "attention_tc"
    assert A.kernel_source(torch.float32) == "attention"
    assert {src for src, _ in A.SOURCES.values()} <= set(_build.SOURCES)
    with pytest.raises(ValueError):
        A.kernel_source(torch.float16)


@pytest.mark.parametrize("shapes,dtypes", [
    (((2, 32, 16), (2, 32, 8), (2, 32, 8)), None),     # head dims differ
    (((2, 32, 16), (3, 32, 16), (3, 32, 16)), None),   # b·h differs
    (((2, 32, 16), (2, 32, 16), (2, 24, 16)), None),   # k and v differ
    (((32, 16), (32, 16), (32, 16)), None),            # not [bh, l, d]
    (None, (torch.float16,) * 3),                      # no kernel
    (None, (torch.bfloat16, torch.float32, torch.float32)),  # mixed
])
def test_both_wrappers_refuse_inputs_that_do_not_fit(shapes, dtypes):
    shapes = shapes or ((2, 32, 16),) * 3
    dtypes = dtypes or (torch.float32,) * 3
    q, k, v = (torch.zeros(s, dtype=t) for s, t in zip(shapes, dtypes))
    before = (A.flash_fwd.launches, A.flash_bwd.launches)
    with pytest.raises(ValueError):
        A.flash_fwd(q, k, v, 0, 0, False, 1.0)
    with pytest.raises(ValueError):
        A.flash_bwd(q, k, v, q, q[..., 0], q, None, 0, 0, False, 1.0)
    assert (A.flash_fwd.launches, A.flash_bwd.launches) == before


@pytest.mark.parametrize("causal", [False, True])
def test_no_lse_cotangent_is_a_zero_one(causal):
    # the dq kernel folds dm = rowsum(dO·o) − g_lse; None stands for zeros
    q, k, v = (torch.from_numpy(a).transpose(1, 2).reshape(4, 32, 16)
               for a in _qkv(seed=13))
    o, lse = A.flash_fwd(q, k, v, 0, 0, causal, 0.25)
    g = torch.from_numpy(np.random.RandomState(14).randn(4, 32, 16)
                         .astype(np.float32))
    got = A.flash_bwd(q, k, v, o, lse, g, None, 0, 0, causal, 0.25)
    want = A.flash_bwd(q, k, v, o, lse, g, torch.zeros_like(lse), 0, 0,
                       causal, 0.25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_align_views_for_tma():
    base = torch.zeros(2 * 32 * 16 + 1, dtype=torch.bfloat16)
    view = base[1:].view(2, 32, 16)   # starts 2 bytes into its storage
    assert view.data_ptr() % 16
    dense = A._dense(view)
    assert dense.data_ptr() % 16 == 0 and torch.equal(dense, view)
    aligned = torch.zeros(2, 32, 16, dtype=torch.bfloat16)
    assert A._dense(aligned) is aligned


def test_an_unused_lse_reaches_the_backward_as_none(monkeypatch):
    # BERT uses only o: the backward then takes no zero lse cotangent
    seen = []
    real = A.flash_bwd

    def spy(*args):
        seen.append(args[6])
        return real(*args)

    monkeypatch.setattr(A, "flash_bwd", spy)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(seed=11))
    A.flash_attention(q, k, v, causal=True).sum().backward()
    assert seen == [None]
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    o, lse = A.flash_attention(q, k, v, causal=True, return_lse=True)
    (o.sum() + 0 * lse.sum()).backward()
    assert seen[1] is not None
    for got, want in zip((q.grad, k.grad, v.grad), grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)

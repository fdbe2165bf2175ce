"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips itself where there is
no GPU. This file imports no JAX, so it also runs on a machine without
it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Packed bytes, unpacked floats and decode_sum are bit-exact; the |x| sum
agrees to rtol 1e-6 (per-block partials, then a fixed-order sum of the
partials, against PyTorch's own reduction order). Int8 codes, scales and
dequantize-sums, top-k counts, index arrays and values are bit-exact,
and the same from run to run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.ops import attention as A
from pytorch_ps_mpi_tpu_torch.ops import quant as Q
from pytorch_ps_mpi_tpu_torch.ops import sign as S
from pytorch_ps_mpi_tpu_torch.ops import tern as TG
from pytorch_ps_mpi_tpu_torch.ops import topk as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _grad(n: int, planted: bool, device) -> torch.Tensor:
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    if planted:
        x[0], x[1], x[128] = -0.0, np.nan, 0.0
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("n", [1024, 13 * 1024, 36864, 2359296])
def test_kernels_match_plain_versions(cuda, n, planted):
    x = _grad(n, planted, cuda)
    before = S.encode_signs.launches
    packed, total = S.encode_signs(x)
    assert S.encode_signs.launches == before + 1
    ref_packed, ref_total = S.encode_signs_ref(x)
    assert torch.equal(packed, ref_packed)
    if planted:
        assert torch.isnan(total)
    else:
        torch.testing.assert_close(total, ref_total, rtol=1e-6, atol=0)
    assert torch.equal(S.pack_signs(x), ref_packed)
    assert torch.equal(S.unpack_signs(packed), S.unpack_signs_ref(packed))


def test_encode_sum_is_the_same_from_run_to_run(cuda):
    x = _grad(2359296, False, cuda)
    totals = {float(S.encode_signs(x)[1]) for _ in range(5)}
    assert len(totals) == 1


@pytest.mark.parametrize("n", [1000, 9216, 36864])
def test_decode_sum_kernel_path_matches_plain_fold(cuda, n):
    code = get_codec("sign")
    gen = torch.Generator(device="cuda").manual_seed(n)
    payloads = [code.encode(torch.randn(n, generator=gen, device=cuda))[0]
                for _ in range(8)]
    stacked = {k: torch.stack([p[k] for p in payloads])
               for k in ("packed", "scale")}
    got = code.decode_sum(stacked, (n,), torch.float32)
    cpu = {k: v.cpu() for k, v in stacked.items()}
    want = code.decode_sum(cpu, (n,), torch.float32)
    assert torch.equal(got.cpu(), want)


def _ef_topk():
    return get_codec("ef", inner=get_codec("topk", fraction=0.01,
                                           pallas=True))


@pytest.mark.parametrize("code", ["sign", "int8", "ef_topk"])
def test_step_on_the_card_matches_the_cpu(cuda, code):
    # sign: the |x| sums differ in order (rtol 1e-6); int8 and ef_topk
    # run the same arithmetic on both devices
    gen = torch.Generator().manual_seed(0)
    shapes = {"conv": (64, 64, 3, 3), "bias": (64,), "fc": (10, 512)}
    cpu = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    gpu = {k: v.to(cuda) for k, v in cpu.items()}
    make = _ef_topk if code == "ef_topk" else (lambda: get_codec(code))
    opts = [SGD(p, lr=0.01, momentum=0.9, code=make(), device=d)
            for p, d in ((cpu, "cpu"), (gpu, "cuda"))]
    for _ in range(3):
        grads = {k: torch.randn((1,) + s, generator=gen)
                 for k, s in shapes.items()}
        opts[0].step(grads=grads)
        opts[1].step(grads={k: g.to(cuda) for k, g in grads.items()})
    for k in shapes:
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=1e-6,
                                   atol=1e-7)


# -- int8 quantize / dequantize-sum ------------------------------------------

def _int8_input(n: int, case: str, device) -> torch.Tensor:
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    if case == "ties":  # scale 1.0: exact .5 ties
        x[0] = 127.0
        x[1:7] = [0.5, 1.5, 2.5, -0.5, -1.5, -126.5]
    elif case == "nan":
        x[[0, n // 2]] = [-0.0, np.nan]
    elif case == "inf":
        x[[0, n - 1]] = [np.inf, -np.inf]
    elif case == "zeros":
        x[:] = 0.0
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("n,case", [(1, "plain"), (7, "plain")] + [
    (n, case) for n in (1000, 1024, 4099, 2359296)
    for case in ("plain", "ties", "nan", "inf", "zeros")])
def test_quantize_matches_plain_version(cuda, n, case):
    x = _int8_input(n, case, cuda)
    before = Q.quantize_int8.launches
    q, s = Q.quantize_int8(x)
    assert Q.quantize_int8.launches == before + 1
    rq, rs = Q.quantize_int8_ref(x)
    assert torch.equal(q, rq)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))


def test_quantize_takes_unaligned_views(cuda):
    x = _int8_input(4099, "plain", cuda)[1:]
    q, s = Q.quantize_int8(x)
    rq, rs = Q.quantize_int8_ref(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("n", [7, 1024, 4099, 2359296])
def test_dequant_sum_matches_the_rank_ordered_fold(cuda, n, world):
    gen = torch.Generator(device="cuda").manual_seed(n + world)
    q = torch.randint(-127, 128, (world, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    s = torch.rand(world, generator=gen, device=cuda)
    got = Q.dequant_sum(q, s)
    assert torch.equal(got, Q.dequant_sum_ref(q, s))
    if world == 1:
        assert torch.equal(Q.dequantize_int8(q[0], s[0]),
                           q[0].float() * s[0])


def test_quant_kernels_are_the_same_from_run_to_run(cuda):
    x = _int8_input(2359296, "plain", cuda)
    outs = {tuple(Q.quantize_int8(x)[0][:4096].tolist()) for _ in range(3)}
    assert len(outs) == 1
    q = torch.randint(-127, 128, (8, 2359296), device=cuda,
                      dtype=torch.int8)
    s = torch.rand(8, device=cuda)
    first = Q.dequant_sum(q, s)
    assert all(torch.equal(Q.dequant_sum(q, s), first) for _ in range(3))


# -- top-k threshold count ----------------------------------------------------

@pytest.mark.parametrize("n,k", [(8192, 82), (9216, 92), (100_003, 1000),
                                 (2359296, 23593), (40_000, 1)])
def test_count_passes_and_topk_match_plain_versions(cuda, n, k):
    x = torch.from_numpy(np.random.RandomState(n).randn(n).astype(
        np.float32)).to(cuda)
    before = T.count_pass.launches
    t, counts = T.kth_threshold(x, k)
    assert T.count_pass.launches == before + T.PASSES
    rt, rcounts = T.kth_threshold(x, k, T.count_pass_ref)
    assert torch.equal(counts, rcounts) and torch.equal(t, rt)
    v, i = T.exact_topk(x, k)
    rv, ri = T.exact_topk_ref(x, k)
    assert torch.equal(i, ri) and torch.equal(v, rv)
    # the same value multiset as torch.topk
    ref = torch.topk(x.abs(), k).values.sort().values
    assert torch.equal(v.abs().sort().values, ref)


def test_topk_heavy_ties_nan_and_signed_zero_match_plain_version(cuda):
    x = np.full(300_000, 0.5, np.float32)
    x[::7] = 2.0
    x[3::11] = -0.5
    x[[5, 6, 8]] = [np.nan, -np.inf, -0.0]
    x = torch.from_numpy(x).to(cuda)
    for k in (50_000, 60_000):
        v, i = T.exact_topk(x, k)
        rv, ri = T.exact_topk_ref(x, k)
        assert torch.equal(i, ri)
        assert torch.equal(v.view(torch.int32), rv.view(torch.int32))


def test_topk_is_the_same_from_run_to_run(cuda):
    x = torch.randn(2359296, device=cuda)
    first = T.exact_topk(x, 23593)[1]
    assert all(torch.equal(T.exact_topk(x, 23593)[1], first)
               for _ in range(3))


def test_topk_decode_sum_matches_the_cpu(cuda):
    code = get_codec("topk", fraction=0.05, pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(8, 36864, generator=gen, device=cuda)
    g[:, :64] = 10.0  # indices every rank sends
    payloads = [code.encode(row)[0] for row in g]
    stacked = {k: torch.stack([p[k] for p in payloads])
               for k in ("values", "indices")}
    got = code.decode_sum(stacked, (36864,), torch.float32)
    want = code.decode_sum({k: v.cpu() for k, v in stacked.items()},
                           (36864,), torch.float32)
    assert torch.equal(got.cpu(), want)


def test_error_feedback_memory_lives_on_the_card(cuda):
    params = {"w": torch.randn(64, 256, device=cuda)}
    opt = SGD(params, lr=0.01, code=_ef_topk(), device="cuda")
    assert opt.codec_state["w"]["memory"].device.type == "cuda"
    opt.step(grads={"w": torch.randn(1, 64, 256, device=cuda)})
    mem = opt.codec_state["w"]["memory"]
    assert mem.device.type == "cuda" and mem.any()
    sd = opt.state_dict()
    sd = {**sd, "codec_state": {"w": {"memory": mem.cpu(), "inner": ()}}}
    opt.load_state_dict(sd)
    assert opt.codec_state["w"]["memory"].device.type == "cuda"
    assert torch.equal(opt.codec_state["w"]["memory"], mem)


# -- TernGrad pack / unpack-sum -----------------------------------------------

def _tern_input(n: int, planted: bool, device):
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n, generator=gen, device=device)
    bits = torch.randint(-2**31, 2**31, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    scale = x.abs().amax()
    if planted:
        scale = torch.tensor(4.0, device=device)
        x[:8] = torch.tensor([-0.0, float("nan"), float("inf"),
                              -float("inf"), -4.0, 0.5, 0.5, 1.0])
        bits[4:8] = torch.tensor([-1, (2097152 << 8) | 0xFF,
                                  ((2097152 - 1) << 8) | 0xFF, -2**31],
                                 dtype=torch.int32)
    return x, bits, scale


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("n", [512, 1536, 1 << 20, 372_224, 2_359_296])
def test_tern_pack_matches_plain_version(cuda, n, planted):
    x, bits, scale = _tern_input(n, planted, cuda)
    before = TG.tern_pack.launches
    packed = TG.tern_pack(x, bits, scale)
    assert TG.tern_pack.launches == before + 1
    assert torch.equal(packed, TG.tern_pack_ref(x, bits, scale))
    if planted:
        assert TG.tern_digits(packed[:128])[:8].tolist() == \
            [0, 0, 1, -1, -1, 0, 1, 0]


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("m", [128, 384, 589_824])
def test_tern_unpack_sum_matches_plain_fold(cuda, m, world):
    gen = torch.Generator(device="cuda").manual_seed(m + world)
    packed = torch.randint(0, 256, (world, m), generator=gen, device=cuda,
                           dtype=torch.uint8)
    scales = torch.rand(world, generator=gen, device=cuda)
    got = TG.tern_unpack_sum(packed, scales)
    want = TG.tern_unpack_sum_ref(packed, scales)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if world == 1:
        assert torch.equal(TG.tern_unpack(packed[0], scales[0]), got)


def test_terngrad_step_on_the_card_matches_the_cpu(cuda):
    # the same random numbers on both sides: drawn on the CPU per leaf
    from pytorch_ps_mpi_tpu_torch import Adam

    def codec():
        code = get_codec("terngrad", use_pallas=True, scan_block=4096)
        gen = torch.Generator().manual_seed(0)

        def encode(grad, state=(), rng=None):
            sub = code._pallas_ok(grad.numel())

            def noise(chunk, size):
                r = (torch.randint(-2**31, 2**31, (size,), generator=gen,
                                   dtype=torch.int32) if sub
                     else torch.rand(size, generator=gen))
                return r.to(grad.device)
            return code.ternarize(grad, noise), state

        code.encode = encode
        return code

    gen = torch.Generator().manual_seed(1)
    shapes = {"emb": (50, 512), "w": (64, 96), "b": (96,), "odd": (1000,)}
    cpu = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    gpu = {k: v.to(cuda) for k, v in cpu.items()}
    opts = [Adam(p, lr=1e-3, code=codec(), device=d)
            for p, d in ((cpu, "cpu"), (gpu, "cuda"))]
    for _ in range(2):
        grads = {k: torch.randn((1,) + s, generator=gen)
                 for k, s in shapes.items()}
        opts[0].step(grads=grads)
        opts[1].step(grads={k: g.to(cuda) for k, g in grads.items()})
    for k in shapes:
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=1e-6, atol=1e-7)


# -- flash attention ------------------------------------------------------------

def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs().max()
        assert float(err) <= 2 ** -6 * float(want.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,offsets", [
    ((4, 512, 12, 64), False, (0, 0)),
    ((4, 512, 12, 64), True, (0, 0)),
    ((2, 128, 4, 32), True, (0, 40)),      # rows 0..39 see no key
    ((2, 64, 2, 16), True, (64, 0)),
    ((1, 96, 2, 128), False, (0, 0)),      # a ragged last tile
    ((2, 64, 2, 8), True, (0, 200)),       # every row masked
])
def test_flash_matches_plain_version(cuda, dtype, shape, causal, offsets):
    b, l, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(l + d)
    q3, k3, v3, g3 = (torch.randn(b * h, l, d, generator=gen, device=cuda)
                      .to(dtype) for _ in range(4))
    g_lse = torch.randn(b * h, l, generator=gen, device=cuda)
    qo, ko = offsets
    scale = d ** -0.5
    before = (A.flash_fwd.launches, A.flash_bwd.launches)
    o, lse = A.flash_fwd(q3, k3, v3, qo, ko, causal, scale)
    ro, rlse = A.flash_fwd_ref(q3, k3, v3, qo, ko, causal, scale)
    _close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    grads = A.flash_bwd(q3, k3, v3, o, lse, g3, g_lse, qo, ko, causal, scale)
    want = A.flash_bwd_ref(q3, k3, v3, o, lse, g3, g_lse, qo, ko, causal,
                           scale)
    assert (A.flash_fwd.launches, A.flash_bwd.launches) == \
        (before[0] + 1, before[1] + 2)
    for got, ref in zip(grads, want):
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            _close(got, ref, dtype)
    if offsets == (0, 200):
        assert not o.float().abs().any()


def test_flash_attention_autograd_on_the_card_matches_the_cpu(cuda):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(2, 64, 4, 32).astype(np.float32) for _ in range(3)]

    def run(device):
        ts = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays]
        o, lse = A.flash_attention(*ts, causal=True, q_offset=8,
                                   return_lse=True)
        loss = (o ** 2).sum() + torch.sin(lse).sum()
        return [loss] + list(torch.autograd.grad(loss, ts))

    for got, want in zip(run(cuda), run("cpu")):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

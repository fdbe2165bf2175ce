"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips itself where there is
no GPU. This file imports no JAX, so it also runs on a machine without
it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Packed bytes, unpacked floats, the unpack-sum at world 1 and 8 (zero,
subnormal, infinite and NaN scales, sums below the smallest normal
float; NaN compared by position) and decode_sum are bit-exact; the |x|
sum agrees to rtol 1e-6 (per-block partials, then a fixed-order sum of
the partials inside the same launch, against PyTorch's own reduction
order) and is the same from run to run. Quantize, sign encode and
unpack-sum are one device row a call in the profiler, at the kernels'
tile, one past it and past the co-resident grid. Int8 codes, scales and
dequantize-sums, top-k counts, index arrays and values are bit-exact,
and the same from run to run. Flash attention: float32 to rtol 1e-5
forward and 1e-4 backward, bf16 (the tensor-core kernels, every head
dim) to 2**-6 of each output's largest magnitude; a ragged tile reads
nothing of the next head, and o, lse, dq, dk, dv are the same from run
to run, bit for bit. The int8 and sign codecs on ResNet-18's buckets at
``bucket_mb=16`` (payloads, decode-sums and two bucketed steps of either
mode) against their plain versions on the CPU. TernGrad: the one-launch
encode and the scale-only launch from float32 and bf16 (one block, one
row past the tile, past the co-resident grid; NaN, ±Inf and
max|x| < 1e-12 planted), the codec's chunked route against the whole-leaf
plain encode, views off alignment and the unpack-sum at worlds 1, 4 and
8, bytes and scales bit for bit; the pack and unpack-sum also at
BERT-base's bucket sizes, and a bucketed TernGrad step on the card
against the CPU. Ring and Ulysses attention, and the
GPT over them, raise on a shard the flash kernels cannot tile.
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


@pytest.fixture(scope="module", autouse=True)
def _built():
    # every library first, as chip_smoke.py builds them: in runs that
    # compiled libraries between profiled tests, a later trace lost
    # kernel records (1 of 3 flash kernels seen)
    if torch.cuda.is_available():
        from pytorch_ps_mpi_tpu_torch.ops import _build

        _build.build(*_build.SOURCES)


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


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("n", [1000, 9216, 36864])
def test_decode_sum_kernel_path_matches_plain_fold(cuda, n, world):
    code = get_codec("sign")
    gen = torch.Generator(device="cuda").manual_seed(n)
    payloads = [code.encode(torch.randn(n, generator=gen, device=cuda))[0]
                for _ in range(world)]
    stacked = {k: torch.stack([p[k] for p in payloads])
               for k in ("packed", "scale")}
    before = S.unpack_signs_sum.launches
    got = code.decode_sum(stacked, (n,), torch.float32)
    # one launch a kernel-layout leaf at any world; none for n = 1000
    assert S.unpack_signs_sum.launches == before + (n % S.GROUP == 0)
    cpu = {k: v.cpu() for k, v in stacked.items()}
    want = code.decode_sum(cpu, (n,), torch.float32)
    assert torch.equal(got.cpu(), want)


# -- the sign unpack-sum ---------------------------------------------------------

def _unpack_sum_input(m: int, world: int, case: str, device):
    """Packed bits [world, m] and float32 scales [world]. ``planted``:
    rank 0's scale 0.0 (every -0 folds to +0), and at world 8 a subnormal
    and six scales within [1, 2) x the smallest normal float, whose sums
    fall below it (flushed); ``nonfinite``: +Inf, and at world 8 NaN in
    another rank; ``unaligned``: a view one byte into its buffer."""
    gen = torch.Generator(device="cuda").manual_seed(m + world)
    offset = 1 if case == "unaligned" else 0
    buf = torch.randint(0, 256, (world * m + offset,), generator=gen,
                        device=device, dtype=torch.uint8)
    packed = buf[offset:].view(world, m)
    scales = torch.rand(world, generator=gen, device=device) + 0.1
    tiny = torch.finfo(torch.float32).tiny
    planted = {"planted": [0.0, 3e-39] + [tiny * (1 + w / 16)
                                          for w in range(1, 7)],
               "nonfinite": [float("inf"), 0.5, 0.25, 2.0, 1.0,
                             float("nan"), 0.5, 0.125]}
    if case in planted:
        scales = torch.tensor(planted[case][:world], device=device)
    return packed, scales


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


@pytest.mark.parametrize("case", ["plain", "planted", "nonfinite",
                                  "unaligned"])
@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("m", [128, 384, 294_912])
def test_unpack_signs_sum_matches_plain_version(cuda, m, world, case):
    packed, scales = _unpack_sum_input(m, world, case, cuda)
    if case == "unaligned":
        assert packed.data_ptr() % 4
    before = S.unpack_signs_sum.launches
    got = S.unpack_signs_sum(packed, scales)
    assert S.unpack_signs_sum.launches == before + 1
    assert got.shape == (8 * m,) and got.dtype == torch.float32
    assert _same_bits(got, S.unpack_signs_sum_ref(packed, scales))
    if case == "planted" and world == 1:  # scale 0.0: no -0 survives
        assert not torch.signbit(got).any()
    if world == 1:
        assert torch.equal(S.unpack_signs(packed[0]),
                           S.unpack_signs_ref(packed[0]))


def test_unpack_signs_sum_is_the_same_from_run_to_run(cuda):
    packed, scales = _unpack_sum_input(294_912, 8, "plain", cuda)
    first = S.unpack_signs_sum(packed, scales)
    for _ in range(3):
        got = S.unpack_signs_sum(packed, scales)
        assert torch.equal(got.view(torch.int32), first.view(torch.int32))


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


@pytest.mark.parametrize("mode", ["allgather", "leader"])
@pytest.mark.parametrize("code", ["sign", "int8"])
def test_codecs_on_resnet18_buckets_match_plain_versions(cuda, code, mode):
    # ResNet-18's leaves in the JAX leaf order at bucket_mb=16: 4 buckets,
    # 2 of them in the sign kernels' layout. Each bucket's payload and
    # one-rank decode-sum on the card against the plain versions on the
    # CPU (sign's |x| sum to rtol 1e-6, all else bit-exact), then two
    # bucketed steps of either mode (int8 bit-exact, sign rtol 1e-6)
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.utils.interop import jax_leaf_order

    model = ResNet18(num_classes=10, small_inputs=True, seed=0, device="cpu")
    named = dict(model.named_parameters())
    cpu = {n: named[n].detach().clone() for n in jax_leaf_order(model)}
    gpu = {n: p.to(cuda) for n, p in cpu.items()}
    opts = [SGD(p, lr=0.01, momentum=0.9, code=get_codec(code),
                bucket_mb=16, mode=mode, device=d)
            for p, d in ((cpu, "cpu"), (gpu, "cuda"))]
    plan = opts[1]._bucket_plan
    assert [b.size for b in plan.buckets] == [3961802, 2493440, 2359296,
                                              2359424]
    codec = get_codec(code)
    gen = torch.Generator().manual_seed(0)
    for b in plan.buckets:
        x = 1e-2 * torch.randn(b.size, generator=gen)
        want, _ = codec.encode(x)
        got, _ = codec.encode(x.to(cuda))
        for key in want:
            if code == "sign" and key == "scale":
                torch.testing.assert_close(got[key].cpu(), want[key],
                                           rtol=1e-6, atol=0)
            else:
                assert torch.equal(got[key].cpu(), want[key]), key
        stacked = {k: v[None] for k, v in got.items()}
        summed = codec.decode_sum(stacked, (b.size,), torch.float32)
        plain = codec.decode_sum({k: v.cpu() for k, v in stacked.items()},
                                 (b.size,), torch.float32)
        assert torch.equal(summed.cpu(), plain)
    counter = S.encode_signs if code == "sign" else Q.quantize_int8
    before = counter.launches
    for _ in range(2):
        grads = {k: 1e-2 * torch.randn((1,) + tuple(p.shape), generator=gen)
                 for k, p in cpu.items()}
        opts[0].step(grads=grads)
        opts[1].step(grads={k: g.to(cuda) for k, g in grads.items()})
    assert counter.launches - before == 2 * (2 if code == "sign" else 4)
    for k in cpu:
        if code == "int8":
            assert torch.equal(gpu[k].cpu(), cpu[k]), k
        else:
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


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("n", [7, 1024, 1028, 4099, 2359296])
def test_dequant_sum_matches_the_rank_ordered_fold(cuda, n, world, offset):
    # n % 16 == 0 and n % 16 == 4 take the 4-code loads; odd n and a view
    # that starts one byte in take the scalar path
    gen = torch.Generator(device="cuda").manual_seed(n + world)
    buf = torch.randint(-127, 128, (world * n + offset,), generator=gen,
                        device=cuda, dtype=torch.int8)
    q = buf[offset:].view(world, n)
    s = torch.rand(world, generator=gen, device=cuda)
    if world == 8:
        s[3] = float("nan")  # a NaN scale poisons its sum
    before = Q.dequant_sum.launches
    got = Q.dequant_sum(q, s)
    assert Q.dequant_sum.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       Q.dequant_sum_ref(q, s).view(torch.int32))
    if world == 1:
        got = Q.dequantize_int8(q[0], s[0])
        assert Q.dequant_sum.launches == before + 2
        assert torch.equal(got, q[0].float() * s[0])


def test_raw_stream_is_the_current_stream(cuda):
    from pytorch_ps_mpi_tpu_torch.ops import _build

    assert _build.raw_stream(0) == torch.cuda.current_stream(0).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.raw_stream(0) == side.cuda_stream
        q = torch.randint(-127, 128, (4096,), device=cuda, dtype=torch.int8)
        s = torch.tensor(0.5, device=cuda)
        out = Q.dequantize_int8(q, s)
    side.synchronize()
    assert torch.equal(out, q.float() * 0.5)


def test_quant_kernels_are_the_same_from_run_to_run(cuda):
    x = _int8_input(2359296, "plain", cuda)
    outs = {tuple(Q.quantize_int8(x)[0][:4096].tolist()) for _ in range(3)}
    assert len(outs) == 1
    q = torch.randint(-127, 128, (8, 2359296), device=cuda,
                      dtype=torch.int8)
    s = torch.rand(8, device=cuda)
    first = Q.dequant_sum(q, s)
    assert all(torch.equal(Q.dequant_sum(q, s), first) for _ in range(3))


# -- the one-launch quantize and sign encode ----------------------------------
# Each call is one device launch: one block up to the kernel's tile, a
# cooperative grid with one grid barrier above it, and past the grid's
# co-resident tiles a second read of the tiles a block could not stage.

def _device_rows(fn, launches: int = 1) -> list:
    """The device rows (kernels and memsets) of one call of ``fn``, by
    name, after a warm-up call. A trace now and then comes back without
    some of the call's kernels (on an H100: a single cooperative launch's
    trace empty, a flash trace with 1 of its 3 kernels), so a trace with
    fewer rows than the ``launches`` the call makes is taken again, at
    most twice; the caller asserts on the last one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e.key for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                for _ in range(e.count)]
        if len(rows) >= launches:
            break
    return rows


def _quant_size(size: str) -> int:
    tile = Q._tile()
    cap = Q._lib().quant_int8_grid(1 << 40)  # the co-resident blocks
    return {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "multi-block": 100_003, "past-grid": cap * tile + 4099}[size]


QUANT_SIZES = ["tile-1", "tile", "tile+1", "multi-block", "past-grid"]


@pytest.mark.parametrize("case", ["plain", "ties", "nan", "inf", "zeros"])
@pytest.mark.parametrize("size", QUANT_SIZES)
def test_one_launch_quantize_matches_plain_version(cuda, size, case):
    n = _quant_size(size)
    grid = Q._lib().quant_int8_grid(n)
    assert (grid == 1) == (n <= Q._tile()) and grid > 0
    x = _int8_input(n, case, cuda)
    before = Q.quantize_int8.launches
    q, s = Q.quantize_int8(x)
    assert Q.quantize_int8.launches == before + 1
    rq, rs = Q.quantize_int8_ref(x)
    assert q.shape == (n,) and s.shape == ()
    assert torch.equal(q, rq)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))


@pytest.mark.parametrize("size", QUANT_SIZES)
def test_quantize_takes_unaligned_views_on_every_path(cuda, size):
    n = _quant_size(size)
    x = _int8_input(n + 1, "ties", cuda)[1:]
    assert x.data_ptr() % 16
    q, s = Q.quantize_int8(x)
    rq, rs = Q.quantize_int8_ref(x)
    assert torch.equal(q, rq)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))


def _sign_rows(size: str) -> int:
    lib = S._lib()
    one = next(r for r in range(1, 1 << 16)
               if lib.sign_encode_grid(r + 1, 1) != 1)
    cap = lib.sign_encode_grid(1 << 40, 1) * S._rows_per_block()
    return {"tile-1": one - 1, "tile": one, "tile+1": one + 1,
            "multi-block": 2304, "past-grid": cap + 3}[size]


SIGN_SIZES = ["tile-1", "tile", "tile+1", "multi-block", "past-grid"]


@pytest.mark.parametrize("case", ["plain", "planted", "unaligned"])
@pytest.mark.parametrize("size", SIGN_SIZES)
def test_one_launch_encode_matches_plain_version(cuda, size, case):
    rows = _sign_rows(size)
    assert rows >= 1
    n = rows * S.GROUP
    if case == "unaligned":
        x = _grad(n + 1, False, cuda)[1:]
        assert x.data_ptr() % 16
    else:
        x = _grad(n, False, cuda)
    if case == "planted":  # ±0.0, NaN, ±Inf
        x[0], x[1], x[128], x[129], x[n - 1] = (
            -0.0, float("nan"), 0.0, float("inf"), -float("inf"))
    before = S.encode_signs.launches
    packed, total = S.encode_signs(x)
    assert S.encode_signs.launches == before + 1
    ref_packed, ref_total = S.encode_signs_ref(x)
    assert packed.shape == (n // 8,) and total.shape == ()
    assert torch.equal(packed, ref_packed)
    assert torch.equal(S.pack_signs(x), ref_packed)
    if case == "planted":
        assert torch.isnan(total)
        assert int(packed[0]) & 0b11 == 0b11   # -0.0 and +0.0 pack as +
        assert int(packed[1]) & 0b11 == 0b10   # NaN as 0, +Inf as +
    else:
        torch.testing.assert_close(total, ref_total, rtol=1e-6, atol=0)


@pytest.mark.parametrize("size", ["tile+1", "past-grid"])
def test_one_launch_outputs_are_the_same_from_run_to_run(cuda, size):
    x = _int8_input(_quant_size(size), "plain", cuda)
    q0, s0 = Q.quantize_int8(x)
    for _ in range(3):
        q, s = Q.quantize_int8(x)
        assert torch.equal(q, q0)
        assert torch.equal(s.view(torch.int32), s0.view(torch.int32))
    x = _grad(_sign_rows(size) * S.GROUP, False, cuda)
    p0, t0 = S.encode_signs(x)
    for _ in range(3):
        p, t = S.encode_signs(x)
        assert torch.equal(p, p0)
        assert torch.equal(t.view(torch.int32), t0.view(torch.int32))


@pytest.mark.parametrize("size", ["tile", "tile+1", "past-grid"])
@pytest.mark.parametrize("which", ["quantize_int8", "encode_signs",
                                   "pack_signs", "unpack_signs",
                                   "unpack_signs_sum"])
def test_each_call_is_one_device_row(cuda, which, size):
    if which == "quantize_int8":
        args = (_int8_input(_quant_size(size), "plain", cuda),)
    else:
        args = (_grad(_sign_rows(size) * S.GROUP, False, cuda),)
        if which == "unpack_signs":
            args = (S.pack_signs(args[0]),)
        elif which == "unpack_signs_sum":  # world 8
            packed = S.pack_signs(args[0])
            args = (torch.stack([packed] * 8), torch.rand(8, device=cuda))
    rows = _device_rows(lambda: getattr(Q if which == "quantize_int8"
                                        else S, which)(*args))
    assert len(rows) == 1, rows
    assert "emset" not in rows[0] and "emcpy" not in rows[0], rows


def test_codec_wrappers_launch_on_the_current_stream(cuda):
    side = torch.cuda.Stream()
    x = _grad(2304 * S.GROUP, False, cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        packed, total = S.encode_signs(x)
        signs = S.unpack_signs(packed)
        summed = S.unpack_signs_sum(packed.view(1, -1), total.view(1))
        q, s = Q.quantize_int8(x)
    side.synchronize()
    ref_packed, ref_total = S.encode_signs_ref(x)
    assert torch.equal(packed, ref_packed)
    torch.testing.assert_close(total, ref_total, rtol=1e-6, atol=0)
    assert torch.equal(signs, S.unpack_signs_ref(ref_packed))
    assert torch.equal(summed, S.unpack_signs_sum_ref(packed.view(1, -1),
                                                      total.view(1)))
    assert torch.equal(q, Q.quantize_int8_ref(x)[0])


# -- top-k radix select and compaction -----------------------------------------

def _check_topk(x: torch.Tensor, k: int) -> None:
    """The radix histograms and t, then the top-k, bit-exact against the
    plain versions, with the launches each call counts."""
    before = (T.radix_threshold.launches, T.exact_topk.launches)
    t, hist = T.radix_threshold(x, k)
    rt, rhist = T.radix_threshold_ref(x, k)
    assert torch.equal(hist, rhist) and torch.equal(t, rt)
    assert int(t) == int(T.kth_threshold(x, k)[0])
    v, i = T.exact_topk(x, k)
    assert (T.radix_threshold.launches, T.exact_topk.launches) == (
        before[0] + T.THRESHOLD_LAUNCHES, before[1] + T.LAUNCHES)
    rv, ri = T.exact_topk_ref(x, k)
    assert torch.equal(i, ri)
    assert torch.equal(v.view(torch.int32), rv.view(torch.int32))


@pytest.mark.parametrize("n,k", [(8192, 82), (9216, 92), (100_003, 1000),
                                 (2359296, 23593), (40_000, 1),
                                 (40_000, 39_999)])
def test_count_passes_and_topk_match_plain_versions(cuda, n, k):
    x = torch.from_numpy(np.random.RandomState(n).randn(n).astype(
        np.float32)).to(cuda)
    _check_topk(x, k)
    # the same value multiset as torch.topk
    v, _ = T.exact_topk(x, k)
    ref = torch.topk(x.abs(), k).values.sort().values
    assert torch.equal(v.abs().sort().values, ref)


@pytest.mark.parametrize("case", ["all_ties", "all_zeros", "more_nans_than_k",
                                  "odd_n_misaligned", "float64"])
def test_topk_planted_cases_match_plain_versions(cuda, case):
    x = torch.from_numpy(np.random.RandomState(3).randn(100_001).astype(
        np.float32)).to(cuda)
    k = 1000
    if case == "all_ties":
        x.fill_(-1.5)
    elif case == "all_zeros":
        x.zero_()
    elif case == "more_nans_than_k":
        nans = torch.tensor([0x7FC00000, 0x7F800001, -0x400000, 0x7FFFFFFF],
                            dtype=torch.int32, device=cuda).view(torch.float32)
        x[::40] = nans.repeat(len(x[::40]) // 4 + 1)[:len(x[::40])]
    elif case == "float64":
        xd = x.double()
        v, i = T.exact_topk(xd, k)
        rv, ri = T.exact_topk_ref(xd, k)
        assert torch.equal(i, ri) and torch.equal(v, rv)
        assert v.dtype == torch.float64
        return
    elif case == "odd_n_misaligned":
        x = x[1:-1]  # 99,999 elements that start 4 bytes in: scalar loads
    _check_topk(x, k)


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
    hist = T.radix_threshold(x, 23593)[1].clone()
    assert all(torch.equal(T.exact_topk(x, 23593)[1], first)
               for _ in range(3))
    assert all(torch.equal(T.radix_threshold(x, 23593)[1], hist)
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


# 2,955,264: the whole BERT-base buckets of 12 at bucket_mb=16
@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("n", [512, 1536, 1 << 20, 372_224, 2_359_296,
                               2_955_264])
def test_tern_pack_matches_plain_version(cuda, n, planted):
    x, bits, scale = _tern_input(n, planted, cuda)
    before = TG.tern_pack.launches
    packed = TG.tern_pack(x, bits, scale)
    assert TG.tern_pack.launches == before + 1
    assert torch.equal(packed, TG.tern_pack_ref(x, bits, scale))
    if planted:
        assert TG.tern_digits(packed[:128])[:8].tolist() == \
            [0, 0, 1, -1, -1, 0, 1, 0]


# one block (3,072: BERT-base's FFN bias), the tile, one row past it (the
# cooperative grid), BERT-base's whole leaves and a chunked leaf whole
# (23,440,896: tiles past the co-resident grid, read twice)
TERN_ENCODE_SIZES = [3072, 4096, 4608, 589_824, 2_359_296, 23_440_896]


def _tern_encode_input(n: int, dtype, case: str, device):
    """x (``dtype``), bits for the encode: ``planted`` holds |x| == s = 4,
    u24 == p24 (drops), u24 == p24 − 1 (keeps), the top random bit and
    -0.0; ``nan`` a NaN element, ``inf`` ±Inf, ``tiny`` max|x| < 1e-12
    (the scale clamps)."""
    gen = torch.Generator(device="cuda").manual_seed(n + len(case))
    x = 0.5 * torch.randn(n, generator=gen, device=device)
    bits = torch.randint(-2**31, 2**31, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    if case == "planted":
        x[:8] = torch.tensor([-0.0, 0.25, 3.0, -3.0, -4.0, 0.5, 0.5, 1.0])
        bits[4:8] = torch.tensor([-1, (2097152 << 8) | 0xFF,
                                  ((2097152 - 1) << 8) | 0xFF, -2**31],
                                 dtype=torch.int32)
    elif case == "nan":
        x[n // 3] = float("nan")
    elif case == "inf":
        x[1], x[n - 1] = float("inf"), -float("inf")
    elif case == "tiny":
        x = x * 1e-30
    return x.to(dtype), bits


def _scale_bits(scale: torch.Tensor) -> int:
    return int(scale.reshape(1).view(torch.int32))


def _same_scale(got: torch.Tensor, want: torch.Tensor) -> bool:
    return _scale_bits(got) == _scale_bits(want)


@pytest.mark.parametrize("case", ["plain", "planted", "nan", "inf", "tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", TERN_ENCODE_SIZES)
def test_tern_encode_matches_plain_version(cuda, n, dtype, case):
    x, bits = _tern_encode_input(n, dtype, case, cuda)
    before = TG.tern_encode.launches
    packed, scale = TG.tern_encode(x, bits)
    assert TG.tern_encode.launches == before + 1
    want_packed, want_scale = TG.tern_encode_ref(x, bits)
    assert packed.dtype == torch.uint8 and packed.shape == (n // 4,)
    assert scale.dtype == torch.float32 and scale.shape == ()
    assert torch.equal(packed, want_packed)
    assert _scale_bits(scale) == _scale_bits(want_scale)
    if case == "planted":
        assert float(scale) == 4.0
        assert TG.tern_digits(packed[:128])[4:8].tolist() == [-1, 0, 1, 0]
    elif case in ("nan", "inf"):
        # a NaN or Inf scale: no element keeps, every digit is 1
        assert not torch.isfinite(scale)
        assert bool((packed == 0x55).all())
    elif case == "tiny":
        assert float(scale) == float(torch.tensor(1e-12))


@pytest.mark.parametrize("case", ["plain", "nan", "inf", "tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [512, 4608, 23_440_896])
def test_tern_scale_matches_plain_version(cuda, n, dtype, case):
    x, _ = _tern_encode_input(n, dtype, case, cuda)
    before = TG.tern_scale.launches
    scale = TG.tern_scale(x)
    assert TG.tern_scale.launches == before + 1
    assert _scale_bits(scale) == _scale_bits(TG.tern_scale_ref(x))
    assert _same_scale(scale, TG.tern_encode_ref(x, torch.zeros(
        n, dtype=torch.int32, device=cuda))[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,block", [(23_440_896, 1 << 20), (11264, 2048)])
def test_tern_chunked_route_matches_the_whole_leaf(cuda, n, block, dtype):
    # the codec's chunked route: a scale-only launch, then one given-scale
    # pack a chunk into its slice of the payload; the whole-leaf plain
    # encode's bytes and scale
    code = get_codec("terngrad", use_pallas=True, scan_block=block)
    assert n >= code.scan_threshold
    x, bits = _tern_encode_input(n, dtype, "planted", cuda)
    before = (TG.tern_scale.launches, TG.tern_pack.launches)
    p = code.ternarize(x, lambda i, size: bits[i * block:i * block + size])
    assert (TG.tern_scale.launches, TG.tern_pack.launches) == \
        (before[0] + 1, before[1] + -(-n // block))
    want_packed, want_scale = TG.tern_encode_ref(x, bits)
    assert torch.equal(p["packed"], want_packed)
    assert _same_scale(p["scale"], want_scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tern_kernels_take_unaligned_views(cuda, dtype):
    # views one element into their buffers: scalar loads and byte stores
    n = 4608
    x, bits = _tern_encode_input(n, dtype, "planted", cuda)
    xb = torch.zeros(n + 1, dtype=dtype, device=cuda)
    bb = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    xb[1:].copy_(x)
    bb[1:].copy_(bits)
    want_packed, want_scale = TG.tern_encode_ref(x, bits)
    packed, scale = TG.tern_encode(xb[1:], bb[1:])
    assert torch.equal(packed, want_packed) and _same_scale(scale, want_scale)
    assert _same_scale(TG.tern_scale(xb[1:]), want_scale)
    out = torch.zeros(n // 4 + 1, dtype=torch.uint8, device=cuda)
    TG.tern_pack(xb[1:], bb[1:], want_scale, out=out[1:])
    assert torch.equal(out[1:], want_packed)
    stack = torch.zeros(1 + 2 * (n // 4), dtype=torch.uint8, device=cuda)
    stack[1:].copy_(torch.cat([want_packed, want_packed]))
    scales = torch.stack([want_scale, want_scale])
    got = TG.tern_unpack_sum(stack[1:].reshape(2, -1), scales)
    assert torch.equal(got.view(torch.int32), TG.tern_unpack_sum_ref(
        stack[1:].reshape(2, -1), scales).view(torch.int32))


@pytest.mark.parametrize("bad", ["strided", "float16", "bits_strided",
                                 "scale_f64", "out_size", "unpack_strided"])
def test_tern_wrappers_raise_on_what_the_kernels_do_not_take(cuda, bad):
    x = torch.randn(2 * 1024, device=cuda)
    bits = torch.zeros(1024, dtype=torch.int32, device=cuda)
    scale = torch.tensor(1.0, device=cuda)
    counts = (TG.tern_encode.launches, TG.tern_pack.launches,
              TG.tern_unpack_sum.launches)
    with pytest.raises(ValueError):
        if bad == "strided":
            TG.tern_encode(x[::2], bits)
        elif bad == "float16":
            TG.tern_encode(x[:1024].half(), bits)
        elif bad == "bits_strided":
            TG.tern_pack(x[:1024], torch.zeros(2048, dtype=torch.int32,
                                               device=cuda)[::2], scale)
        elif bad == "scale_f64":
            TG.tern_pack(x[:1024], bits, scale.double())
        elif bad == "out_size":
            TG.tern_pack(x[:1024], bits, scale,
                         out=torch.empty(255, dtype=torch.uint8, device=cuda))
        else:
            TG.tern_unpack_sum(torch.zeros(256, 2, dtype=torch.uint8,
                                           device=cuda).t(),
                               torch.ones(2, device=cuda))
    assert (TG.tern_encode.launches, TG.tern_pack.launches,
            TG.tern_unpack_sum.launches) == counts


# 738,816: a BERT-base bucket's packed row at bucket_mb=16
@pytest.mark.parametrize("world", [1, 4, 8])
@pytest.mark.parametrize("m", [128, 384, 589_824, 738_816])
def test_tern_unpack_sum_matches_plain_fold(cuda, m, world):
    gen = torch.Generator(device="cuda").manual_seed(m + world)
    packed = torch.randint(0, 256, (world, m), generator=gen, device=cuda,
                           dtype=torch.uint8)
    scales = torch.rand(world, generator=gen, device=cuda)
    before = TG.tern_unpack_sum.launches
    got = TG.tern_unpack_sum(packed, scales)
    assert TG.tern_unpack_sum.launches == before + 1
    want = TG.tern_unpack_sum_ref(packed, scales)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if world == 1:
        assert torch.equal(TG.tern_unpack(packed[0], scales[0]), got)


def _shared_noise_terngrad():
    # the same random numbers on both sides: drawn on the CPU per call
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


def _terngrad_steps(cuda, shapes, **opt_kw):
    """Two Adam(terngrad) steps on the card and on the CPU; returns both
    parameter dicts and the card optimizer."""
    from pytorch_ps_mpi_tpu_torch import Adam

    gen = torch.Generator().manual_seed(1)
    cpu = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    gpu = {k: v.to(cuda) for k, v in cpu.items()}
    opts = [Adam(p, lr=1e-3, code=_shared_noise_terngrad(), device=d,
                 **opt_kw)
            for p, d in ((cpu, "cpu"), (gpu, "cuda"))]
    for _ in range(2):
        grads = {k: torch.randn((1,) + s, generator=gen)
                 for k, s in shapes.items()}
        opts[0].step(grads=grads)
        opts[1].step(grads={k: g.to(cuda) for k, g in grads.items()})
    return cpu, gpu, opts[1]


def test_terngrad_step_on_the_card_matches_the_cpu(cuda):
    shapes = {"emb": (50, 512), "w": (64, 96), "b": (96,), "odd": (1000,)}
    cpu, gpu, _ = _terngrad_steps(cuda, shapes)
    for k in shapes:
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=1e-6, atol=1e-7)


def test_bucketed_terngrad_step_on_the_card_matches_the_cpu(cuda):
    # at 0.05 MB: a flat bucket (b, odd), a sublane bucket of one leaf
    # packed in 7 chunks (emb) and a sublane bucket of two leaves (w, v)
    shapes = {"b": (96,), "odd": (1000,), "emb": (50, 512), "w": (64, 96),
              "v": (8, 64)}
    counters = (TG.tern_encode, TG.tern_scale, TG.tern_pack,
                TG.tern_unpack_sum)
    before = [k.launches for k in counters]
    cpu, gpu, opt = _terngrad_steps(cuda, shapes, bucket_mb=0.05)
    assert [b.size for b in opt._bucket_plan.buckets] == [1096, 25600, 6656]
    # a step: 6,656 in one encode; 25,600 a scale and 7 chunk packs
    assert [k.launches - b for k, b in zip(counters, before)] == \
        [2 * 1, 2 * 1, 2 * 7, 2 * 2]
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


def _bf16_set(gen, bh, l, d, device):
    q, k, v, g = (torch.randn(bh, l, d, generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(4))
    return q, k, v, g, torch.randn(bh, l, generator=gen, device=device)


def _fwd_bwd(q, k, v, g, g_lse, qo=0, ko=0, causal=False):
    scale = q.shape[-1] ** -0.5
    o, lse = A.flash_fwd(q, k, v, qo, ko, causal, scale)
    return (o, lse) + A.flash_bwd(q, k, v, o, lse, g, g_lse, qo, ko, causal,
                                  scale)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", A.HEAD_DIMS)
def test_flash_bf16_every_head_dim_matches_plain_version(cuda, d, causal):
    # the tensor-core kernels at every head dim the wrapper takes, with a
    # ragged length (200 = 3 tiles + 8 rows)
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, g, g_lse = _bf16_set(gen, 6, 200, d, cuda)
    got = _fwd_bwd(q, k, v, g, g_lse, causal=causal)
    scale = d ** -0.5
    ro, rlse = A.flash_fwd_ref(q, k, v, 0, 0, causal, scale)
    _close(got[0], ro, torch.bfloat16)
    torch.testing.assert_close(got[1], rlse, rtol=1e-5, atol=1e-5)
    want = A.flash_bwd_ref(q, k, v, got[0], got[1], g, g_lse, 0, 0, causal,
                           scale)
    for a, b in zip(got[2:], want):
        _close(a, b, torch.bfloat16)


def test_flash_bf16_ragged_tile_reads_nothing_of_the_next_head(cuda):
    # rows past l of head 0 are head 1's in memory: with k and v of head 1
    # at 1e4, head 0's outputs must equal those of head 0 alone, bit for bit
    gen = torch.Generator(device="cuda").manual_seed(96)
    q, k, v, g, g_lse = _bf16_set(gen, 2, 96, 128, cuda)
    k[1], v[1] = 1e4, 1e4
    both = _fwd_bwd(q, k, v, g, g_lse)
    alone = _fwd_bwd(*(t[:1].clone() for t in (q, k, v, g, g_lse)))
    for a, b in zip(both, alone):
        assert torch.isfinite(a[:1].float()).all()
        assert torch.equal(a[:1], b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_is_the_same_from_run_to_run(cuda, dtype):
    # no atomics: o, lse, dq, dk and dv are each written by one block
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, g, g_lse = (t.to(dtype) if t.dim() == 3 else t
                         for t in _bf16_set(gen, 48, 512, 64, cuda))
    first = _fwd_bwd(q, k, v, g, g_lse, causal=True)
    for _ in range(3):
        for a, b in zip(_fwd_bwd(q, k, v, g, g_lse, causal=True), first):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,kernels,not_in", [
    (torch.bfloat16, ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc"),
     "_kernel"),
    (torch.float32, ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                     "flash_bwd_dkv_kernel"), "_tc"),
])
def test_flash_dtype_takes_its_kernels(cuda, dtype, kernels, not_in):
    # bf16 runs on the tensor-core kernels (attention_tc.cu), float32 on
    # the CUDA-core ones (attention.cu): the kernel names in a trace
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, g, _ = (t.to(dtype) for t in _bf16_set(gen, 4, 128, 64, cuda))
    names = _device_rows(lambda: _fwd_bwd(q, k, v, g, None), launches=3)
    flash = [n for n in names if "flash" in n]
    assert len(flash) == 3, names
    for kern in kernels:
        assert any(kern in n for n in flash), (kern, flash)
    assert not any(not_in in n for n in flash), flash


def test_card_shards_the_kernels_cannot_tile_raise(cuda):
    """On CUDA tensors the ring and Ulysses paths, and the models over
    them, demand the flash kernels: a shard they cannot tile raises
    instead of taking the dense path."""
    from pytorch_ps_mpi_tpu_torch.models.gpt import GPTLM, gpt_tiny
    from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_attention
    from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 100, 2, 16, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(ValueError, match="cannot tile"):
            fn(q, k, v, "seq", causal=True)
    for attention in ("ring", "ulysses"):
        model = GPTLM(gpt_tiny(attention=attention, dtype=torch.bfloat16),
                      device="cuda")
        with pytest.raises(ValueError, match="cannot tile"):
            model(torch.zeros(1, 100, dtype=torch.long, device="cuda"))

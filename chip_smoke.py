"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; the script exits non-zero if any fails:

1. device    -- requires a CUDA device; prints the card's name and power
               limit as nvidia-smi reports them.
2. build     -- compiles ``pytorch_ps_mpi_tpu_torch/csrc/{sign,quant,
               topk,tern,attention,attention_tc}.cu`` with nvcc for sm_90a,
               one nvcc per source, all started together, and prints the
               seconds each took, ptxas's registers and spills of each
               tensor-core flash kernel, and the count of HGMMA/HMMA
               instructions in the attention libraries' SASS (where the
               toolkit has ``cuobjdump``).
3. kernels   -- each kernel against its plain PyTorch version on the card,
               at the main paths' leaf sizes, with planted cases:
               - the sign kernels at ResNet-18's 20 kernel-path leaves, at
                 one row below, at and above the rows one encode block
                 sums, and past the co-resident grid (bytes bit-exact, |x|
                 sum within rtol 1e-6, -0.0 and NaN);
               - int8 quantize and dequantize-sum at ResNet-18's 62 leaves,
                 world 1 and world 8, and quantize also one below, at and
                 above its tile and past the co-resident grid (codes,
                 scales and floats bit-exact; NaN, ±Inf, ±0.0 and exact .5
                 ties);
               - for the one-launch quantize and sign encode: the grid each
                 leaf size takes, one device row a call (asserted), and the
                 largest leaf's cold device ms against its byte bound;
               - int8 dequantize-sum also at n % 16 == 0, n % 16 == 4,
                 odd n and a view that starts one byte in, and at the
                 largest leaf (2,359,296 codes) at world 8;
               - the top-k radix threshold and the whole exact top-k at
                 ResNet-50's 53 kernel-path leaves with k = round(0.01 n)
                 (histograms, thresholds, index arrays and values
                 bit-exact; heavy |x| ties, NaN, ±Inf, ±0.0, all ties, all
                 zeros, k = 1, k = n − 1, more NaNs than k, odd n from a
                 misaligned view, run-to-run identity);
               - TernGrad's pack at BERT-base's 63 sublane-layout leaves as
                 the codec calls it (the two 23,440,896-element leaves in
                 chunks of 2**20), and its unpack-sum at world 1 and 8
                 (bytes and floats bit-exact; ±0.0, NaN, ±Inf, |x| == s,
                 u24 == p24, the top random bit);
               - the flash forward and backward at [b=4, l=512, h=12, d=64]
                 in bf16 (tensor cores) and float32 (CUDA cores),
                 non-causal, causal, with a k offset that leaves rows
                 without a visible key, and an lse cotangent (float32 to
                 rtol 1e-5 forward and 1e-4 backward; bf16 to 2**-6 of
                 each output's largest magnitude, see
                 ``check_flash_kernels``); in bf16 also every head dim
                 (8–128, causal and not), a ragged length whose
                 neighbouring heads hold 1e4 (nothing may leak), and
                 run-to-run identity of o, lse, dq, dk and dv.
               Times each over the main path's calls in sequence: ``ms``
               is the wrapper's call (median of CUDA-event timings, host
               launch cost included), ``device_ms`` the kernels' own time
               in a profiler trace, ``plain_ms`` the plain version's call,
               ``bound_ms`` the larger of the bytes the function must move
               over 3.35 TB/s and its operations over 989 TFLOP/s (bf16
               tensor cores), ``library_ms`` one PyTorch call computing the
               same function where there is one (never called by the
               port; for flash each SDPA backend that takes the shape is
               timed too, forward and backward alone). ``attention`` then
               times the dense attention of ``attention="full"`` against
               flash at BERT-base's shape.
4. decode_sum -- 8 stacked sign payloads for every ResNet-18 leaf through
               ``SignCodec.decode_sum``; bit-exact against the plain fold.
5. reference -- grads-only steps on the card against the same steps on the
               CPU (the plain versions), rtol 1e-6: SGD(sign) and
               SGD(int8) on ResNet-18, SGD(ef∘topk) on ResNet-50, and
               Adam(terngrad(use_pallas=True)) on BERT-base with the same
               random numbers on both sides; then BERT-base's loss and
               gradients with the flash kernels against the same with their
               plain versions on the card (bf16, see ``check_bert_flash``).
6. main path -- a one-rank NCCL process group, then 5 ``step(loss_fn=...)``
               calls and 1 ``step(grads=...)`` call of each of: identity
               (no kernel), sign, int8 and qsgd on ResNet-18 (CIFAR stem,
               GroupNorm, f32) at batch 256, and ef∘topk(fraction=0.01,
               pallas=True) on ResNet-50 (ImageNet stem, 1000 classes) at
               224x224, batch 128; then Adam(lr=1e-4) with identity and
               terngrad(use_pallas=True) on BERT-base MLM (132,361,530
               parameters in 150 leaves, bf16 compute, float32 parameters,
               attention="flash") at batch 4, sequence 512. Every kernel
               count is set to 0 just before a run and read just after it,
               and must equal the run's exact launches (flash only in loss
               steps: 12 forward and 12 + 12 backward launches a step).
               One more step then runs under torch.profiler (phase
               ``profile``): the device's busy time against the step's
               wall time and the kernels that take the most of it.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. This script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (data sheet)
WORLD = 1
BATCH = 256          # ResNet-18, CIFAR-10
BATCH_IMAGENET = 128  # ResNet-50, ImageNet
LOSS_STEPS = 5
TOPK_FRACTION = 0.01
BERT_BATCH, BERT_SEQ = 4, 512
BERT_HEADS, BERT_HEAD_DIM = 12, 64


def phase(name: str, **fields) -> None:
    print(f"phase={name} " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps``
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_events(prof) -> list:
    """The trace's kernel and memcpy rows (CPU operator rows also carry
    their kernels' time, so summing every row would count it twice)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _profiled(fn, cold: bool = False) -> list:
    """The device rows of one call of ``fn`` after a warm-up call;
    ``cold``: with the 50 MB L2 flushed just before. Every ``fn`` here
    launches work, yet a trace of one call now and then comes back
    without its kernel (seen for single cooperative launches on an H100):
    an empty trace is taken again, at most twice, and then fails the
    run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        if cold:
            torch.empty(2**27, dtype=torch.int8, device="cuda").fill_(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = _device_events(prof)
        if rows:
            return rows
    raise AssertionError("three profiler traces held no device row")


def device_ms(fn, cold: bool = False) -> float:
    """Device time of the kernels one call of ``fn`` launches, summed
    from torch.profiler's trace (no host time between launches); ``cold``:
    with the L2 flushed, so the inputs come from device memory as the byte
    bound assumes."""
    return sum(e.self_device_time_total for e in _profiled(fn, cold)) / 1e3


def device_launches(fn) -> int:
    """The device rows (kernels and memsets) one call of ``fn`` makes."""
    return sum(e.count for e in _profiled(fn))


def host_us(fn, calls: int = 20000) -> float:
    """Host microseconds a call of ``fn`` (best of 3 runs of ``calls``)."""
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", kind=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


def build_kernels() -> None:
    """Build every source (0.00 s for a library that is up to date), then
    print ptxas's report of the tensor-core flash kernels and the
    attention libraries' counts of tensor-core instructions."""
    import re

    from pytorch_ps_mpi_tpu_torch.ops import _build

    seconds = _build.build(*_build.SOURCES)
    for name, s in seconds.items():
        phase("build", source=f"csrc/{name}.cu", nvcc_s=f"{s:.2f}")
    kernel = None
    for line in _build.ptxas_report("attention_tc").splitlines():
        found = re.search(r"(flash_\w+_tc)ILi(\d+)EE", line)
        if found:
            kernel, spills = f"{found[1]}<{found[2]}>", ""
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line:
            phase("build", ptxas=kernel,
                  registers=re.search(r"Used (\d+) registers", line)[1],
                  spills=repr(spills))
            kernel = None
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in ("attention_tc", "attention"):
        lib = _build.BUILD_DIR / f"lib{name}.so"
        if not os.path.exists(cuobjdump):
            phase("build", sass=f"lib{name}.so", counts="not available")
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        phase("build", sass=f"lib{name}.so",
              HGMMA=len(re.findall(r"\bHGMMA\.", sass)),
              HMMA=len(re.findall(r"\bHMMA\.", sass)))


def timed(kern, plain, args, nbytes, library=None, reps=20, rounds=5,
          flops=None):
    """``ms``/``device_ms``/``plain_ms``/``bound_ms``/``bound_by``/
    ``library_ms`` of a kernel wrapper over one step's calls in sequence
    (``args``: one argument tuple per call; ``nbytes``/``flops``: the
    function's bytes and bf16 operations per call)."""
    def run_all(fn):
        for a in args:
            fn(*a)

    def total(fn):
        return sum(cuda_ms(lambda: fn(*a), reps, rounds) for a in args)

    by_bytes = sum(nbytes(*a) for a in args) / HBM_BYTES_PER_S * 1e3
    by_ops = (0.0 if flops is None
              else sum(flops(*a) for a in args) / BF16_FLOPS * 1e3)
    return dict(ms=total(kern), device_ms=device_ms(lambda: run_all(kern)),
                plain_ms=total(plain), bound_ms=max(by_bytes, by_ops),
                bound_by="operations" if by_ops > by_bytes else "bytes",
                library_ms=None if library is None else total(library))


def _kernel_names(fn) -> str:
    """The device kernels one call of ``fn`` launches, from a profiler
    trace (which backend a library call chose)."""
    return json.dumps(sorted({e.key[:60] for e in _profiled(fn)}))


def report(kernel: str, r: dict, **extra) -> None:
    phase("kernels", kernel=kernel, ms=f"{r['ms']:.4f}",
          device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
          bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
          library_ms=("null" if r["library_ms"] is None
                      else f"{r['library_ms']:.4f}"),
          max_abs_err=r["max_abs_err"], **extra)


# -- sign ------------------------------------------------------------------------

def kernel_sizes(model) -> list:
    from pytorch_ps_mpi_tpu_torch.ops.sign import GROUP

    sizes = [p.numel() for p in model.parameters() if p.numel() % GROUP == 0]
    if len(sizes) != 20:
        raise AssertionError(f"expected 20 kernel-path leaves, got {sizes}")
    return sizes


def check_kernels(sizes: list) -> dict:
    """Bit-exactness and timing of the three sign kernels."""
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    gen = torch.Generator(device="cuda").manual_seed(0)
    one, past = sign_edge_rows()
    cases = sorted(set(sizes)) + [S.GROUP, 13 * S.GROUP] + [
        r * S.GROUP for r in (one - 1, one, one + 1, past) if r > 0]
    max_err = {"encode_signs": 0.0, "pack_signs": 0.0, "unpack_signs": 0.0}
    for n in cases:
        for planted in (False, True):
            x = torch.randn(n, generator=gen, device="cuda")
            if planted:
                x[0], x[1], x[128] = -0.0, float("nan"), 0.0
            packed, total = S.encode_signs(x)
            ref_packed, ref_total = S.encode_signs_ref(x)
            if not torch.equal(packed, ref_packed):
                raise AssertionError(f"encode_signs bytes differ at n={n}")
            if not torch.equal(S.pack_signs(x), ref_packed):
                raise AssertionError(f"pack_signs bytes differ at n={n}")
            out = S.unpack_signs(packed)
            if not torch.equal(out, S.unpack_signs_ref(packed)):
                raise AssertionError(f"unpack_signs differs at n={n}")
            if planted:
                # -0.0 packs as +, NaN as 0 (bit s of byte [r, lane])
                b0 = int(packed[0])
                if (b0 & 1, int(packed[1]) & 1, (b0 >> 1) & 1) != (1, 0, 1):
                    raise AssertionError("-0.0/NaN/+0.0 packed wrongly")
                if not (torch.isnan(total) and torch.isnan(ref_total)):
                    raise AssertionError("a planted NaN must reach the sum")
                continue
            err = abs(float(total) - float(ref_total))
            if err > 1e-6 * abs(float(ref_total)):
                raise AssertionError(
                    f"encode_signs sum at n={n}: {float(total)} vs "
                    f"{float(ref_total)}")
            max_err["encode_signs"] = max(max_err["encode_signs"], err)

    # times at the main path's shapes: one step's 20 leaves in sequence
    xs = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
    args = [(x, S.pack_signs_ref(x)) for x in xs]
    fns = {
        "encode_signs": (lambda x, p: S.encode_signs(x),
                         lambda x, p: S.encode_signs_ref(x),
                         lambda x, p: 4 * x.numel() + x.numel() // 8 + 4),
        "pack_signs": (lambda x, p: S.pack_signs(x),
                       lambda x, p: S.pack_signs_ref(x),
                       lambda x, p: 4 * x.numel() + x.numel() // 8),
        "unpack_signs": (lambda x, p: S.unpack_signs(p),
                         lambda x, p: S.unpack_signs_ref(p),
                         lambda x, p: x.numel() // 8 + 4 * x.numel()),
    }
    results = {}
    for name, (kern, plain, nbytes) in fns.items():
        r = timed(kern, plain, args, nbytes)
        r["max_abs_err"] = max_err[name]
        results[name] = r
        report(name, r, leaves=len(sizes), cases=2 * len(cases))
    sum_ms = sum(cuda_ms(lambda: torch.sum(x.abs())) for x in xs)
    phase("kernels", yardstick="torch.sum(x.abs()) over the 20 leaves",
          ms=f"{sum_ms:.4f}")
    lib = S._lib()
    one_launch_design(
        "encode_signs", S.encode_signs, xs,
        lambda n: lib.sign_encode_grid(n // S.GROUP, 1),
        lambda n: 4 * n + n // 8 + 4,
        rows_per_block_pass=S._rows_per_block(), one_block_rows=one,
        cases=len(cases))
    return results


def sign_edge_rows() -> tuple:
    """The most packed rows one encode block sums, and the rows one past
    the co-resident grid's first pass over them."""
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    lib = S._lib()
    one = next(r for r in range(1, 1 << 16)
               if lib.sign_encode_grid(r + 1, 1) != 1)
    return one, lib.sign_encode_grid(1 << 40, 1) * S._rows_per_block() + 3


def one_launch_design(kernel: str, fn, xs: list, grid, nbytes,
                      **tile) -> None:
    """The one-launch design of ``fn`` at the main path's leaves: for each
    leaf size the grid it chose and one call's device µs (warm), the
    device rows of one call (each must be 1: no memset, no second kernel)
    and the largest leaf's cold device ms against its byte bound."""
    by_size = {x.numel(): x for x in xs}
    traces = {n: _profiled(lambda: fn(x)) for n, x in by_size.items()}
    rows = {n: sum(e.count for e in t) for n, t in traces.items()}
    if set(rows.values()) != {1}:
        raise AssertionError(f"{kernel}: device rows a call {rows}, not 1")
    n = max(by_size)
    cold = device_ms(lambda: fn(by_size[n]), cold=True)
    bound = nbytes(n) / HBM_BYTES_PER_S * 1e3
    phase("kernels", kernel=kernel, design="one launch a call", **tile,
          block=256, device_rows_per_call=1,
          grids=json.dumps({m: grid(m) for m in sorted(by_size)},
                           separators=(",", ":")),
          device_us=json.dumps(
              {m: round(sum(e.self_device_time_total for e in traces[m]), 3)
               for m in sorted(by_size)}, separators=(",", ":")),
          largest_leaf=n, cold_device_ms=f"{cold:.4f}",
          bound_ms=f"{bound:.5f}", share_of_bound=f"{bound / cold:.3f}",
          alternative="programmatic dependent launch: not measured")


# -- int8 quantize / dequantize-sum --------------------------------------------

def _int8_planted(n: int, case: str, gen) -> torch.Tensor:
    x = torch.randn(n, generator=gen, device="cuda")
    if case == "ties":  # absmax 127 makes the scale 1.0: exact .5 ties
        x[0] = 127.0
        x[1:9] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                               -126.5])
    elif case == "signed_zero":
        x[0], x[1] = -0.0, 0.0
    elif case == "nan":
        x[0], x[n // 2] = -0.0, float("nan")
    elif case == "inf":
        x[0], x[n - 1] = float("inf"), -2.5
    elif case == "neg_inf":
        x[n // 3] = float("-inf")
    elif case == "zeros":
        x.zero_()
    return x


def check_quant_kernels(model) -> dict:
    """The int8 quantize and dequantize-sum kernels at ResNet-18's 62
    leaves: bit-exact at world 1 and 8, planted cases, and timing."""
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q

    sizes = [p.numel() for p in model.parameters()]
    if len(sizes) != 62:
        raise AssertionError(f"expected 62 leaves, got {len(sizes)}")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def same(a, b, what):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs from its plain version")

    cases = 0
    tile = Q._tile()
    past = Q._lib().quant_int8_grid(1 << 40) * tile + 4099
    for n in sorted(set(sizes)) + [4099, 1000, tile - 1, tile, tile + 1,
                                   past]:
        for case in (("plain", "ties", "signed_zero", "nan", "inf",
                      "neg_inf", "zeros") if n >= 16 else ("plain",)):
            x = 1e-2 * _int8_planted(n, case, gen)
            q, s = Q.quantize_int8(x)
            rq, rs = Q.quantize_int8_ref(x)
            same(q, rq, f"quantize_int8 codes at n={n} ({case})")
            same(s, rs, f"quantize_int8 scale at n={n} ({case})")
            cases += 1
    # the dequantize-sum's three load widths: n % 16 == 0 (16 codes a
    # thread), n % 16 == 4 (4 codes), odd n, and codes that start one byte
    # into their buffer (so no row is aligned), at world 1 and 8
    dequant_cases = 0
    for n in sorted(set(sizes)) + [4099, 1000, 1028, 2_359_296 + 4]:
        for world in (1, 8):
            for offset in (0, 1):
                buf = torch.randint(-127, 128, (world * n + offset,),
                                    generator=gen, device="cuda",
                                    dtype=torch.int8)
                qs = buf[offset:].view(world, n)
                ss = torch.rand(world, generator=gen, device="cuda")
                if n == 4099 and world == 8:
                    ss[3] = float("nan")  # a NaN scale poisons its sum
                same(Q.dequant_sum(qs, ss), Q.dequant_sum_ref(qs, ss),
                     f"dequant_sum at n={n}, world {world}, offset {offset}")
                if world == 1:
                    same(Q.dequantize_int8(qs[0], ss[0]),
                         Q.dequant_sum_ref(qs, ss),
                         f"dequantize_int8 at n={n}, offset {offset}")
                dequant_cases += 1
    phase("kernels", check="int8 bit-exact", sizes=len(set(sizes)) + 6,
          quantize_cases=cases, dequant_cases=dequant_cases,
          dequant_worlds="1,8", dequant_widths="n%16==0,n%16==4,odd,offset 1")

    xs = [1e-2 * torch.randn(n, generator=gen, device="cuda") for n in sizes]
    quant_args = [(x,) for x in xs]
    payloads = [Q.quantize_int8_ref(x) for x in xs]
    results = {}
    r_q = timed(Q.quantize_int8, Q.quantize_int8_ref, quant_args,
                lambda x: 5 * x.numel() + 4)
    results["quantize_int8"] = dict(r_q, max_abs_err=0.0)
    report("quantize_int8", results["quantize_int8"], leaves=len(sizes))
    yard = sum(cuda_ms(lambda: torch.amax(x.abs())) for x in xs)
    phase("kernels", yardstick="torch.amax(x.abs()) over the 62 leaves",
          ms=f"{yard:.4f}")

    r = timed(Q.dequantize_int8,
              lambda q, s: Q.dequant_sum_ref(q.reshape(1, -1), s.reshape(1)),
              payloads, lambda q, s: 5 * q.numel() + 4,
              library=lambda q, s: torch.mul(q, s))
    results["dequantize_int8"] = dict(r, max_abs_err=0.0)
    report("dequantize_int8", results["dequantize_int8"], leaves=len(sizes),
           world=1, library="torch.mul(q, scale)")
    phase("kernels", host="quantize_int8 wrapper over dequantize_int8's",
          ratio=f"{r_q['ms'] / r['ms']:.3f}")
    one_launch_design("quantize_int8", Q.quantize_int8, xs,
                      Q._lib().quant_int8_grid, lambda n: 5 * n + 4,
                      tile_floats=tile)

    stacks = [(torch.stack([q] * 8), torch.stack([s] * 8))
              for q, s in payloads]
    r = timed(Q.dequant_sum, Q.dequant_sum_ref, stacks,
              lambda q, s: 12 * q.shape[1] + 4 * 8, reps=10, rounds=3)
    report("dequant_sum", dict(r, max_abs_err=0.0), leaves=len(sizes),
           world=8)
    n = max(sizes)
    big = [(torch.randint(-127, 128, (8, n), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(8, generator=gen, device="cuda"))]
    r = timed(Q.dequant_sum, Q.dequant_sum_ref, big,
              lambda q, s: 12 * q.shape[1] + 4 * 8, reps=10, rounds=3)
    cold = device_ms(lambda: Q.dequant_sum(*big[0]), cold=True)
    report("dequant_sum", dict(r, max_abs_err=0.0), leaf=n, world=8,
           cold_device_ms=f"{cold:.4f}",
           cold_over_bound=f"{cold / r['bound_ms']:.2f}")
    from pytorch_ps_mpi_tpu_torch.ops import _build

    def current_stream():
        return torch.cuda.current_stream(0).cuda_stream

    phase("kernels", host="stream handle, us a call",
          raw_stream=f"{host_us(lambda: _build.raw_stream(0)):.3f}",
          current_stream=f"{host_us(current_stream):.3f}",
          launches_per_call=device_launches(
              lambda: Q.dequantize_int8(*payloads[0])))
    return results


# -- exact top-k ----------------------------------------------------------------

def topk_leaves(model) -> list:
    """(n, k) of ResNet-50's leaves that take the count kernel."""
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    leaves = []
    for p in model.parameters():
        n = p.numel()
        k = max(1, int(round(n * TOPK_FRACTION)))
        if 4 * 2048 <= n <= T.MAX_N and k < n:
            leaves.append((n, k))
    if len(leaves) != 53 or sum(n for n, _ in leaves) != 25_498_816:
        raise AssertionError(f"expected 53 kernel-path leaves of 25,498,816 "
                             f"elements, got {len(leaves)}")
    return leaves


def _topk_planted(case: str, gen):
    """(x, k) of a planted case at the largest leaf's size."""
    n, k = 2_359_296, 23_593
    x = torch.randn(n, generator=gen, device="cuda")
    if case == "heavy ties":
        x = 0.25 * torch.randint(0, 4, (n,), generator=gen,
                                 device="cuda").float()
        x[::5] *= -1
    elif case == "NaN, ±Inf, ±0.0":
        x[[3, 70, 900, 901, 5, 6]] = torch.tensor(
            [float("nan"), float("inf"), float("-inf"), float("nan"), -0.0,
             0.0], device="cuda")
    elif case == "all ties":
        x.fill_(-1.5)
    elif case == "all zeros":
        x.zero_()
    elif case == "k = 1":
        k = 1
    elif case == "k = n - 1":
        k = n - 1
    elif case == "more NaNs than k":
        # quiet, signalling, negative and payload NaNs: all above Inf
        nans = torch.tensor([0x7FC00000, 0x7F800001, -0x400000, 0x7FFFFFFF],
                            dtype=torch.int32, device="cuda")
        x[::40] = nans.repeat(n // 160 + 1)[:len(x[::40])].view(torch.float32)
        x[7] = float("inf")
    elif case == "odd n, misaligned":
        x = x[1:-2]  # starts 4 bytes in: the scalar loads
        n = x.numel()
        k = int(round(0.01 * n))
    return x, k


TOPK_PLANTED = ("heavy ties", "NaN, ±Inf, ±0.0", "all ties", "all zeros",
                "k = 1", "k = n - 1", "more NaNs than k", "odd n, misaligned")


def check_topk_kernels(leaves: list):
    """The top-k radix threshold and the whole exact top-k against their
    plain versions at ResNet-50's 53 kernel-path leaves and the planted
    cases, bit for bit, and timing. Returns (launches a call, results)."""
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    gen = torch.Generator(device="cuda").manual_seed(5)

    def check(x, k, what):
        t, hist = T.radix_threshold(x, k)
        rt, rhist = T.radix_threshold_ref(x, k)
        if not (torch.equal(hist, rhist) and torch.equal(t, rt)):
            raise AssertionError(f"radix histograms or t differ: {what}")
        v, i = T.exact_topk(x, k)
        rv, ri = T.exact_topk_ref(x, k)
        if not (torch.equal(i, ri)
                and torch.equal(v.view(torch.int32), rv.view(torch.int32))):
            raise AssertionError(f"exact_topk differs: {what}")
        for _ in range(2):
            if not torch.equal(T.exact_topk(x, k)[1], i):
                raise AssertionError(f"exact_topk changed from run to run: "
                                     f"{what}")

    for n, k in sorted(set(leaves)):
        check(torch.randn(n, generator=gen, device="cuda"), k, f"n={n}")
    for case in TOPK_PLANTED:
        check(*_topk_planted(case, gen), case)
    x = torch.randn(2_359_296, generator=gen, device="cuda")
    launches = device_launches(lambda: T.exact_topk(x, 23_593))
    if launches != T.LAUNCHES:
        raise AssertionError(f"one exact_topk call made {launches} device "
                             f"launches, not {T.LAUNCHES}")
    phase("kernels", check="topk bit-exact", sizes=len(set(leaves)),
          planted="; ".join(TOPK_PLANTED), run_to_run="identical",
          launches_per_call=launches)

    xs = [(torch.randn(n, generator=gen, device="cuda"), k)
          for n, k in leaves]
    r = timed(T.exact_topk, T.exact_topk_ref, xs,
              lambda x, k: 4 * x.numel() + 8 * k,
              library=lambda x, k: torch.topk(x.abs(), k), reps=5, rounds=3)
    threshold = timed(T.radix_threshold, T.radix_threshold_ref, xs,
                      lambda x, k: 4 * x.numel(), reps=5, rounds=3)
    design_ms = sum(24 * x.numel() + 8 * k
                    for x, k in xs) / HBM_BYTES_PER_S * 1e3
    results = {"exact_topk": dict(r, max_abs_err=0.0)}
    report("exact_topk", results["exact_topk"], leaves=len(leaves),
           library="torch.topk(x.abs(), k)",
           design_bound_ms=f"{design_ms:.5f}",
           threshold_ms=f"{threshold['ms']:.4f}",
           threshold_device_ms=f"{threshold['device_ms']:.4f}",
           threshold_plain_ms=f"{threshold['plain_ms']:.4f}",
           launches_per_call=T.LAUNCHES)
    big = [max(xs, key=lambda a: a[0].numel())]
    r = timed(T.exact_topk, T.exact_topk_ref, big,
              lambda x, k: 4 * x.numel() + 8 * k,
              library=lambda x, k: torch.topk(x.abs(), k), reps=10, rounds=3)
    (x, k), = big
    report("exact_topk", dict(r, max_abs_err=0.0), leaf=x.numel(), k=k,
           library="torch.topk(x.abs(), k)",
           design_bound_ms=f"{(24 * x.numel() + 8 * k) / HBM_BYTES_PER_S * 1e3:.5f}",
           cold_device_ms=f"{device_ms(lambda: T.exact_topk(x, k), True):.4f}")
    return T.LAUNCHES, results


# -- TernGrad pack / unpack-sum ---------------------------------------------------

def tern_calls(model) -> list:
    """Per sublane-layout leaf of ``model``, the element counts of its
    ``tern_pack`` calls as ``TernGradCodec(use_pallas=True)`` makes them:
    the whole leaf, or its chunks at or above the scan threshold."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    code = get_codec("terngrad", use_pallas=True)
    leaves = []
    for p in model.parameters():
        n = p.numel()
        if not code._pallas_ok(n):
            continue
        if n < code.scan_threshold:
            leaves.append([n])
        else:
            full, tail = divmod(n, code.scan_block)
            leaves.append([code.scan_block] * full + ([tail] if tail else []))
    calls = [c for leaf in leaves for c in leaf]
    if len(leaves) != 63 or len(calls) != 107 or sum(calls) != 132_246_528:
        raise AssertionError(f"expected 107 tern_pack calls over 63 leaves "
                             f"(132,246,528 elements), got {len(calls)} over "
                             f"{len(leaves)}")
    return leaves


def _tern_planted(n: int, gen):
    """x, bits, scale with the planted cases of ``tests/test_torch_tern_ops``:
    ±0.0, NaN, ±Inf, |x| == s, u24 == p24 (drops), u24 == p24 − 1 (keeps),
    the top random bit set."""
    x = 0.5 * torch.randn(n, generator=gen, device="cuda")
    bits = torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    x[:8] = torch.tensor([-0.0, float("nan"), float("inf"), -float("inf"),
                          -4.0, 0.5, 0.5, 1.0])
    bits[4:8] = torch.tensor([-1, (2097152 << 8) | 0xFF,
                              ((2097152 - 1) << 8) | 0xFF, -2**31],
                             dtype=torch.int32)
    return x, bits, torch.tensor(4.0, device="cuda")


def check_tern_kernels(model) -> dict:
    """``tern_pack`` at BERT-base's 107 calls a step and the unpack-sum at
    its 63 sublane-layout leaves (world 1 and 8): bit-exact against the
    plain versions, planted cases, and timing."""
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    leaves = tern_calls(model)
    calls = [c for leaf in leaves for c in leaf]
    leaf_sizes = sorted({sum(leaf) for leaf in leaves})
    gen = torch.Generator(device="cuda").manual_seed(6)
    for n in sorted(set(calls)):
        x = torch.randn(n, generator=gen, device="cuda")
        bits = torch.randint(-2**31, 2**31, (n,), generator=gen,
                             device="cuda", dtype=torch.int32)
        s = x.abs().amax()
        if not torch.equal(TG.tern_pack(x, bits, s),
                           TG.tern_pack_ref(x, bits, s)):
            raise AssertionError(f"tern_pack differs at n={n}")
    for n in (512, 372_224):
        x, bits, s = _tern_planted(n, gen)
        packed = TG.tern_pack(x, bits, s)
        if not torch.equal(packed, TG.tern_pack_ref(x, bits, s)):
            raise AssertionError(f"tern_pack differs on planted cases, n={n}")
        if TG.tern_digits(packed[:128])[:8].tolist() != [0, 0, 1, -1, -1, 0,
                                                       1, 0]:
            raise AssertionError("tern_pack planted digits wrong")
        for scale in (float("nan"), float("inf")):
            s = torch.tensor(scale, device="cuda")
            if not torch.equal(TG.tern_pack(x, bits, s),
                               TG.tern_pack_ref(x, bits, s)):
                raise AssertionError(f"tern_pack differs at scale {scale}")
    for m in [n // 4 for n in leaf_sizes]:
        for world in (1, 8):
            packed = torch.randint(0, 256, (world, m), generator=gen,
                                   device="cuda", dtype=torch.uint8)
            scales = torch.rand(world, generator=gen, device="cuda")
            got = TG.tern_unpack_sum(packed, scales)
            want = TG.tern_unpack_sum_ref(packed, scales)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"tern_unpack_sum differs at m={m}, "
                                     f"world {world}")
    phase("kernels", check="terngrad bit-exact", pack_sizes=len(set(calls)),
          unpack_sizes=len(leaf_sizes), unpack_worlds="1,8",
          planted="±0.0, NaN, ±Inf, |x|==s, u24==p24, top bit; NaN/Inf scale")

    pack_args = []
    for n in calls:
        x = 1e-3 * torch.randn(n, generator=gen, device="cuda")
        pack_args.append((x, torch.randint(-2**31, 2**31, (n,), generator=gen,
                                           device="cuda", dtype=torch.int32),
                          x.abs().amax()))
    results = {}
    r = timed(TG.tern_pack, TG.tern_pack_ref, pack_args,
              lambda x, b, s: 8 * x.numel() + x.numel() // 4 + 4,
              reps=10, rounds=3)
    results["tern_pack"] = dict(r, max_abs_err=0.0)
    report("tern_pack", results["tern_pack"], calls=len(calls))

    unpack_args = [(TG.tern_pack(x, b, s).reshape(1, -1), s.reshape(1))
                   for x, b, s in pack_args]
    del pack_args
    # one step's unpack-sums are per leaf: the chunks of a leaf concatenate
    leaf_args, i = [], 0
    for leaf in leaves:
        k = len(leaf)
        leaf_args.append((torch.cat([a[0] for a in unpack_args[i:i + k]], 1),
                          unpack_args[i][1]))
        i += k
    del unpack_args
    r = timed(TG.tern_unpack_sum, TG.tern_unpack_sum_ref, leaf_args,
              lambda q, s: q.numel() + 16 * q.shape[1] + 4,
              reps=10, rounds=3)
    results["tern_unpack"] = dict(r, max_abs_err=0.0)
    report("tern_unpack", results["tern_unpack"], leaves=len(leaf_args),
           world=1)
    stacks = [(torch.cat([q] * 8), torch.cat([s] * 8)) for q, s in leaf_args]
    r = timed(TG.tern_unpack_sum, TG.tern_unpack_sum_ref, stacks,
              lambda q, s: q.numel() + 16 * q.shape[1] + 4 * 8,
              reps=3, rounds=3)
    report("tern_unpack_sum", dict(r, max_abs_err=0.0),
           leaves=len(leaf_args), world=8)
    return results


# -- flash attention -------------------------------------------------------------

def _flash_inputs(dtype, gen, b=BERT_BATCH, l=BERT_SEQ, h=BERT_HEADS,
                  d=BERT_HEAD_DIM):
    q, k, v, g = (torch.randn(b * h, l, d, generator=gen, device="cuda")
                  .to(dtype) for _ in range(4))
    return q, k, v, g, torch.randn(b * h, l, generator=gen, device="cuda")


def _flash_err(got, want, dtype, what: str, grad: bool) -> float:
    """max|got − want|, held to float32's tolerance (rtol 1e-5 forward,
    1e-4 backward, the same atol) or to bf16's: 2**-6 of the output's
    largest magnitude. Kernel and plain version round p and ds to bf16
    before their products and the results to bf16 (2**-9 relative each),
    but the kernel rounds p against the running max and the plain version
    against the final one, so a few bf16 ulps can differ."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if dtype == torch.float32:
        tol = 1e-4 if grad else 1e-5
        bad = (got - want).abs() > tol + tol * want.abs()
        if bool(bad.any()):
            raise AssertionError(f"{what}: max abs err {err}")
    elif err > 2 ** -6 * float(want.abs().max()):
        raise AssertionError(f"{what}: max abs err {err}")
    return err


def check_flash_kernels() -> dict:
    """The flash forward and backward against their plain versions at
    BERT-base's attention shape, then timing at the main path's 12
    launches a step (bf16, non-causal)."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(7)
    scale = BERT_HEAD_DIM ** -0.5
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for causal, (qo, ko) in ((False, (0, 0)), (True, (0, 0)),
                                 (True, (0, 100)), (True, (256, 0))):
            q, k, v, g, g_lse = _flash_inputs(dtype, gen)
            tag = f"{dtype} causal={causal} offsets={qo},{ko}"
            o, lse = A.flash_fwd(q, k, v, qo, ko, causal, scale)
            ro, rlse = A.flash_fwd_ref(q, k, v, qo, ko, causal, scale)
            err_f = max(_flash_err(o, ro, dtype, f"flash_fwd o, {tag}", False),
                        _flash_err(lse, rlse, torch.float32,
                                   f"flash_fwd lse, {tag}", False))
            grads = A.flash_bwd(q, k, v, o, lse, g, g_lse, qo, ko, causal,
                                scale)
            want = A.flash_bwd_ref(q, k, v, o, lse, g, g_lse, qo, ko, causal,
                                   scale)
            err_b = max(_flash_err(a, b, dtype, f"flash_bwd d{n}, {tag}", True)
                        for a, b, n in zip(grads, want, "qkv"))
            if dtype == torch.bfloat16 and not causal:  # the main path's
                worst = {"flash_fwd": err_f, "flash_bwd": err_b}
            if ko == 100 and o[:, :100].float().abs().any():
                raise AssertionError("rows with no visible key must give 0")
            cases += 1
    phase("kernels", check="flash within tolerance", cases=cases,
          shape=f"[{BERT_BATCH * BERT_HEADS},{BERT_SEQ},{BERT_HEAD_DIM}]",
          dtypes="bf16,f32", bf16_fwd_err=worst["flash_fwd"],
          bf16_bwd_err=worst["flash_bwd"])
    check_flash_tensor_cores(gen)

    layers = 12
    sets = [_flash_inputs(torch.bfloat16, gen) for _ in range(layers)]
    bh, l, d = sets[0][0].shape
    fwd_args = [(q, k, v) for q, k, v, _, _ in sets]
    attn = 4 * bh * l * l * d  # q k^T and p v
    results = {}
    r = timed(lambda q, k, v: A.flash_fwd(q, k, v, 0, 0, False, scale),
              lambda q, k, v: A.flash_fwd_ref(q, k, v, 0, 0, False, scale),
              fwd_args, lambda q, k, v: 4 * q.numel() * 2 + 4 * bh * l,
              library=lambda q, k, v: torch.nn.functional
              .scaled_dot_product_attention(q.view(-1, BERT_HEADS, l, d),
                                            k.view(-1, BERT_HEADS, l, d),
                                            v.view(-1, BERT_HEADS, l, d)),
              flops=lambda q, k, v: attn, reps=5, rounds=3)
    results["flash_fwd"] = dict(r, max_abs_err=worst["flash_fwd"])
    report("flash_fwd", results["flash_fwd"], calls=layers,
           library="scaled_dot_product_attention forward")
    sdpa_backends(sets)

    bwd_args = []
    for q, k, v, g, _ in sets:
        o, lse = A.flash_fwd(q, k, v, 0, 0, False, scale)
        qs, ks, vs = (t.view(-1, BERT_HEADS, l, d).detach().requires_grad_()
                      for t in (q, k, v))
        ref = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
        bwd_args.append((q, k, v, o, lse, g, torch.zeros_like(lse),
                         (ref, (qs, ks, vs), g.view(-1, BERT_HEADS, l, d))))

    def sdpa_backward(*a):
        ref, inputs, grad = a[-1]
        torch.autograd.grad(ref, inputs, grad, retain_graph=True)

    phase("kernels", yardstick="scaled_dot_product_attention backends",
          forward=_kernel_names(
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  *(t.view(-1, BERT_HEADS, l, d) for t in fwd_args[0]))),
          backward=_kernel_names(lambda: sdpa_backward(*bwd_args[0])))
    r = timed(lambda *a: A.flash_bwd(*a[:7], 0, 0, False, scale),
              lambda *a: A.flash_bwd_ref(*a[:7], 0, 0, False, scale),
              bwd_args, lambda q, *a: 8 * q.numel() * 2 + 2 * 4 * bh * l,
              library=sdpa_backward, flops=lambda *a: 2.5 * attn,
              reps=5, rounds=3)
    results["flash_bwd"] = dict(r, max_abs_err=worst["flash_bwd"])
    report("flash_bwd", results["flash_bwd"], calls=layers,
           library="scaled_dot_product_attention backward alone")

    flash_host(scale)

    # the "full" crossover: BERT's dense attention against the kernel, one
    # layer's [b, l, h, d] in bf16, forward and forward + backward
    from pytorch_ps_mpi_tpu_torch.models.bert import dense_attention

    q, k, v, g, _ = sets[0]
    q4, k4, v4, g4 = (t.view(BERT_BATCH, BERT_HEADS, l, d).transpose(1, 2)
                      for t in (q, k, v, g))

    def fwd_bwd(fn):
        def run():
            ins = [t.detach().requires_grad_() for t in (q4, k4, v4)]
            torch.autograd.grad(fn(*ins), ins, g4)
        return run

    def flash(a, b, c):
        return A.flash_attention(a, b, c)

    def dense(a, b, c):
        return dense_attention(a, b, c, False)

    phase("attention", shape=f"[{BERT_BATCH},{l},{BERT_HEADS},{d}] bf16",
          dense_fwd_ms=f"{cuda_ms(lambda: dense(q4, k4, v4), 5, 3):.4f}",
          flash_fwd_ms=f"{cuda_ms(lambda: flash(q4, k4, v4), 5, 3):.4f}",
          dense_fwd_bwd_ms=f"{cuda_ms(fwd_bwd(dense), 5, 3):.4f}",
          flash_fwd_bwd_ms=f"{cuda_ms(fwd_bwd(flash), 5, 3):.4f}")
    return results


def flash_host(scale: float) -> None:
    """Host µs a call of the flash wrappers and their pieces, at [1, 64,
    64] bf16 where the device's part is a few µs: the forward and
    backward wrappers, SDPA's forward, one ``torch.empty_like``, and the
    ctypes call of ``flash_fwd_bf16`` alone (with bh = 0, which it
    refuses at once)."""
    from pytorch_ps_mpi_tpu_torch.ops import _build
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, g, _ = _flash_inputs(torch.bfloat16, gen, b=1, l=64, h=1)
    o, lse = A.flash_fwd(q, k, v, 0, 0, False, scale)
    fn = A._kernels(torch.bfloat16)[0]
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]
    q4, k4, v4 = (t.view(1, 1, 64, -1) for t in (q, k, v))
    calls = 5000
    us = {
        "fwd_wrapper": host_us(lambda: A.flash_fwd(q, k, v, 0, 0, False,
                                                   scale), calls),
        "bwd_wrapper": host_us(lambda: A.flash_bwd(q, k, v, o, lse, g, None,
                                                   0, 0, False, scale), calls),
        "sdpa_fwd": host_us(lambda: torch.nn.functional
                            .scaled_dot_product_attention(q4, k4, v4), calls),
        "empty_like": host_us(lambda: torch.empty_like(q), calls),
        "ctypes_call": host_us(lambda: fn(*ptrs, 0, 64, 64, 64, 0, 0, 0,
                                          scale, _build.raw_stream(0)),
                               calls),
    }
    phase("kernels", host_us="flash at [1,64,64] bf16",
          **{k: f"{v:.2f}" for k, v in us.items()})


def _flash_both(q, k, v, g, g_lse, causal=False):
    """o, lse, dq, dk, dv of the kernels (forward, then backward)."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    scale = q.shape[-1] ** -0.5
    o, lse = A.flash_fwd(q, k, v, 0, 0, causal, scale)
    return (o, lse) + A.flash_bwd(q, k, v, o, lse, g, g_lse, 0, 0, causal,
                                  scale)


def check_flash_tensor_cores(gen) -> None:
    """The bf16 (tensor-core) kernels at the phase's b, l and h: every head
    dim, causal and not, against the plain versions (2**-6 of each
    output's largest magnitude); a ragged length (500 = 7 tiles + 52
    rows) whose odd heads' k and v are then set to 1e4, after which the
    even heads' outputs must be the same bit for bit; and o, lse, dq, dk,
    dv bit for bit the same over 3 more runs at the main path's shape."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    worst, cases = 0.0, 0
    for d in A.HEAD_DIMS:
        for causal in (False, True):
            q, k, v, g, g_lse = _flash_inputs(torch.bfloat16, gen, d=d)
            got = _flash_both(q, k, v, g, g_lse, causal)
            scale = d ** -0.5
            tag = f"bf16 d={d} causal={causal}"
            ro, rlse = A.flash_fwd_ref(q, k, v, 0, 0, causal, scale)
            want = A.flash_bwd_ref(q, k, v, got[0], got[1], g, g_lse, 0, 0,
                                   causal, scale)
            _flash_err(got[1], rlse, torch.float32, f"lse, {tag}", False)
            for a, b, n in zip(got[:1] + got[2:], (ro,) + want,
                               ("o", "dq", "dk", "dv")):
                err = _flash_err(a, b, torch.bfloat16, f"{n}, {tag}", n != "o")
                worst = max(worst, err / float(b.float().abs().max()))
            cases += 1
    q, k, v, g, g_lse = _flash_inputs(torch.bfloat16, gen, l=500)
    clean = _flash_both(q, k, v, g, g_lse)
    k[1::2], v[1::2] = 1e4, 1e4
    poisoned = _flash_both(q, k, v, g, g_lse)
    for a, b in zip(clean, poisoned):
        if not (torch.equal(a[0::2], b[0::2])
                and bool(torch.isfinite(b.float()).all())):
            raise AssertionError("a ragged tile read its neighbouring head")
    q, k, v, g, g_lse = _flash_inputs(torch.bfloat16, gen)
    first = _flash_both(q, k, v, g, g_lse)
    for _ in range(3):
        if not all(torch.equal(a, b) for a, b in
                   zip(_flash_both(q, k, v, g, g_lse), first)):
            raise AssertionError("flash differs from run to run")
    phase("kernels", check="flash bf16 on the tensor cores",
          head_dims=",".join(map(str, A.HEAD_DIMS)), cases=cases,
          worst_rel_err=f"{worst:.3e}", tolerance="2**-6",
          ragged_neighbour="l=500, odd heads 1e4: even heads bit-equal",
          run_to_run="o,lse,dq,dk,dv bit-equal over 4 runs")


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_backends(sets) -> None:
    """The yardstick per SDPA backend: the 12 calls' forward and, alone,
    backward under ``torch.nn.attention.sdpa_kernel`` (CUDA-event ms,
    summed over the calls as ``timed`` does); "unsupported" where the
    backend does not take the shape. Never called by the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def total(calls) -> str:
        return f"{sum(cuda_ms(c, 5, 3) for c in calls):.4f}"

    fwd, bwd = {}, {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                fwd_calls, bwd_calls = [], []
                for q, k, v, g, _ in sets:
                    x = [t.view(BERT_BATCH, BERT_HEADS, *t.shape[1:])
                         for t in (q, k, v, g)]
                    ins = [t.detach().requires_grad_() for t in x[:3]]
                    out = sdpa(*ins)
                    fwd_calls.append(lambda x=x: sdpa(*x[:3]))
                    bwd_calls.append(lambda o=out, i=ins, g=x[3]:
                                     torch.autograd.grad(o, i, g,
                                                         retain_graph=True))
                fwd[name], bwd[name] = total(fwd_calls), total(bwd_calls)
        except RuntimeError as err:  # the backend does not take the shape
            fwd[name] = bwd[name] = "unsupported"
            phase("kernels", sdpa_backend=name,
                  unsupported=repr(str(err)[:80]))
    phase("kernels", yardstick="sdpa backends", direction="forward",
          calls=len(sets), **fwd)
    phase("kernels", yardstick="sdpa backends", direction="backward alone",
          calls=len(sets), **bwd)


# -- decode_sum and the reference steps -----------------------------------------

def check_decode_sum(model) -> None:
    """8 workers' sign payloads for every leaf through decode_sum: the
    kernel path bit-exact against the plain fold."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    code = get_codec("sign")
    gen = torch.Generator(device="cuda").manual_seed(1)
    workers, leaves = 8, 0
    for p in model.parameters():
        shape = tuple(p.shape)
        payloads = [code.encode(torch.randn(shape, generator=gen,
                                            device="cuda"))[0]
                    for _ in range(workers)]
        stacked = {k: torch.stack([pl[k] for pl in payloads])
                   for k in ("packed", "scale")}
        got = code.decode_sum(stacked, shape, torch.float32)
        if p.numel() % S.GROUP == 0:
            want = torch.zeros(shape, device="cuda")
            for r in range(workers):
                want.add_((S.unpack_signs_ref(stacked["packed"][r])
                           * stacked["scale"][r]).reshape(shape))
            if not torch.equal(got, want):
                raise AssertionError(f"decode_sum differs, shape {shape}")
            leaves += 1
    phase("decode_sum", workers=workers, kernel_leaves=leaves,
          all_leaves=len(list(model.parameters())), bit_exact=True)


def make_codec(name: str):
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    if name == "ef_topk":
        return get_codec("ef", inner=get_codec(
            "topk", fraction=TOPK_FRACTION, pallas=True))
    if name == "terngrad":
        return get_codec("terngrad", use_pallas=True)
    return get_codec(name)


def check_reference(model, code_name: str, model_name: str,
                    exact: bool = False) -> None:
    """A grads-only step on the card against the same step on the CPU,
    where every wrapper takes its plain version; ``exact``: the same
    arithmetic on both devices, so equal bit for bit."""
    from pytorch_ps_mpi_tpu_torch import SGD

    gen = torch.Generator().manual_seed(2)
    cpu = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
    gpu = {k: p.cuda() for k, p in cpu.items()}
    grads = {k: 1e-2 * torch.randn((1,) + tuple(p.shape), generator=gen)
             for k, p in cpu.items()}
    opts = [SGD(params, lr=0.01, momentum=0.9, code=make_codec(code_name),
                device=dev) for params, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    for _ in range(2):
        opts[0].step(grads=grads)
        opts[1].step(grads={k: g.cuda() for k, g in grads.items()})
    worst = 0.0
    for k in cpu:
        a, b = cpu[k], gpu[k].cpu()
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        worst = max(worst, float((a - b).abs().max()))
    if exact and worst != 0.0:
        raise AssertionError(f"SGD({code_name}) on the card differs from the "
                             f"CPU by {worst}")
    phase("reference", step=f"grads-only SGD({code_name}) x2",
          model=model_name, rtol=1e-6, max_abs_diff=worst)


def shared_noise_terngrad(seed: int):
    """``terngrad(use_pallas=True)`` whose encode draws its random numbers
    on the CPU from its own seeded generator and moves them to the leaf's
    device, so optimizers on two devices get the same numbers."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    code = get_codec("terngrad", use_pallas=True)
    gen = torch.Generator().manual_seed(seed)

    def encode(grad, state=(), rng=None):
        sublane = code._pallas_ok(grad.numel())

        def noise(chunk, size):
            r = (torch.randint(-2**31, 2**31, (size,), generator=gen,
                               dtype=torch.int32) if sublane
                 else torch.rand(size, generator=gen))
            return r.to(grad.device)

        return code.ternarize(grad, noise), state

    code.encode = encode
    return code


def check_bert_reference(model) -> None:
    """One grads-only Adam(terngrad(use_pallas=True)) step of BERT-base on
    the card against the same step on the CPU (the plain versions), the
    same random numbers on both sides; rtol 1e-6."""
    from pytorch_ps_mpi_tpu_torch import Adam

    gen = torch.Generator().manual_seed(8)
    cpu = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
    gpu = {k: p.detach().clone() for k, p in model.named_parameters()}
    grads = {k: 1e-3 * torch.randn((1,) + tuple(p.shape), generator=gen)
             for k, p in cpu.items()}
    opts = [Adam(params, lr=1e-4, code=shared_noise_terngrad(9), device=dev)
            for params, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    opts[0].step(grads=grads)
    opts[1].step(grads={k: g.cuda() for k, g in grads.items()})
    worst = 0.0
    for k in cpu:
        a, b = cpu[k], gpu[k].cpu()
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        worst = max(worst, float((a - b).abs().max()))
    phase("reference", step="grads-only Adam(terngrad(use_pallas=True)) x1",
          model="BERT-base", leaves=len(cpu), rtol=1e-6, max_abs_diff=worst)


def check_bert_flash(model) -> None:
    """BERT-base's loss and gradients (b4 s512, bf16) with the flash
    kernels against the same with their plain versions on the card.
    Tolerance: the loss to 1e-2 relative and all gradients together to 5e-2
    relative L2. The kernels and the plain versions round p and ds to bf16
    at the same points but against other running maxima (a few bf16 ulps
    of 2**-9 in each attention output), and twelve layers of bf16
    activations carry that difference into every gradient."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch.data import synthetic_mlm
    from pytorch_ps_mpi_tpu_torch.models import mlm_loss
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    b = next(synthetic_mlm(BERT_BATCH, BERT_SEQ, model.cfg.vocab_size,
                           seed=1, device="cuda"))

    def loss_and_grads():
        params = {k: p.detach().requires_grad_()
                  for k, p in model.named_parameters()}
        loss = mlm_loss(functional_call(model, params, (b["tokens"],)),
                        b["targets"], b["mask"])
        return float(loss.detach()), torch.autograd.grad(
            loss, list(params.values()))

    before = (A.flash_fwd.launches, A.flash_bwd.launches)
    loss_k, g_k = loss_and_grads()
    if (A.flash_fwd.launches - before[0],
            A.flash_bwd.launches - before[1]) != (12, 24):
        raise AssertionError("a BERT-base loss step must launch 12 forward "
                             "and 24 backward flash kernels")
    kernels = A.flash_fwd, A.flash_bwd
    A.flash_fwd, A.flash_bwd = A.flash_fwd_ref, A.flash_bwd_ref
    try:
        loss_p, g_p = loss_and_grads()
    finally:
        A.flash_fwd, A.flash_bwd = kernels
    diff = math.sqrt(sum(float(((a - c) ** 2).sum()) for a, c in zip(g_k, g_p)))
    norm = math.sqrt(sum(float((c ** 2).sum()) for c in g_p))
    worst_leaf = max(float((a - c).norm() / c.norm().clamp(min=1e-30))
                     for a, c in zip(g_k, g_p))
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    if rel_loss > 1e-2 or diff / norm > 5e-2:
        raise AssertionError(f"flash vs plain attention on BERT-base: loss "
                             f"{loss_k} vs {loss_p}, gradient rel L2 "
                             f"{diff / norm}")
    phase("reference", step="BERT-base loss+grads, flash kernels vs plain",
          loss_kernel=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}",
          loss_rel=f"{rel_loss:.3e}", grad_rel_l2=f"{diff / norm:.3e}",
          worst_leaf_rel_l2=f"{worst_leaf:.3e}")


# -- the main paths -------------------------------------------------------------

def kernel_counters() -> dict:
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q
    from pytorch_ps_mpi_tpu_torch.ops import sign as S
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    from pytorch_ps_mpi_tpu_torch.ops import attention as A
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    return {"encode_signs": S.encode_signs, "pack_signs": S.pack_signs,
            "unpack_signs": S.unpack_signs, "quantize_int8": Q.quantize_int8,
            "dequantize_int8": Q.dequant_sum, "exact_topk": T.exact_topk,
            "tern_pack": TG.tern_pack, "tern_unpack": TG.tern_unpack_sum,
            "flash_fwd": A.flash_fwd, "flash_bwd": A.flash_bwd}


def run_main_path(model, code_name: str, dataset: str, batch: int,
                  per_step: dict, model_name: str) -> dict:
    """5 loss_fn steps and 1 grads-only step of SGD on a ResNet; the launch
    counts of the run must equal ``per_step`` (kernel -> launches a step)
    x 6."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)

    opt = SGD(model, lr=0.01, momentum=0.9, code=make_codec(code_name),
              device="cuda")
    # drawn before the timed steps: the ImageNet generator makes a 602 MB
    # class-mean table and 77 MB per batch on the host
    stream = synthetic_images(dataset, batch, seed=0, device="cuda")
    batches = [next(stream) for _ in range(LOSS_STEPS + 1)]

    def loss_fn(params, b):
        x, y = b
        return cross_entropy_loss(functional_call(model, params, (x,)), y)

    return drive(opt, loss_fn, batches, per_step, per_step, code_name,
                 model=model_name, batch=batch)


def run_bert_path(model, code_name: str, per_loss_step: dict,
                  per_grads_step: dict) -> dict:
    """5 loss_fn steps and 1 grads-only step of Adam(lr=1e-4) on BERT-base
    MLM at batch 4, sequence 512."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import Adam
    from pytorch_ps_mpi_tpu_torch.data import synthetic_mlm
    from pytorch_ps_mpi_tpu_torch.models import mlm_loss

    opt = Adam(model, lr=1e-4, code=make_codec(code_name), device="cuda")
    stream = synthetic_mlm(BERT_BATCH, BERT_SEQ, model.cfg.vocab_size,
                           seed=0, device="cuda")
    batches = [next(stream) for _ in range(LOSS_STEPS + 1)]

    def loss_fn(params, b):
        logits = functional_call(model, params, (b["tokens"],))
        return mlm_loss(logits, b["targets"], b["mask"])

    return drive(opt, loss_fn, batches, per_loss_step, per_grads_step,
                 code_name, model="BERT-base-mlm-bf16-flash",
                 batch=f"{BERT_BATCH}x{BERT_SEQ}")


def drive(opt, loss_fn, batches, per_loss_step: dict, per_grads_step: dict,
          code_name: str, **fields) -> dict:
    """``LOSS_STEPS`` loss_fn steps and 1 grads-only step; every kernel
    count is set to 0 just before and read just after, and must equal
    ``per_loss_step`` x ``LOSS_STEPS`` + ``per_grads_step``."""
    before = {k: p.detach().clone() for k, p in opt.params.items()}
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    losses, step_ms = [], []
    for b in batches[:LOSS_STEPS]:
        loss, data = opt.step(loss_fn=loss_fn, batch=b)
        losses.append(float(loss))
        step_ms.append(data["step_time"] * 1e3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = {k: 1e-3 * torch.randn((WORLD,) + tuple(p.shape), generator=gen,
                                   device="cuda")
             for k, p in opt.params.items()}
    _, data = opt.step(grads=grads)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    del grads

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(torch.isfinite(p).all() for p in opt.params.values()):
        raise AssertionError("non-finite parameters")
    if all(torch.equal(before[k], p) for k, p in opt.params.items()):
        raise AssertionError("the parameters did not change")
    del before
    want = {name: per_loss_step.get(name, 0) * LOSS_STEPS
            + per_grads_step.get(name, 0) for name in counters}
    if launches != want:
        raise AssertionError(f"{code_name}: launches {launches}, expected "
                             f"{want}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(step_ms)
    profile_step(opt, loss_fn, batches[-1], code_name)
    phase("main_path", code=code_name, **fields,
          params=sum(p.numel() for p in opt.params.values()),
          leaves=len(opt.params), world=WORLD,
          losses=json.dumps([round(v, 5) for v in losses]),
          step_ms=json.dumps([round(v, 3) for v in step_ms]),
          median_step_ms=f"{median:.3f}",
          grads_step_ms=f"{data['step_time'] * 1e3:.3f}",
          peak_mem_gb=f"{peak_gb:.2f}",
          cudnn_tf32=torch.backends.cudnn.allow_tf32,
          matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")))
    return launches


def profile_step(opt, loss_fn, batch, code_name: str) -> None:
    """One more loss_fn step under torch.profiler, after the launch counts
    were read: the device's busy time against the step's wall time, and
    the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, data = opt.step(loss_fn=loss_fn, batch=batch)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in _device_events(prof)), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    wall_ms = data["step_time"] * 1e3
    top = [{"name": k[:48], "ms": round(t / 1e3, 4), "calls": c}
           for k, t, c in rows[:8]]
    phase("profile", code=code_name, wall_ms=f"{wall_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.3f}",
          top=json.dumps(top, separators=(",", ":")))


SOURCES = {
    "encode_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:68"),
    "pack_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:104"),
    "unpack_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:131"),
    "quantize_int8": ("quant.cu",
                      "pytorch_ps_mpi_tpu/ops/quant_pallas.py:64"),
    "dequantize_int8": ("quant.cu",
                        "pytorch_ps_mpi_tpu/ops/quant_pallas.py:118"),
    "exact_topk": ("topk.cu", "pytorch_ps_mpi_tpu/ops/topk_pallas.py:67"),
    "tern_pack": ("tern.cu", "pytorch_ps_mpi_tpu/ops/tern_pallas.py:61"),
    "tern_unpack": ("tern.cu", "pytorch_ps_mpi_tpu/ops/tern_pallas.py:97"),
    # bf16, the main path's type (float32: attention.cu, the CUDA cores)
    "flash_fwd": ("attention_tc.cu",
                  "pytorch_ps_mpi_tpu/ops/attention_pallas.py:143"),
    "flash_bwd": ("attention_tc.cu",
                  "pytorch_ps_mpi_tpu/ops/attention_pallas.py:267"),
}


def main() -> int:
    check_device()
    # stated and set: f32 matmuls in full f32, f32 convolutions in TF32
    # (cuDNN's default), so the step runs as a PyTorch user's would
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.set_device(0)

    from pytorch_ps_mpi_tpu_torch import mesh
    from pytorch_ps_mpi_tpu_torch.models import (BertConfig, BertMLM,
                                                 ResNet18, ResNet50)

    def resnet18():
        return ResNet18(num_classes=10, small_inputs=True, seed=0,
                        device="cuda")

    def resnet50():
        return ResNet50(num_classes=1000, seed=0, device="cuda")

    def bert_base():
        return BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                       seed=0, device="cuda")

    build_kernels()
    model = resnet18()
    r50 = resnet50()
    results = check_kernels(kernel_sizes(model))
    results.update(check_quant_kernels(model))
    leaves = topk_leaves(r50)
    topk_launches, topk_results = check_topk_kernels(leaves)
    results.update(topk_results)
    check_decode_sum(model)
    check_reference(model, "sign", "ResNet18-cifar-gn-f32")
    check_reference(model, "int8", "ResNet18-cifar-gn-f32", exact=True)
    check_reference(r50, "ef_topk", "ResNet50-imagenet-gn-f32", exact=True)
    del r50
    bert = bert_base()
    results.update(check_tern_kernels(bert))
    results.update(check_flash_kernels())
    check_bert_reference(bert)
    check_bert_flash(bert)
    del bert
    torch.cuda.empty_cache()

    r18 = sum(1 for _ in model.parameters())
    runs = [
        ("identity", resnet18, "cifar10", BATCH, {}),
        ("sign", lambda: model, "cifar10", BATCH,
         {"encode_signs": 20, "unpack_signs": 20 * WORLD}),
        ("int8", resnet18, "cifar10", BATCH,
         {"quantize_int8": r18, "dequantize_int8": r18}),
        ("qsgd", resnet18, "cifar10", BATCH, {"dequantize_int8": r18}),
        ("ef_topk", resnet50, "imagenet", BATCH_IMAGENET,
         {"exact_topk": topk_launches * len(leaves)}),
    ]
    # BERT-base: 12 flash forward and 12 + 12 backward launches a loss
    # step, none in the grads-only step; TernGrad packs 61 leaves whole and
    # the two 23,440,896-element leaves in 23 chunks each, and unpack-sums
    # its 63 sublane-layout leaves, in every step
    flash = {"flash_fwd": 12, "flash_bwd": 24}
    tern = {"tern_pack": 61 + 2 * 23, "tern_unpack": 63}
    bert_runs = [("identity", flash, {}),
                 ("terngrad", {**flash, **tern}, tern)]
    launches = {}
    mesh.initialize_distributed(f"tcp://localhost:{free_port()}",
                                world_size=WORLD, rank=0, backend="nccl")
    try:
        for code, make_model, dataset, batch, per_step in runs:
            name = ("ResNet50-imagenet-gn-f32" if dataset == "imagenet"
                    else "ResNet18-cifar-gn-f32")
            got = run_main_path(make_model(), code, dataset, batch, per_step,
                                name)
            for kernel in per_step:
                launches.setdefault(kernel, got[kernel])
        for code, per_loss, per_grads in bert_runs:
            got = run_bert_path(bert_base(), code, per_loss, per_grads)
            for kernel in per_loss:
                launches[kernel] = got[kernel]
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    launches.setdefault("pack_signs", 0)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"pytorch_ps_mpi_tpu_torch/csrc/{SOURCES[name][0]}",
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in results.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    sys.exit(main())

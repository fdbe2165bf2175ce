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
               at the main paths' leaf sizes and the sizes of their
               buckets at bucket_mb=16 (the plan over the JAX leaf
               order), with planted cases:
               - the sign kernels at ResNet-18's 20 kernel-path leaves and
                 its 2 kernel-layout buckets, at
                 one row below, at and above the rows one encode block
                 sums, and past the co-resident grid (bytes bit-exact, |x|
                 sum within rtol 1e-6, -0.0 and NaN); the unpack-sum
                 there at world 1 and 8 with zero, subnormal, +Inf and NaN
                 scales, sums below the smallest normal float and a view
                 one byte into its buffer (bit-exact, NaN by position),
                 timed over the 20 leaves at each world;
               - int8 quantize and dequantize-sum at ResNet-18's 62 leaves
                 and 4 buckets, world 1 and world 8, and quantize also one
                 below, at and
                 above its tile and past the co-resident grid (codes,
                 scales and floats bit-exact; NaN, ±Inf, ±0.0 and exact .5
                 ties);
               - for the one-launch quantize, sign encode and unpack-sum:
                 the grid each leaf size takes, one device row a call
                 (asserted), and the largest leaf's cold device ms against
                 its byte bound;
               - int8 dequantize-sum also at n % 16 == 0, n % 16 == 4,
                 odd n and a view that starts one byte in, and at the
                 largest leaf (2,359,296 codes) at world 8;
               - the top-k radix threshold and the whole exact top-k at
                 ResNet-50's 53 kernel-path leaves with k = round(0.01 n)
                 (histograms, thresholds, index arrays and values
                 bit-exact; heavy |x| ties, NaN, ±Inf, ±0.0, all ties, all
                 zeros, k = 1, k = n − 1, more NaNs than k, odd n from a
                 misaligned view, run-to-run identity);
               - TernGrad's pack at BERT-base's 63 sublane-layout leaves and
                 15 such buckets as the codec calls it (the two
                 23,440,896-element units in chunks of 2**20), and its
                 unpack-sum there at world 1 and 8
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
4. decode_sum -- 1 and 8 stacked sign payloads for every ResNet-18 leaf
               through ``SignCodec.decode_sum``: bit-exact against the
               plain fold, one device row a kernel-layout leaf (asserted),
               and its ms and device ms over the 20 kernel leaves.
5. reference -- grads-only steps on the card against the same steps on the
               CPU (the plain versions), rtol 1e-6: SGD(sign) and
               SGD(int8) on ResNet-18, SGD(sign) also at bucket_mb=16 and
               SGD(int8) at bucket_mb=16 in allgather and in leader mode
               (bit-exact), SGD(ef∘topk) on ResNet-50, and
               Adam(terngrad(use_pallas=True)) on BERT-base per leaf and at
               bucket_mb=16, with the same random numbers on both sides
               and the card's TernGrad launches asserted; then BERT-base's
               loss and
               gradients with the flash kernels against the same with their
               plain versions on the card (bf16, see ``check_bert_flash``).
               Then the codecs without a kernel, at the settings of
               ``benchmarks/bert_bench.py:156-162``: phase ``sync`` runs
               the encode and decode-sum of random-k, block top-k, block
               top-k int8 and threshold on every BERT-base leaf under
               ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
               ``reference`` holds each on the card against the CPU at
               BERT-base's own leaves (the embedding, an FFN kernel, an
               attention output kernel, the 30,522-element bias, a [768]
               bias; payloads and decode-sums bit-exact, PowerSGD's
               two-all-reduce protocol over three steps within 1e-4 of
               each tensor's largest magnitude); ``powersgd_qr`` times the
               51 QRs of PowerSGD's step and calls them, and the whole
               protocol, behind a spin kernel (does either wait on the
               device?); the powersgd-r4 run's ``profile`` line gives
               the QRs' device time and share of its step.
6. main path -- a one-rank NCCL process group, then 5 ``step(loss_fn=...)``
               calls and 1 ``step(grads=...)`` call of each of: identity
               (no kernel), sign, int8 and qsgd on ResNet-18 (CIFAR stem,
               GroupNorm, f32) at batch 256, and ef∘topk(fraction=0.01,
               pallas=True) on ResNet-50 (ImageNet stem, 1000 classes) at
               224x224, batch 128; then Adam(lr=1e-4) with identity and
               terngrad(use_pallas=True) on BERT-base MLM (132,361,530
               parameters in 150 leaves, bf16 compute, float32 parameters,
               attention="flash") at batch 4, sequence 512. Then the
               bucketed runs at bucket_mb=16, parameters in the JAX leaf
               order: ResNet-18 SGD with sign and int8 in allgather mode
               and int8 in leader mode (ZeRO-1, payload_gather at world
               1), BERT-base Adam with terngrad(use_pallas=True) in
               allgather mode and identity in leader mode (psum_scatter,
               the state kept a bucket at a time). Then BERT-base Adam with
               powersgd(rank=4), blocktopk and blocktopk8 (fraction 0.01),
               randomk(fraction=0.01) per leaf and at bucket_mb=16, and
               threshold(tau=2, max_fraction=0.05). Every kernel count and
               the collective counter (``comms.calls``) are set to 0 just
               before a run and read just after it; the kernel counts must
               equal the run's exact launches (flash only in loss steps:
               12 forward and 12 + 12 backward launches a step; a
               bucketed run's codec launches from its own bucket plan,
               which must give the JAX plan's), and the collective calls
               of the grads-only step a fixed table (62/124/124/124/322
               per leaf on the ResNets, 150/300 on BERT-base; 8, 8, 12,
               56 and 28 reduce-scatters + 28 all-gathers bucketed;
               PowerSGD 201 all-reduces, block top-k and random-k 300
               all-gathers, block top-k int8 and threshold 450, random-k
               bucketed 56), plus one all-reduce of the loss a loss step;
               the codecs without a kernel launch none.
               One more step then runs under torch.profiler (phase
               ``profile``): the device's busy time against the step's
               wall time and the kernels that take the most of it.

7. training -- in the same process group, with cuDNN deterministic, every
               run's kernel counts and collective calls asserted exactly:
               ResNet-18 (CIFAR stem, SyncBatchNorm, f32) SGD(sign) at
               batch 256 through ``Trainer.fit``, 8 steps in two
               ``run_steps`` calls, checkpointing every 4 (20 + 20 sign
               launches a step; 144 all-gathers and 22 all-reduces a step:
               the gradients' 124, one all-gather and one all-reduce a
               BatchNorm layer, the running statistics' all-reduce and the
               loss's); a fresh Trainer restored from the step-4
               checkpoint of a 4-step run (a directory of its own) and run
               4 more equals it bit for bit (parameters, running statistics,
               momentum), and ``run_steps(4)`` equals 4 ``step`` calls bit
               for bit (two rounds, the second in the other order, both
               wall times printed). BERT-base Adam(terngrad(use_pallas=True)) through
               ``step_accumulate`` over 2 microbatches of 4 x 512 (24 + 48
               flash launches and 107 + 63 TernGrad launches a step; 300
               all-gathers + 1), then the same with ``instrument=True``
               (every stage timed, the stages within ``step_time``, the
               parameters the fused run's bit for bit). ResNet-18 SGD(int8):
               ``make_sync_train_step`` per leaf and at bucket_mb=16 equals
               ``MPI_PS.step`` bit for bit over 3 steps, and an
               ``instrument=True`` step equals the fused one (3 steps). Last,
               ``python -m pytorch_ps_mpi_tpu_torch.launch ... train.py
               --config resnet18_cifar10 --norm batch --codec int8 --steps
               3`` in a subprocess exits 0 with a finite ``final_loss``.
               Each path in this process prints its median step ms, peak
               GB and (one more step under torch.profiler) its idle share;
               the CLI its seconds and ``Trainer.fit``'s mean step ms.

Phase ``done`` gives the seconds the whole run took. The line before the
last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. This script imports
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


#: runtime calls that put one row on the device: a kernel, memset or copy
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                 "cudaMemcpy", "cuMemcpy")
_LEAD = 256  # spin kernels that open every trace, there to be dropped
_TAKES = 5  # traces taken before a short one fails the run


def _profiled(fn, cold: bool = False) -> list:
    """The device rows of one call of ``fn``, in launch order, after a
    warm-up call; ``cold``: with the 50 MB L2 flushed just before. Late
    in a long run of this script on an H100 the profiler dropped the
    first device rows of a trace (all of a one-kernel trace, the first of
    20 decode_sum calls, once 102 rows early in a run; PERF.md §7), while
    it still recorded every runtime launch call. So each trace opens with
    ``_LEAD`` spin kernels, and is whole only when its other device rows
    match the launch calls made after them; a trace short of rows is
    taken again, ``_TAKES`` times in all, and then fails the run."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    fn()
    for _ in range(_TAKES):
        if cold:
            torch.empty(2**27, dtype=torch.int8, device="cuda").fill_(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(_LEAD):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        rows = sorted((e for e in events if e.device_type == cuda
                       and "spin_kernel" not in e.name),
                      key=lambda e: e.time_range.start)
        launched = sum(e.name.startswith(_LAUNCH_CALLS) for e in events
                       if e.device_type != cuda) - _LEAD
        if rows and len(rows) == launched:
            return rows
    raise AssertionError(f"{_TAKES} profiler traces lost device rows: "
                         f"{len(rows)} of {launched} launched")


def device_ms(fn, cold: bool = False) -> float:
    """Device time of the kernels one call of ``fn`` launches, summed
    from torch.profiler's trace (no host time between launches); ``cold``:
    with the L2 flushed, so the inputs come from device memory as the byte
    bound assumes."""
    return sum(e.self_device_time_total for e in _profiled(fn, cold)) / 1e3


def device_launches(fn) -> int:
    """The device rows (kernels and memsets) one call of ``fn`` makes."""
    return len(_profiled(fn))


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


def bucket_sizes(model) -> list:
    """The element counts of ``model``'s buckets at ``BUCKET_MB``: the plan
    the bucketed main paths build over its parameters in JAX leaf order."""
    from pytorch_ps_mpi_tpu_torch.bucketing import plan_buckets

    plan = plan_buckets(ordered_params(model), BUCKET_MB)
    return [b.size for b in plan.buckets]


def check_kernels(sizes: list, buckets: list) -> dict:
    """Bit-exactness and timing of the three sign kernels, at the leaf
    ``sizes`` and the kernel-layout ``buckets`` of the main paths."""
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    gen = torch.Generator(device="cuda").manual_seed(0)
    one, past = sign_edge_rows()
    kernel_buckets = [n for n in buckets if n % S.GROUP == 0]
    if len(kernel_buckets) != PLAN_LAUNCHES["sign"]["encode_signs"]:
        raise AssertionError(f"sign: kernel-layout buckets {kernel_buckets}")
    cases = sorted(set(sizes + kernel_buckets)) + [S.GROUP, 13 * S.GROUP] + [
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
        report(name, r, leaves=len(sizes), cases=2 * len(cases),
               buckets_checked=len(kernel_buckets))
    results["unpack_signs_sum"] = check_unpack_sum(sizes, cases, gen)
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


def _unpack_sum_case(m: int, world: int, case: str, gen) -> tuple:
    """Packed bits [world, m] and float32 scales [world] on the card:
    ``planted``: rank 0's scale 0.0 (each -0 folds to +0), then a
    subnormal and scales within [1, 2) x the smallest normal float, whose
    sums fall below it (flushed); ``nonfinite``: +Inf, and NaN in rank 5;
    ``unaligned``: a view one byte into its buffer."""
    offset = 1 if case == "unaligned" else 0
    buf = torch.randint(0, 256, (world * m + offset,), generator=gen,
                        device="cuda", dtype=torch.uint8)
    scales = torch.rand(world, generator=gen, device="cuda") + 0.1
    tiny = torch.finfo(torch.float32).tiny
    planted = {"planted": [0.0, 3e-39] + [tiny * (1 + w / 16)
                                          for w in range(1, 7)],
               "nonfinite": [math.inf, 0.5, 0.25, 2.0, 1.0, math.nan, 0.5,
                             0.125]}
    if case in planted:
        scales = torch.tensor(planted[case][:world], device="cuda")
    return buf[offset:].view(world, m), scales


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same places, every other element bit for bit."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


def check_unpack_sum(sizes: list, cases: list, gen) -> dict:
    """``unpack_signs_sum`` at world 1 and 8: bit-exact against its plain
    version at every sign case size, plain, planted, non-finite and
    unaligned; then over the 20 leaves at each world its times, one
    device row a call and the largest leaf's cold share of its bound.
    Returns the world-1 row (the main path's world)."""
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    checked = 0
    for world in (1, 8):
        for n in cases:
            for case in ("plain", "planted", "nonfinite", "unaligned"):
                packed, scales = _unpack_sum_case(n // 8, world, case, gen)
                got = S.unpack_signs_sum(packed, scales)
                if not _same_bits(got, S.unpack_signs_sum_ref(packed,
                                                              scales)):
                    raise AssertionError(f"unpack_signs_sum differs at "
                                         f"n={n}, world={world}, {case}")
                if case == "planted" and world == 1 \
                        and torch.signbit(got).any():
                    raise AssertionError("a -0 survived the fold from +0")
                checked += 1
    rows = {}
    for world in (1, 8):
        args = [_unpack_sum_case(n // 8, world, "plain", gen)
                for n in sizes]
        r = timed(lambda p, s: S.unpack_signs_sum(p, s),
                  lambda p, s: S.unpack_signs_sum_ref(p, s), args,
                  lambda p, s: p.numel() + 4 * s.numel() + 32 * p.shape[1])
        r["max_abs_err"] = 0.0  # bit-exact, asserted above
        report("unpack_signs_sum", r, world=world, leaves=len(sizes),
               cases=checked)
        scales = args[0][1]
        one_launch_design(
            "unpack_signs_sum", lambda p: S.unpack_signs_sum(p, scales),
            [p for p, _ in args],
            lambda n: -(-n // world // S.LANE // 8),
            lambda n: n + 4 * world + 32 * n // world, world=world,
            sizes_in="packed bytes, world x m")
        rows[world] = r
    return rows[1]


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
    leaf size the grid it chose and one call's device µs (warm), from one
    trace of one call a size, which must hold one device row a call (no
    memset, no second kernel), and the largest leaf's cold device ms
    against its byte bound."""
    by_size = {x.numel(): x for x in xs}
    sizes = sorted(by_size)
    rows = _profiled(lambda: [fn(by_size[n]) for n in sizes])
    if len(rows) != len(sizes):
        raise AssertionError(f"{kernel}: {len(rows)} device rows for "
                             f"{len(sizes)} calls, not 1 a call")
    n = sizes[-1]
    cold = device_ms(lambda: fn(by_size[n]), cold=True)
    bound = nbytes(n) / HBM_BYTES_PER_S * 1e3
    phase("kernels", kernel=kernel, design="one launch a call", **tile,
          block=256, device_rows_per_call=1,
          grids=json.dumps({m: grid(m) for m in sizes},
                           separators=(",", ":")),
          device_us=json.dumps(
              {m: round(e.self_device_time_total, 3)
               for m, e in zip(sizes, rows)}, separators=(",", ":")),
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
    leaves and its buckets at ``BUCKET_MB``: bit-exact at world 1 and 8,
    planted cases, and timing (over the leaves)."""
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q

    sizes = [p.numel() for p in model.parameters()]
    if len(sizes) != 62:
        raise AssertionError(f"expected 62 leaves, got {len(sizes)}")
    buckets = bucket_sizes(model)
    if len(buckets) != PLAN_LAUNCHES["int8"]["quantize_int8"]:
        raise AssertionError(f"int8: buckets {buckets}")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def same(a, b, what):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs from its plain version")

    cases = 0
    tile = Q._tile()
    past = Q._lib().quant_int8_grid(1 << 40) * tile + 4099
    for n in sorted(set(sizes + buckets)) + [4099, 1000, tile - 1, tile,
                                             tile + 1, past]:
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
    for n in sorted(set(sizes + buckets)) + [4099, 1000, 1028,
                                             2_359_296 + 4]:
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
    phase("kernels", check="int8 bit-exact",
          sizes=len(set(sizes + buckets)) + 6,
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

def tern_units(sizes) -> list:
    """Per sublane-layout unit (leaf or bucket) of these element counts,
    the element counts of its ``tern_pack`` calls as
    ``TernGradCodec(use_pallas=True)`` makes them: the whole unit, or its
    chunks at or above the scan threshold."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    code = get_codec("terngrad", use_pallas=True)
    units = []
    for n in sizes:
        if not code._pallas_ok(n):
            continue
        if n < code.scan_threshold:
            units.append([n])
        else:
            full, tail = divmod(n, code.scan_block)
            units.append([code.scan_block] * full + ([tail] if tail else []))
    return units


def tern_calls(model) -> list:
    """:func:`tern_units` of ``model``'s leaves: BERT-base's 107
    ``tern_pack`` calls a per-leaf step."""
    leaves = tern_units(p.numel() for p in model.parameters())
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
    """``tern_pack`` at BERT-base's 107 calls a per-leaf step and the 59 of
    a step at ``BUCKET_MB``, and the unpack-sum at its 63 sublane-layout
    leaves and 15 such buckets (world 1 and 8): bit-exact against the
    plain versions, planted cases, and timing (over the leaves)."""
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    leaves = tern_calls(model)
    calls = [c for leaf in leaves for c in leaf]
    buckets = tern_units(bucket_sizes(model))
    got = {"tern_pack": sum(len(b) for b in buckets),
           "tern_unpack": len(buckets)}
    if got != PLAN_LAUNCHES["terngrad"]:
        raise AssertionError(f"terngrad buckets give {got}")
    pack_sizes = sorted({c for unit in leaves + buckets for c in unit})
    unit_sizes = sorted({sum(unit) for unit in leaves + buckets})
    gen = torch.Generator(device="cuda").manual_seed(6)
    for n in pack_sizes:
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
    for m in [n // 4 for n in unit_sizes]:
        for world in (1, 8):
            packed = torch.randint(0, 256, (world, m), generator=gen,
                                   device="cuda", dtype=torch.uint8)
            scales = torch.rand(world, generator=gen, device="cuda")
            got = TG.tern_unpack_sum(packed, scales)
            want = TG.tern_unpack_sum_ref(packed, scales)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"tern_unpack_sum differs at m={m}, "
                                     f"world {world}")
    phase("kernels", check="terngrad bit-exact", pack_sizes=len(pack_sizes),
          unpack_sizes=len(unit_sizes), unpack_worlds="1,8",
          units="leaves and buckets",
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
    """1 and 8 workers' sign payloads for every leaf through decode_sum:
    the kernel path bit-exact against the plain fold of ``unpack_signs_ref
    * scale``; one device row a kernel-layout leaf (the rank-by-rank fold
    made 1 + 3 x world); decode_sum's time over the 20 kernel leaves."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    code = get_codec("sign")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for workers in (1, 8):
        calls = []
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
                    raise AssertionError(f"decode_sum differs, shape {shape}"
                                         f", {workers} workers")
                calls.append((stacked, shape))

        def step():
            for stacked, shape in calls:
                code.decode_sum(stacked, shape, torch.float32)

        events = _profiled(step)
        rows = len(events)
        names = {e.name for e in events}
        if rows != len(calls) or not all("sign_unpack_sum" in k
                                         for k in names):
            raise AssertionError(f"decode_sum: {rows} device rows ({names}) "
                                 f"for {len(calls)} kernel leaves, not 1 a "
                                 f"leaf")
        nbytes = sum(st["packed"].numel() + 4 * workers
                     + 32 * st["packed"].shape[1] for st, _ in calls)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        phase("decode_sum", workers=workers, kernel_leaves=len(calls),
              all_leaves=len(list(model.parameters())), bit_exact=True,
              device_rows=rows, ms=f"{cuda_ms(step):.4f}",
              device_ms=f"{busy:.4f}",
              bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f}")


def make_codec(name: str):
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    if name == "ef_topk":
        return get_codec("ef", inner=get_codec(
            "topk", fraction=TOPK_FRACTION, pallas=True))
    if name == "terngrad":
        return get_codec("terngrad", use_pallas=True)
    if name in BERT_CODECS:
        codec, kw = BERT_CODECS[name]
        return get_codec(codec, **kw)
    return get_codec(name)


def check_reference(model, code_name: str, model_name: str,
                    exact: bool = False, **opt_kw) -> None:
    """A grads-only step on the card against the same step on the CPU,
    where every wrapper takes its plain version; ``exact``: the same
    arithmetic on both devices, so equal bit for bit. ``opt_kw``
    (``bucket_mb``, ``mode``) go to both optimizers, whose parameters are
    in the JAX package's leaf order, as the main path's bucketed runs
    give them."""
    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.utils.interop import jax_leaf_order

    gen = torch.Generator().manual_seed(2)
    named = dict(model.named_parameters())
    cpu = {k: named[k].detach().cpu().clone() for k in jax_leaf_order(model)}
    gpu = {k: p.cuda() for k, p in cpu.items()}
    grads = {k: 1e-2 * torch.randn((1,) + tuple(p.shape), generator=gen)
             for k, p in cpu.items()}
    opts = [SGD(params, lr=0.01, momentum=0.9, code=make_codec(code_name),
                device=dev, **opt_kw)
            for params, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    for _ in range(2):
        opts[0].step(grads=grads)
        opts[1].step(grads={k: g.cuda() for k, g in grads.items()})
    worst = 0.0
    for k in cpu:
        a, b = cpu[k], gpu[k].cpu()
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        worst = max(worst, float((a - b).abs().max()))
    if exact and worst != 0.0:
        raise AssertionError(f"SGD({code_name}, {opt_kw}) on the card "
                             f"differs from the CPU by {worst}")
    phase("reference", step=f"grads-only SGD({code_name}) x2",
          model=model_name, **opt_kw,
          buckets=opts[1]._metrics["bucket_count"],
          wire_lowering=opts[1]._metrics["wire_lowering"], rtol=1e-6,
          max_abs_diff=worst)


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


def check_bert_reference(model, tern_launches: dict, **opt_kw) -> None:
    """One grads-only Adam(terngrad(use_pallas=True)) step of BERT-base on
    the card against the same step on the CPU (the plain versions), the
    same random numbers on both sides; rtol 1e-6. ``opt_kw``
    (``bucket_mb``) go to both optimizers, whose parameters are in the JAX
    leaf order; the card's step must launch the TernGrad kernels
    ``tern_launches`` times."""
    from pytorch_ps_mpi_tpu_torch import Adam

    gen = torch.Generator().manual_seed(8)
    gpu = {k: p.detach().clone() for k, p in ordered_params(model).items()}
    cpu = {k: p.cpu() for k, p in gpu.items()}
    grads = {k: 1e-3 * torch.randn((1,) + tuple(p.shape), generator=gen)
             for k, p in cpu.items()}
    opts = [Adam(params, lr=1e-4, code=shared_noise_terngrad(9), device=dev,
                 **opt_kw)
            for params, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    counters = kernel_counters()
    before = {k: counters[k].launches for k in tern_launches}
    opts[0].step(grads=grads)
    opts[1].step(grads={k: g.cuda() for k, g in grads.items()})
    got = {k: counters[k].launches - before[k] for k in tern_launches}
    if got != tern_launches:
        raise AssertionError(f"BERT reference {opt_kw}: launches {got}, "
                             f"expected {tern_launches}")
    worst = 0.0
    for k in cpu:
        a, b = cpu[k], gpu[k].cpu()
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        worst = max(worst, float((a - b).abs().max()))
    phase("reference", step="grads-only Adam(terngrad(use_pallas=True)) x1",
          model="BERT-base", **opt_kw, leaves=len(cpu),
          buckets=opts[1]._metrics["bucket_count"],
          launches=json.dumps(got, separators=(",", ":")), rtol=1e-6,
          max_abs_diff=worst)


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


# -- the remaining codecs: random-k, block top-k (int8), threshold, PowerSGD --

#: the BERT-base codec runs, the settings of ``benchmarks/bert_bench.py:156-162``
BERT_CODECS = {
    "powersgd-r4": ("powersgd", {"rank": 4}),
    "blocktopk-1%": ("blocktopk", {"fraction": 0.01}),
    "blocktopk8-1%": ("blocktopk8", {"fraction": 0.01}),
    "randomk-1%": ("randomk", {"fraction": 0.01}),
    "threshold": ("threshold", {"tau": 2.0, "max_fraction": 0.05}),
}
SPARSE_CODECS = ("blocktopk-1%", "blocktopk8-1%", "randomk-1%", "threshold")
#: BERT-base leaves of the card-against-CPU phase: the embedding, an FFN
#: kernel, an attention output kernel, the 30,522-element bias (29 blocks
#: and 826 elements) and a [768] bias
REFERENCE_LEAVES = ("tok_emb.embedding", "layer_0.Dense_0.kernel",
                    "layer_0.SelfAttention_0.out.kernel", "mlm_head.bias",
                    "layer_0.Dense_0.bias")
POWERSGD_RTOL = 1e-4


def check_sparse_sync(model) -> None:
    """The sparse codecs' encode and decode-sum of every BERT-base leaf,
    one rank's payload stacked as the gather would stack it (the calls of
    a grads-only step, the collective left out), under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync raises."""
    shapes = [tuple(p.shape) for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(4)
    grads = [1e-3 * torch.randn(s, generator=gen, device="cuda")
             for s in shapes]
    for name in SPARSE_CODECS:
        code = make_codec(name)
        states = [code.init_state(s, torch.float32, "cuda") for s in shapes]
        rng = torch.Generator(device="cuda").manual_seed(5)

        def run():
            for g, st, s in zip(grads, states, shapes):
                payload, _ = code.encode(g, st, rng)
                code.decode_sum({k: v.unsqueeze(0) for k, v in payload.items()},
                                s, torch.float32)

        run()  # first calls: the strata and the allocator's pools
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            run()
            host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
        phase("sync", codec=name, leaves=len(shapes),
              sync_debug_mode="error", host_syncs=0,
              ms=f"{cuda_ms(run, reps=1, rounds=3):.3f}",
              host_ms=f"{host_ms:.3f}")
    del grads


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU as integers of its width, so -0.0 and NaN compare
    by their bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    return t


def _same_payload(a: dict, b: dict, what: str) -> None:
    if list(a) != list(b):
        raise AssertionError(f"{what}: payload keys {list(a)} and {list(b)}")
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(_bits(a[k]),
                                                       _bits(b[k])):
            raise AssertionError(f"{what}: payload {k!r} differs")


def check_codec_reference(model) -> None:
    """Each new codec on the card against the same calls on the CPU, at
    BERT-base's own leaves (:data:`REFERENCE_LEAVES`), two ranks' gradients
    drawn on the CPU: random-k (the same uniforms), block top-k and block
    top-k int8 payloads and decode-sums bit for bit; threshold's payload,
    length and decode-sum bit for bit; PowerSGD's two-all-reduce protocol
    (world 1, no process group) over three steps with the state carried,
    and its per-rank factors' decode-sum, within rtol
    :data:`POWERSGD_RTOL` of each tensor's largest magnitude (the card's
    matmuls and QR sum in another order than the CPU's)."""
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(7)
    leaves = {n: tuple(named[n].shape) for n in REFERENCE_LEAVES}
    grads = {n: [1e-3 * torch.randn(s, generator=gen) for _ in range(2)]
             for n, s in leaves.items()}
    for name in SPARSE_CODECS:
        code = make_codec(name)
        for leaf, shape in leaves.items():
            out = {}
            for dev in ("cpu", "cuda"):
                payloads = []
                for g in grads[leaf]:
                    g = g.to(dev)
                    if name.startswith("randomk"):
                        u = torch.rand(code._k_for(shape),
                                       generator=torch.Generator()
                                       .manual_seed(len(payloads)))
                        payloads.append(code.sample(g, u.to(dev)))
                    else:
                        payloads.append(code.encode(g, code.init_state(
                            shape, torch.float32, dev))[0])
                stacked = {k: torch.stack([p[k] for p in payloads])
                           for k in payloads[0]}
                out[dev] = (payloads, code.decode_sum(stacked, shape,
                                                      torch.float32))
            for r in range(2):
                _same_payload(out["cpu"][0][r], out["cuda"][0][r],
                              f"{name} {leaf} rank {r}")
            if not torch.equal(_bits(out["cpu"][1]), _bits(out["cuda"][1])):
                raise AssertionError(f"{name} {leaf}: decode_sum differs")
        phase("reference", codec=name, leaves=json.dumps(
            {n: list(s) for n, s in leaves.items()}, separators=(",", ":")),
            ranks=2, payload_bit_exact=True, decode_sum_bit_exact=True)

    code = make_codec("powersgd-r4")
    worst = {"summed": 0.0, "memory": 0.0, "decode_sum": 0.0}

    def rel(a, b) -> float:
        return float((a.cpu() - b).abs().max() / b.abs().max().clamp(
            min=1e-30))

    for leaf, shape in leaves.items():
        states = {dev: code.init_state(shape, torch.float32, dev)
                  for dev in ("cpu", "cuda")}
        for step in range(3):
            g = grads[leaf][step % 2] * (step + 1)
            got = {dev: code.fused_allreduce(g.to(dev), states[dev])
                   for dev in ("cpu", "cuda")}
            states = {dev: got[dev][1] for dev in got}
            worst["summed"] = max(worst["summed"],
                                  rel(got["cuda"][0], got["cpu"][0]))
            if states["cpu"]:
                worst["memory"] = max(worst["memory"], rel(
                    states["cuda"]["memory"], states["cpu"]["memory"]))
        sums = {}
        for dev in ("cpu", "cuda"):
            pls = [code.encode(g.to(dev), code.init_state(
                shape, torch.float32, dev))[0] for g in grads[leaf]]
            sums[dev] = code.decode_sum(
                {k: torch.stack([p[k] for p in pls]) for k in pls[0]},
                shape, torch.float32)
        worst["decode_sum"] = max(worst["decode_sum"],
                                  rel(sums["cuda"], sums["cpu"]))
    if max(worst.values()) > POWERSGD_RTOL:
        raise AssertionError(f"powersgd on the card against the CPU: {worst}")
    phase("reference", codec="powersgd-r4", steps=3,
          rtol_of_max=POWERSGD_RTOL,
          **{f"max_rel_{k}": f"{v:.3e}" for k, v in worst.items()})


def call_behind_spin(calls) -> tuple:
    """``(index of the first call that returned after half the spin, or
    None; the spin's ms)``: ``calls`` made back to back while a ~0.1 s
    spin kernel holds the stream. A call that waits on the device (a host
    sync, a library reading a result back, or a launch into a full
    launch queue) cannot return before the spin ends."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(2 * 10**8)
    end.record()
    t0 = time.perf_counter()
    done = []
    for c in calls:
        c()
        done.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    spin_ms = start.elapsed_time(end)
    return next((i for i, t in enumerate(done) if t > spin_ms / 2),
                None), spin_ms


def check_powersgd_qr(model) -> None:
    """PowerSGD's QR on BERT-base: the 51 compressed leaves' [n, 4] QRs
    timed alone, and whether they, or the whole protocol of the 150
    leaves (no process group here), wait on the device: each is called
    behind a spin kernel. Where the protocol waits, the device launches
    made before the waiting leaf are set against the launch queue's
    depth, measured with one-kernel calls: a wait that comes only when
    the queue is full is backpressure, not a sync. Their share of the
    step is read from the powersgd-r4 main path's trace
    (``profile_step``)."""
    from pytorch_ps_mpi_tpu_torch.codecs.powersgd import _matrix_shape

    code = make_codec("powersgd-r4")
    params = ordered_params(model)
    shapes = [tuple(p.shape) for p in params.values()
              if code._compresses(tuple(p.shape))]
    if len(shapes) != 51:
        raise AssertionError(f"powersgd compresses {len(shapes)} leaves")
    gen = torch.Generator(device="cuda").manual_seed(6)
    factors = [torch.randn((_matrix_shape(s)[0], 4), generator=gen,
                           device="cuda") for s in shapes]
    qrs = [lambda p=p: torch.linalg.qr(p) for p in factors]
    grads = {k: 1e-3 * torch.randn(p.shape, generator=gen, device="cuda")
             for k, p in params.items()}
    states = {k: code.init_state(tuple(p.shape), p.dtype, "cuda")
              for k, p in params.items()}
    leaves = [lambda k=k: code.fused_allreduce(grads[k], states[k])
              for k in grads]

    def run(calls):
        return lambda: [c() for c in calls]

    one = torch.zeros(1, device="cuda")
    depth, _ = call_behind_spin([lambda: one.add_(1)] * 4096)
    qr_ms = cuda_ms(run(qrs), reps=5, rounds=5)
    qr_wait, spin_ms = call_behind_spin(qrs)
    leaf_wait, _ = call_behind_spin(leaves)
    fields = {}
    if leaf_wait is not None:
        before = device_launches(run(leaves[:leaf_wait])) if leaf_wait \
            else 0
        through = device_launches(run(leaves[:leaf_wait + 1]))
        # the spin and its two events hold a few entries of the queue
        full = depth is not None and before <= depth + 8 <= through + 16
        fields = dict(protocol_first_waiting_leaf=leaf_wait,
                      protocol_launches_before_it=before,
                      protocol_launches_through_it=through,
                      protocol_waits_for=("launch_queue" if full
                                          else "sync"))
    phase("powersgd_qr", qr_calls=len(shapes), qr_ms=f"{qr_ms:.4f}",
          spin_ms=f"{spin_ms:.4f}", launch_queue_depth=depth,
          qr_first_waiting_call=qr_wait,
          protocol_launches=device_launches(run(leaves)), **fields)


# -- the main paths -------------------------------------------------------------

def kernel_counters() -> dict:
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q
    from pytorch_ps_mpi_tpu_torch.ops import sign as S
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    from pytorch_ps_mpi_tpu_torch.ops import attention as A
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    return {"encode_signs": S.encode_signs, "pack_signs": S.pack_signs,
            "unpack_signs": S.unpack_signs,
            "unpack_signs_sum": S.unpack_signs_sum,
            "quantize_int8": Q.quantize_int8,
            "dequantize_int8": Q.dequant_sum, "exact_topk": T.exact_topk,
            "tern_pack": TG.tern_pack, "tern_unpack": TG.tern_unpack_sum,
            "flash_fwd": A.flash_fwd, "flash_bwd": A.flash_bwd}


#: bucket_mb of the bucketed and leader runs, and the kernel launches a
#: step that the JAX package's plan_buckets gives on these models' leaves
#: in its leaf order (ResNet-18: 4 buckets, 2 of n % 1024 == 0; BERT-base:
#: 28 buckets, 15 of n % 512 == 0, two of them 23,440,896 elements packed
#: in 23 chunks each)
BUCKET_MB = 16.0
PLAN_LAUNCHES = {
    "sign": {"encode_signs": 2, "unpack_signs_sum": 2},
    "int8": {"quantize_int8": 4, "dequantize_int8": 4},
    "terngrad": {"tern_pack": 13 + 2 * 23, "tern_unpack": 15},
}


def from_plan(code_name: str):
    """``per_step`` of a bucketed run: the launches the optimizer's own
    plan gives, which must equal :data:`PLAN_LAUNCHES`."""
    def per_step(opt) -> dict:
        got = plan_launches(opt, code_name)
        if got != PLAN_LAUNCHES[code_name]:
            raise AssertionError(f"{code_name}: the port's plan gives "
                                 f"{got}, the JAX plan "
                                 f"{PLAN_LAUNCHES[code_name]}")
        return got
    return per_step


def ordered_params(model) -> dict:
    """``model``'s parameters in the JAX package's leaf order, so a bucket
    plan holds the JAX package's buckets."""
    from pytorch_ps_mpi_tpu_torch.utils.interop import jax_leaf_order

    named = dict(model.named_parameters())
    return {n: named[n] for n in jax_leaf_order(model)}


def plan_launches(opt, code_name: str) -> dict:
    """Kernel launches a step of a bucketed codec, derived from the
    optimizer's own bucket plan: sign's kernels take a bucket of n % 1024
    == 0, int8's every bucket, TernGrad's pack a sublane-layout bucket
    whole or chunk by chunk and its unpack-sum each such bucket."""
    sizes = [b.size for b in opt._bucket_plan.buckets]
    code = opt.code
    if code_name == "sign":
        n = sum(1 for m in sizes if code._kernel_ok(m))
        return {"encode_signs": n, "unpack_signs_sum": n}
    if code_name == "int8":
        return {"quantize_int8": len(sizes), "dequantize_int8": len(sizes)}
    if code_name == "terngrad":
        units = tern_units(sizes)
        return {"tern_pack": sum(len(u) for u in units),
                "tern_unpack": len(units)}
    return {}


def run_main_path(model, code_name: str, dataset: str, batch: int,
                  per_step, calls: dict, model_name: str, **opt_kw) -> dict:
    """5 loss_fn steps and 1 grads-only step of SGD on a ResNet; the launch
    counts of the run must equal ``per_step`` (kernel -> launches a step)
    x 6, and its collective calls ``calls`` (kind -> calls a grads-only
    step). ``opt_kw`` (``bucket_mb``, ``mode``) go to the optimizer, whose
    parameters are in the JAX leaf order; ``per_step`` may be a callable
    of the optimizer (the counts its bucket plan gives)."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)

    opt = SGD(ordered_params(model), lr=0.01, momentum=0.9,
              code=make_codec(code_name), device="cuda", **opt_kw)
    if callable(per_step):
        per_step = per_step(opt)
    # drawn before the timed steps: the ImageNet generator makes a 602 MB
    # class-mean table and 77 MB per batch on the host
    stream = synthetic_images(dataset, batch, seed=0, device="cuda")
    batches = [next(stream) for _ in range(LOSS_STEPS + 1)]

    def loss_fn(params, b):
        x, y = b
        return cross_entropy_loss(functional_call(model, params, (x,)), y)

    return drive(opt, loss_fn, batches, per_step, per_step, calls, code_name,
                 model=model_name, batch=batch)


def run_bert_path(model, code_name: str, per_loss_step: dict,
                  per_grads_step: dict, calls: dict, **opt_kw) -> dict:
    """5 loss_fn steps and 1 grads-only step of Adam(lr=1e-4) on BERT-base
    MLM at batch 4, sequence 512; ``per_grads_step`` may be a callable
    of the optimizer, whose counts are then added to ``per_loss_step``."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import Adam
    from pytorch_ps_mpi_tpu_torch.data import synthetic_mlm
    from pytorch_ps_mpi_tpu_torch.models import mlm_loss

    opt = Adam(ordered_params(model), lr=1e-4, code=make_codec(code_name),
               device="cuda", **opt_kw)
    if callable(per_grads_step):
        per_grads_step = per_grads_step(opt)
        per_loss_step = {**per_loss_step, **per_grads_step}
    stream = synthetic_mlm(BERT_BATCH, BERT_SEQ, model.cfg.vocab_size,
                           seed=0, device="cuda")
    batches = [next(stream) for _ in range(LOSS_STEPS + 1)]

    def loss_fn(params, b):
        logits = functional_call(model, params, (b["tokens"],))
        return mlm_loss(logits, b["targets"], b["mask"])

    return drive(opt, loss_fn, batches, per_loss_step, per_grads_step, calls,
                 code_name, model="BERT-base-mlm-bf16-flash",
                 batch=f"{BERT_BATCH}x{BERT_SEQ}")


def drive(opt, loss_fn, batches, per_loss_step: dict, per_grads_step: dict,
          calls: dict, code_name: str, **fields) -> dict:
    """``LOSS_STEPS`` loss_fn steps and 1 grads-only step; every kernel
    count and the collective counter are set to 0 just before and read
    just after, and must equal ``per_loss_step`` x ``LOSS_STEPS`` +
    ``per_grads_step``, and ``calls`` in the grads-only step (a loss step
    adds the loss's all-reduce)."""
    from pytorch_ps_mpi_tpu_torch import comms

    before = {k: p.detach().clone() for k, p in opt.params.items()}
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    comms.reset_calls()
    losses, step_ms = [], []
    for b in batches[:LOSS_STEPS]:
        loss, data = opt.step(loss_fn=loss_fn, batch=b)
        losses.append(float(loss))
        step_ms.append(data["step_time"] * 1e3)
    loss_calls = dict(comms.calls)
    comms.reset_calls()
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = {k: 1e-3 * torch.randn((WORLD,) + tuple(p.shape), generator=gen,
                                   device="cuda")
             for k, p in opt.params.items()}
    _, data = opt.step(grads=grads)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    grads_calls = dict(comms.calls)
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
    want_grads = {k: calls.get(k, 0) for k in grads_calls}
    want_loss = {k: (calls.get(k, 0) + (k == "all_reduce")) * LOSS_STEPS
                 for k in loss_calls}
    if grads_calls != want_grads or loss_calls != want_loss:
        raise AssertionError(f"{code_name}: collective calls {loss_calls} "
                             f"in the loss steps and {grads_calls} in the "
                             f"grads-only step, expected {want_loss} and "
                             f"{want_grads}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(step_ms)
    profile_step(opt, loss_fn, batches[-1], code_name)
    phase("main_path", code=code_name, **fields,
          params=sum(p.numel() for p in opt.params.values()),
          leaves=len(opt.params), world=WORLD, mode=opt.mode,
          bucket_mb=opt.bucket_mb, bucket_count=int(data["bucket_count"]),
          agg_launches=int(data["agg_launches"]),
          wire_lowering=data["wire_lowering"],
          collectives_per_grads_step=json.dumps(
              {k: v for k, v in grads_calls.items() if v},
              separators=(",", ":")),
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
    # PowerSGD's QRs: the device time of the kernels aten::linalg_qr
    # launched (cuSOLVER's or MAGMA's), against the step's busy and wall
    qr = [(e.device_time_total / 1e3, e.count) for e in prof.key_averages()
          if e.key == "aten::linalg_qr"]
    qr_fields = {}
    if qr:
        qr_ms = sum(t for t, _ in qr)
        qr_fields = dict(qr_calls=sum(c for _, c in qr),
                         qr_device_ms=f"{qr_ms:.4f}",
                         qr_share_of_busy=f"{qr_ms / busy_ms:.4f}",
                         qr_share_of_wall=f"{qr_ms / wall_ms:.4f}")
    phase("profile", code=code_name, wall_ms=f"{wall_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.3f}",
          top=json.dumps(top, separators=(",", ":")), **qr_fields)


# -- phase 7: the training layer -----------------------------------------

#: steps of the Trainer run (two run_steps calls of SCAN_CHUNK), and of
#: each equality run
TRAIN_STEPS, SCAN_CHUNK = 8, 4
EQ_STEPS = 3
#: ResNet-18 with SyncBatchNorm: 20 BatchNorm layers, each one all-gather
#: of its statistics in the forward and one all-reduce of their cotangent
#: in the backward; one all-reduce of the running statistics (one dtype)
#: and one of the loss a step
BN_LAYERS = 20
SYNCBN_CALLS = {"all_gather": 124 + BN_LAYERS,
                "all_reduce": 1 + BN_LAYERS + 1}


def _counted(fn):
    """``fn()`` with every kernel count and the collective counter set to
    0 just before and read just after: ``(result, launches, calls)``."""
    from pytorch_ps_mpi_tpu_torch import comms

    counters = kernel_counters()
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    comms.reset_calls()
    out = fn()
    torch.cuda.synchronize()
    return (out, {n: k.launches for n, k in counters.items() if k.launches},
            {n: c for n, c in comms.calls.items() if c})


def _expect(what: str, got: dict, per_step: dict, steps: int) -> None:
    want = {k: v * steps for k, v in per_step.items() if v}
    if got != want:
        raise AssertionError(f"{what}: {got}, expected {want}")


def _tensors(tree) -> list:
    from pytorch_ps_mpi_tpu_torch import comms

    out = []
    comms.tree_map(lambda t: out.append(t) if torch.is_tensor(t) else None,
                   tree)
    return out


def _assert_same_state(a, b, what: str) -> None:
    """Every tensor of ``a`` equals its twin in ``b`` bit for bit."""
    ta, tb = _tensors(a), _tensors(b)
    if len(ta) != len(tb) or not all(
            x.shape == y.shape and torch.equal(x, y) for x, y in zip(ta, tb)):
        raise AssertionError(f"{what}: not equal bit for bit")


def _idle(fn) -> dict:
    """``fn`` (one step) under torch.profiler: its wall, the device's busy
    time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in _device_events(prof)) / 1e3
    return dict(profiled_wall_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}",
                idle_share=f"{max(0.0, 1 - busy / wall):.3f}")


def _peak_gb() -> str:
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f}"


def train_resnet_syncbn(tmp: str) -> None:
    """ResNet-18 (CIFAR stem) with SyncBatchNorm, SGD(sign) at batch 256:
    ``Trainer.fit`` of 8 steps in two ``run_steps`` calls, checkpointing
    every 4; a Trainer that checkpointed its first 4 steps into a
    directory of its own, then a fresh one restored from it and run 4
    more, equal it bit for bit; ``run_steps(4)`` equals 4 ``step`` calls
    bit for bit."""
    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.models.resnet import (apply_with_stats,
                                                        batch_stats_of)
    from pytorch_ps_mpi_tpu_torch.trainer import Trainer, stack_batches

    stream = synthetic_images("cifar10", BATCH, seed=0, device="cuda")
    batches = [next(stream) for _ in range(TRAIN_STEPS)]

    def build(**trainer_kw):
        model = ResNet18(num_classes=10, small_inputs=True, norm="batch",
                         bn_axis="data", seed=0, device="cuda")
        opt = SGD(ordered_params(model), lr=0.01, momentum=0.9,
                  code=make_codec("sign"), device="cuda")

        def loss_fn(p, aux, b):
            logits, new = apply_with_stats(model, p, aux, b[0])
            return cross_entropy_loss(logits, b[1]), new

        return Trainer(opt, loss_fn, aux_state=batch_stats_of(model),
                       **trainer_kw)

    per_step = {"encode_signs": 20, "unpack_signs_sum": 20}
    torch.cuda.reset_peak_memory_stats()
    straight = build(checkpoint_dir=tmp, checkpoint_every=SCAN_CHUNK,
                     scan_chunk=SCAN_CHUNK)
    out, launches, calls = _counted(
        lambda: straight.fit(iter(batches), TRAIN_STEPS))
    _expect("R18 SyncBN sign fit launches", launches, per_step, TRAIN_STEPS)
    _expect("R18 SyncBN sign fit collectives", calls, SYNCBN_CALLS,
            TRAIN_STEPS)
    if straight.ckpt.steps() != [SCAN_CHUNK, TRAIN_STEPS]:
        raise AssertionError(f"checkpoints {straight.ckpt.steps()}")
    if not math.isfinite(out["final_loss"]):
        raise AssertionError(f"non-finite loss {out['final_loss']}")
    first_dir = os.path.join(tmp, "first")
    first = build(checkpoint_dir=first_dir, checkpoint_every=SCAN_CHUNK,
                  scan_chunk=SCAN_CHUNK)
    first.fit(iter(batches[:SCAN_CHUNK]), SCAN_CHUNK)
    resumed = build(checkpoint_dir=first_dir, scan_chunk=SCAN_CHUNK)
    if not (resumed.maybe_restore() and resumed.step_count == SCAN_CHUNK):
        raise AssertionError("the restore of step 4 failed")
    resumed.fit(iter(batches[SCAN_CHUNK:]), TRAIN_STEPS - SCAN_CHUNK)
    a, b = straight.opt, resumed.opt
    _assert_same_state(a.params, b.params, "resumed parameters")
    _assert_same_state(a.aux_state, b.aux_state,
                       "resumed running statistics")
    _assert_same_state(a.opt_state.momentum_buf, b.opt_state.momentum_buf,
               "resumed momentum")

    scan, loop = build(), build()
    step_ms, scan_ms, loop_ms = [], [], []

    def run_scan(part):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, _ = scan.opt.run_steps(scan.loss_fn, stack_batches(part),
                                       aux_state=scan.opt.aux_state)
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        return losses

    def run_loop(part):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for x in part:
            loss, d = loop.opt.step(loss_fn=loop.loss_fn, batch=x,
                                    aux_state=loop.opt.aux_state)
            losses.append(loss)
            step_ms.append(d["step_time"] * 1e3)
        loop_ms.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(losses)

    # two rounds of 4 steps, the second in the other order, so neither
    # side always runs first
    for i, part in enumerate((batches[:SCAN_CHUNK], batches[SCAN_CHUNK:])):
        if i == 0:
            got, want = run_scan(part), run_loop(part)
        else:
            want, got = run_loop(part), run_scan(part)
        _assert_same_state([got, scan.opt.params, scan.opt.aux_state],
                   [want, loop.opt.params, loop.opt.aux_state],
                   f"run_steps(4) against 4 step calls, round {i + 1}")
    idle = _idle(lambda: loop.opt.step(loss_fn=loop.loss_fn,
                                       batch=batches[-1],
                                       aux_state=loop.opt.aux_state))
    phase("training", path="trainer_fit", model="ResNet18-cifar-syncbn-f32",
          code="sign", batch=BATCH, steps=TRAIN_STEPS, scan_chunk=SCAN_CHUNK,
          checkpoints=json.dumps(straight.ckpt.steps()),
          resume_bit_exact=True, run_steps_bit_exact=True,
          final_loss=f"{out['final_loss']:.5f}",
          fit_step_ms=f"{out['step_time'] * 1e3:.3f}",
          run_steps4_ms=json.dumps([round(v, 3) for v in scan_ms]),
          step_calls4_ms=json.dumps([round(v, 3) for v in loop_ms]),
          median_step_ms=f"{statistics.median(step_ms):.3f}",
          peak_mem_gb=_peak_gb(), **idle,
          launches_per_step=json.dumps(per_step, separators=(",", ":")),
          collectives_per_step=json.dumps(SYNCBN_CALLS,
                                          separators=(",", ":")))


def train_bert_accumulate() -> None:
    """BERT-base MLM (bf16, flash) Adam(terngrad(use_pallas=True)) through
    ``step_accumulate`` over 2 microbatches of 4 x 512, then the same
    staged (``instrument=True``) from the same weights and generator seed:
    the same parameters bit for bit."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import Adam
    from pytorch_ps_mpi_tpu_torch.data import synthetic_mlm
    from pytorch_ps_mpi_tpu_torch.models import (BertConfig, BertMLM,
                                                 mlm_loss)
    from pytorch_ps_mpi_tpu_torch.trainer import stack_batches

    def build(instrument: bool):
        model = BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                        seed=0, device="cuda")
        opt = Adam(ordered_params(model), lr=1e-4, seed=0,
                   code=make_codec("terngrad"), instrument=instrument,
                   device="cuda")

        def loss_fn(params, b):
            logits = functional_call(model, params, (b["tokens"],))
            return mlm_loss(logits, b["targets"], b["mask"])

        return opt, loss_fn

    stream = synthetic_mlm(BERT_BATCH, BERT_SEQ, BertConfig().vocab_size,
                           seed=0, device="cuda")
    micro = [stack_batches([next(stream), next(stream)])
             for _ in range(EQ_STEPS)]
    # the flash kernels each microbatch (12 layers), TernGrad's once a step
    per_step = {"flash_fwd": 12 * 2, "flash_bwd": 24 * 2,
                "tern_pack": 61 + 2 * 23, "tern_unpack": 63}
    calls_per_step = {"all_gather": 300, "all_reduce": 1}
    stages = ("grad_time", "code_wait", "isend_time", "comm_wait",
              "decode_time", "optim_step_time")
    opts, lines = {}, {}
    for instrument in (False, True):
        torch.cuda.reset_peak_memory_stats()
        opt, loss_fn = build(instrument)
        out, launches, calls = _counted(
            lambda: [opt.step_accumulate(loss_fn, m) for m in micro])
        what = f"BERT-base step_accumulate instrument={instrument}"
        _expect(f"{what} launches", launches, per_step, EQ_STEPS)
        _expect(f"{what} collectives", calls, calls_per_step, EQ_STEPS)
        losses = [float(loss) for loss, _ in out]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{what}: non-finite loss {losses}")
        data = out[-1][1]
        median_ms = statistics.median(d["step_time"] for _, d in out) * 1e3
        fields = {}
        if instrument:
            if not all(data[k] > 0 for k in stages):
                raise AssertionError(f"{what}: a stage was not timed: "
                                     f"{data}")
            staged = sum(data[k] for k in stages if k != "isend_time")
            if staged > data["step_time"]:
                raise AssertionError(f"{what}: the stages sum to {staged} s "
                                     f"> step_time {data['step_time']} s")
            fields = {k: f"{data[k] * 1e3:.3f}" for k in stages}
            per_micro = data["grad_time_per_microbatch"] * 1e3
            fields.update(stages_sum_ms=f"{staged * 1e3:.3f}",
                          grad_ms_per_microbatch=f"{per_micro:.3f}")
        opts[instrument] = (opt, loss_fn)
        lines[instrument] = dict(
            instrument=instrument, microbatches=2,
            batch=f"{BERT_BATCH}x{BERT_SEQ}", steps=EQ_STEPS,
            losses=json.dumps([round(v, 5) for v in losses]),
            median_step_ms=f"{median_ms:.3f}",
            peak_mem_gb=_peak_gb(), wire_lowering=data["wire_lowering"],
            **fields)
    _assert_same_state(opts[True][0].params, opts[False][0].params,
               "BERT-base staged against fused parameters")
    staged, staged_loss = opts[True]
    lines[True].update(_idle(lambda: staged.step_accumulate(staged_loss,
                                                            micro[-1])))
    opt, loss_fn = opts[False]
    # the fused steps again, after the staged ones: the first run of a
    # phase also pays warm-up
    again = [opt.step_accumulate(loss_fn, m)[1]["step_time"] * 1e3
             for m in micro]
    lines[False]["median_step_ms_again"] = f"{statistics.median(again):.3f}"
    lines[False].update(_idle(lambda: opt.step_accumulate(loss_fn,
                                                          micro[-1])))
    for instrument in (False, True):
        phase("training", path="step_accumulate",
              model="BERT-base-mlm-bf16-flash", code="terngrad",
              **lines[instrument], staged_equals_fused=True,
              launches_per_step=json.dumps(per_step, separators=(",", ":")),
              collectives_per_step=json.dumps(calls_per_step,
                                              separators=(",", ":")))


def train_resnet_dp() -> None:
    """ResNet-18 (GroupNorm) SGD(int8) at batch 256: the functional step
    ``make_sync_train_step`` per leaf and at bucket_mb=16 equals
    ``MPI_PS.step`` from the same state bit for bit over 3 steps; three
    ``instrument=True`` steps equal the fused ones."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.parallel import make_sync_train_step

    stream = synthetic_images("cifar10", BATCH, seed=0, device="cuda")
    batches = [next(stream) for _ in range(EQ_STEPS)]

    def resnet():
        return ResNet18(num_classes=10, small_inputs=True, seed=0,
                        device="cuda")

    def loss_of(model):
        def loss_fn(p, b):
            return cross_entropy_loss(functional_call(model, p, (b[0],)),
                                      b[1])
        return loss_fn

    for bucket_mb in (0.0, BUCKET_MB):
        model = resnet()
        params = {k: p.detach().clone()
                  for k, p in ordered_params(model).items()}
        init_fn, step_fn = make_sync_train_step(
            loss_of(model), optim="sgd", code=make_codec("int8"), lr=0.01,
            momentum=0.9, bucket_mb=bucket_mb)
        opt_state, codec_state = init_fn(params)

        def run(p=params, o=opt_state, c=codec_state):
            step_ms = []
            for b in batches:
                t0 = time.perf_counter()
                p, o, c, loss = step_fn(p, o, c, b)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            return (p, o, c), step_ms

        torch.cuda.reset_peak_memory_stats()
        (state, step_ms), launches, calls = _counted(run)
        got = state[0]
        twin = resnet()
        opt = SGD(ordered_params(twin), lr=0.01, momentum=0.9,
                  code=make_codec("int8"), bucket_mb=bucket_mb,
                  device="cuda")
        for b in batches:
            opt.step(loss_fn=loss_of(twin), batch=b)
        _assert_same_state(got, opt.params,
                           f"make_sync_train_step at bucket_mb={bucket_mb}")
        idle = _idle(lambda: step_fn(*state, batches[-1]))
        per_step = (plan_launches(opt, "int8") if bucket_mb else
                    {"quantize_int8": 62, "dequantize_int8": 62})
        calls_per_step = {"all_gather": 8 if bucket_mb else 124,
                          "all_reduce": 1}
        _expect(f"dp int8 bucket_mb={bucket_mb} launches", launches,
                per_step, EQ_STEPS)
        _expect(f"dp int8 bucket_mb={bucket_mb} collectives", calls,
                calls_per_step, EQ_STEPS)
        phase("training", path="make_sync_train_step",
              model="ResNet18-cifar-gn-f32", code="int8", batch=BATCH,
              bucket_mb=bucket_mb, steps=EQ_STEPS, equals_mpi_ps=True,
              median_step_ms=f"{statistics.median(step_ms):.3f}",
              peak_mem_gb=_peak_gb(), **idle,
              launches_per_step=json.dumps(per_step, separators=(",", ":")),
              collectives_per_step=json.dumps(calls_per_step,
                                              separators=(",", ":")))
        del model, twin, opt, got, state

    fused_model, staged_model = resnet(), resnet()
    fused = SGD(ordered_params(fused_model), lr=0.01, momentum=0.9,
                code=make_codec("int8"), device="cuda")
    staged = SGD(ordered_params(staged_model), lr=0.01, momentum=0.9,
                 code=make_codec("int8"), instrument=True, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for b in batches:
        fused.step(loss_fn=loss_of(fused_model), batch=b)
        _, data = staged.step(loss_fn=loss_of(staged_model), batch=b)
        step_ms.append(data["step_time"] * 1e3)
    _assert_same_state(staged.params, fused.params,
                       "R18 int8 staged against fused parameters")
    idle = _idle(lambda: staged.step(loss_fn=loss_of(staged_model),
                                     batch=batches[-1]))
    phase("training", path="instrument", model="ResNet18-cifar-gn-f32",
          code="int8", batch=BATCH, steps=EQ_STEPS, staged_equals_fused=True,
          wire_lowering=data["wire_lowering"],
          median_step_ms=f"{statistics.median(step_ms):.3f}",
          peak_mem_gb=_peak_gb(), **idle,
          **{k: f"{data[k] * 1e3:.3f}" for k in (
              "grad_time", "code_wait", "isend_time", "comm_wait",
              "decode_time", "optim_step_time")})


def train_cli() -> None:
    """``train.py`` through the launcher in a subprocess (a one-process
    NCCL group of its own): ResNet-18 with SyncBatchNorm and int8, 3
    steps; its last line is a JSON of ``Trainer.fit``'s metrics."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.launch",
           "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
           "1", "--process-id", "0",
           os.path.join(root, "pytorch_ps_mpi_tpu_torch", "train.py"),
           "--config", "resnet18_cifar10", "--norm", "batch", "--codec",
           "int8", "--steps", "3", "--log-every", "0"]
    env = {**os.environ, "PYTHONPATH": root}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"train.py through launch exited "
                             f"{out.returncode}: {out.stderr[-4000:]}")
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    if not math.isfinite(summary["final_loss"]):
        raise AssertionError(f"train.py: final_loss {summary['final_loss']}")
    phase("training", path="cli", config="resnet18_cifar10", norm="batch",
          code="int8", steps=3, seconds=f"{seconds:.1f}",
          final_loss=summary["final_loss"],
          step_ms=f"{summary['step_time'] * 1e3:.3f}",
          header=repr(out.stdout.strip().splitlines()[0]))


def run_training() -> None:
    """Phase 7 (``training``), after the main paths, in their process
    group; convolutions deterministic so that equal inputs give equal
    bits."""
    import shutil
    import tempfile

    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        train_resnet_syncbn(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    train_bert_accumulate()
    torch.cuda.empty_cache()
    train_resnet_dp()
    torch.cuda.empty_cache()
    train_cli()
    phase("training", seconds=f"{time.perf_counter() - t0:.1f}")


SOURCES = {
    "encode_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:68"),
    "pack_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:104"),
    "unpack_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:131"),
    # with the codec's scale and rank-ordered fold (codecs/sign.py:89-96)
    "unpack_signs_sum": ("sign.cu",
                         "pytorch_ps_mpi_tpu/ops/sign_pallas.py:131"),
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
    t0 = time.perf_counter()
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
    results = check_kernels(kernel_sizes(model), bucket_sizes(model))
    check_decode_sum(model)
    results.update(check_quant_kernels(model))
    leaves = topk_leaves(r50)
    topk_launches, topk_results = check_topk_kernels(leaves)
    results.update(topk_results)
    check_reference(model, "sign", "ResNet18-cifar-gn-f32")
    check_reference(model, "sign", "ResNet18-cifar-gn-f32",
                    bucket_mb=BUCKET_MB)
    check_reference(model, "int8", "ResNet18-cifar-gn-f32", exact=True)
    check_reference(model, "int8", "ResNet18-cifar-gn-f32", exact=True,
                    bucket_mb=BUCKET_MB)
    check_reference(model, "int8", "ResNet18-cifar-gn-f32", exact=True,
                    bucket_mb=BUCKET_MB, mode="leader")
    check_reference(r50, "ef_topk", "ResNet50-imagenet-gn-f32", exact=True)
    del r50
    bert = bert_base()
    results.update(check_tern_kernels(bert))
    results.update(check_flash_kernels())
    check_bert_reference(bert, {"tern_pack": 107, "tern_unpack": 63})
    check_bert_reference(bert, PLAN_LAUNCHES["terngrad"],
                         bucket_mb=BUCKET_MB)
    check_bert_flash(bert)
    check_sparse_sync(bert)
    check_codec_reference(bert)
    check_powersgd_qr(bert)
    del bert
    torch.cuda.empty_cache()

    r18 = sum(1 for _ in model.parameters())
    bucketed = dict(bucket_mb=BUCKET_MB)
    leader = dict(bucket_mb=BUCKET_MB, mode="leader")
    # the collective calls of a grads-only step: one all-reduce a unit for
    # identity, one all-gather a payload tensor (two a unit) for the
    # gathered codecs, and in leader mode a reduce-scatter and an
    # all-gather a unit (psum_scatter) or the payload all-gathers and one
    # parameter all-gather a unit (payload_gather, int8 at world 1); a
    # unit is a leaf (ResNet-18 62, ResNet-50 161, BERT-base 150) or a
    # bucket (ResNet-18 4, BERT-base 28)
    runs = [
        ("identity", resnet18, "cifar10", BATCH, {}, {"all_reduce": 62}, {}),
        ("sign", lambda: model, "cifar10", BATCH,
         {"encode_signs": 20, "unpack_signs_sum": 20}, {"all_gather": 124},
         {}),
        ("int8", resnet18, "cifar10", BATCH,
         {"quantize_int8": r18, "dequantize_int8": r18}, {"all_gather": 124},
         {}),
        ("qsgd", resnet18, "cifar10", BATCH, {"dequantize_int8": r18},
         {"all_gather": 124}, {}),
        ("ef_topk", resnet50, "imagenet", BATCH_IMAGENET,
         {"exact_topk": topk_launches * len(leaves)}, {"all_gather": 322},
         {}),
        ("sign", resnet18, "cifar10", BATCH, from_plan("sign"),
         {"all_gather": 8}, bucketed),
        ("int8", resnet18, "cifar10", BATCH, from_plan("int8"),
         {"all_gather": 8}, bucketed),
        ("int8", resnet18, "cifar10", BATCH, from_plan("int8"),
         {"all_gather": 8 + 4}, leader),
    ]
    # BERT-base: 12 flash forward and 12 + 12 backward launches a loss
    # step, none in the grads-only step; TernGrad packs 61 leaves whole and
    # the two 23,440,896-element leaves in 23 chunks each, and unpack-sums
    # its 63 sublane-layout leaves, in every step
    flash = {"flash_fwd": 12, "flash_bwd": 24}
    tern = {"tern_pack": 61 + 2 * 23, "tern_unpack": 63}
    bert_runs = [("identity", flash, {}, {"all_reduce": 150}, {}),
                 ("terngrad", {**flash, **tern}, tern, {"all_gather": 300},
                  {}),
                 ("terngrad", flash, from_plan("terngrad"),
                  {"all_gather": 56}, bucketed),
                 ("identity", flash, {},
                  {"reduce_scatter": 28, "all_gather": 28}, leader),
                 # no codec kernel: PowerSGD's two all-reduces on 51
                 # compressed leaves and one on each of the 99 others; an
                 # all-gather a payload tensor of the 150 leaves (random-k
                 # and block top-k values and indices, block top-k int8
                 # and threshold three), or of random-k's 28 buckets
                 ("powersgd-r4", flash, {}, {"all_reduce": 51 * 2 + 99}, {}),
                 ("blocktopk-1%", flash, {}, {"all_gather": 300}, {}),
                 ("blocktopk8-1%", flash, {}, {"all_gather": 450}, {}),
                 ("randomk-1%", flash, {}, {"all_gather": 300}, {}),
                 ("randomk-1%", flash, {}, {"all_gather": 56}, bucketed),
                 ("threshold", flash, {}, {"all_gather": 450}, {})]
    launches = {}
    mesh.initialize_distributed(f"tcp://localhost:{free_port()}",
                                world_size=WORLD, rank=0, backend="nccl")
    try:
        for code, make_model, dataset, batch, per_step, calls, opt_kw in runs:
            name = ("ResNet50-imagenet-gn-f32" if dataset == "imagenet"
                    else "ResNet18-cifar-gn-f32")
            got = run_main_path(make_model(), code, dataset, batch, per_step,
                                calls, name, **opt_kw)
            for kernel, n in got.items():
                if n:
                    launches.setdefault(kernel, n)
            torch.cuda.empty_cache()
        for code, per_loss, per_grads, calls, opt_kw in bert_runs:
            got = run_bert_path(bert_base(), code, per_loss, per_grads, calls,
                                **opt_kw)
            for kernel, n in got.items():
                if n:
                    launches.setdefault(kernel, n)
            torch.cuda.empty_cache()
        run_training()
    finally:
        torch.distributed.destroy_process_group()
    launches.setdefault("pack_signs", 0)
    launches.setdefault("unpack_signs", 0)

    phase("done", seconds=f"{time.perf_counter() - t0:.1f}")
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

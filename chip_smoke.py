"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; the script exits non-zero if any fails:

1. device    -- requires a CUDA device; prints the card's name and power
               limit as nvidia-smi reports them.
2. build     -- compiles ``pytorch_ps_mpi_tpu_torch/csrc/{sign,quant,
               topk}.cu`` with nvcc for sm_90a, one nvcc per source, all
               started together, and prints the seconds each took.
3. kernels   -- each kernel against its plain PyTorch version on the card,
               at the main paths' leaf sizes, with planted cases:
               - the sign kernels at ResNet-18's 20 kernel-path leaves
                 (bytes bit-exact, |x| sum within rtol 1e-6, -0.0 and NaN);
               - int8 quantize and dequantize-sum at ResNet-18's 62 leaves,
                 world 1 and world 8 (codes, scales and floats bit-exact;
                 NaN, ±Inf, ±0.0 and exact .5 ties);
               - the top-k count pass and the whole exact top-k at
                 ResNet-50's 53 kernel-path leaves with k = round(0.01 n)
                 (counts, index arrays and values bit-exact; heavy |x|
                 ties, NaN, ±Inf, ±0.0).
               Times each over the main path's leaves in sequence: ``ms``
               is the wrapper's call (median of CUDA-event timings, host
               launch cost included), ``device_ms`` the kernels' own time
               in a profiler trace, ``plain_ms`` the plain version's call,
               ``bound_ms`` the bytes the function must move over 3.35 TB/s,
               ``library_ms`` one PyTorch call computing the same function
               where there is one (never called by the port).
4. decode_sum -- 8 stacked sign payloads for every ResNet-18 leaf through
               ``SignCodec.decode_sum``; bit-exact against the plain fold.
5. reference -- grads-only steps on the card against the same steps on the
               CPU (the plain versions), rtol 1e-6: SGD(sign) and
               SGD(int8) on ResNet-18, SGD(ef∘topk) on ResNet-50.
6. main path -- a one-rank NCCL process group, then 5 ``step(loss_fn=...)``
               calls and 1 ``step(grads=...)`` call of each of: identity
               (no kernel), sign, int8 and qsgd on ResNet-18 (CIFAR stem,
               GroupNorm, f32) at batch 256, and ef∘topk(fraction=0.01,
               pallas=True) on ResNet-50 (ImageNet stem, 1000 classes) at
               224x224, batch 128. Every kernel count is set to 0 just
               before a run and read just after it, and must equal that
               codec's exact launches per step. One more step then runs
               under torch.profiler (phase ``profile``): the device's busy
               time against the step's wall time and the kernels that take
               the most of it.

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

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
WORLD = 1
BATCH = 256          # ResNet-18, CIFAR-10
BATCH_IMAGENET = 128  # ResNet-50, ImageNet
LOSS_STEPS = 5
TOPK_FRACTION = 0.01


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


def device_ms(fn) -> float:
    """Device time of the kernels one call of ``fn`` launches, summed
    from torch.profiler's trace (no host time between launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in _device_events(prof)) / 1e3


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
    from pytorch_ps_mpi_tpu_torch.ops import _build

    seconds = _build.build("sign", "quant", "topk")
    for name, s in seconds.items():
        phase("build", source=f"csrc/{name}.cu", nvcc_s=f"{s:.2f}")


def timed(kern, plain, args, nbytes, library=None, reps=20, rounds=5):
    """``ms``/``device_ms``/``plain_ms``/``bound_ms``/``library_ms`` of a
    kernel wrapper over one step's leaves in sequence (``args``: one
    argument tuple per leaf, ``nbytes``: the function's bytes per leaf)."""
    def run_all(fn):
        for a in args:
            fn(*a)

    def total(fn):
        return sum(cuda_ms(lambda: fn(*a), reps, rounds) for a in args)

    return dict(ms=total(kern), device_ms=device_ms(lambda: run_all(kern)),
                plain_ms=total(plain),
                bound_ms=sum(nbytes(*a) for a in args) / HBM_BYTES_PER_S * 1e3,
                library_ms=None if library is None else total(library))


def report(kernel: str, r: dict, **extra) -> None:
    phase("kernels", kernel=kernel, ms=f"{r['ms']:.4f}",
          device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
          bound_ms=f"{r['bound_ms']:.5f}",
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
    cases = sorted(set(sizes)) + [S.GROUP, 13 * S.GROUP]
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
    return results


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
    for n in sorted(set(sizes)) + [4099, 1000]:
        for case in (("plain", "ties", "signed_zero", "nan", "inf",
                      "neg_inf", "zeros") if n >= 16 else ("plain",)):
            x = 1e-2 * _int8_planted(n, case, gen)
            q, s = Q.quantize_int8(x)
            rq, rs = Q.quantize_int8_ref(x)
            same(q, rq, f"quantize_int8 codes at n={n} ({case})")
            same(s, rs, f"quantize_int8 scale at n={n} ({case})")
            cases += 1
        for world in (1, 8):
            qs = torch.randint(-127, 128, (world, n), generator=gen,
                               device="cuda", dtype=torch.int8)
            ss = torch.rand(world, generator=gen, device="cuda")
            if n == 4099 and world == 8:
                ss[3] = float("nan")  # a NaN scale poisons its sum
            same(Q.dequant_sum(qs, ss), Q.dequant_sum_ref(qs, ss),
                 f"dequant_sum at n={n}, world {world}")
    phase("kernels", check="int8 bit-exact", sizes=len(set(sizes)) + 2,
          quantize_cases=cases, dequant_worlds="1,8")

    xs = [1e-2 * torch.randn(n, generator=gen, device="cuda") for n in sizes]
    quant_args = [(x,) for x in xs]
    payloads = [Q.quantize_int8_ref(x) for x in xs]
    results = {}
    r = timed(Q.quantize_int8, Q.quantize_int8_ref, quant_args,
              lambda x: 5 * x.numel() + 4)
    results["quantize_int8"] = dict(r, max_abs_err=0.0)
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

    stacks = [(torch.stack([q] * 8), torch.stack([s] * 8))
              for q, s in payloads]
    r = timed(Q.dequant_sum, Q.dequant_sum_ref, stacks,
              lambda q, s: 12 * q.shape[1] + 4 * 8, reps=10, rounds=3)
    report("dequant_sum", dict(r, max_abs_err=0.0), leaves=len(sizes),
           world=8)
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


def check_topk_kernels(leaves: list) -> dict:
    """The top-k count kernel and the whole exact top-k against their
    plain versions at ResNet-50's 53 kernel-path leaves, planted cases,
    and timing."""
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    gen = torch.Generator(device="cuda").manual_seed(5)

    def check(x, k, what):
        t, counts = T.kth_threshold(x, k)
        rt, rcounts = T.kth_threshold(x, k, T.count_pass_ref)
        if not (torch.equal(counts, rcounts) and torch.equal(t, rt)):
            raise AssertionError(f"count passes differ: {what}")
        v, i = T.exact_topk(x, k)
        rv, ri = T.exact_topk_ref(x, k)
        if not (torch.equal(i, ri)
                and torch.equal(v.view(torch.int32), rv.view(torch.int32))):
            raise AssertionError(f"exact_topk differs: {what}")

    for n, k in sorted(set(leaves)):
        check(torch.randn(n, generator=gen, device="cuda"), k, f"n={n}")
    n, k = 2_359_296, 23_593
    ties = 0.25 * torch.randint(0, 4, (n,), generator=gen,
                                device="cuda").float()
    ties[::5] *= -1
    check(ties, k, "heavy ties")
    planted = torch.randn(n, generator=gen, device="cuda")
    planted[[3, 70, 900, 901, 5, 6]] = torch.tensor(
        [float("nan"), float("inf"), float("-inf"), float("nan"), -0.0, 0.0],
        device="cuda")
    check(planted, k, "NaN, ±Inf, ±0.0")
    phase("kernels", check="topk bit-exact", sizes=len(set(leaves)),
          planted="heavy ties; NaN, ±Inf, ±0.0")

    xs = [(torch.randn(n, generator=gen, device="cuda"), k)
          for n, k in leaves]
    r = timed(T.exact_topk, T.exact_topk_ref, xs,
              lambda x, k: 4 * x.numel() + 8 * k,
              library=lambda x, k: torch.topk(x.abs(), k), reps=5, rounds=3)
    threshold = timed(lambda x, k: T.kth_threshold(x, k),
                      lambda x, k: T.kth_threshold(x, k, T.count_pass_ref),
                      xs, lambda x, k: 4 * x.numel() * T.PASSES,
                      reps=5, rounds=3)
    results = {"exact_topk": dict(r, max_abs_err=0.0)}
    report("exact_topk", results["exact_topk"], leaves=len(leaves),
           library="torch.topk(x.abs(), k)",
           design_bound_ms=f"{threshold['bound_ms']:.4f}",
           count_passes_ms=f"{threshold['ms']:.4f}",
           count_passes_device_ms=f"{threshold['device_ms']:.4f}",
           count_launches_per_call=T.PASSES * len(leaves))
    return results


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
    return get_codec(name)


def check_reference(model, code_name: str, model_name: str) -> None:
    """A grads-only step on the card against the same step on the CPU,
    where every wrapper takes its plain version."""
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
    phase("reference", step=f"grads-only SGD({code_name}) x2",
          model=model_name, rtol=1e-6, max_abs_diff=worst)


# -- the main paths -------------------------------------------------------------

def kernel_counters() -> dict:
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q
    from pytorch_ps_mpi_tpu_torch.ops import sign as S
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    return {"encode_signs": S.encode_signs, "pack_signs": S.pack_signs,
            "unpack_signs": S.unpack_signs, "quantize_int8": Q.quantize_int8,
            "dequantize_int8": Q.dequant_sum, "exact_topk": T.count_pass}


def run_main_path(model, code_name: str, dataset: str, batch: int,
                  per_step: dict, model_name: str) -> dict:
    """5 loss_fn steps and 1 grads-only step of SGD; the launch counts of
    the run must equal ``per_step`` (kernel -> launches a step) x 6."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = SGD(model, lr=0.01, momentum=0.9, code=make_codec(code_name),
              device="cuda")
    # drawn before the timed steps: the ImageNet generator makes a 602 MB
    # class-mean table and 77 MB per batch on the host
    stream = synthetic_images(dataset, batch, seed=0, device="cuda")
    batches = [next(stream) for _ in range(LOSS_STEPS + 1)]

    def loss_fn(params, b):
        x, y = b
        return cross_entropy_loss(functional_call(model, params, (x,)), y)

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

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(torch.isfinite(p).all() for p in opt.params.values()):
        raise AssertionError("non-finite parameters")
    if all(torch.equal(before[k], p) for k, p in opt.params.items()):
        raise AssertionError("the parameters did not change")
    steps = LOSS_STEPS + 1
    want = {name: per_step.get(name, 0) * steps for name in counters}
    if launches != want:
        raise AssertionError(f"{code_name}: launches {launches}, expected "
                             f"{want}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(step_ms)
    profile_step(opt, loss_fn, batches[-1], code_name)
    phase("main_path", code=code_name, model=model_name,
          params=sum(p.numel() for p in opt.params.values()),
          leaves=len(opt.params), batch=batch, world=WORLD,
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
}


def main() -> int:
    check_device()
    # stated and set: f32 matmuls in full f32, f32 convolutions in TF32
    # (cuDNN's default), so the step runs as a PyTorch user's would
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.set_device(0)

    from pytorch_ps_mpi_tpu_torch import mesh
    from pytorch_ps_mpi_tpu_torch.models import ResNet18, ResNet50

    def resnet18():
        return ResNet18(num_classes=10, small_inputs=True, seed=0,
                        device="cuda")

    def resnet50():
        return ResNet50(num_classes=1000, seed=0, device="cuda")

    build_kernels()
    model = resnet18()
    r50 = resnet50()
    results = check_kernels(kernel_sizes(model))
    results.update(check_quant_kernels(model))
    leaves = topk_leaves(r50)
    results.update(check_topk_kernels(leaves))
    check_decode_sum(model)
    check_reference(model, "sign", "ResNet18-cifar-gn-f32")
    check_reference(model, "int8", "ResNet18-cifar-gn-f32")
    check_reference(r50, "ef_topk", "ResNet50-imagenet-gn-f32")
    del r50

    r18 = sum(1 for _ in model.parameters())
    runs = [
        ("identity", resnet18, "cifar10", BATCH, {}),
        ("sign", lambda: model, "cifar10", BATCH,
         {"encode_signs": 20, "unpack_signs": 20 * WORLD}),
        ("int8", resnet18, "cifar10", BATCH,
         {"quantize_int8": r18, "dequantize_int8": r18}),
        ("qsgd", resnet18, "cifar10", BATCH, {"dequantize_int8": r18}),
        ("ef_topk", resnet50, "imagenet", BATCH_IMAGENET,
         {"exact_topk": 31 * len(leaves)}),
    ]
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
    finally:
        torch.distributed.destroy_process_group()
    launches.setdefault("pack_signs", 0)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"pytorch_ps_mpi_tpu_torch/csrc/{SOURCES[name][0]}",
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": "bytes",
         "library_ms": r["library_ms"]}
        for name, r in results.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    sys.exit(main())

"""Load width of the int8 dequantize-sum on one NVIDIA GPU.

    python3 chip_dequant_widths.py

Holds the shipped ``dequant_sum`` kernel (``csrc/quant.cu``: 4 codes a
thread, a 4-byte load per rank and a float4 store) against two designs
that load 16 codes a thread with one 16-byte load per rank: ``own``, each
thread storing its own 16 sums as 4 float4s (64 bytes apart across a
warp), and ``staged``, the sums staged through shared memory so a warp's
float4 stores are contiguous. Every variant is bit-exact against
``dequant_sum_ref`` before it is timed. Device time from torch.profiler,
summed over ResNet-18's 61 leaves whose size is a multiple of 16, at world
1 and 8, in turns (shipped, own, staged, staged, own, shipped); then the
largest leaf alone, with the L2 warm and flushed. Prints one line each
and the card's name and power limit first. The variants live here only,
compiled into the package's git-ignored ``_build/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

VARIANTS_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int kThreads = 256;
__device__ __forceinline__ float code(int word, int j) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * j)));
}
// 16 codes a thread; kStaged: stores through shared memory
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
dequant16(const int8_t* __restrict__ q, const float* __restrict__ scales, int world,
          long long n, float* __restrict__ out) {
  __shared__ float4 stage[kStaged ? kThreads * 4 : 1];
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float acc[16];
  for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
  if (g < n / 16) {
    for (int w = 0; w < world; ++w) {
      const int4 v = *reinterpret_cast<const int4*>(q + static_cast<long long>(w) * n + 16 * g);
      const int words[4] = {v.x, v.y, v.z, v.w};
      const float s = scales[w];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(code(words[j / 4], j % 4), s));
    }
  }
  float4* o = reinterpret_cast<float4*>(out);
  if (!kStaged) {
    if (g < n / 16)
      for (int j = 0; j < 4; ++j)
        o[4 * g + j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    return;
  }
  for (int j = 0; j < 4; ++j)
    stage[4 * threadIdx.x + j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * 4;
  for (int j = 0; j < 4; ++j) {
    const long long i = base + threadIdx.x + kThreads * j;
    if (i < n / 4) o[i] = stage[threadIdx.x + kThreads * j];
  }
}
}  // namespace
extern "C" int dequant16(int staged, const void* q, const void* scales, int world,
                         long long n, void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n / 16 + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  auto qq = static_cast<const int8_t*>(q);
  auto ss = static_cast<const float*>(scales);
  auto oo = static_cast<float*>(out);
  if (staged) dequant16<true><<<blocks, kThreads, 0, st>>>(qq, ss, world, n, oo);
  else dequant16<false><<<blocks, kThreads, 0, st>>>(qq, ss, world, n, oo);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_variants() -> ctypes.CDLL:
    from pytorch_ps_mpi_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    src = _build.BUILD_DIR / "dequant_widths.cu"
    lib = _build.BUILD_DIR / "libdequant_widths.so"
    src.write_text(VARIANTS_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    cdll = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    cdll.dequant16.argtypes = [ctypes.c_int, P, P, ctypes.c_int,
                               ctypes.c_longlong, P, P]
    cdll.dequant16.restype = ctypes.c_int
    return cdll


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_dequant_widths: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from chip_smoke import HBM_BYTES_PER_S, device_ms
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.ops import _build
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q

    lib = build_variants()
    sizes = [p.numel() for p in ResNet18(num_classes=10, small_inputs=True,
                                         seed=0, device="cuda").parameters()
             if p.numel() % 16 == 0]

    def variant(staged):
        def call(q, s):
            out = torch.empty(q.shape[1], device="cuda")
            _build.launch(lib.dequant16, 0, staged, q.data_ptr(),
                          s.data_ptr(), q.shape[0], q.shape[1],
                          out.data_ptr())
            return out
        return call

    kernels = {"shipped": Q.dequant_sum, "own": variant(0),
               "staged": variant(1)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for world in (1, 8):
        args = [(torch.randint(-127, 128, (world, n), generator=gen,
                               device="cuda", dtype=torch.int8),
                 torch.rand(world, generator=gen, device="cuda"))
                for n in sizes]
        for name, fn in kernels.items():
            for q, s in args:
                got, want = fn(q, s), Q.dequant_sum_ref(q, s)
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"{name} differs at {tuple(q.shape)}")
        order = ["shipped", "own", "staged", "staged", "own", "shipped"]
        times = {name: [] for name in kernels}
        for name in order:
            times[name].append(device_ms(
                lambda: [kernels[name](q, s) for q, s in args]))
        print(f"world={world} leaves={len(sizes)} device_ms "
              + " ".join(f"{k}={v}" for k, v in times.items()), flush=True)
        q, s = max(args, key=lambda a: a[0].shape[1])
        bound = ((world + 4) * q.shape[1] + 4 * world) / HBM_BYTES_PER_S * 1e3
        for name, fn in kernels.items():
            print(f"world={world} leaf={q.shape[1]} {name} "
                  f"warm_ms={device_ms(lambda: fn(q, s)):.4f} "
                  f"cold_ms={device_ms(lambda: fn(q, s), cold=True):.4f} "
                  f"bound_ms={bound:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

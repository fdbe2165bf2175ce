// Top-k threshold count kernel for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel of pytorch_ps_mpi_tpu/ops/topk_pallas.py:
//   topk_count <- _counts (:67, pallas_call :74, _count_kernel :49), called
//                 once per bit by _kth_threshold (:89)
//
// exact_topk finds the k-th largest |x| without sorting: |x| is read as
// its int32 bit pattern (key = bits & 0x7fffffff, so -0.0 is 0 and NaN lies
// above Inf), and the threshold t is built from bit 30 down. Pass b tries
// cand = t | 1 << (30 - b) and counts key >= cand and key > cand; bit b of
// t is set when the first count reaches k. 31 passes, one launch each.
//
// No host sync in the loop: counts lives in device memory as i32[31][2]
// (zeroed by the caller), pass b writes row b, and every block of pass b
// rebuilds t from rows 0..b-1 itself (bit j is set iff counts[j][0] >= k).
// So the candidate never travels to the host and no update kernel runs
// between passes. The TPU kernel carried its count across a sequential
// grid in SMEM; CUDA blocks run in no order, so each block reduces its
// counts in registers and shared memory and adds them to row b with one
// integer atomicAdd per count: integer sums do not depend on the order,
// so the counts are the same from run to run.
//
// Bound: memory. One pass reads the 4n bytes of x; the design's 31 passes
// read 124n, where the function itself needs 4n + 8k bytes (read x once,
// write k values and k indices). Leaves of up to ~12 M elements fit the
// 50 MB L2, so after the first pass most reads come from L2. Closing the
// gap (a radix select of 8 bits a pass: 4 passes) is later work. 16-byte
// vector loads where x is aligned and n % 4 == 0, a scalar path otherwise.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
constexpr int kPasses = 31;

__device__ __forceinline__ int key_of(float v) {
  return __float_as_int(v) & 0x7fffffff;
}

__device__ __forceinline__ int block_sum(int v, int* smem) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kThreads / 32) ? smem[threadIdx.x] : 0;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // smem is reused by the next reduction
  return v;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ x, long long n, int k, int pass, bool vec,
             int* __restrict__ counts) {
  __shared__ int cand_s;
  __shared__ int smem[kThreads / 32];
  if (threadIdx.x == 0) {
    int t = 0;
    for (int j = 0; j < pass; ++j)
      if (counts[2 * j] >= k) t |= 1 << (30 - j);
    cand_s = t | (1 << (30 - pass));
  }
  __syncthreads();
  const int cand = cand_s;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int ge = 0, gt = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = tid; i < n / 4; i += stride) {
      const float4 v = x4[i];
      const int a = key_of(v.x), b = key_of(v.y), c = key_of(v.z), d = key_of(v.w);
      ge += (a >= cand) + (b >= cand) + (c >= cand) + (d >= cand);
      gt += (a > cand) + (b > cand) + (c > cand) + (d > cand);
    }
  } else {
    for (long long i = tid; i < n; i += stride) {
      const int a = key_of(x[i]);
      ge += a >= cand;
      gt += a > cand;
    }
  }
  ge = block_sum(ge, smem);
  gt = block_sum(gt, smem);
  if (threadIdx.x == 0) {
    atomicAdd(counts + 2 * pass, ge);
    atomicAdd(counts + 2 * pass + 1, gt);
  }
}

}  // namespace

extern "C" {

int topk_passes() { return kPasses; }

// x: f32[n]; counts: i32[31][2], zero before pass 0 and holding the
// earlier passes' rows before pass b. Adds pass b's (count >= cand,
// count > cand) to row b.
int topk_count(const void* x, long long n, int k, int pass, void* counts,
               void* stream) {
  if (n <= 0 || k <= 0 || pass < 0 || pass >= kPasses)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const long long work = vec ? n / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, k, pass, vec, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Exact top-k by magnitude for Hopper (sm_90a): a 4-pass radix select of
// the k-th largest key and a stream compaction, with a plain C interface.
//
// Replaces the Pallas TPU kernel of pytorch_ps_mpi_tpu/ops/topk_pallas.py:
//   radix_hist_kernel     <- _counts (:67, pallas_call :74, _count_kernel
//                            :49), which _kth_threshold (:89) calls once
//                            per bit: 4 passes of 8 bits in place of 31 of 1
//   compact_count_kernel  <- the compaction of exact_topk (:144,
//   compact_scatter_kernel   _compact_two_phase :102), which ran in XLA ops
//
// Keys are |x|'s int32 bit patterns (bits & 0x7fffffff: -0.0 is 0, NaN lies
// above Inf); t is the k-th largest key. The output holds the keys > t in
// index order, then the first k - m keys == t in index order (m = #keys > t),
// bit for bit the JAX package's.
//
// Threshold: digits of 7, 8, 8 and 8 bits (bits 30-24, 23-16, 15-8, 7-0).
// Pass p builds the 256-bin histogram of digit p over the keys whose higher
// bits equal the prefix the passes before it chose. Nothing waits for the
// host: the histograms live in device memory (i32[4][256], zeroed by one
// cudaMemsetAsync), and every block of pass p first rebuilds the prefix and
// the count still to find from rows 0..p-1 (one warp, a suffix sum over each
// row's 256 bins). A block gathers its histogram in shared memory, one
// atomicAdd per group of lanes with the same bin (__match_any_sync: pass 0's
// keys crowd into a few exponent bins), then adds it to its row with integer
// atomics. Integer sums do not depend on the order: the same from run to run.
//
// Compaction: index order decides the output, so each block owns one
// contiguous range of indices (a grid-stride loop would interleave them).
// compact_count_kernel writes each block's (strict, tie) counts, and block 0
// writes t and m; compact_scatter_kernel sums the counts of the blocks before
// its own to find its first slots, then walks its range in tiles of 1024 keys
// (4 a thread), ranks them by a block scan, and writes idx[k] (int32) and, for
// float32 input, values[k]. Ties whose rank reaches k - m are dropped.
//
// Launches a call, fixed: topk_threshold makes 6 (the memset, 4 histogram
// passes, the count), topk_select 7 (those and the scatter).
//
// Bound: memory. The function needs 4n + 8k bytes (read x once, write k
// values and k indices); the design reads x six times (24n + 8k). Leaves of
// up to ~12 M elements stay in the 50 MB L2 after the first pass. 16-byte
// loads where x is aligned and n % 4 == 0, scalar loads otherwise.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns the first CUDA error (0 if none).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 4;
constexpr int kBins = 256;
constexpr long long kMaxHistBlocks = 132 * 8;
constexpr long long kMaxCompactBlocks = 1024;
constexpr long long kTile = 4 * kThreads;  // keys a compaction block takes a step
constexpr long long kMaxN = 1LL << 30;
constexpr unsigned kFull = 0xffffffffu;

// scratch, int32: the histograms, t, m, then (strict, tie) per compaction block
constexpr int kHistInts = kPasses * kBins;
constexpr int kT = kHistInts;
constexpr int kM = kHistInts + 1;
constexpr int kCounts = kHistInts + 4;
constexpr int kScratchInts = kCounts + 2 * static_cast<int>(kMaxCompactBlocks);

// digit p is bits [digit_shift(p), digit_top(p)) of the key
__device__ __forceinline__ int digit_shift(int p) { return 24 - 8 * p; }
__device__ __forceinline__ int digit_top(int p) { return p == 0 ? 31 : 32 - 8 * p; }

__device__ __forceinline__ int key_of(float v) {
  return __float_as_int(v) & 0x7fffffff;
}

// Elements i0..i0+3: their values and keys, key -1 past `end` (every real
// key is >= 0, so -1 matches no prefix and is never selected).
__device__ __forceinline__ void load4(const float* __restrict__ x, long long i0,
                                      long long end, bool vec, float v[4],
                                      int key[4]) {
  if (vec && i0 + 3 < end) {
    const float4 f = *reinterpret_cast<const float4*>(x + i0);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = key_of(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j < end) {
        v[j] = x[i0 + j];
        key[j] = key_of(v[j]);
      } else {
        v[j] = 0.0f;
        key[j] = -1;
      }
    }
  }
}

// Called by all 32 lanes of one warp: the prefix of digits 0..upto-1 and the
// count still to find among the keys that carry it, from the histogram rows.
// Row p's digit is the largest d whose suffix sum (bins >= d) reaches the
// count; the count then drops by the bins above d.
__device__ void rebuild(const int* __restrict__ hist, int k, int upto,
                        int* prefix_out, int* krem_out) {
  const int lane = threadIdx.x & 31;
  int h[kPasses][8];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (p < upto) {  // lane l holds bins 8l..8l+7; all rows load at once
      const int4* row = reinterpret_cast<const int4*>(hist + p * kBins + 8 * lane);
      const int4 a = row[0], b = row[1];
      h[p][0] = a.x; h[p][1] = a.y; h[p][2] = a.z; h[p][3] = a.w;
      h[p][4] = b.x; h[p][5] = b.y; h[p][6] = b.z; h[p][7] = b.w;
    }
  }
  int prefix = 0, krem = k;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (p < upto) {
      int total = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) total += h[p][j];
      int suffix = total;  // -> the bins of this lane and the lanes above it
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_down_sync(kFull, suffix, off);
        if (lane + off < 32) suffix += o;
      }
      int cum = suffix - total, d = -1, left = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        const int next = cum + h[p][j];
        if (cum < krem && next >= krem) {
          d = 8 * lane + j;
          left = krem - cum;
        }
        cum = next;
      }
      const unsigned who = __ballot_sync(kFull, d >= 0);
      const int src = who ? __ffs(who) - 1 : 0;
      d = __shfl_sync(kFull, d, src);
      krem = __shfl_sync(kFull, left, src);
      prefix |= d << digit_shift(p);
    }
  }
  *prefix_out = prefix;
  *krem_out = krem;
}

// The sum of v over the block, in every thread.
__device__ __forceinline__ int block_sum(int v, int* smem) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // smem may still be read by the previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  int all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all += smem[w];
  return all;
}

// Exclusive prefix sum of v over the block's threads, and the block's total.
__device__ __forceinline__ void block_scan(int v, int* excl, int* total, int* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = smem[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();  // smem is reused by the next tile
  *excl = before + inc - v;
  *total = all;
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const float* __restrict__ x, long long n, int k, int pass,
                  bool vec, int* __restrict__ hist) {
  __shared__ int bins[kBins];
  __shared__ int prefix_s;
  bins[threadIdx.x] = 0;  // kThreads == kBins
  if (threadIdx.x < 32) {
    int prefix, krem;
    rebuild(hist, k, pass, &prefix, &krem);
    if (threadIdx.x == 0) prefix_s = prefix;
  }
  __syncthreads();
  const unsigned top_mask = ~0u << digit_top(pass);
  const unsigned want = static_cast<unsigned>(prefix_s) & top_mask;
  const int shift = digit_shift(pass), lane = threadIdx.x & 31;
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // the loop runs on a warp's first group, so the warp's lanes stay together
  // for __match_any_sync
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < groups; base += stride) {
    float v[4];
    int key[4];
    load4(x, 4 * (base + lane), n, vec, v, key);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool match = (static_cast<unsigned>(key[j]) & top_mask) == want;
      if (!__any_sync(kFull, match)) continue;
      const int bin = match ? (key[j] >> shift) & 0xff : -1;
      const unsigned peers = __match_any_sync(kFull, bin);
      if (match && lane == __ffs(peers) - 1) atomicAdd(&bins[bin], __popc(peers));
    }
  }
  __syncthreads();
  if (bins[threadIdx.x]) atomicAdd(hist + pass * kBins + threadIdx.x, bins[threadIdx.x]);
}

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const float* __restrict__ x, long long n, int k, long long per,
                     bool vec, int* __restrict__ scratch) {
  __shared__ int t_s;
  __shared__ int smem[kWarps];
  if (threadIdx.x < 32) {
    int t, krem;
    rebuild(scratch, k, kPasses, &t, &krem);
    if (threadIdx.x == 0) {
      t_s = t;
      if (blockIdx.x == 0) {
        scratch[kT] = t;
        scratch[kM] = k - krem;
      }
    }
  }
  __syncthreads();
  const int t = t_s;
  const long long begin = static_cast<long long>(blockIdx.x) * per;
  const long long end = begin + per < n ? begin + per : n;
  int strict = 0, tie = 0;
  for (long long i0 = begin + 4 * threadIdx.x; i0 < end; i0 += kTile) {
    float v[4];
    int key[4];
    load4(x, i0, end, vec, v, key);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      strict += key[j] > t;
      tie += key[j] == t;
    }
  }
  strict = block_sum(strict, smem);
  tie = block_sum(tie, smem);
  if (threadIdx.x == 0) {
    scratch[kCounts + 2 * blockIdx.x] = strict;
    scratch[kCounts + 2 * blockIdx.x + 1] = tie;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const float* __restrict__ x, long long n, int k, long long per,
                       bool vec, const int* __restrict__ scratch,
                       float* __restrict__ values, int* __restrict__ idx) {
  __shared__ int sum_smem[kWarps], scan_smem[kWarps];
  const int t = scratch[kT], m = scratch[kM], need = k - m;
  const int* counts = scratch + kCounts;
  int strict_before = 0, tie_before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kThreads) {
    strict_before += counts[2 * b];
    tie_before += counts[2 * b + 1];
  }
  strict_before = block_sum(strict_before, sum_smem);
  tie_before = block_sum(tie_before, sum_smem);
  const int strict_end = strict_before + counts[2 * blockIdx.x];
  const int tie_here = counts[2 * blockIdx.x + 1];
  if (strict_before == strict_end && (tie_here == 0 || tie_before >= need)) return;

  const long long begin = static_cast<long long>(blockIdx.x) * per;
  const long long end = begin + per < n ? begin + per : n;
  int strict_run = strict_before, tie_run = tie_before;  // the next ranks
  for (long long base = begin; base < end; base += kTile) {
    const long long i0 = base + 4 * threadIdx.x;
    float v[4];
    int key[4];
    load4(x, i0, end, vec, v, key);
    int ns = 0, nt = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ns += key[j] > t;
      nt += key[j] == t;
    }
    // both counts in one scan: a tile holds at most 1024 of each
    int excl, total;
    block_scan(ns | (nt << 16), &excl, &total, scan_smem);
    if (total == 0) continue;
    int s = strict_run + (excl & 0xffff), r = tie_run + (excl >> 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int slot = -1;
      if (key[j] > t) {
        slot = s++;
      } else if (key[j] == t) {
        slot = r < need ? m + r : -1;
        ++r;
      }
      if (slot >= 0) {
        idx[slot] = static_cast<int>(i0 + j);
        if (values) values[slot] = v[j];
      }
    }
    strict_run += total & 0xffff;
    tie_run += total >> 16;
    if (strict_run == strict_end && tie_run >= need) break;
  }
}

struct Plan {
  bool vec;
  unsigned hist_blocks, compact_blocks;
  long long per;  // indices a compaction block owns, a multiple of kTile
};

Plan plan_for(const void* x, long long n) {
  Plan plan;
  plan.vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  long long hb = ((n + 3) / 4 + kThreads - 1) / kThreads;
  plan.hist_blocks = static_cast<unsigned>(hb > kMaxHistBlocks ? kMaxHistBlocks : hb);
  long long cb = (n + 4 * kTile - 1) / (4 * kTile);
  cb = cb > kMaxCompactBlocks ? kMaxCompactBlocks : cb;
  plan.per = ((n + cb - 1) / cb + kTile - 1) / kTile * kTile;
  plan.compact_blocks = static_cast<unsigned>((n + plan.per - 1) / plan.per);
  return plan;
}

bool bad_args(long long n, int k, int scratch_ints) {
  return n <= 0 || n > kMaxN || k <= 0 || k > n || scratch_ints < kScratchInts;
}

int threshold_launches(const float* x, long long n, int k, int* scratch,
                       const Plan& plan, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, kHistInts * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p = 0; p < kPasses; ++p) {
    radix_hist_kernel<<<plan.hist_blocks, kThreads, 0, st>>>(x, n, k, p, plan.vec, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  compact_count_kernel<<<plan.compact_blocks, kThreads, 0, st>>>(x, n, k, plan.per,
                                                                 plan.vec, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: f32[n], 0 < k <= n <= 2**30; scratch: i32[scratch_ints], at least
// 1024 + 4 + 2 * 1024 (the call fails on less). 6 launches. Leaves the histograms in scratch[0:1024]
// (row p at p * 256), t in scratch[1024] and m in scratch[1025].
int topk_threshold(const void* x, long long n, int k, void* scratch, int scratch_ints,
                   void* stream) {
  if (bad_args(n, k, scratch_ints)) return static_cast<int>(cudaErrorInvalidValue);
  return threshold_launches(static_cast<const float*>(x), n, k, static_cast<int*>(scratch),
                            plan_for(x, n), static_cast<cudaStream_t>(stream));
}

// topk_threshold, then the scatter: idx i32[k] and, unless values is null,
// values f32[k]. 7 launches.
int topk_select(const void* x, long long n, int k, void* values, void* idx, void* scratch,
                int scratch_ints, void* stream) {
  if (bad_args(n, k, scratch_ints)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_for(x, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = threshold_launches(static_cast<const float*>(x), n, k,
                                     static_cast<int*>(scratch), plan, st);
  if (err) return err;
  compact_scatter_kernel<<<plan.compact_blocks, kThreads, 0, st>>>(
      static_cast<const float*>(x), n, k, plan.per, plan.vec,
      static_cast<const int*>(scratch), static_cast<float*>(values), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

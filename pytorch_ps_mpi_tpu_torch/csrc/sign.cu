// 1-bit sign kernels for Hopper (sm_90a), with a plain C interface.
//
// Replace the Pallas TPU kernels of pytorch_ps_mpi_tpu/ops/sign_pallas.py:
//   sign_encode(with_sum=1) <- encode_signs / _encode_kernel  (pack + sum|x|)
//   sign_encode(with_sum=0) <- pack_signs   / _pack_kernel    (pack only)
//   sign_unpack             <- unpack_signs / _unpack_kernel  (bits -> +-1)
//
// Layout (the TPU kernels' own): the flat f32 input is viewed as
// [rows, 8, 128]; bit s of packed byte [r, lane] is x[r*1024 + s*128 + lane]
// >= 0 (so -0.0 packs as +, NaN as 0).
//
// Bound: all three are memory-bound elementwise or reduction work. encode
// reads 4n bytes and writes n/8 (+4); unpack reads m bytes and writes 32m.
// At H100 SXM's 3.35 TB/s a ResNet-18 leaf of 2.36 M elements is ~2.9 us
// of traffic, about the cost of a launch, so encode is one launch a call:
//  - A thread covers 4 lanes of a packed row: eight float4 loads (one per
//    sublane s, 32 threads a row, so a warp reads 512 consecutive bytes
//    per load) and one 4-byte store of its 4 packed bytes. A block of 256
//    threads covers 8 rows a pass; x not 16-byte aligned takes scalar loads.
//  - Each thread sums its |x| in a fixed order, then the block in a fixed
//    tree. rows <= 8: one block (one pass) writes the total; no scratch,
//    no barrier across blocks.
//  - Larger: one cooperative launch of min(ceil(rows / 8), co-resident)
//    blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count,
//    cached per device), looping over passes. Each block writes its partial
//    to its own slot, the grid syncs once (cg::this_grid().sync()) and
//    block 0 sums the slots in index order: the same total from run to run,
//    no float atomics, nothing to zero first and no state kept between
//    calls. Rows past `rows` are never read, so they stay out of the sum.
//  - pack only (with_sum=0) needs no reduction: one ordinary launch of
//    ceil(rows / 8) blocks.
// The TPU kernel carried the sum across its sequential grid in an SMEM
// scalar; CUDA blocks run in no order, hence the slots and the barrier.
// One block up to 8 rows (one pass) was picked by measurement on an H100:
// one block looping up to 16, 32 or 64 rows took as long or longer over
// ResNet-18's 20 leaves (PERF.md). A 9-row grid costs ~1.5 us more than an
// 8-row block: the grid barrier and the slot reads after it. A failed
// occupancy query, or 0 co-resident blocks, is an error.
// unpack: one thread per packed byte, eight coalesced f32 stores.
//
// Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing and returns a cudaError_t (0 on success).

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLane = 128;                 // lanes per packed row
constexpr int kGroup = 8 * kLane;          // elements per packed row
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / 32;  // 32 threads x 4 lanes a row
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float block_sum(float v, float* red) {
  // fixed-order block reduction: warp butterfly, then warp 0 over warps
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red's last readers are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (lane < kThreads / 32) ? red[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // valid in every thread of warp 0
}

__device__ __forceinline__ unsigned ge0(float v, int shift) {
  return (v >= 0.0f ? 1u : 0u) << shift;
}

// kSum: Σ|x| too. kGrid: a cooperative grid, slots[gridDim.x] the blocks'
// partials; otherwise one block (kSum) or one block a pass (pack only).
template <bool kSum, bool kGrid>
__global__ void __launch_bounds__(kThreads)
sign_encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ packed,
                   float* __restrict__ total, float* __restrict__ slots, long long rows) {
  __shared__ float red[kThreads / 32];
  const int lane4 = (threadIdx.x & 31) * 4;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  float acc = 0.0f;
  for (long long r = static_cast<long long>(blockIdx.x) * kRowsPerPass + (threadIdx.x >> 5);
       r < rows; r += static_cast<long long>(gridDim.x) * kRowsPerPass) {
    const float* src = x + r * kGroup + lane4;
    float4 v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (vec) {
        v[s] = *reinterpret_cast<const float4*>(src + s * kLane);
      } else {
        v[s] = make_float4(src[s * kLane], src[s * kLane + 1], src[s * kLane + 2],
                           src[s * kLane + 3]);
      }
    }
    unsigned word = 0;  // byte j holds lane lane4 + j
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      word |= ge0(v[s].x, s) | ge0(v[s].y, s + 8) | ge0(v[s].z, s + 16) | ge0(v[s].w, s + 24);
      if constexpr (kSum)
        acc += (fabsf(v[s].x) + fabsf(v[s].y)) + (fabsf(v[s].z) + fabsf(v[s].w));
    }
    *reinterpret_cast<unsigned*>(packed + r * kLane + lane4) = word;
  }
  if constexpr (kSum) {
    float b = block_sum(acc, red);
    if constexpr (!kGrid) {
      if (threadIdx.x == 0) *total = b;
    } else {
      if (threadIdx.x == 0) slots[blockIdx.x] = b;
      cg::this_grid().sync();
      if (blockIdx.x != 0) return;
      float a = 0.0f;
      for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
        a += __ldcg(slots + i);
      b = block_sum(a, red);
      if (threadIdx.x == 0) *total = b;
    }
  }
}

// blocks of sign_encode_kernel<true, true> that fit on the current device
// at once (0 with the error in *err where the query fails)
int encode_coresident(cudaError_t* err) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int c = cache[dev].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sign_encode_kernel<true, true>,
                                                       kThreads, 0);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (per_sm * sms <= 0) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  if (dev < kMaxDevices) cache[dev].store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

__global__ void __launch_bounds__(kThreads)
sign_unpack_kernel(const uint8_t* __restrict__ packed, float* __restrict__ out,
                   long long m) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const long long r = i / kLane;
  const int lane = static_cast<int>(i % kLane);
  const unsigned b = packed[i];
  float* dst = out + r * kGroup + lane;
#pragma unroll
  for (int s = 0; s < 8; ++s) dst[s * kLane] = ((b >> s) & 1u) ? 1.0f : -1.0f;
}

}  // namespace

extern "C" {

// Rows one block covers a pass (the wrapper sizes its slots by it).
int sign_encode_rows_per_block() { return kRowsPerPass; }

// The grid sign_encode launches for `rows` packed rows on the current
// device: 1 where one block sums them, ceil(rows / 8) for pack only, the
// cooperative grid otherwise; the negated cudaError_t where the occupancy
// query fails.
long long sign_encode_grid(long long rows, int with_sum) {
  const long long passes = (rows + kRowsPerPass - 1) / kRowsPerPass;
  if (!with_sum) return passes;
  if (rows <= kRowsPerPass) return 1;  // one block sums one pass
  cudaError_t err;
  const int cap = encode_coresident(&err);
  if (cap <= 0) return -static_cast<long long>(err);
  return passes < cap ? passes : cap;
}

// x: f32[rows*1024]. out: one buffer, 4-byte aligned: u8 packed
// [0, rows*128); with_sum: then the f32 total and f32 slots[grid] (grid <=
// ceil(rows / 8), written only by the cooperative grid).
int sign_encode(const void* x, void* out, long long rows, int with_sum, void* stream) {
  if (rows <= 0 || (reinterpret_cast<uintptr_t>(out) & 3u))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  uint8_t* packed = static_cast<uint8_t*>(out);
  float* total = reinterpret_cast<float*>(packed + rows * kLane);
  float* slots = total + 1;
  const long long grid = sign_encode_grid(rows, with_sum);
  if (grid < 0) return static_cast<int>(-grid);
  if (!with_sum) {
    sign_encode_kernel<false, false><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        xp, packed, nullptr, nullptr, rows);
  } else if (grid == 1) {
    sign_encode_kernel<true, false><<<1, kThreads, 0, st>>>(xp, packed, total, nullptr, rows);
  } else {
    void* args[] = {&xp, &packed, &total, &slots, &rows};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&sign_encode_kernel<true, true>),
        dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0, st));
  }
  return static_cast<int>(cudaGetLastError());
}

// packed: u8[m] (m % 128 == 0); out: f32[8m].
int sign_unpack(const void* packed, void* out, long long m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (m + kThreads - 1) / kThreads;
  sign_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<float*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

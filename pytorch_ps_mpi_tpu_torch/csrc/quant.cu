// Int8 symmetric quantize / dequantize-sum kernels for Hopper (sm_90a),
// with a plain C interface.
//
// Replace the Pallas TPU kernels of pytorch_ps_mpi_tpu/ops/quant_pallas.py:
//   quant_int8   <- quantize_int8 (_absmax_kernel, pallas_call :84;
//                   _quant_kernel, pallas_call :97), both in one launch
//   dequant_sum  <- dequantize_int8 (_dequant_kernel, pallas_call :130) at
//                   world 1, and the codec's einsum("wn,w->n") aggregation
//                   (codecs/quant.py:61-65) at world W
//
// Semantics (the JAX package's, as XLA compiles it in its jitted step and
// in its Pallas kernel):
//   s = max(max|x| * f32(1/127), 1e-12) in f32, NaN propagating: the
//   source says max|x| / 127.0, and XLA rewrites a division by a constant
//   into a product with its f32 reciprocal;
//   q = clip(round_half_even(x / s), -127, 127), NaN -> 0 (XLA's f32->s8
//   convert); dequant_sum: out[i] = sum_w f32(q[w, i]) * s[w], in rank order.
// x / s is a true division (never a multiply by a reciprocal), rounding
// is rintf (half to even), and every product and sum is an explicit
// __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA: the codes
// and sums are bit-exact against the plain PyTorch versions.
//
// The absmax is a max over the int32 bit patterns of |x|: for non-negative
// floats integer order is value order, and NaN's pattern lies above Inf's,
// so NaN wins as jnp.max makes it win (fmaxf would drop it). A max is
// order-free, so the result is the same from run to run.
//
// Bound: memory. quantize needs 4n + n + 4 bytes; it reads x from device
// memory once and makes one device launch a call, with no memset:
//  - n <= kTile: one block. Its threads load the tile into registers
//    (kQuads float4s each, 16-byte loads where x is 16-byte aligned,
//    scalar loads otherwise), the block reduces the bit-pattern max and
//    computes s, and the threads quantize what they hold with char4
//    stores. No scratch, no barrier across blocks.
//  - n > kTile: one cooperative launch of min(ceil(n / kTile), co-resident
//    blocks) blocks. Each block loads its first tile the same way, reduces
//    it and writes its max to its own slot; the grid syncs once
//    (cg::this_grid().sync()); every block reduces all slots in index
//    order (nothing to zero first), then quantizes the tile it holds. The
//    co-resident count is cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//    the SM count, computed once per device and cached here.
//  - Past grid x kTile elements (n > co-resident x kTile) a block's further
//    tiles are read for the max and read a second time to quantize. On an
//    H100 (48 registers a thread, 5 blocks an SM: 660 blocks) that starts
//    past 2,703,360 elements; ResNet-18's largest leaf holds 2,359,296.
// Measured on an H100 (PERF.md): holding the tile in registers took 3%
// less device time over ResNet-18's 62 leaves than staging it in shared
// memory by a cp.async.bulk copy on an mbarrier (the first design), and
// kTile = 4,096 beat 8,192 and 16,384 there (each built and timed). A
// 2-block grid costs ~1.5 us more than one block: the grid barrier and the
// slot reads after it. A failed occupancy query, or 0 co-resident blocks,
// is an error; nothing falls back.
// dequant_sum reads W*n + 4W bytes and writes 4n: 4 codes a thread (a
// coalesced 4-byte load per rank, a float4 store) where n % 4 == 0 and the
// pointers are aligned, 1 otherwise; the grid sized to the leaf.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a cudaError_t (0 on success).

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 4096;  // floats a block holds
constexpr int kThreads = 256;
constexpr int kQuads = kTile / (4 * kThreads);  // float4s a thread holds
constexpr int kMaxDevices = 64;
constexpr float kInv127 = 1.0f / 127.0f;  // rounded to f32 at compile time
static_assert(kTile % (4 * kThreads) == 0, "whole float4s a thread");

__device__ __forceinline__ float scale_from_bits(int bits) {
  const float s = __fmul_rn(__int_as_float(bits), kInv127);
  // jnp.maximum(s, 1e-12): NaN propagates (fmaxf alone would drop it)
  return (s != s) ? s : fmaxf(s, 1e-12f);
}

__device__ __forceinline__ int8_t quant1(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  if (r != r) return 0;  // XLA converts NaN to 0
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

__device__ __forceinline__ int abs_bits(float v) {
  return __float_as_int(v) & 0x7fffffff;
}

__device__ __forceinline__ int abs_bits4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ char4 quant4(float4 v, float s) {
  return make_char4(quant1(v.x, s), quant1(v.y, s), quant1(v.z, s), quant1(v.w, s));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// this thread's quads of the tile x[0, len): quad j holds x[4 * (threadIdx.x
// + j * kThreads) ...]. Where x is 16-byte aligned and len % 4 == 0 (every
// tile of such a leaf) each quad is one 16-byte load, all issued before
// any is used; otherwise scalar loads. Lanes past len read 0, which no
// max|x| can lose to.
__device__ __forceinline__ void load_quads(const float* __restrict__ x, int len, bool vec,
                                           float4 (&v)[kQuads]) {
  if (vec && (len & 3) == 0) {
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int i = 4 * (threadIdx.x + j * kThreads);
      v[j] = i < len ? *reinterpret_cast<const float4*>(x + i) : make_float4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int i = 4 * (threadIdx.x + j * kThreads);
      v[j] = make_float4(i < len ? x[i] : 0.0f, i + 1 < len ? x[i + 1] : 0.0f,
                         i + 2 < len ? x[i + 2] : 0.0f, i + 3 < len ? x[i + 3] : 0.0f);
    }
  }
}

// q[0, len) from this thread's quads: char4 stores (q is 4-byte aligned),
// byte stores for a partial last quad
__device__ __forceinline__ void quant_quads(const float4 (&v)[kQuads], int len, float s,
                                            int8_t* __restrict__ q) {
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int i = 4 * (threadIdx.x + j * kThreads);
    if (i + 4 <= len) {
      *reinterpret_cast<char4*>(q + i) = quant4(v[j], s);
    } else if (i < len) {
      q[i] = quant1(v[j].x, s);
      if (i + 1 < len) q[i + 1] = quant1(v[j].y, s);
      if (i + 2 < len) q[i + 2] = quant1(v[j].z, s);
    }
  }
}

// the max of v over the block, in every thread
__device__ __forceinline__ int block_max(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) v = max(v, red[w]);
  return v;
}

// max|x| bits of x[0, len) (global memory; float4 loads where vec)
__device__ __forceinline__ int range_max(const float* __restrict__ x, int len, bool vec) {
  int m = 0;
  const int len4 = vec ? (len & ~3) : 0;
  for (int i = 4 * threadIdx.x; i < len4; i += 4 * kThreads)
    m = max(m, abs_bits4(*reinterpret_cast<const float4*>(x + i)));
  for (int i = len4 + threadIdx.x; i < len; i += kThreads) m = max(m, abs_bits(x[i]));
  return m;
}

// q[0, len) from x[0, len) (global memory; float4 loads and char4 stores
// where vec)
__device__ __forceinline__ void range_quant(const float* __restrict__ x, int len, bool vec,
                                            float s, int8_t* __restrict__ q) {
  const int len4 = vec ? (len & ~3) : 0;
  for (int i = 4 * threadIdx.x; i < len4; i += 4 * kThreads)
    *reinterpret_cast<char4*>(q + i) = quant4(*reinterpret_cast<const float4*>(x + i), s);
  for (int i = len4 + threadIdx.x; i < len; i += kThreads) q[i] = quant1(x[i], s);
}

// kGrid false: one block, n <= kTile. kGrid true: a cooperative grid, each
// block's first tile held in its threads' registers, slots[gridDim.x] the
// blocks' maxima.
template <bool kGrid>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, long long n, int8_t* __restrict__ q,
             float* __restrict__ scale_out, int* __restrict__ slots) {
  __shared__ int red[kThreads / 32];
  const bool vec = aligned16(x);
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), n - start));
  float4 v[kQuads];
  load_quads(x + start, len, vec, v);
  int m = 0;
#pragma unroll
  for (int j = 0; j < kQuads; ++j) m = max(m, abs_bits4(v[j]));
  const long long stride = static_cast<long long>(gridDim.x) * kTile;
  if constexpr (kGrid) {  // tiles past the grid's first: read here and again below
    for (long long t = start + stride; t < n; t += stride)
      m = max(m, range_max(x + t, static_cast<int>(min(static_cast<long long>(kTile), n - t)),
                           vec));
  }
  m = block_max(m, red);
  if constexpr (kGrid) {
    if (threadIdx.x == 0) slots[blockIdx.x] = m;
    cg::this_grid().sync();
    m = 0;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
      m = max(m, __ldcg(slots + i));
    m = block_max(m, red);
  }
  const float s = scale_from_bits(m);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  quant_quads(v, len, s, q + start);
  if constexpr (kGrid) {
    for (long long t = start + stride; t < n; t += stride)
      range_quant(x + t, static_cast<int>(min(static_cast<long long>(kTile), n - t)), vec, s,
                  q + t);
  }
}

// blocks of quant_kernel<true> that fit on the current device at once
// (0 with the error in *err where the query fails)
int quant_coresident(cudaError_t* err) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int c = cache[dev].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quant_kernel<true>, kThreads, 0);
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

// V consecutive codes a thread (V = 4: one 4-byte load per rank and one
// float4 store; V = 1: bytes), one group a thread, so each thread reads
// each rank's scale once and a small leaf is one block. Row w starts at
// q + w * n, so every row stays 4-byte aligned where n % 4 == 0 and q is.
// 16 codes a thread (one 16-byte load per rank) measured slower at every
// ResNet-18 leaf size, at world 1 and 8, with or without its sums staged
// through shared memory for coalesced stores (chip_dequant_widths.py).
template <int V>
__global__ void __launch_bounds__(kThreads)
dequant_sum_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                   int world, long long n, float* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n / V) return;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int w = 0; w < world; ++w) {
    const int8_t* row = q + static_cast<long long>(w) * n + g * V;
    const float s = scales[w];
    int8_t c[V];
    if constexpr (V == 4) {
      const char4 word = *reinterpret_cast<const char4*>(row);
      c[0] = word.x;
      c[1] = word.y;
      c[2] = word.z;
      c[3] = word.w;
    } else {
      c[0] = row[0];
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(static_cast<float>(c[j]), s));
  }
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(out)[g] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    out[g] = acc[0];
  }
}

template <int V>
int launch_dequant_sum(const void* q, const void* scales, int world, long long n,
                       void* out, cudaStream_t st) {
  const long long blocks = (n / V + kThreads - 1) / kThreads;
  dequant_sum_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), world, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats one quant_int8 block holds (the wrapper sizes its buffer by it).
int quant_int8_tile() { return kTile; }

// The grid quant_int8 launches for n elements on the current device: 1 for
// one block, the cooperative grid otherwise; the negated cudaError_t where
// the occupancy query fails.
long long quant_int8_grid(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles <= 1) return 1;
  cudaError_t err;
  const int cap = quant_coresident(&err);
  if (cap <= 0) return -static_cast<long long>(err);
  return tiles < cap ? tiles : cap;
}

// x: f32[n]. out: one buffer, 16-byte aligned: i8 codes [0, n), the f32
// scale at byte round_up(n, 4), then i32 slots[grid] (grid <=
// ceil(n / kTile), only where n > kTile).
int quant_int8(const void* x, void* out, long long n, void* stream) {
  if (n <= 0 || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  int8_t* q = static_cast<int8_t*>(out);
  float* scale = reinterpret_cast<float*>(q + ((n + 3) & ~3LL));
  int* slots = reinterpret_cast<int*>(scale + 1);
  const long long grid = quant_int8_grid(n);
  if (grid < 0) return static_cast<int>(-grid);
  if (grid == 1) {
    quant_kernel<false><<<1, kThreads, 0, st>>>(xp, n, q, scale, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&xp, &n, &q, &scale, &slots};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&quant_kernel<true>), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, 0, st));
}

// q: i8[world, n] (row-major); scales: f32[world]; out: f32[n].
int dequant_sum(const void* q, const void* scales, int world, long long n,
                void* out, void* stream) {
  if (n <= 0 || world <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 3u) == 0 && aligned16(out))
    return launch_dequant_sum<4>(q, scales, world, n, out, st);
  return launch_dequant_sum<1>(q, scales, world, n, out, st);
}

}  // extern "C"

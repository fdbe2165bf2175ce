// Int8 symmetric quantize / dequantize-sum kernels for Hopper (sm_90a),
// with a plain C interface.
//
// Replace the Pallas TPU kernels of pytorch_ps_mpi_tpu/ops/quant_pallas.py:
//   quant_absmax + quant_apply <- quantize_int8 (_absmax_kernel, pallas_call
//                                 :84; _quant_kernel, pallas_call :97)
//   dequant_sum                <- dequantize_int8 (_dequant_kernel, pallas_call
//                                 :130) at world 1, and the codec's
//                                 einsum("wn,w->n") aggregation
//                                 (codecs/quant.py:61-65) at world W
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
// so NaN wins as jnp.max makes it win (fmaxf would drop it). An atomicMax
// on that pattern is order-free, so the result is the same from run to run.
//
// Bound: memory. quantize reads x twice (absmax pass, quantize pass; the
// function itself needs 4n + n + 4 bytes): grid-stride loops, float4 loads
// where x is aligned and n % 4 == 0, a scalar path otherwise, one atomicMax
// per block; no tuning yet (no TMA, no fusion of the two passes).
// dequant_sum reads W*n + 4W bytes and writes 4n: 4 codes a thread (a
// coalesced 4-byte load per rank, a float4 store) where n % 4 == 0 and the
// pointers are aligned, 1 otherwise; the grid sized to the leaf.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 resident blocks per SM
constexpr float kInv127 = 1.0f / 127.0f;    // rounded to f32 at compile time

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

long long blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long n, bool vec,
              int* __restrict__ absmax_bits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int m = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = tid; i < n / 4; i += stride) {
      const float4 v = x4[i];
      m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)),
                     max(abs_bits(v.z), abs_bits(v.w))));
    }
  } else {
    for (long long i = tid; i < n; i += stride) m = max(m, abs_bits(x[i]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ int smem[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = (lane < kThreads / 32) ? smem[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(absmax_bits, m);
  }
}

__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, long long n, bool vec,
             const int* __restrict__ absmax_bits, int8_t* __restrict__ q,
             float* __restrict__ scale_out) {
  const float s = scale_from_bits(*absmax_bits);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid == 0) *scale_out = s;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    for (long long i = tid; i < n / 4; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_char4(quant1(v.x, s), quant1(v.y, s), quant1(v.z, s),
                         quant1(v.w, s));
    }
  } else {
    for (long long i = tid; i < n; i += stride) q[i] = quant1(x[i], s);
  }
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

// x: f32[n]; q: i8[n] out; scale: f32[1] out; absmax_bits: i32[1] scratch.
int quant_int8(const void* x, void* q, void* scale, void* absmax_bits,
               long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(q);
  const long long blocks = blocks_for(vec ? n / 4 : n);
  cudaError_t err = cudaMemsetAsync(absmax_bits, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(x), n, vec, static_cast<int*>(absmax_bits));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(x), n, vec, static_cast<const int*>(absmax_bits),
      static_cast<int8_t*>(q), static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
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

// TernGrad ternarize + base-4 pack, and the dequantizing unpack-sum, for
// Hopper (sm_90a), with a plain C interface.
//
// Replace the Pallas TPU kernels of pytorch_ps_mpi_tpu/ops/tern_pallas.py:
//   tern_pack        <- tern_pack (_pack_kernel, pallas_call :73)
//   tern_unpack_sum  <- tern_unpack (_unpack_kernel, pallas_call :108) at
//                       world 1, and TernGradCodec.aggregate's
//                       einsum("wn,w->n") (codecs/terngrad.py:233-242) at
//                       world W
//
// Layout (the Pallas kernel's): the flat input is viewed as [rows, 4, 128];
// digit s (weight 4^s) of packed byte [r, lane] holds element
// r*512 + s*128 + lane. Digits: 0 -> -1, 1 -> 0 (dropped), 2 -> +1.
//
// Semantics, bit for bit the Pallas kernel's:
//   p24  = |x| * (16777216 / s)   a true division, then a product
//   keep = float(u >> 8) < p24    u the raw uint32 random bits, shifted
//                                 logically; 24 bits, exact in f32
//   digit = keep ? (x >= 0 ? 2 : 0) : 1
// so -0.0 packs as +, a NaN element (or a NaN/Inf scale) never keeps, and
// |x| == s (p24 = 2^24, above every 24-bit u) always keeps. The unpack-sum
// is out[i] = sum_w f32(digit_w[i] - 1) * s_w in rank order, the first
// rank's product taken alone, so one rank equals tern_unpack bit for bit.
// Every product, quotient and sum is an explicit __fmul_rn/__fdiv_rn/
// __fadd_rn: nvcc cannot contract them into an FMA or a reciprocal.
//
// Bound: memory. tern_pack reads 4n bytes of x and 4n of bits and writes
// n/4 (8.25 bytes an element); tern_unpack_sum reads W*n/4 and writes 4n.
// Design for that bound: one thread per packed byte, so each of the four
// digit reads of a warp is one coalesced 128-byte row of x and of the bits,
// and the four outputs of the unpack likewise; grid-stride loops, the scale
// read on the device (no host sync). No tuning yet (no 16-byte vector
// loads, no persistent grid).
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 resident blocks per SM
constexpr int kLane = 128;

long long blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

__global__ void __launch_bounds__(kThreads)
tern_pack_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
                 const float* __restrict__ scale, long long m,
                 uint8_t* __restrict__ out) {
  const float k = __fdiv_rn(16777216.0f, *scale);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < m; b += stride) {
    const long long base = (b / kLane) * (4 * kLane) + (b % kLane);
    unsigned packed = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float v = x[base + s * kLane];
      const float p24 = __fmul_rn(fabsf(v), k);
      const float u24 = static_cast<float>(bits[base + s * kLane] >> 8);
      const unsigned digit = (u24 < p24) ? (v >= 0.0f ? 2u : 0u) : 1u;
      packed |= digit << (2 * s);
    }
    out[b] = static_cast<uint8_t>(packed);
  }
}

__global__ void __launch_bounds__(kThreads)
tern_unpack_sum_kernel(const uint8_t* __restrict__ packed,
                       const float* __restrict__ scales, int world, long long m,
                       float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < m; b += stride) {
    float acc[4];
    for (int w = 0; w < world; ++w) {
      const unsigned byte = packed[w * m + b];
      const float s = scales[w];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float t = __fmul_rn(
            static_cast<float>(static_cast<int>((byte >> (2 * d)) & 3u) - 1), s);
        acc[d] = (w == 0) ? t : __fadd_rn(acc[d], t);
      }
    }
    const long long base = (b / kLane) * (4 * kLane) + (b % kLane);
#pragma unroll
    for (int d = 0; d < 4; ++d) out[base + d * kLane] = acc[d];
  }
}

}  // namespace

extern "C" {

// x: f32[n], bits: u32[n], scale: f32[1]; out: u8[n/4]. n % 512 == 0.
int tern_pack(const void* x, const void* bits, const void* scale, long long n,
              void* out, void* stream) {
  if (n <= 0 || n % (4 * kLane)) return static_cast<int>(cudaErrorInvalidValue);
  const long long m = n / 4;
  tern_pack_kernel<<<static_cast<unsigned>(blocks_for(m)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(bits),
      static_cast<const float*>(scale), m, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// packed: u8[world, m] (row-major), scales: f32[world]; out: f32[4m].
// m % 128 == 0.
int tern_unpack_sum(const void* packed, const void* scales, int world,
                    long long m, void* out, void* stream) {
  if (m <= 0 || m % kLane || world <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  tern_unpack_sum_kernel<<<static_cast<unsigned>(blocks_for(m)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      world, m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

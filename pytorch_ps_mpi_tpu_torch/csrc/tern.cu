// TernGrad: the scale, the ternarize + base-4 pack, and the dequantizing
// unpack-sum, for Hopper (sm_90a), with a plain C interface.
//
// Replace the Pallas TPU kernels of pytorch_ps_mpi_tpu/ops/tern_pallas.py
// and the scale the JAX codec computes around them:
//   tern_encode      <- tern_pack (_pack_kernel, pallas_call :73) with the
//                       codec's jnp.maximum(jnp.max(jnp.abs(g)), 1e-12)
//                       (codecs/terngrad.py:187), both in one launch
//   tern_scale       <- the chunked encode's absmax scan (codecs/
//                       terngrad.py:149-155), in one launch
//   tern_pack        <- tern_pack with a given scale (one chunk of a
//                       chunked leaf, and the JAX signature)
//   tern_unpack_sum  <- tern_unpack (_unpack_kernel, pallas_call :108) at
//                       world 1, and TernGradCodec.aggregate's
//                       einsum("wn,w->n") (codecs/terngrad.py:233-242) at
//                       world W
//
// Layout (the Pallas kernel's): the flat input is viewed as [rows, 4, 128];
// digit s (weight 4^s) of packed byte [r, lane] holds element
// r*512 + s*128 + lane. Digits: 0 -> -1, 1 -> 0 (dropped), 2 -> +1.
//
// Semantics, bit for bit the JAX codec's with the Pallas kernel:
//   s    = max(max|x|, 1e-12) in f32, NaN propagating
//   p24  = |x| * (16777216 / s)   a true division, then a product
//   keep = float(u >> 8) < p24    u the raw uint32 random bits, shifted
//                                 logically; 24 bits, exact in f32
//   digit = keep ? (x >= 0 ? 2 : 0) : 1
// so -0.0 packs as +, a NaN element (or a NaN/Inf scale) never keeps, and
// |x| == s (p24 = 2^24, above every 24-bit u) always keeps. x is read in
// its own type, f32 or bf16: bf16 -> f32 is exact (a shift), so the digits
// and the scale are those of the f32 cast the JAX codec makes first. The
// max is taken over the int32 bit patterns of |x| (as csrc/quant.cu does):
// for non-negative floats integer order is value order and a NaN's pattern
// lies above Inf's, so NaN wins as jnp.max makes it win (fmaxf would drop
// it), and max(bits, bits(1e-12f)) is the clamp. A NaN scale is written as
// the card's canonical NaN (0x7fffffff), the pattern PyTorch's plain
// version gives on the card (its abs does not keep a NaN's payload; the
// JAX package on the CPU keeps the input's, 0x7fc00000 for a plain NaN):
// a NaN's payload is no part of the codec's contract. The unpack-sum is
// out[i] = sum_w f32(digit_w[i] - 1) * s_w in rank order, the first rank's
// product taken alone, so one rank equals tern_unpack bit for bit. Every
// product, quotient and sum is an explicit __fmul_rn/__fdiv_rn/__fadd_rn:
// nvcc cannot contract them into an FMA or a reciprocal.
//
// Bound: memory. The encode reads x (4 or 2 bytes an element) and the bits
// (4) once and writes n/4 bytes and the scale: 8.25 bytes an element from
// f32, 6.25 from bf16. The scale reads x once; a given-scale pack moves what
// the encode does; the unpack-sum reads W*n/4 and writes 4n.
// Design for that bound:
//  - A thread takes a quad: four consecutive lanes of a packed row, so for
//    each of the four sublanes one 16-byte load of x (8-byte for bf16) and
//    one of the bits, and one 4-byte store of its 4 packed bytes. A warp
//    covers one packed row (32 quads), each load a coalesced 512 bytes. A
//    base pointer off that alignment takes scalar loads and byte stores.
//  - tern_encode, n <= kTile (4096): one block; each thread holds its quad
//    of x in registers, the block reduces the bit-pattern max, and the
//    threads pack what they hold. Larger: one cooperative launch of
//    min(ceil(n / kTile), co-resident) blocks (quant.cu's pattern). Each
//    block holds its first tile in registers, reduces and writes its max to
//    its own slot, the grid syncs once, every block reduces the slots in
//    index order (nothing to zero first) and packs the tile it holds;
//    tiles past the grid's first are read for the max and again to pack
//    (BERT-base's largest whole leaf, 2,359,296 elements, is 576 tiles; a
//    leaf of 4.7 MB of bf16 is read again from the 50 MB L2). The bits are
//    prefetched into L2 before the barrier, so the pack after it does not
//    wait on device memory for them.
//  - tern_scale: the same kernel without the pack: every block loops over
//    its tiles, and block 0 writes the scale after the grid's barrier.
//  - tern_pack: the scale read on the device (no host sync), one quad a
//    thread, the grid sized to the work; no barrier.
//  - tern_unpack_sum: a thread takes four consecutive packed bytes of each
//    rank (one 4-byte load a rank; above world 1, 4 ranks' loads issued
//    before their products: at world 8 on an H100 that took less time
//    than 8, 2 or 1, or than 4 with the registers capped, chip_tern_ab.py)
//    and makes four 16-byte stores, one a sublane. At world 8 it still
//    takes ~2% longer than one thread a packed byte did; at world 1, 14%
//    less (PERF.md).
// The co-resident count is cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// the SM count, per kernel and device, computed once and cached. A failed
// occupancy query, or 0 co-resident blocks, is an error; nothing falls
// back.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a cudaError_t (0 on success).

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;
constexpr int kQuad = 16;                // elements a quad covers
constexpr int kTile = kThreads * kQuad;  // elements a block holds: 4096
constexpr int kMaxDevices = 64;

using bf16_bits = uint16_t;  // a bf16 element, read as its bit pattern

__host__ __device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// the first element of quad q: row q / 32, lanes 4 (q % 32) ...
__device__ __forceinline__ long long quad_base(long long q) {
  return (q >> 5) * (4 * kLane) + (q & 31) * 4;
}

// x[0..4) as floats: one 16-byte load (f32) or 8-byte load (bf16) where vec
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float4 load4(const bf16_bits* p, bool vec) {
  uint2 w;
  if (vec) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    w.x = p[0] | (static_cast<unsigned>(p[1]) << 16);
    w.y = p[2] | (static_cast<unsigned>(p[3]) << 16);
  }
  // bf16 -> f32 is the bit pattern shifted up 16: exact, NaN payloads kept
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ uint4 load_bits4(const uint32_t* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(p[0], p[1], p[2], p[3]);
}

template <typename T>
__device__ __forceinline__ void load_quad(const T* __restrict__ x, long long q, bool vec,
                                          float4 (&v)[4]) {
  const T* p = x + quad_base(q);
#pragma unroll
  for (int s = 0; s < 4; ++s) v[s] = load4(p + s * kLane, vec);
}

__device__ __forceinline__ int abs_bits(float v) { return __float_as_int(v) & 0x7fffffff; }

__device__ __forceinline__ int quad_max(const float4 (&v)[4]) {
  int m = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    m = max(m, max(max(abs_bits(v[s].x), abs_bits(v[s].y)),
                   max(abs_bits(v[s].z), abs_bits(v[s].w))));
  return m;
}

__device__ __forceinline__ unsigned digit(float v, uint32_t u, float k) {
  const float p24 = __fmul_rn(fabsf(v), k);
  const float u24 = static_cast<float>(u >> 8);
  return (u24 < p24) ? (v >= 0.0f ? 2u : 0u) : 1u;
}

// packs quad q of x (held in v) with the bits and k = 2^24 / s: byte l of
// the word is lane 4 (q % 32) + l, its digit s from sublane s
__device__ __forceinline__ void pack_quad(const float4 (&v)[4], const uint32_t* __restrict__ bits,
                                          long long q, float k, bool vec,
                                          uint8_t* __restrict__ out) {
  const uint32_t* b = bits + quad_base(q);
  unsigned word = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint4 u = load_bits4(b + s * kLane, vec);
    word |= digit(v[s].x, u.x, k) << (2 * s);
    word |= digit(v[s].y, u.y, k) << (8 + 2 * s);
    word |= digit(v[s].z, u.z, k) << (16 + 2 * s);
    word |= digit(v[s].w, u.w, k) << (24 + 2 * s);
  }
  if (vec) {
    reinterpret_cast<uint32_t*>(out)[q] = word;
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) out[4 * q + l] = static_cast<uint8_t>(word >> (8 * l));
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
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

// kGrid false: one block, n <= kTile. kGrid true: a cooperative grid,
// slots[gridDim.x] the blocks' maxima. kPack false: the scale alone.
// vec: x, bits and out aligned for the quad's vector loads and store.
template <typename T, bool kGrid, bool kPack>
__global__ void __launch_bounds__(kThreads)
tern_pack_encode_kernel(const T* __restrict__ x, const uint32_t* __restrict__ bits,
                        long long n, bool vec, uint8_t* __restrict__ out,
                        float* __restrict__ scale_out, int* __restrict__ slots) {
  __shared__ int red[kThreads / 32];
  const long long quads = n / kQuad;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long q0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float4 v[4];
  int m = 0;
  long long q = q0;
  if constexpr (kPack) {  // the first quad held for the pack
    if (q0 < quads) {
      load_quad(x, q0, vec, v);
      m = quad_max(v);
      const uint32_t* b = bits + quad_base(q0);
#pragma unroll
      for (int s = 0; s < 4; ++s) prefetch_l2(b + s * kLane);
    }
    q += stride;
  }
  for (; q < quads; q += stride) {  // read here, and again below to pack
    float4 w[4];
    load_quad(x, q, vec, w);
    m = max(m, quad_max(w));
  }
  m = block_max(m, red);
  if constexpr (kGrid) {
    if (threadIdx.x == 0) slots[blockIdx.x] = m;
    cg::this_grid().sync();
    if (!kPack && blockIdx.x != 0) return;
    m = 0;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
      m = max(m, __ldcg(slots + i));
    m = block_max(m, red);
  }
  // max(max|x|, 1e-12): both non-negative bit patterns, NaN's the largest;
  // a NaN written as the card's canonical NaN, as PyTorch's abs and amax
  // write it on the card
  const float s = __int_as_float(m > 0x7f800000 ? 0x7fffffff : max(m, __float_as_int(1e-12f)));
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  if constexpr (kPack) {
    const float k = __fdiv_rn(16777216.0f, s);
    if (q0 < quads) pack_quad(v, bits, q0, k, vec, out);
    for (q = q0 + stride; q < quads; q += stride) {
      load_quad(x, q, vec, v);
      pack_quad(v, bits, q, k, vec, out);
    }
  }
}

// one quad a thread, the scale given on the device
template <typename T>
__global__ void __launch_bounds__(kThreads)
tern_pack_kernel(const T* __restrict__ x, const uint32_t* __restrict__ bits,
                 const float* __restrict__ scale, long long quads, bool vec,
                 uint8_t* __restrict__ out) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= quads) return;
  float4 v[4];
  load_quad(x, q, vec, v);
  pack_quad(v, bits, q, __fdiv_rn(16777216.0f, __ldg(scale)), vec, out);
}

// a thread: packed bytes [4g, 4g + 4) of every rank, one 4-byte load a rank
// where vec (byte loads otherwise), kBatch ranks' loads issued before their
// products, four float4 stores. kBatch 1 at world 1 keeps the registers,
// and so the blocks an SM holds, those of a one-rank decode.
template <int kBatch>
__global__ void __launch_bounds__(kThreads)
tern_unpack_sum_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ scales,
                       int world, long long m, bool vec, float* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= m / 4) return;
  float acc[4][4];  // [sublane][lane]
  for (int w0 = 0; w0 < world; w0 += kBatch) {
    unsigned words[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (w0 + j < world) {
        const uint8_t* p = packed + static_cast<long long>(w0 + j) * m + 4 * g;
        words[j] = vec ? __ldg(reinterpret_cast<const unsigned*>(p))
                       : (p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<unsigned>(p[3]) << 24));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int w = w0 + j;
      if (w >= world) break;
      const float s = __ldg(scales + w);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int t = static_cast<int>((words[j] >> (8 * l + 2 * d)) & 3u) - 1;
          const float prod = __fmul_rn(static_cast<float>(t), s);
          acc[d][l] = (w == 0) ? prod : __fadd_rn(acc[d][l], prod);
        }
      }
    }
  }
  float* o = out + quad_base(g);
#pragma unroll
  for (int d = 0; d < 4; ++d)
    *reinterpret_cast<float4*>(o + d * kLane) = make_float4(acc[d][0], acc[d][1], acc[d][2], acc[d][3]);
}

// blocks of `kernel` that fit on the current device at once (0 with the
// error in *err where the query fails); cache: one slot a device
int coresident(const void* kernel, std::atomic<int>* cache, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int c = cache[dev].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (per_sm * sms <= 0) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  if (dev < kMaxDevices) cache[dev].store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

// one launch of tern_pack_encode_kernel<T, *, kPack>: one block up to
// kTile, the cooperative grid above it
template <typename T, bool kPack>
int launch_encode(const T* x, const uint32_t* bits, long long n, uint8_t* out, float* scale,
                  int* slots, cudaStream_t st) {
  static std::atomic<int> cache[kMaxDevices];
  bool vec = aligned(x, 4 * sizeof(T));
  if (kPack) vec = vec && aligned(bits, 16) && aligned(out, 4);
  if (n <= kTile) {
    tern_pack_encode_kernel<T, false, kPack><<<1, kThreads, 0, st>>>(x, bits, n, vec, out, scale,
                                                                    nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const void* kernel = reinterpret_cast<const void*>(&tern_pack_encode_kernel<T, true, kPack>);
  cudaError_t err;
  const long long cap = coresident(kernel, cache, &err);
  if (cap <= 0) return static_cast<int>(err);
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles : cap);
  void* args[] = {&x, &bits, &n, &vec, &out, &scale, &slots};
  return static_cast<int>(cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, 0, st));
}

template <typename T>
int launch_pack(const T* x, const uint32_t* bits, const float* scale, long long n, uint8_t* out,
                cudaStream_t st) {
  const bool vec = aligned(x, 4 * sizeof(T)) && aligned(bits, 16) && aligned(out, 4);
  const long long quads = n / kQuad;
  tern_pack_kernel<T><<<static_cast<unsigned>((quads + kThreads - 1) / kThreads), kThreads, 0,
                        st>>>(x, bits, scale, quads, vec, out);
  return static_cast<int>(cudaGetLastError());
}

bool bad_size(long long n) { return n <= 0 || n % (4 * kLane); }

}  // namespace

extern "C" {

// Elements one block of tern_encode / tern_scale covers: the slots the
// cooperative grid needs are at most ceil(n / tern_tile()).
int tern_tile() { return kTile; }

// x: f32[n] (bf16 = 0) or bf16[n] (bf16 = 1); bits: u32[n]; n % 512 == 0.
// out: one buffer, 4-byte aligned: u8 packed [0, n/4), the f32 scale at byte
// n/4, then i32 slots[ceil(n / tern_tile())] (only where n > tern_tile()).
int tern_encode(const void* x, int bf16, const void* bits, long long n, void* out,
                void* stream) {
  if (bad_size(n) || !aligned(out, 4)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* packed = static_cast<uint8_t*>(out);
  float* scale = reinterpret_cast<float*>(packed + n / 4);
  int* slots = reinterpret_cast<int*>(scale + 1);
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  if (bf16)
    return launch_encode<bf16_bits, true>(static_cast<const bf16_bits*>(x), b, n, packed, scale,
                                          slots, st);
  return launch_encode<float, true>(static_cast<const float*>(x), b, n, packed, scale, slots, st);
}

// x as tern_encode's (n % 512 == 0); out: 4-byte aligned, the f32 scale,
// then i32 slots[ceil(n / tern_tile())] (only where n > tern_tile()).
int tern_scale(const void* x, int bf16, long long n, void* out, void* stream) {
  if (bad_size(n) || !aligned(out, 4)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* scale = static_cast<float*>(out);
  int* slots = reinterpret_cast<int*>(scale + 1);
  if (bf16)
    return launch_encode<bf16_bits, false>(static_cast<const bf16_bits*>(x), nullptr, n, nullptr,
                                           scale, slots, st);
  return launch_encode<float, false>(static_cast<const float*>(x), nullptr, n, nullptr, scale,
                                     slots, st);
}

// x and bits as tern_encode's, scale: f32[1] on the device; out: u8[n/4].
int tern_pack(const void* x, int bf16, const void* bits, const void* scale, long long n,
              void* out, void* stream) {
  if (bad_size(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  const float* s = static_cast<const float*>(scale);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (bf16) return launch_pack(static_cast<const bf16_bits*>(x), b, s, n, o, st);
  return launch_pack(static_cast<const float*>(x), b, s, n, o, st);
}

// packed: u8[world, m] (row-major), scales: f32[world]; out: f32[4m],
// 16-byte aligned. m % 128 == 0.
int tern_unpack_sum(const void* packed, const void* scales, int world, long long m, void* out,
                    void* stream) {
  if (m <= 0 || m % kLane || world <= 0 || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(packed, 4);
  const unsigned blocks = static_cast<unsigned>((m / 4 + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (world == 1)
    tern_unpack_sum_kernel<1><<<blocks, kThreads, 0, st>>>(p, s, world, m, vec, o);
  else
    tern_unpack_sum_kernel<4><<<blocks, kThreads, 0, st>>>(p, s, world, m, vec, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

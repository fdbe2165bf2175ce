// Flash attention forward and backward for Hopper (sm_90a), with a plain C
// interface.
//
// Replace the Pallas TPU kernels of pytorch_ps_mpi_tpu/ops/attention_pallas.py:
//   flash_fwd      <- _fwd (_fwd_kernel, pallas_call :150)
//   flash_bwd_dq   <- _bwd's first pallas_call (_bwd_dq_kernel, :281)
//   flash_bwd_dkv  <- _bwd's second pallas_call (_bwd_dkv_kernel, :301)
//
// Semantics (the Pallas kernels'): on [bh, l, d] tensors, scores
// s = (q k^T) * scale in f32; under `causal` a key is visible when
// k_off + col <= q_off + row (global coordinates, runtime offsets), and a
// masked score is -1e30; p is exp(s - m) where s > -1e29 and exactly 0
// elsewhere, so a row with no visible key gives o = 0 and
// lse = -1e30 + log(1e-30). The forward keeps the running max m, the
// running sum l and the accumulator in f32, rounds p to the input type
// before p@v (as p.astype(v.dtype)), and writes o = acc / max(l, 1e-30) in
// the input type and lse = m + log(max(l, 1e-30)) in f32 ([bh, lq]; the
// TPU's lane-replicated [bh, lq, 128] was a Mosaic tiling artifact). The
// backward recomputes p = exp(s - lse), takes dm = rowsum(do * o) - g_lse
// from the caller (the lse cotangent), forms ds = p * (dp - dm) with
// dp = do v^T, rounds p and ds to the input type before the products, and
// adds each tile's product to the f32 accumulators: dq += (ds k) * scale,
// dk += (ds^T q) * scale, dv += p^T do. Tiles that lie wholly in the
// masked future are skipped.
//
// Design. On the TPU the k (or q) grid axis runs in order on one core and
// carries the accumulators in VMEM; here blocks run in parallel, so one
// block owns a (bh, 64-row q tile) for the forward and dq, or a (bh,
// 64-row k tile) for dk/dv, and a loop inside the block walks the other
// axis. 256 threads; thread (tx, ty) = (tid % 16, tid / 16) owns score
// rows ty + 16i and columns tx + 16j (i, j < 4) and output columns
// tx + 16jj, so the row max and row sums are shuffles within 16 lanes. The
// tiles live in shared memory as f32 (rows padded by one word against bank
// conflicts), the products are f32 FMAs on the CUDA cores, and the exps
// are expf/logf.
//
// Bound. At BERT-base's shape ([48, 512, 64] bf16) the forward's bound is
// bytes (12.7 MB a call, 3.8 us at 3.35 TB/s, against 3.2 GFLOP at 989
// TFLOP/s bf16) and the backward's operations (5 products, 8.1 GFLOP a
// call). This first design runs the products on the f32 CUDA cores, not
// on the tensor cores, so it is far from either bound; wgmma tiles fed by
// TMA are the later redesign.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;              // q-tile rows and k-tile rows
constexpr int kP = kB + 1;          // padded row of a score tile
constexpr float kMasked = -1e30f;
constexpr float kThresh = -1e29f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the .astype(input dtype) before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [r0, r0 + kB) of a [len, D] matrix into an f32 tile [kB][D + 1];
// rows past len are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int len) {
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] =
        (r0 + r < len) ? to_f(src[static_cast<long long>(r0 + r) * D + c]) : 0.0f;
  }
}

// the thread's 4x4 block of a @ b^T over D, a and b f32 tiles [kB][D + 1]:
// out[i][j] = a[ty + 16i] . b[tx + 16j]
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int tx,
                                         int ty, float out[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] += av[i] * bv[j];
  }
}

// the score (row, col) after scale and mask: masked or out of range -> -1e30
__device__ __forceinline__ float masked_score(float dot, float scale, int r, int c,
                                              int lq, int lk, int q_off, int k_off,
                                              bool causal) {
  if (r >= lq || c >= lk || (causal && k_off + c > q_off + r)) return kMasked;
  return dot * scale;
}

__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int lq, int lk, int q_off, int k_off,
                 bool causal, float scale) {
  constexpr int DP = D + 1, DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * DP;
  float* Vs = Ks + kB * DP;
  float* Ps = Vs + kB * DP;  // [kB][kP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const T* kb = k + bh * lk * D;
  const T* vb = v + bh * lk * D;
  load_tile<T, D>(Qs, q + bh * lq * D, q0, lq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.0f;
  }
  for (int k0 = 0; k0 < lk; k0 += kB) {
    if (causal && k_off + k0 > q_off + q0 + kB - 1) break;  // masked future
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D>(Ks, kb, k0, lk);
    load_tile<T, D>(Vs, vb, k0, lk);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], scale, r, k0 + tx + 16 * j, lq, lk,
                               q_off, k_off, causal);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > kThresh ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        Ps[(ty + 16 * i) * kP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row16_sum(psum);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
    for (int c = 0; c < kB; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kP + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = tx + 16 * jj;
        if (d < D) {
          const float vv = Vs[c * DP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] += pv[i] * vv;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= lq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) o[(bh * lq + r) * D + d] = from_f<T>(acc[i][jj] / l_safe);
    }
    if (tx == 0) lse[bh * lq + r] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dm,
                    T* __restrict__ dq, int lq, int lk, int q_off, int k_off,
                    bool causal, float scale) {
  constexpr int DP = D + 1, DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * DP;
  float* Ks = dOs + kB * DP;
  float* Vs = Ks + kB * DP;
  float* dSs = Vs + kB * DP;  // [kB][kP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const T* kb = k + bh * lk * D;
  const T* vb = v + bh * lk * D;
  load_tile<T, D>(Qs, q + bh * lq * D, q0, lq);
  load_tile<T, D>(dOs, dout + bh * lq * D, q0, lq);
  float lse_r[4], dm_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < lq ? lse[bh * lq + r] : 0.0f;
    dm_r[i] = r < lq ? dm[bh * lq + r] : 0.0f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.0f;
  }
  for (int k0 = 0; k0 < lk; k0 += kB) {
    if (causal && k_off + k0 > q_off + q0 + kB - 1) break;
    __syncthreads();
    load_tile<T, D>(Ks, kb, k0, lk);
    load_tile<T, D>(Vs, vb, k0, lk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
    tile_dot<D>(dOs, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc = masked_score(s[i][j], scale, q0 + ty + 16 * i,
                                      k0 + tx + 16 * j, lq, lk, q_off, k_off,
                                      causal);
        const float p = sc > kThresh ? expf(sc - lse_r[i]) : 0.0f;
        dSs[(ty + 16 * i) * kP + tx + 16 * j] = round_to<T>(p * (dp[i][j] - dm_r[i]));
      }
    __syncthreads();
    float t[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) t[i][jj] = 0.0f;
    for (int c = 0; c < kB; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * kP + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = tx + 16 * jj;
        if (d < D) {
          const float kv = Ks[c * DP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) t[i][jj] += dsv[i] * kv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] += t[i][jj] * scale;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= lq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) dq[(bh * lq + r) * D + d] = from_f<T>(acc[i][jj]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dm,
                     T* __restrict__ dk, T* __restrict__ dv, int lq, int lk,
                     int q_off, int k_off, bool causal, float scale) {
  constexpr int DP = D + 1, DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * DP;
  float* Qs = Vs + kB * DP;
  float* dOs = Qs + kB * DP;
  float* Ps = dOs + kB * DP;   // [kB q rows][kP]
  float* dSs = Ps + kB * kP;   // [kB q rows][kP]
  float* Ls = dSs + kB * kP;   // [kB] lse of the q tile
  float* Dm = Ls + kB;         // [kB] dm of the q tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const T* qb = q + bh * lq * D;
  const T* ob = dout + bh * lq * D;
  load_tile<T, D>(Ks, k + bh * lk * D, k0, lk);
  load_tile<T, D>(Vs, v + bh * lk * D, k0, lk);
  // the thread owns k rows ty + 16i, output columns tx + 16jj
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.0f;
  for (int q0 = 0; q0 < lq; q0 += kB) {
    if (causal && k_off + k0 > q_off + q0 + kB - 1) continue;  // masked future
    __syncthreads();
    load_tile<T, D>(Qs, qb, q0, lq);
    load_tile<T, D>(dOs, ob, q0, lq);
    if (threadIdx.x < kB) {
      const int r = q0 + threadIdx.x;
      Ls[threadIdx.x] = r < lq ? lse[bh * lq + r] : 0.0f;
      Dm[threadIdx.x] = r < lq ? dm[bh * lq + r] : 0.0f;
    }
    __syncthreads();
    // scores of q rows ty + 16i against k rows tx + 16j
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, tx, ty, s);
    tile_dot<D>(dOs, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rq = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ck = tx + 16 * j;
        const float sc = masked_score(s[i][j], scale, q0 + rq, k0 + ck, lq, lk,
                                      q_off, k_off, causal);
        const float p = sc > kThresh ? expf(sc - Ls[rq]) : 0.0f;
        Ps[rq * kP + ck] = round_to<T>(p);
        dSs[rq * kP + ck] = round_to<T>(p * (dp[i][j] - Dm[rq]));
      }
    }
    __syncthreads();
    float t[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) t[i][jj] = 0.0f;
    for (int r = 0; r < kB; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * kP + ty + 16 * i];
        dsv[i] = dSs[r * kP + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const int d = tx + 16 * jj;
        if (d < D) {
          const float ov = dOs[r * DP + d], qv = Qs[r * DP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][jj] += pv[i] * ov;
            t[i][jj] += dsv[i] * qv;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) dk_acc[i][jj] += t[i][jj] * scale;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= lk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) {
        dk[(bh * lk + c) * D + d] = from_f<T>(dk_acc[i][jj]);
        dv[(bh * lk + c) * D + d] = from_f<T>(dv_acc[i][jj]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *dm;
  void *o, *lse, *dq, *dk, *dv;
  int bh, lq, lk, q_off, k_off;
  bool causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(int which, const Args& a) {
  constexpr int DP = D + 1;
  const int qtiles = (a.lq + kB - 1) / kB, ktiles = (a.lk + kB - 1) / kB;
  cudaError_t err;
  if (which == 0) {
    const size_t bytes = sizeof(float) * (3 * kB * DP + kB * kP);
    auto kern = flash_fwd_kernel<T, D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(qtiles, a.bh), kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse), a.lq, a.lk, a.q_off, a.k_off, a.causal,
        a.scale);
  } else if (which == 1) {
    const size_t bytes = sizeof(float) * (4 * kB * DP + kB * kP);
    auto kern = flash_bwd_dq_kernel<T, D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(qtiles, a.bh), kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in), static_cast<const float*>(a.dm),
        static_cast<T*>(a.dq), a.lq, a.lk, a.q_off, a.k_off, a.causal, a.scale);
  } else {
    const size_t bytes = sizeof(float) * (4 * kB * DP + 2 * kB * kP + 2 * kB);
    auto kern = flash_bwd_dkv_kernel<T, D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(ktiles, a.bh), kThreads, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in), static_cast<const float*>(a.dm),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.lq, a.lk, a.q_off,
        a.k_off, a.causal, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int which, int d, const Args& a) {
  switch (d) {
    case 8: return launch<T, 8>(which, a);
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int which, int bf16, int d, const Args& a) {
  if (a.bh <= 0 || a.lq <= 0 || a.lk <= 0 || a.bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch<__nv_bfloat16>(which, d, a) : dispatch<float>(which, d, a);
}

}  // namespace

extern "C" {

// q: T[bh, lq, d], k, v: T[bh, lk, d]; o: T[bh, lq, d], lse: f32[bh, lq].
// T is bf16 when bf16 != 0, else f32; d in {8, 16, 32, 64, 128}.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int bh, int lq, int lk, int d, int q_off, int k_off, int causal,
              float scale, int bf16, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         bh, lq, lk, q_off, k_off, causal != 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, bf16, d, a);
}

// dout: T[bh, lq, d], lse, dm: f32[bh, lq]; dq: T[bh, lq, d].
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* dm, void* dq, int bh, int lq,
                 int lk, int d, int q_off, int k_off, int causal, float scale,
                 int bf16, void* stream) {
  Args a{q, k, v, dout, lse, dm, nullptr, nullptr, dq, nullptr, nullptr,
         bh, lq, lk, q_off, k_off, causal != 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, bf16, d, a);
}

// dk, dv: T[bh, lk, d].
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* dm, void* dk, void* dv, int bh,
                  int lq, int lk, int d, int q_off, int k_off, int causal,
                  float scale, int bf16, void* stream) {
  Args a{q, k, v, dout, lse, dm, nullptr, nullptr, nullptr, dk, dv,
         bh, lq, lk, q_off, k_off, causal != 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(2, bf16, d, a);
}

}  // extern "C"

// Flash attention forward and backward in float32 for Hopper (sm_90a), on
// the CUDA cores, with a plain C interface. bf16 takes the tensor-core
// kernels of attention_tc.cu; the wrapper (ops/attention.py) picks the
// source by dtype. float32 stays here because the tensor cores would take
// it as TF32 (about three decimal digits), which the float32 contract
// (rtol 1e-5 forward, 1e-4 backward against the plain version) rules out.
//
// Replace, for float32, the Pallas TPU kernels of
// pytorch_ps_mpi_tpu/ops/attention_pallas.py:
//   flash_fwd_f32      <- _fwd (_fwd_kernel, pallas_call :150)
//   flash_bwd_dq_f32   <- _bwd's first pallas_call (_bwd_dq_kernel, :281)
//   flash_bwd_dkv_f32  <- _bwd's second pallas_call (_bwd_dkv_kernel, :301)
//
// Semantics (the Pallas kernels'): on [bh, l, d] tensors, scores
// s = (q k^T) * scale in f32; under `causal` a key is visible when
// k_off + col <= q_off + row (global coordinates, runtime offsets), and a
// masked score is -1e30; p is exp(s - m) where s > -1e29 and exactly 0
// elsewhere, so a row with no visible key gives o = 0 and
// lse = -1e30 + log(1e-30). The forward keeps the running max m, the
// running sum l and the accumulator in f32 and writes o = acc / max(l,
// 1e-30) and lse = m + log(max(l, 1e-30)) ([bh, lq]; the TPU's
// lane-replicated [bh, lq, 128] was a Mosaic tiling artifact). The
// backward recomputes p = exp(s - lse), forms ds = p * (dp - dm) with
// dp = do v^T and dm = rowsum(do * o) - g_lse (the lse cotangent), and
// adds each tile's product to the accumulators: dq += (ds k) * scale,
// dk += (ds^T q) * scale, dv += p^T do. The dq kernel computes dm for its
// q tile and writes it to an f32 [bh, lq] buffer that the dk/dv kernel,
// launched after it, reads. Tiles that lie wholly in the masked future
// are skipped.
//
// Design. On the TPU the k (or q) grid axis runs in order on one core and
// carries the accumulators in VMEM; here blocks run in parallel, so one
// block owns a (bh, 64-row q tile) for the forward and dq, or a (bh,
// 64-row k tile) for dk/dv, and a loop inside the block walks the other
// axis. 256 threads; thread (tx, ty) = (tid % 16, tid / 16) owns score
// rows ty + 16i and columns tx + 16j (i, j < 4) and output columns
// tx + 16jj, so the row max and row sums are shuffles within 16 lanes. The
// tiles live in shared memory (rows padded by one word against bank
// conflicts), the products are f32 FMAs on the CUDA cores, and the exps
// are expf/logf. The float32 path is on no main path (BERT runs bf16).
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;              // q-tile rows and k-tile rows
constexpr int kP = kB + 1;          // padded row of a score tile
constexpr float kMasked = -1e30f;
constexpr float kThresh = -1e29f;

// rows [r0, r0 + kB) of a [len, D] matrix into an f32 tile [kB][D + 1];
// rows past len are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, int len) {
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] =
        (r0 + r < len) ? src[static_cast<long long>(r0 + r) * D + c] : 0.0f;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* kb = k + bh * lk * D;
  const float* vb = v + bh * lk * D;
  load_tile<D>(Qs, q + bh * lq * D, q0, lq);

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
    load_tile<D>(Ks, kb, k0, lk);
    load_tile<D>(Vs, vb, k0, lk);
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
        Ps[(ty + 16 * i) * kP + tx + 16 * j] = (p);
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
      if (d < D) o[(bh * lq + r) * D + d] = (acc[i][jj] / l_safe);
    }
    if (tx == 0) lse[bh * lq + r] = m[i] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ g_lse, float* __restrict__ dm,
                    float* __restrict__ dq, int lq, int lk, int q_off, int k_off,
                    bool causal, float scale) {
  constexpr int DP = D + 1, DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * DP;
  float* Ks = dOs + kB * DP;
  float* Vs = Ks + kB * DP;
  float* dSs = Vs + kB * DP;   // [kB][kP]
  float* Dm = dSs + kB * kP;   // [kB] dm of the q tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const float* kb = k + bh * lk * D;
  const float* vb = v + bh * lk * D;
  load_tile<D>(Qs, q + bh * lq * D, q0, lq);
  load_tile<D>(dOs, dout + bh * lq * D, q0, lq);
  {  // dm = rowsum(dout * out) - g_lse of the tile's rows, 4 threads a row
    const int r = threadIdx.x / 4, row = q0 + r;
    float part = 0.0f;
    if (row < lq)
      for (int c = threadIdx.x % 4; c < D; c += 4)
        part += dout[(bh * lq + row) * D + c] * out[(bh * lq + row) * D + c];
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (threadIdx.x % 4 == 0) {
      const float val = row < lq ? part - (g_lse ? g_lse[bh * lq + row] : 0.0f) : 0.0f;
      Dm[r] = val;
      if (row < lq) dm[bh * lq + row] = val;
    }
  }
  __syncthreads();
  float lse_r[4], dm_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < lq ? lse[bh * lq + r] : 0.0f;
    dm_r[i] = Dm[ty + 16 * i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.0f;
  }
  for (int k0 = 0; k0 < lk; k0 += kB) {
    if (causal && k_off + k0 > q_off + q0 + kB - 1) break;
    __syncthreads();
    load_tile<D>(Ks, kb, k0, lk);
    load_tile<D>(Vs, vb, k0, lk);
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
        dSs[(ty + 16 * i) * kP + tx + 16 * j] = (p * (dp[i][j] - dm_r[i]));
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
      if (d < D) dq[(bh * lq + r) * D + d] = (acc[i][jj]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dm,
                     float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
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
  const float* qb = q + bh * lq * D;
  const float* ob = dout + bh * lq * D;
  load_tile<D>(Ks, k + bh * lk * D, k0, lk);
  load_tile<D>(Vs, v + bh * lk * D, k0, lk);
  // the thread owns k rows ty + 16i, output columns tx + 16jj
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.0f;
  for (int q0 = 0; q0 < lq; q0 += kB) {
    if (causal && k_off + k0 > q_off + q0 + kB - 1) continue;  // masked future
    __syncthreads();
    load_tile<D>(Qs, qb, q0, lq);
    load_tile<D>(dOs, ob, q0, lq);
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
        Ps[rq * kP + ck] = (p);
        dSs[rq * kP + ck] = (p * (dp[i][j] - Dm[rq]));
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
        dk[(bh * lk + c) * D + d] = (dk_acc[i][jj]);
        dv[(bh * lk + c) * D + d] = (dv_acc[i][jj]);
      }
    }
  }
}

struct Args {
  const float *q, *k, *v, *out, *dout, *lse_in, *g_lse;
  float *o, *lse, *dm, *dq, *dk, *dv;
  int bh, lq, lk, q_off, k_off;
  bool causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch(int which, const Args& a) {
  constexpr int DP = D + 1;
  const int qtiles = (a.lq + kB - 1) / kB, ktiles = (a.lk + kB - 1) / kB;
  cudaError_t err;
  if (which == 0) {
    const size_t bytes = sizeof(float) * (3 * kB * DP + kB * kP);
    auto kern = flash_fwd_kernel<D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(qtiles, a.bh), kThreads, bytes, a.stream>>>(
        a.q, a.k, a.v, a.o, a.lse, a.lq, a.lk, a.q_off, a.k_off, a.causal,
        a.scale);
  } else if (which == 1) {
    const size_t bytes = sizeof(float) * (4 * kB * DP + kB * kP + kB);
    auto kern = flash_bwd_dq_kernel<D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(qtiles, a.bh), kThreads, bytes, a.stream>>>(
        a.q, a.k, a.v, a.out, a.dout, a.lse_in, a.g_lse, a.dm, a.dq, a.lq,
        a.lk, a.q_off, a.k_off, a.causal, a.scale);
  } else {
    const size_t bytes = sizeof(float) * (4 * kB * DP + 2 * kB * kP + 2 * kB);
    auto kern = flash_bwd_dkv_kernel<D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(ktiles, a.bh), kThreads, bytes, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse_in, a.dm, a.dk, a.dv, a.lq, a.lk,
        a.q_off, a.k_off, a.causal, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(int which, int d, const Args& a) {
  if (a.bh <= 0 || a.lq <= 0 || a.lk <= 0 || a.bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8: return launch<8>(which, a);
    case 16: return launch<16>(which, a);
    case 32: return launch<32>(which, a);
    case 64: return launch<64>(which, a);
    case 128: return launch<128>(which, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: f32[bh, lq, d], k, v: f32[bh, lk, d]; o: f32[bh, lq, d], lse:
// f32[bh, lq]; d in {8, 16, 32, 64, 128}.
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int lq, int lk, int d, int q_off,
                  int k_off, int causal, float scale, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), nullptr, nullptr, nullptr, nullptr,
         static_cast<float*>(o), static_cast<float*>(lse), nullptr, nullptr,
         nullptr, nullptr, bh, lq, lk, q_off, k_off, causal != 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, d, a);
}

// out, dout: f32[bh, lq, d], lse: f32[bh, lq], g_lse: f32[bh, lq] or null
// (a zero cotangent); writes dm = rowsum(dout * out) - g_lse to dm
// (f32[bh, lq]) and dq: f32[bh, lq, d].
int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const void* lse,
                     const void* g_lse, void* dm, void* dq, int bh, int lq,
                     int lk, int d, int q_off, int k_off, int causal,
                     float scale, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(out),
         static_cast<const float*>(dout), static_cast<const float*>(lse),
         static_cast<const float*>(g_lse), nullptr, nullptr,
         static_cast<float*>(dm), static_cast<float*>(dq), nullptr, nullptr,
         bh, lq, lk, q_off, k_off, causal != 0, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, d, a);
}

// dm: the dq kernel's f32[bh, lq]; dk, dv: f32[bh, lk, d].
int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dm,
                      void* dk, void* dv, int bh, int lq, int lk, int d,
                      int q_off, int k_off, int causal, float scale,
                      void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), nullptr,
         static_cast<const float*>(dout), static_cast<const float*>(lse),
         nullptr, nullptr, nullptr,
         const_cast<float*>(static_cast<const float*>(dm)), nullptr,
         static_cast<float*>(dk), static_cast<float*>(dv), bh, lq, lk, q_off,
         k_off, causal != 0, scale, static_cast<cudaStream_t>(stream)};
  return run(2, d, a);
}

}  // extern "C"

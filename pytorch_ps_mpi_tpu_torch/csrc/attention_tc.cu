// Flash attention forward and backward in bf16 on Hopper's tensor cores
// (sm_90a: wgmma fed by TMA), with a plain C interface.
//
// Replace, for bf16, the Pallas TPU kernels of
// pytorch_ps_mpi_tpu/ops/attention_pallas.py:
//   flash_fwd_bf16      <- _fwd (_fwd_kernel, pallas_call :150)
//   flash_bwd_dq_bf16   <- _bwd's first pallas_call (_bwd_dq_kernel, :281)
//   flash_bwd_dkv_bf16  <- _bwd's second pallas_call (_bwd_dkv_kernel, :301)
// float32 keeps the CUDA-core kernels of attention.cu (tensor cores would
// take it as TF32); the wrapper (ops/attention.py) picks the source by
// dtype.
//
// Semantics: those of attention.cu's note, unchanged. Scores s = (q k^T) *
// scale in f32; under `causal` a key is visible when k_off + col <= q_off +
// row; a masked score is -1e30 and p is 0 where s <= -1e29; the running max,
// sum and accumulators are f32 and p is rounded to bf16 before p v; o is
// bf16 and lse f32 [bh, lq]. The backward recomputes p = exp(s - lse),
// forms ds = p (dp - dm) with dm = rowsum(dO o) - g_lse, rounds p and ds to
// bf16 before their products, and skips tiles wholly in the masked future.
//
// Bound at BERT-base's shape ([48, 512, 64], a call): the forward moves
// 12.68 MB (q, k, v, o in bf16 and lse) and does 3.22 GFLOP, so bytes bound
// it (3.8 us at 3.35 TB/s against 3.3 us at 989 TFLOP/s); the backward's
// function needs 5 products, 8.05 GFLOP (8.1 us), against 25.4 MB (7.6 us):
// operations bound it.
//
// Design. A block is one consumer warpgroup (128 threads) and owns 64 rows:
// q rows for the forward and dq, k rows for dk/dv. At BERT-base's shape
// these 384 blocks beat 128-row blocks of two warpgroups sharing each
// streamed tile (192 blocks) in every kernel (PERF.md), and the dk/dv
// kernel at d <= 64 is held to 168 registers so that 3 blocks share an SM
// and the 384 run in one wave. Thread 0 also acts as the producer: it
// loads the block's own tiles once and streams the other axis through a
// ring of two stages with TMA (cp.async.bulk.tensor, 3D maps (d, l, bh) so
// that rows past l are zero-filled rather than the next head's), each
// stage completing on an mbarrier; the copy of tile t + 2 is issued once
// the warpgroup is done with tile t, so one tile is always in flight
// while it computes. Every product is a
// wgmma.mma_async m64nNk16 with bf16 operands and f32 accumulators:
//   forward: S = Q K^T (A and B K-major in shared memory, N = 64),
//            O += P V (P from registers, V as an MN-major B, N = d);
//   dq:      S = Q K^T, dP = dO V^T (shared memory), dQ += dS K (dS from
//            registers, K as an MN-major B);
//   dk/dv:   S^T = K Q^T, dP^T = V dO^T (shared memory; the block's k rows
//            are M, so the accumulators hold P^T and dS^T row by k row),
//            dV += P^T dO, dK += dS^T Q (from registers, dO and Q as
//            MN-major B).
// So no product needs a transposed A, and P and dS never go through shared
// memory: an f32 accumulator fragment of a 64 x 16 slice, rounded to bf16
// in pairs, is exactly wgmma's register A fragment. The backward does 7
// products where the function needs 5: the dk/dv kernel recomputes S and
// dP, the price of having no atomics (dq, dk and dv are each written by one
// block, so they are the same from run to run). dm = rowsum(dO o) - g_lse
// is computed by the dq kernel from o and dO in f32 and written to an f32
// [bh, lq] buffer that the dk/dv kernel, launched after it, reads.
//
// Layouts. A tile is 64 rows of d bf16 in shared memory, as TMA writes it
// with the swizzle that the wgmma descriptor names: a row of 128 bytes
// (d = 64) takes SWIZZLE_128B, d = 32 and 16 the 64- and 32-byte modes,
// d = 128 two 64-column panels of 128B each. d = 8 is zero-padded to 16
// columns (32B) by TMA's out-of-bounds fill: where d is the reduction depth
// (Q K^T, dO V^T) the padding is zeros; where d is N (P V, dS K, P^T dO,
// dS^T Q) the product takes N = 8 and reads the first 8 columns. The row
// statistics follow the accumulator's layout: a thread holds two rows of
// its warp's 16, and the row max and sum are shuffles across the 4 lanes
// of a quad. Columns past lk (rows past lq in dk/dv) are masked by index:
// TMA's zero fill would give them a score of 0, not -1e30.
//
// Every entry point computes its own grid, shared memory and tensor maps,
// launches on the caller's stream, does not synchronise, allocates nothing
// and returns a cudaError_t (or 10000 + a CUresult when a tensor map cannot
// be encoded).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows of every tile, and rows a block owns
constexpr int kStages = 2;
constexpr float kMasked = -1e30f;
constexpr float kThresh = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;

// A [64][D] bf16 tile in shared memory.
template <int D>
struct Tile {
  static constexpr int kCols = D < 16 ? 16 : D;           // padded row
  static constexpr int kPanel = kCols < 64 ? kCols : 64;  // columns a panel
  static constexpr int kPanels = kCols / kPanel;
  static constexpr int kRowBytes = kPanel * 2;            // = swizzle span
  static constexpr int kPanelBytes = kRows * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;
  static constexpr int kKSteps = kCols / 16;              // k16 steps over d
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  static_assert(kCols % 16 == 0 && kPanels * kPanel == kCols, "head dim");
  static_assert(D * 2 % 16 == 0, "TMA takes strides in multiples of 16 bytes");
};

// Shared memory of each kernel: 1024 bytes of alignment slack, the block's
// own tiles (q; q and dO; k and v), two tiles a stage of the ring, the dq
// kernel's dm rows, and the mbarriers (one for the own tiles, one a stage).
template <int D>
struct Smem {
  static constexpr int kTile = Tile<D>::kBytes;
  static constexpr int kBars = 8 * (1 + kStages);
  static constexpr int kFwd = 1024 + (1 + 2 * kStages) * kTile + kBars;
  static constexpr int kDq = 1024 + (2 + 2 * kStages) * kTile + 4 * kRows + kBars;
  static constexpr int kDkv = 1024 + (2 + 2 * kStages) * kTile + kBars;
  static_assert(kDq <= 232448 && kDkv <= 232448, "an SM's shared memory");
};

// -- PTX: shared memory, mbarriers, TMA -----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// rows [row, row + 64) of head bh, every panel, into a tile; completes on bar
template <int D>
__device__ __forceinline__ void tma_tile(const CUtensorMap* map, uint8_t* dst,
                                         uint64_t* bar, int row, int bh) {
  using L = Tile<D>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            smem_u32(dst + p * L::kPanelBytes)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(p * L::kPanel), "r"(row), "r"(bh)
        : "memory");
}

// -- PTX: wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// The 16 columns [16 ks, 16 ks + 16) of a tile's 64 rows as a K-major
// operand (rows are M or N, d is K): a k step moves 32 bytes along a row,
// or to the next panel; 8-row groups are 8 rows apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int ks) {
  using L = Tile<D>;
  const int col = ks * 16;
  return make_desc(smem_u32(tile + (col / L::kPanel) * L::kPanelBytes +
                            (col % L::kPanel) * 2),
                   16, 8 * L::kRowBytes, L::kLayout);
}

// Rows [16 ks, 16 ks + 16) of a tile as an MN-major B (rows are K, d is N):
// two 8-row groups 8 rows apart (SBO), panels kPanelBytes apart (LBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int ks) {
  using L = Tile<D>;
  return make_desc(smem_u32(tile + ks * 16 * L::kRowBytes), L::kPanelBytes,
                   8 * L::kRowBytes, L::kLayout);
}

template <int N>
struct Mma;

template <> struct Mma<8> {
  // D[64][8] (+)= A[64][16] * B[16][8], A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D[64][8] += A[64][16] * B[16][8], A in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<16> {
  // D[64][16] (+)= A[64][16] * B[16][16], A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D[64][16] += A[64][16] * B[16][16], A in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<32> {
  // D[64][32] (+)= A[64][16] * B[16][32], A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D[64][32] += A[64][16] * B[16][32], A in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<64> {
  // D[64][64] (+)= A[64][16] * B[16][64], A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D[64][64] += A[64][16] * B[16][64], A in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<128> {
  // D[64][128] (+)= A[64][16] * B[16][128], A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D[64][128] += A[64][16] * B[16][128], A in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the low half, = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 64 x 64 f32 accumulator (rows by warp, as wgmma
// leaves them) rounded to bf16: 4 registers for each of the 4 k16 steps.
__device__ __forceinline__ void to_a_frags(const float* acc, uint32_t* a) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[4 * ks + 0] = pack_bf16(acc[8 * ks + 0], acc[8 * ks + 1]);
    a[4 * ks + 1] = pack_bf16(acc[8 * ks + 2], acc[8 * ks + 3]);
    a[4 * ks + 2] = pack_bf16(acc[8 * ks + 4], acc[8 * ks + 5]);
    a[4 * ks + 3] = pack_bf16(acc[8 * ks + 6], acc[8 * ks + 7]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator layout of m64nNk16 (f32): element 4j + 2h + e of a thread with
// lane l in warp w of its warpgroup is row 16w + l/4 + 8h, column
// 8j + 2(l%4) + e.

// Number of 64-row k tiles that the forward or dq block of the q rows from
// row0 walks (k tiles [0, n)).
__device__ __forceinline__ int k_tiles_visible(int row0, int lk, int q_off,
                                               int k_off, bool causal) {
  const int tiles = (lk + kRows - 1) / kRows;
  if (!causal) return tiles;
  const int lim = q_off + row0 + kRows - 1 - k_off;  // last visible key
  return lim < 0 ? 0 : min(tiles, lim / kRows + 1);
}

// dk/dv: the first q tile with a visible pair for k rows from col0.
__device__ __forceinline__ int q_tile_first(int col0, int q_off, int k_off,
                                            bool causal) {
  if (!causal) return 0;
  const int x = k_off + col0 - q_off - (kRows - 1);
  return x <= 0 ? 0 : (x + kRows - 1) / kRows;
}

template <int D>
__global__ void __launch_bounds__(128, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
             float* __restrict__ lse, int lq, int lk, int q_off, int k_off,
             int causal, float scale) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + L::kBytes;
  uint8_t* sv = sk + kStages * L::kBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * L::kBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n = k_tiles_visible(q0, lk, q_off, k_off, causal);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], L::kBytes);
    tma_tile<D>(&tq, sq, &bars[0], q0, bh);
    for (int t = 0; t < kStages && t < n; ++t) {
      mbar_expect_tx(&bars[1 + t], 2 * L::kBytes);
      tma_tile<D>(&tk, sk + t * L::kBytes, &bars[1 + t], t * kRows, bh);
      tma_tile<D>(&tv, sv + t * L::kBytes, &bars[1 + t], t * kRows, bh);
    }
  }
  const int row0 = q0 + warp * 16 + lane / 4;  // the thread's rows: +0, +8
  const int col_in = 2 * (lane % 4);
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  mbar_wait(&bars[0], 0);
  for (int t = 0; t < n; ++t) {
    const int s = t % kStages;
    mbar_wait(&bars[1 + s], (t / kStages) & 1);
    const uint8_t* ks = sk + s * L::kBytes;
    const uint8_t* vs = sv + s * L::kBytes;
    float sc[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kKSteps; ++kk)
      Mma<64>::ss(sc, desc_k<D>(sq, kk), desc_k<D>(ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    const int k0 = t * kRows;
    const bool need_mask =
        k0 + kRows > lk || (causal && k_off + k0 + kRows - 1 > q_off + q0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, col = k0 + 8 * j + col_in + e;
          float v = sc[i] * scale;
          if (need_mask && (col >= lk || (causal && k_off + col > q_off + row)))
            v = kMasked;
          sc[i] = v;
          mx = fmaxf(mx, v);
        }
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float corr = exp2f((m[h] - m_new) * kLog2e);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float p = sc[i] > kThresh ? exp2f((sc[i] - m_new) * kLog2e) : 0.0f;
          sc[i] = p;
          psum += p;
        }
      l[h] = l[h] * corr + quad_sum(psum);
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * h] *= corr;
        acc[4 * j + 2 * h + 1] *= corr;
      }
    }
    uint32_t pa[16];
    to_a_frags(sc, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<D>::rs(acc, pa + 4 * kk, desc_mn<D>(vs, kk));
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && t + kStages < n) {
      mbar_expect_tx(&bars[1 + s], 2 * L::kBytes);
      tma_tile<D>(&tk, sk + s * L::kBytes, &bars[1 + s], (t + kStages) * kRows, bh);
      tma_tile<D>(&tv, sv + s * L::kBytes, &bars[1 + s], (t + kStages) * kRows, bh);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= lq) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    bf16* orow = o + (static_cast<long long>(bh) * lq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h] / l_safe,
                                                     acc[4 * j + 2 * h + 1] / l_safe);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col_in) = v;
    }
    if (lane % 4 == 0) lse[static_cast<long long>(bh) * lq + row] = m[h] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const bf16* __restrict__ out, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ g_lse,
                float* __restrict__ dm, bf16* __restrict__ dq, int lq, int lk,
                int q_off, int k_off, int causal, float scale) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sdo = sq + L::kBytes;
  uint8_t* sk = sdo + L::kBytes;
  uint8_t* sv = sk + kStages * L::kBytes;
  float* dm_s = reinterpret_cast<float*>(sv + kStages * L::kBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(dm_s + kRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int n = k_tiles_visible(q0, lk, q_off, k_off, causal);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * L::kBytes);
    tma_tile<D>(&tq, sq, &bars[0], q0, bh);
    tma_tile<D>(&tdo, sdo, &bars[0], q0, bh);
    for (int t = 0; t < kStages && t < n; ++t) {
      mbar_expect_tx(&bars[1 + t], 2 * L::kBytes);
      tma_tile<D>(&tk, sk + t * L::kBytes, &bars[1 + t], t * kRows, bh);
      tma_tile<D>(&tv, sv + t * L::kBytes, &bars[1 + t], t * kRows, bh);
    }
  }
  // dm of the block's rows, two threads a row, from o and dO in device
  // memory while the tiles load
  {
    const int r = tid / 2, row = q0 + r;
    float part = 0.0f;
    if (row < lq) {
      const long long base = (static_cast<long long>(bh) * lq + row) * D;
      const __nv_bfloat162* a =
          reinterpret_cast<const __nv_bfloat162*>(out + base) + (tid % 2) * (D / 4);
      const __nv_bfloat162* b =
          reinterpret_cast<const __nv_bfloat162*>(dout + base) + (tid % 2) * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float2 x = __bfloat1622float2(a[c]), y = __bfloat1622float2(b[c]);
        part += x.x * y.x + x.y * y.y;
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (tid % 2 == 0) {
      const long long at = static_cast<long long>(bh) * lq + row;
      const float v = row < lq ? part - (g_lse ? g_lse[at] : 0.0f) : 0.0f;
      dm_s[r] = v;
      if (row < lq) dm[at] = v;
    }
  }
  __syncthreads();
  const int rloc = warp * 16 + lane / 4;  // the thread's rows: +0, +8
  const int row0 = q0 + rloc;
  const int col_in = 2 * (lane % 4);
  float lse_r[2], dm_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse_r[h] = row < lq ? lse[static_cast<long long>(bh) * lq + row] : 0.0f;
    dm_r[h] = dm_s[rloc + 8 * h];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  mbar_wait(&bars[0], 0);
  for (int t = 0; t < n; ++t) {
    const int s = t % kStages;
    mbar_wait(&bars[1 + s], (t / kStages) & 1);
    const uint8_t* ks = sk + s * L::kBytes;
    const uint8_t* vs = sv + s * L::kBytes;
    float sc[32] = {}, dp[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kKSteps; ++kk)
      Mma<64>::ss(sc, desc_k<D>(sq, kk), desc_k<D>(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < L::kKSteps; ++kk)
      Mma<64>::ss(dp, desc_k<D>(sdo, kk), desc_k<D>(vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    const int k0 = t * kRows;
    const bool need_mask =
        k0 + kRows > lk || (causal && k_off + k0 + kRows - 1 > q_off + q0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, col = k0 + 8 * j + col_in + e;
          float v = sc[i] * scale;
          if (need_mask && (col >= lk || (causal && k_off + col > q_off + row)))
            v = kMasked;
          const float p = v > kThresh ? exp2f((v - lse_r[h]) * kLog2e) : 0.0f;
          sc[i] = p * (dp[i] - dm_r[h]);
        }
    }
    uint32_t da[16];
    to_a_frags(sc, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<D>::rs(acc, da + 4 * kk, desc_mn<D>(ks, kk));
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();
    if (tid == 0 && t + kStages < n) {
      mbar_expect_tx(&bars[1 + s], 2 * L::kBytes);
      tma_tile<D>(&tk, sk + s * L::kBytes, &bars[1 + s], (t + kStages) * kRows, bh);
      tma_tile<D>(&tv, sv + s * L::kBytes, &bars[1 + s], (t + kStages) * kRows, bh);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= lq) continue;
    bf16* drow = dq + (static_cast<long long>(bh) * lq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j + col_in) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * scale,
                                acc[4 * j + 2 * h + 1] * scale);
  }
}

// at d <= 64 held to 168 registers, so that 3 blocks fit an SM and
// BERT-base's 384 blocks run in one wave over 132 SMs
template <int D>
__global__ void __launch_bounds__(128, D <= 64 ? 3 : 1)
flash_bwd_dkv_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ dm,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int lq, int lk,
                 int q_off, int k_off, int causal, float scale) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sv = sk + L::kBytes;
  uint8_t* sq = sv + L::kBytes;
  uint8_t* sdo = sq + kStages * L::kBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sdo + kStages * L::kBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int qtiles = (lq + kRows - 1) / kRows;
  const int first = q_tile_first(k0, q_off, k_off, causal);
  const int n = qtiles > first ? qtiles - first : 0;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * L::kBytes);
    tma_tile<D>(&tk, sk, &bars[0], k0, bh);
    tma_tile<D>(&tv, sv, &bars[0], k0, bh);
    for (int t = 0; t < kStages && t < n; ++t) {
      mbar_expect_tx(&bars[1 + t], 2 * L::kBytes);
      tma_tile<D>(&tq, sq + t * L::kBytes, &bars[1 + t], (first + t) * kRows, bh);
      tma_tile<D>(&tdo, sdo + t * L::kBytes, &bars[1 + t], (first + t) * kRows, bh);
    }
  }
  const int krow0 = k0 + warp * 16 + lane / 4;  // the thread's rows: +0, +8
  const int col_in = 2 * (lane % 4);
  const float* lse_b = lse + static_cast<long long>(bh) * lq;
  const float* dm_b = dm + static_cast<long long>(bh) * lq;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  mbar_wait(&bars[0], 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int q0 = (first + i) * kRows;
    mbar_wait(&bars[1 + s], (i / kStages) & 1);
    const uint8_t* qs = sq + s * L::kBytes;
    const uint8_t* dos = sdo + s * L::kBytes;
    float st[32] = {}, dpt[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kKSteps; ++kk)
      Mma<64>::ss(st, desc_k<D>(sk, kk), desc_k<D>(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < L::kKSteps; ++kk)
      Mma<64>::ss(dpt, desc_k<D>(sv, kk), desc_k<D>(dos, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    const bool need_mask =
        q0 + kRows > lq || (causal && k_off + k0 + kRows - 1 > q_off + q0);
    // column by column (lse and dm are per q row, a column here), each
    // pair of p and ds packed into its A fragment as soon as it is made
    uint32_t pa[16], da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float lse_c[2], dm_c[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q0 + 8 * j + col_in + e;
        lse_c[e] = col < lq ? lse_b[col] : 0.0f;
        dm_c[e] = col < lq ? dm_b[col] : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int krow = krow0 + 8 * h;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * h + e, col = q0 + 8 * j + col_in + e;
          float v = st[x] * scale;
          if (need_mask && (col >= lq || (causal && k_off + krow > q_off + col)))
            v = kMasked;
          p[e] = v > kThresh ? exp2f((v - lse_c[e]) * kLog2e) : 0.0f;
          ds[e] = p[e] * (dpt[x] - dm_c[e]);
        }
        pa[4 * (j / 2) + 2 * (j % 2) + h] = pack_bf16(p[0], p[1]);
        da[4 * (j / 2) + 2 * (j % 2) + h] = pack_bf16(ds[0], ds[1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<D>::rs(dv_acc, pa + 4 * kk, desc_mn<D>(dos, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<D>::rs(dk_acc, da + 4 * kk, desc_mn<D>(qs, kk));
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();
    if (tid == 0 && i + kStages < n) {
      const int row = (first + i + kStages) * kRows;
      mbar_expect_tx(&bars[1 + s], 2 * L::kBytes);
      tma_tile<D>(&tq, sq + s * L::kBytes, &bars[1 + s], row, bh);
      tma_tile<D>(&tdo, sdo + s * L::kBytes, &bars[1 + s], row, bh);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int krow = krow0 + 8 * h;
    if (krow >= lk) continue;
    const long long at = (static_cast<long long>(bh) * lk + krow) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j + col_in) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                dk_acc[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j + col_in) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// -- host side --------------------------------------------------------------------

PFN_cuTensorMapEncodeTiled encode_fn() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// The 3D map (d, l, bh) of a contiguous bf16 [bh, l, d] tensor, a box of one
// panel by 64 rows of one head.
template <int D>
int make_map(CUtensorMap* map, const void* base, int l, int bh) {
  using L = Tile<D>;
  PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(l),
                        static_cast<cuuint64_t>(bh)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                           static_cast<cuuint64_t>(l) * D * 2};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kPanel), kRows, 1};
  cuuint32_t steps[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(base), dims, strides, box, steps,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, L::kSwizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

struct Args {
  const void *q, *k, *v, *out, *dout, *lse_in, *g_lse;
  void *o, *lse, *dm, *dq, *dk, *dv;
  int bh, lq, lk, q_off, k_off, causal;
  float scale;
  cudaStream_t stream;
};

// Opts a kernel into its shared memory once per device: `ready` holds a bit
// for each device on which the attribute is set.
template <typename K>
int prepare(K kern, int smem, unsigned* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(*ready & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    *ready |= bit;
  }
  return 0;
}

// One block a 64-row tile of the owned axis (q for the forward and dq, k for
// dk/dv) of each head.
template <int D>
int launch(int which, const Args& a) {
  using S = Smem<D>;
  const int smem = which == 0 ? S::kFwd : which == 1 ? S::kDq : S::kDkv;
  const dim3 grid(((which == 2 ? a.lk : a.lq) + kRows - 1) / kRows, a.bh);
  static unsigned ready[3] = {0, 0, 0};  // this <D>'s three kernels
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map<D>(&tq, a.q, a.lq, a.bh);
  if (!err) err = make_map<D>(&tk, a.k, a.lk, a.bh);
  if (!err) err = make_map<D>(&tv, a.v, a.lk, a.bh);
  if (!err && which != 0) err = make_map<D>(&tdo, a.dout, a.lq, a.bh);
  if (err) return err;
  if (which == 0) {
    auto kern = flash_fwd_tc<D>;
    if ((err = prepare(kern, smem, &ready[which]))) return err;
    kern<<<grid, 128, smem, a.stream>>>(
        tq, tk, tv, static_cast<bf16*>(a.o), static_cast<float*>(a.lse), a.lq,
        a.lk, a.q_off, a.k_off, a.causal, a.scale);
  } else if (which == 1) {
    auto kern = flash_bwd_dq_tc<D>;
    if ((err = prepare(kern, smem, &ready[which]))) return err;
    kern<<<grid, 128, smem, a.stream>>>(
        tq, tk, tv, tdo, static_cast<const bf16*>(a.out),
        static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.g_lse), static_cast<float*>(a.dm),
        static_cast<bf16*>(a.dq), a.lq, a.lk, a.q_off, a.k_off, a.causal,
        a.scale);
  } else {
    auto kern = flash_bwd_dkv_tc<D>;
    if ((err = prepare(kern, smem, &ready[which]))) return err;
    kern<<<grid, 128, smem, a.stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.dm), static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.lq, a.lk, a.q_off, a.k_off, a.causal,
        a.scale);
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

// q: bf16[bh, lq, d], k, v: bf16[bh, lk, d], all contiguous and 16-byte
// aligned; o: bf16[bh, lq, d], lse: f32[bh, lq].
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int lq, int lk, int d, int q_off,
                   int k_off, int causal, float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, nullptr,
         o, lse, nullptr, nullptr, nullptr, nullptr,
         bh, lq, lk, q_off, k_off, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(0, d, a);
}

// out, dout: bf16[bh, lq, d], lse: f32[bh, lq], g_lse: f32[bh, lq] or null
// (a zero cotangent); writes dm = rowsum(dout * out) - g_lse to dm
// (f32[bh, lq]) and dq: bf16[bh, lq, d].
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, const void* lse,
                      const void* g_lse, void* dm, void* dq, int bh, int lq,
                      int lk, int d, int q_off, int k_off, int causal,
                      float scale, void* stream) {
  Args a{q, k, v, out, dout, lse, g_lse,
         nullptr, nullptr, dm, dq, nullptr, nullptr,
         bh, lq, lk, q_off, k_off, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, d, a);
}

// dm: the dq kernel's f32[bh, lq]; dk, dv: bf16[bh, lk, d].
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dm,
                       void* dk, void* dv, int bh, int lq, int lk, int d,
                       int q_off, int k_off, int causal, float scale,
                       void* stream) {
  Args a{q, k, v, nullptr, dout, lse, nullptr,
         nullptr, nullptr, const_cast<void*>(dm), nullptr, dk, dv,
         bh, lq, lk, q_off, k_off, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return run(2, d, a);
}

}  // extern "C"

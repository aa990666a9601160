// The tensor-core grouped GEMM with A and B swapped, shared by kernel 8
// (grouped_gemm.cu, y[e] = x[e] @ w[e]) and kernel 4's tensor-core build
// (moe_fused.cu, h[e] @ Wd[e] with a weighted-row epilogue): bf16 operands,
// f32 accumulators, for products of few rows an expert (16 at decode and
// at a 128-token admission) through wide weights.
//
//  * y[e]^T = w[e]^T . x[e]^T.  The weight tile is wgmma's A operand, 64
//    output columns a warpgroup instruction, read MN-major from shared
//    memory (w is (K, N) row-major; imm-trans-a), and the rows of x are the
//    N operand, K-major as stored.  The M tile of a block is 16, 64 or 256
//    rows (m64n16k16, m64n64k16, m64n256k16); no tensor-core work is padded
//    from 16 rows to 64.
//  * One producer warp keeps a ring of STAGES stages full by TMA (64 K rows
//    of w, 128 columns at BM <= 64, and x's 64-column slice of the M tile),
//    each completing on its mbarrier; one consumer warpgroup runs the
//    wgmmas of a stage, waits for them, and releases the stage to the
//    producer through a second mbarrier.  TMA zero-fills rows and columns
//    past M, K and N (and past an expert's M rows: E is the maps' third dim).
//  * Sums in a fixed order: a repeated launch is bitwise equal.
//
// A kernel built on it: aligns the dynamic shared memory base to 1,024
// bytes, calls init_ring (then __syncthreads), sends the producer warp to
// produce and the consumer warpgroup to consume, and reads the
// accumulators with for_each_acc.
#pragma once

#include "sm90.cuh"

namespace gtc {

constexpr int BK = 64;                    // K rows a stage: one 128-byte box row of x
constexpr int STAGES = 4;
constexpr int CONSUMERS = 128;            // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int BOX = BK * 128;             // bytes of a (64 K rows x 64 columns) box of w

// shared memory: STAGES x (NT boxes of w, then x's BM x 64 tile), then the
// full and empty mbarriers of each stage; the base is aligned to 1,024
// bytes (the 128-byte swizzle's period) by hand.  Every region is a
// multiple of 1,024 bytes.
template <int BM>
struct Tile {
  static constexpr int NT = BM <= 64 ? 2 : 1;  // m64 tiles of w's columns a block
  static constexpr int BN = 64 * NT;           // output columns a block
  static constexpr int NA = BM / 2;            // accumulator registers a thread, per m64 tile
  static constexpr int W_BYTES = NT * BOX;
  static constexpr int STAGE = W_BYTES + BM * 128;
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;
  static constexpr int YS = BN + 8;            // row stride of a bf16 output tile staged in the ring
  static_assert(BM * YS * 2 <= STAGE, "a bf16 output tile fits stage 0");
};

template <int BM>
__device__ __forceinline__ void wgmma_tn(float (&d)[BM / 2], uint64_t da, uint64_t db) {
  if constexpr (BM == 16) sm90::wgmma_tn_m64n16k16(d, da, db);
  else if constexpr (BM == 64) sm90::wgmma_tn_m64n64k16(d, da, db);
  else sm90::wgmma_tn_m64n256k16(d, da, db);
}

// thread 0 initialises the stages' full barriers (one arrival, with the
// stage's bytes) and empty barriers (one arrival per consumer warp)
template <int BM>
__device__ __forceinline__ void init_ring(uint32_t base) {
  if (threadIdx.x == 0) {
    const uint32_t full = base + Tile<BM>::BAR, empty = full + 8 * STAGES;
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    sm90::mbar_init_fence();
  }
}

// the producer (one lane): stage it % STAGES gets K rows it * BK .. of the
// block's NT boxes of w (columns n0 ..) and of x's tile (rows m0 ..) of expert e
template <int BM>
__device__ __forceinline__ void produce(const CUtensorMap* tw, const CUtensorMap* tx, uint32_t base, int n0, int m0,
                                        int e, int nk) {
  using L = Tile<BM>;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    if (it >= STAGES) sm90::mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
    const uint32_t st = base + s * L::STAGE;
    sm90::mbar_expect_tx(full + 8 * s, L::STAGE);
    for (int j = 0; j < L::NT; ++j) sm90::tma_load_3d(st + j * BOX, tw, full + 8 * s, n0 + 64 * j, it * BK, e);
    sm90::tma_load_3d(st + L::W_BYTES, tx, full + 8 * s, it * BK, m0, e);
  }
}

// the consumer warpgroup (threads 0-127): acc[j] = y^T's rows 64 j .. + 63
// of the block's columns by its BM rows of x, summed over all nk stages
template <int BM>
__device__ __forceinline__ void consume(float (&acc)[Tile<BM>::NT][Tile<BM>::NA], uint32_t base, int nk) {
  using L = Tile<BM>;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int i = 0; i < L::NA; ++i) acc[j][i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    sm90::mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const uint32_t st = base + s * L::STAGE, sx = st + L::W_BYTES;
#pragma unroll
    for (int j = 0; j < L::NT; ++j) sm90::fence_operands(acc[j]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // step kk: K rows 16 kk .. 16 kk + 15 of w (2,048 bytes on), bytes 32 kk of x's rows
      const uint64_t dx = sm90::desc_kmajor(sx + kk * 32);
#pragma unroll
      for (int j = 0; j < L::NT; ++j) wgmma_tn<BM>(acc[j], sm90::desc_mnmajor(st + j * BOX + kk * 16 * 128, BOX), dx);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < L::NT; ++j) sm90::fence_operands(acc[j]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(empty + 8 * s);
  }
}

// f(row, col, value) for each accumulator of a consumer thread: acc[j][4 c
// + 2 i + h] is output column 64 j + 16 warp + lane / 4 + 8 i of the
// block's, row 8 c + 2 (lane % 4) + h of its M tile
template <int BM, typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[Tile<BM>::NT][Tile<BM>::NA], F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < Tile<BM>::NT; ++j)
#pragma unroll
    for (int c = 0; c < BM / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(8 * c + 2 * (lane & 3) + h, 64 * j + 16 * warp + (lane >> 2) + 8 * i, acc[j][4 * c + 2 * i + h]);
}

// host: the tensor maps of w (E, K, N) as (N, K, E), boxes of (64, BK, 1),
// and x (E, M, K) as (K, M, E), boxes of (64, BM, 1); false if they cannot
// be made
template <int BM>
inline bool make_maps(CUtensorMap* tw, CUtensorMap* tx, const void* w, const void* x, int E, int M, int K, int N) {
  const cuuint64_t b = 2;  // sizeof(bf16)
  const cuuint64_t wdims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t wstr[2] = {N * b, (cuuint64_t)K * N * b};
  const cuuint32_t wbox[3] = {64, BK, 1};
  const cuuint64_t xdims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)E};
  const cuuint64_t xstr[2] = {K * b, (cuuint64_t)M * K * b};
  const cuuint32_t xbox[3] = {64, BM, 1};
  return sm90::bf16_tensor_map(tw, w, 3, wdims, wstr, wbox) && sm90::bf16_tensor_map(tx, x, 3, xdims, xstr, xbox);
}

}  // namespace gtc

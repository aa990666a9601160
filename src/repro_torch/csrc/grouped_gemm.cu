// Grouped GEMM: y[e] = x[e] @ w[e] for E experts in one launch, accumulated
// in f32, written in x's type.  The expert-parallel a2a body's down
// projection (repro_torch.kernels.moe_fused.ops.fused_experts_fn) and the
// three products of grouped_swiglu.
//
// Replaces: src/repro/kernels/grouped_gemm/kernel.py, grouped_gemm_pallas
//   (kernel _gg_kernel).
//
// What bounds it on the card: at the a2a path's down projection, h
// (128, 16, 1536) @ w_down (128, 1536, 4096) in bf16, each expert's weights
// are used by 16 rows, ~16 FLOPs per weight byte: the 1.61 GB of w_down
// bound it (0.48 ms at 3.35 TB/s); its 25.8 GFLOP take 0.026 ms at the bf16
// tensor rate and ~0.39 ms on the f32 CUDA cores.
//
// Two builds, chosen by the wrapper from (dtype, K, N, alignment) alone
// (ops.grouped_gemm_path):
//
// Tensor cores (bf16, K and N multiples of 8, 16-byte-aligned bases: what
// TMA needs of global strides and addresses): the main loop of
// grouped_tc.cuh (shared with kernel 4's tensor-core build in moe_fused.cu),
// shaped for the decode-sized product it serves, 16 rows an expert:
//  * A and B swapped, y[e]^T = w[e]^T . x[e]^T: no tensor-core work is
//    padded from 16 rows to 64; the M tile of a block is 16, 64 or 256 rows,
//    the smallest that holds M, and M beyond 256 is tiled over the grid.
//  * A 4-stage TMA ring (64 K rows of w, 128 columns at M <= 64, and x's
//    64-column slice of the M tile: 18 KB a stage at M 16) with one
//    producer warp and one consumer warpgroup.  At 73 KB a block three
//    blocks share an SM: ~190 KB of weights in flight per SM, far above the
//    ~25 KB that covers HBM latency at 3.35 TB/s.
//  * y is written in bf16 through shared memory, transposed back to
//    (E, M, N) so each row's stores are 16-byte vectors on neighbouring
//    addresses.  Every output element is written once, with its sums in a
//    fixed order: a repeated launch is bitwise equal.
//
// CUDA cores (f32, and bf16 at any other shape; the first version, kept as
// it was):
//  * One block per (256-column N tile, 16-row M tile, expert), the K loop
//    inside, f32 accumulators in registers: 16 rows x 2 columns a thread, so
//    each weight element read from shared memory feeds 16 FMAs and one
//    float4 read of the x tile (stored transposed) feeds 8.
//  * The weight tile (32 x 256) is staged in shared memory in the input
//    type with 16-byte vector loads when a row of w is a whole number of
//    16-byte vectors (scalar loads otherwise), neighbouring threads on
//    neighbouring addresses; every weight byte is read from device memory
//    once per M tile (once in all at M <= 16).
//  * Ragged M, K and N are masked in the kernel (zeros staged past the
//    edges, stores skipped): no padded copies, unlike the TPU wrapper.
//  * Every output element is written once by one thread: no atomics, the
//    same sums in the same order on every run.  The TPU kernel's sequential
//    K grid axis with its VMEM accumulator becomes the loop inside the block.
#include "common.cuh"
#include "grouped_tc.cuh"

namespace {

constexpr int BM = 16;    // rows of an M tile
constexpr int BN = 256;   // columns of an N tile
constexpr int BK = 32;    // contraction tile
constexpr int THREADS = 128;
constexpr int CPT = BN / THREADS;  // columns a thread: tid, tid + 128
constexpr int XPAD = 4;   // x tile row padding (keeps float4 alignment, spreads banks)

template <typename T>
__global__ void __launch_bounds__(THREADS) grouped_gemm_kernel(
    const T* __restrict__ x,  // (E, M, K)
    const T* __restrict__ w,  // (E, K, N)
    T* __restrict__ y,        // (E, M, N)
    int M, int K, int N, int vec) {
  __shared__ __align__(16) float xs[BK][BM + XPAD];
  // raw bytes: a __shared__ array of a class type (bf16) may not have a constructor
  __shared__ __align__(16) unsigned char ws_raw[BK * BN * sizeof(T)];
  T (*ws)[BN] = reinterpret_cast<T (*)[BN]>(ws_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  const int tid = threadIdx.x;
  const T* xe = x + e * M * (long)K;
  const T* we = w + e * K * (long)N;
  float acc[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r, kg = k0 + kk;
      xs[kk][r] = (m < M && kg < K) ? to_f32(xe[(long)m * K + kg]) : 0.f;
    }
    if (vec) {
      // N is a whole number of 16-byte vectors: a vector is all in or all out
      constexpr int V = 16 / sizeof(T);
      constexpr int CH = BN / V;
      for (int i = tid; i < BK * CH; i += THREADS) {
        const int kk = i / CH, n = n0 + (i % CH) * V;
        const int kg = k0 + kk;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (kg < K && n < N) v = *reinterpret_cast<const uint4*>(we + (long)kg * N + n);
        *reinterpret_cast<uint4*>(&ws[kk][(i % CH) * V]) = v;
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, nn = i % BN;
        const int kg = k0 + kk, n = n0 + nn;
        ws[kk][nn] = (kg < K && n < N) ? we[(long)kg * N + n] : from_f32<T>(0.f);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float b[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) b[c] = to_f32(ws[kk][tid + c * THREADS]);
      const float4* xr = reinterpret_cast<const float4*>(xs[kk]);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 a = xr[q];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[4 * q + 0][c] += a.x * b[c];
          acc[4 * q + 1][c] += a.y * b[c];
          acc[4 * q + 2][c] += a.z * b[c];
          acc[4 * q + 3][c] += a.w * b[c];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int n = n0 + tid + c * THREADS;
      if (n < N) y[(e * M + m) * (long)N + n] = from_f32<T>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor cores: wgmma on bf16 tiles fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

using gtc::CONSUMERS;

// One block per (BN-column tile, BM-row tile, expert): grouped_tc.cuh's
// main loop, then y written in bf16 through shared memory.
template <int BM>
__global__ void __launch_bounds__(gtc::THREADS, 1) grouped_gemm_tc_kernel(
    const __grid_constant__ CUtensorMap tw,  // w as (N, K, E): boxes of (64, BK, 1)
    const __grid_constant__ CUtensorMap tx,  // x as (K, M, E): boxes of (64, BM, 1)
    __nv_bfloat16* __restrict__ y,           // (E, M, N)
    int M, int K, int N) {
  using L = gtc::Tile<BM>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * L::BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const int nk = (K + gtc::BK - 1) / gtc::BK;
  gtc::init_ring<BM>(base);
  __syncthreads();
  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every load
    if (tid == CONSUMERS) gtc::produce<BM>(&tw, &tx, base, n0, m0, e, nk);
    return;
  }
  float acc[L::NT][L::NA];
  gtc::consume<BM>(acc, base, nk);

  // epilogue: the tile staged as (BM, BN) bf16 in stage 0 (every load has
  // landed and every wgmma is done once all four warps pass the barrier),
  // then stored a 16-byte row piece a thread
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - sm90::smem_u32(smem_raw)));
  gtc::for_each_acc<BM>(acc, [&](int row, int col, float v) { ys[row * L::YS + col] = __float2bfloat16(v); });
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  constexpr int PIECES = L::BN / 8;  // 16-byte pieces of a row
  for (int i = tid; i < BM * PIECES; i += CONSUMERS) {
    const int r = i / PIECES, c8 = (i - r * PIECES) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m < M && n < N)  // N is a multiple of 8: a piece is all in or all out
      *reinterpret_cast<uint4*>(y + ((long)e * M + m) * N + n) = *reinterpret_cast<const uint4*>(ys + r * L::YS + c8);
  }
}

template <int BM>
int launch(const void* x, const void* w, void* y, int E, int M, int K, int N, cudaStream_t stream) {
  using L = gtc::Tile<BM>;
  CUtensorMap tw, tx;
  if (!gtc::make_maps<BM>(&tw, &tx, w, x, E, M, K, N)) return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted =
      cudaFuncSetAttribute(grouped_gemm_tc_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((N + L::BN - 1) / L::BN, (M + BM - 1) / BM, E);
  grouped_gemm_tc_kernel<BM><<<grid, gtc::THREADS, L::BYTES, stream>>>(tw, tx, (__nv_bfloat16*)y, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int repro_grouped_gemm(int dtype, const void* x, const void* w, void* y, int E, int M, int K, int N,
                                  int vec, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, Tp, {
    grouped_gemm_kernel<Tp><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const Tp*)x, (const Tp*)w, (Tp*)y, M, K, N, vec);
  });
  return (int)cudaGetLastError();
}

// The tensor-core build: bf16 x (E, M, K), w (E, K, N), y (E, M, N), all
// contiguous and 16-byte aligned, K and N multiples of 8.
extern "C" int repro_grouped_gemm_tc(const void* x, const void* w, void* y, int E, int M, int K, int N,
                                     void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || E > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (M <= 16) return tc::launch<16>(x, w, y, E, M, K, N, s);
  if (M <= 64) return tc::launch<64>(x, w, y, E, M, K, N, s);
  if ((M + 255) / 256 > 65535) return (int)cudaErrorInvalidValue;
  return tc::launch<256>(x, w, y, E, M, K, N, s);
}

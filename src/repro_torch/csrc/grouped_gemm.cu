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
// Its backward (8_bwd), for the a2a body's gradient: dx[e] = dy[e] @ w[e]^T
// and dw[e] = x[e]^T @ dy[e], both in x's type with f32 sums, one C entry a
// build (repro_grouped_gemm_bwd, repro_grouped_gemm_bwd_tc).  The TPU kernel
// has no VJP: the reference trains the a2a body through jax's transpose of
// grouped_gemm's einsum, which computes the same two products.
//
// What bounds it on the card: at the a2a path's training shapes (E 128,
// M = ep C 320, K = f 1,536, N = d 4,096, bf16) the two products are 1.03
// TFLOP (1.04 ms at the bf16 tensor rate) over 3.8 GB of operands and
// results (1.13 ms at 3.35 TB/s): the bytes, by a little, with the tensor
// cores busy all the while.
//
// Tensor cores (bf16, K and N multiples of 8, 16-byte-aligned bases): one
// persistent block an SM walks output tiles of 64 rows x 256 columns (one
// warpgroup a 128-column half), one producer lane keeping a 4-stage TMA
// ring full (128-byte swizzle) across tiles, as moe_fused_bwd.cu's tc::gemm
// does for 4_bwd's same two products (there with f32 dy split into bf16 hi
// + lo pairs; here dy is bf16, the gradient of a bf16 output, and enters as
// it is):
//   dx  D = dy (64 slots x N) . w^T: A dy's rows and B w's 256 K rows, both
//       K-major as stored (the sum runs over N, their contiguous axis);
//   dw  D = x^T (64 rows of K x M) . dy (M x 256 of N): A and B read
//       MN-major (the sum runs over M, the rows of both).
// A tile's M-tiles are the fastest index, so the tiles in flight share one
// 256-wide slice of w (dx) or dy (dw) and read it from memory once.  TMA
// zero-fills past M, K and N.  Each output element is written once with its
// sum in a fixed order: a repeated launch is bitwise equal.
// CUDA cores (f32, and bf16 at any other shape): two tiled SIMT products,
// 64 x 64 outputs a block of 256 threads, 4 x 4 a thread, the sum in steps
// of 16 through shared memory, ragged edges masked.
#include "common.cuh"
#include "grouped_tc.cuh"

#include <algorithm>

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

// ---------------------------------------------------------------------------
// 8_bwd on CUDA cores
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int BT = 64;       // outputs a block: BT x BT
constexpr int BKS = 16;      // the sum's step
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

struct alignas(16) Tiles {
  float a[BKS][BT + 4];  // [k][row]
  float b[BKS][BT + 4];  // [k][column]
};

__device__ __forceinline__ void products(float (&acc)[4][4], const Tiles& s, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BKS; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
    const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
  }
}

// One block per (64 columns of K, 64 rows of M, expert): dx[e] = dy[e] w[e]^T, the sum over N.
template <typename T>
__global__ void __launch_bounds__(THREADS) dx_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                                                     T* __restrict__ dx, int M, int K, int N) {
  __shared__ Tiles s;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BT, m0 = blockIdx.y * BT;
  const long e = blockIdx.z;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += BKS) {
    for (int i = tid; i < BT * BKS; i += THREADS) {
      const int r = i / BKS, kk = i % BKS, n = n0 + kk;
      s.a[kk][r] = (m0 + r < M && n < N) ? to_f32(dy[(e * M + m0 + r) * N + n]) : 0.f;
      s.b[kk][r] = (k0 + r < K && n < N) ? to_f32(w[(e * K + k0 + r) * N + n]) : 0.f;
    }
    __syncthreads();
    products(acc, s, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (m < M && k < K) dx[(e * M + m) * K + k] = from_f32<T>(acc[i][j]);
    }
  }
}

// One block per (64 columns of N, 64 rows of K, expert): dw[e] = x[e]^T dy[e], the sum over M.
template <typename T>
__global__ void __launch_bounds__(THREADS) dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                                     T* __restrict__ dw, int M, int K, int N) {
  __shared__ Tiles s;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BT, r0 = blockIdx.y * BT;
  const long e = blockIdx.z;
  float acc[4][4] = {};
  for (int m0 = 0; m0 < M; m0 += BKS) {
    for (int i = tid; i < BKS * BT; i += THREADS) {
      const int kk = i / BT, c = i % BT, m = m0 + kk;
      s.a[kk][c] = (m < M && r0 + c < K) ? to_f32(x[(e * M + m) * K + r0 + c]) : 0.f;
      s.b[kk][c] = (m < M && n0 + c < N) ? to_f32(dy[(e * M + m) * N + n0 + c]) : 0.f;
    }
    __syncthreads();
    products(acc, s, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (r < K && n < N) dw[(e * K + r) * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// 8_bwd on tensor cores: one persistent wgmma template for both products
// ---------------------------------------------------------------------------

namespace tcb {

constexpr int BK = 64;                   // the sum's rows a stage
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX = 64 * 128;            // bytes of a 64 x 64 bf16 tile (128-byte swizzle)
constexpr int BN = 256;                  // output columns a tile: 128 a warpgroup
constexpr int HALF = BN / 2 * 128;       // bytes of a warpgroup's half of a B tile
constexpr int STAGES = 4;
constexpr int STAGE = BOX + BN * 128;    // A's 64 x 64 tile, B's 256 x 64
constexpr int BYTES = STAGES * STAGE + 1024;

// DX: D (64 rows of M x 256 of K) = dy . w^T, A and B K-major (the sum over N);
// DW: D (64 rows of K x 256 of N) = x^T . dy, A and B MN-major (the sum over M)
enum Prod { DX, DW };

struct Params {
  __nv_bfloat16* out;  // DX: dx (E, M, K); DW: dw (E, K, N)
  int E, M, K, N;
  int nM, nN;          // tiles: 64-row tiles of D, 256-column tiles of D
};

struct Tile {
  int e, mu, nu;
};

// the M-tiles fastest: the tiles in flight share B's 256-wide slice
__device__ __forceinline__ Tile decode(const Params& p, int t) {
  Tile x;
  x.mu = t % p.nM;
  t /= p.nM;
  x.nu = t % p.nN;
  x.e = t / p.nN;
  return x;
}

template <int P>
__device__ __forceinline__ int steps(const Params& p) {
  return P == DX ? (p.N + BK - 1) / BK : (p.M + BK - 1) / BK;
}

// the producer (one lane): fills stage after stage of the block's tiles, a ring of STAGES
template <int P>
__device__ __forceinline__ void produce(const CUtensorMap* ma, const CUtensorMap* mb, const Params& p,
                                        uint32_t base, uint32_t full, uint32_t empty, int ntiles) {
  const int nk = steps<P>(p);
  int n = 0;  // stages filled, across tiles
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile x = decode(p, t);
    for (int it = 0; it < nk; ++it, ++n) {
      const int s = n % STAGES;
      if (n >= STAGES) sm90::mbar_wait(empty + 8 * s, ((n / STAGES) - 1) & 1);
      const uint32_t sa = base + s * STAGE, sb = sa + BOX, bar = full + 8 * s;
      sm90::mbar_expect_tx(bar, STAGE);
      if constexpr (P == DX) {  // dy as (N, M, E), w as (N, K, E): K-major boxes
        sm90::tma_load_3d(sa, ma, bar, it * BK, x.mu * 64, x.e);
        for (int j = 0; j < BN / 64; ++j) sm90::tma_load_3d(sb + j * BOX, mb, bar, it * BK, x.nu * BN + 64 * j, x.e);
      } else {  // x as (K, M, E), dy as (N, M, E): MN-major boxes
        sm90::tma_load_3d(sa, ma, bar, x.mu * 64, it * BK, x.e);
        for (int j = 0; j < BN / 64; ++j) sm90::tma_load_3d(sb + j * BOX, mb, bar, x.nu * BN + 64 * j, it * BK, x.e);
      }
    }
  }
}

// the consumer warpgroups: warpgroup w takes D's columns 128 w .. 128 w + 127;
// a stage's products are issued, then the previous stage's waited for and its
// buffers released.  acc[4 c + 2 i + h] is row 16 warp + lane / 4 + 8 i of the
// tile and column 8 c + 2 (lane % 4) + h of the warpgroup's 128.
template <int P>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, uint32_t full, uint32_t empty, int ntiles) {
  constexpr int MN = P == DW;
  const int tid = threadIdx.x, w = tid >> 7, lane = tid & 31, nk = steps<P>(p);
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2), c2 = 2 * (lane & 3);
  float acc[64];
  int n = 0;  // stages consumed, across tiles
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile x = decode(p, t);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int it = 0; it < nk; ++it, ++n) {
      const int s = n % STAGES;
      sm90::mbar_wait(full + 8 * s, (n / STAGES) & 1);
      const uint32_t sa = base + s * STAGE, sb = sa + BOX + w * HALF;
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // step kk: rows 16 kk .. of an MN-major tile (2,048 bytes on), bytes 32 kk of a K-major one's rows
        const uint32_t o = MN ? kk * 16 * 128 : kk * 32;
        const uint64_t da = MN ? sm90::desc_mnmajor(sa + o, BOX) : sm90::desc_kmajor(sa + o);
        const uint64_t db = MN ? sm90::desc_mnmajor(sb + o, BOX) : sm90::desc_kmajor(sb + o);
        sm90::wgmma_m64n128k16<MN, MN>(acc, da, db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_operands(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + 8 * prev);
      }
      prev = s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + 8 * prev);
    }
    // D's row r (of M, or K) and column c (of K, or N): bf16 pairs of neighbouring columns
    const int R = P == DX ? p.M : p.K, Cn = P == DX ? p.K : p.N;
    const int c0 = x.nu * BN + 128 * w;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = x.mu * 64 + r0 + 8 * i;
      if (r >= R) continue;
      __nv_bfloat16* row = p.out + ((long)x.e * R + r) * Cn;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = c0 + 8 * c + c2;
        if (col < Cn)  // Cn is a multiple of 8: col + 1 < Cn too
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
      }
    }
  }
}

template <int P>
__device__ __forceinline__ void gemm(const CUtensorMap* ma, const CUtensorMap* mb, const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = sm90::smem_u32(bars), empty = full + 8 * STAGES;
  const int ntiles = p.nM * p.nN * p.E;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      sm90::mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival a consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == CONSUMERS) produce<P>(ma, mb, p, base, full, empty, ntiles);
  else if (threadIdx.x < CONSUMERS) consume<P>(p, base, full, empty, ntiles);
}

__global__ void __launch_bounds__(THREADS, 1) dx_tc_kernel(const __grid_constant__ CUtensorMap ma,
                                                           const __grid_constant__ CUtensorMap mb,
                                                           const __grid_constant__ Params p) {
  gemm<DX>(&ma, &mb, p);
}
__global__ void __launch_bounds__(THREADS, 1) dw_tc_kernel(const __grid_constant__ CUtensorMap ma,
                                                           const __grid_constant__ CUtensorMap mb,
                                                           const __grid_constant__ Params p) {
  gemm<DW>(&ma, &mb, p);
}

// launched before the tensor maps are encoded: as a runtime launch it makes
// the card's context current on this host thread, which
// cuTensorMapEncodeTiled (libcuda's) needs; autograd runs the backward on a
// thread of its own, where this may be the first CUDA call
__global__ void touch_kernel() {}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, c = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    return c;
  }();
  return n;
}

// a bf16 tensor map of a row-major (depth, rows, inner) array, boxes of (64, 64, 1)
inline bool map3(CUtensorMap* m, const void* base, long inner, long rows, long depth) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t str[2] = {(cuuint64_t)inner * 2, (cuuint64_t)(inner * rows * 2)};
  const cuuint32_t box[3] = {64, 64, 1};
  return sm90::bf16_tensor_map(m, base, 3, dims, str, box);
}

template <int P>
int run(const CUtensorMap& ma, const CUtensorMap& mb, const Params& p, cudaStream_t st) {
  const auto kernel = P == DX ? dx_tc_kernel : dw_tc_kernel;
  // the opt-in above 48 KB, once a process a kernel (the port drives one card a process)
  static const cudaError_t opted = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (opted != cudaSuccess) return (int)opted;
  const long ntiles = (long)p.nM * p.nN * p.E;
  if (ntiles == 0) return 0;
  if (ntiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)std::min<long>(ntiles, sm_count()), THREADS, BYTES, st>>>(ma, mb, p);
  return (int)cudaGetLastError();
}

}  // namespace tcb

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

// 8_bwd on CUDA cores: x (E, M, K), w (E, K, N), dy (E, M, N) in the dtype
// code's type; outputs dx (E, M, K) and dw (E, K, N) in that type.  Two launches.
extern "C" int repro_grouped_gemm_bwd(int dtype, const void* x, const void* w, const void* dy, void* dx, void* dw,
                                      int E, int M, int K, int N, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return 0;
  const dim3 gx((K + bwd::BT - 1) / bwd::BT, (M + bwd::BT - 1) / bwd::BT, E);
  const dim3 gw((N + bwd::BT - 1) / bwd::BT, (K + bwd::BT - 1) / bwd::BT, E);
  if (gx.y > 65535 || gw.y > 65535 || E > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH(dtype, Tp, {
    bwd::dx_kernel<Tp><<<gx, bwd::THREADS, 0, st>>>((const Tp*)dy, (const Tp*)w, (Tp*)dx, M, K, N);
    bwd::dw_kernel<Tp><<<gw, bwd::THREADS, 0, st>>>((const Tp*)x, (const Tp*)dy, (Tp*)dw, M, K, N);
  });
  return (int)cudaGetLastError();
}

// 8_bwd's tensor-core build: bf16 x (E, M, K), w (E, K, N), dy (E, M, N),
// contiguous with 16-byte-aligned bases, K and N multiples of 8; outputs dx
// (E, M, K) and dw (E, K, N) bf16.  Three launches: the context's touch, dx, dw.
extern "C" int repro_grouped_gemm_bwd_tc(const void* x, const void* w, const void* dy, void* dx, void* dw, int E,
                                         int M, int K, int N, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return 0;
  if (K % 8 != 0 || N % 8 != 0 || E > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  tcb::touch_kernel<<<1, 1, 0, st>>>();
  int err = (int)cudaGetLastError();
  if (err) return err;
  CUtensorMap mdy, mw, mx;  // dy (N, M, E); w (N, K, E); x (K, M, E)
  if (!tcb::map3(&mdy, dy, N, M, E) || !tcb::map3(&mw, w, N, K, E) || !tcb::map3(&mx, x, K, M, E))
    return (int)cudaErrorInvalidValue;
  tcb::Params p{};
  p.E = E, p.M = M, p.K = K, p.N = N;
  p.out = (__nv_bfloat16*)dx;
  p.nM = (M + 63) / 64, p.nN = (K + tcb::BN - 1) / tcb::BN;
  if ((err = tcb::run<tcb::DX>(mdy, mw, p, st))) return err;
  p.out = (__nv_bfloat16*)dw;
  p.nM = (K + 63) / 64, p.nN = (N + tcb::BN - 1) / tcb::BN;
  return tcb::run<tcb::DW>(mx, mdy, p, st);
}

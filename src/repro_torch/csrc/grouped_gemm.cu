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
// Tensor cores (bf16, K and N multiples of 8, 16-byte-aligned bases): two
// persistent kernels, one block an SM, each two consumer warpgroups (232
// registers a thread by setmaxnreg) and a producer warpgroup one lane of
// which keeps a TMA ring full (128-byte swizzle) across the block's units:
//   dx  D^T = w (128 rows of K x N) . dy^T (N x 320 slots), operands swapped
//       as kernel 8's forward swaps them: w's K rows are wgmma's M (64 a
//       warpgroup) and the slots its N, two halves of 160 at every M.
//       A stage (64 of N) brings 16 KB of w and 40 KB of dy for 5.2 MFLOP;
//       w is read once.  The units' K tiles are the fastest index, so the
//       blocks in flight share each expert's dy.  Both operands K-major as
//       stored; the epilogue writes D^T's columns as dx's rows.
//   dw  D = x^T (64 rows of K x M) . dy (M x 256 of N), both MN-major.  A
//       unit (256 columns of N, one expert) loads its dy slice once into
//       shared memory (160 KB at M 320: ceil(M / 64) <= 5 chunks of 64 rows)
//       and keeps it while x's 64-row K tiles stream past through an 8-stage
//       ring: dy leaves L2 once a unit instead of once a 64-row tile.  The
//       two warpgroups take the K tiles in turns (m64n256k16, 128
//       accumulators a thread): one issues its tile's products when the
//       other has issued its own, then stores while the other multiplies, so
//       the tensor cores do not wait on the epilogue.  A quad's transpose by
//       shuffles makes each lane's stores 16-byte vectors, two whole 32-byte
//       sectors a row a warp.  Above the budget (M > 320) each stage brings
//       dy's chunk beside x's tile (streamed).
// dw's schedule (resident or streamed) is the host's, from M alone
// (ops.grouped_gemm_bwd_schedule), passed to the C entry.  TMA zero-fills
// past M, K and N (dx's slot halves past M too).  Each output element is
// written once with its sum in a fixed order: a repeated launch is bitwise
// equal.
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
// 8_bwd on tensor cores: dx with w's K rows as wgmma's M, dw over dy's slice kept on chip
// ---------------------------------------------------------------------------

namespace tcb {

constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup, one lane of which issues every load
constexpr int BOX = 64 * 128;             // bytes of a 64 x 64 bf16 TMA box (128-byte swizzle)
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168, what the launch allots
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// dx: D (64 rows of K a warpgroup x 160 DX_HALVES columns of M) = w . dy^T,
// both operands K-major as stored (the sum over N, their contiguous axis)
constexpr int DX_HALF = 160;  // M columns a wgmma
constexpr int DX_HALVES = 2;  // wgmmas a step: M columns a unit
constexpr int DX_STAGES = 4;
struct Dx {
  static constexpr int MT = DX_HALF * DX_HALVES;          // M columns a unit
  static constexpr int DY_BOXES = (MT + 63) / 64;         // dy's 64-row boxes a stage
  static constexpr int STAGE = (2 + DY_BOXES) * BOX;      // 64 of N: w's 128 K rows, then dy's rows
  static constexpr int BYTES = DX_STAGES * STAGE + 1024;  // 230,400
};

// dw: D (64 rows of K a warpgroup x 256 of N) = x^T . dy, both operands
// MN-major as stored (the sum over M, the rows of both)
constexpr int DW_NB = 256;                     // N columns a unit
constexpr int DW_CHUNK = DW_NB / 64 * BOX;     // dy's 64 rows of M x 256 of N: 32 KB
constexpr int DW_RESIDENT_CHUNKS = 5;          // dy's slice stays on chip while ceil(M / 64) <= 5
template <bool RES>
struct Dw {
  static constexpr int STAGES = RES ? 8 : 5;
  static constexpr int STAGE = RES ? BOX : BOX + DW_CHUNK;  // x's 64 K x 64 M (streamed: and dy's chunk)
  static constexpr int BYTES = (RES ? DW_RESIDENT_CHUNKS * DW_CHUNK : 0) + STAGES * STAGE + 1024;
};

struct Params {
  __nv_bfloat16* out;  // dx (E, M, K) or dw (E, K, N)
  int E, M, K, N;
};

// a warp's arrival on a barrier counting warps, once its lanes are done
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v[t] of lane q of a quad (four lanes with the same lane / 4) becomes
// lane t's v[q]: two butterfly exchanges, over bit 0 and bit 1 of q
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool o = q & 1, t = q & 2;
  uint32_t a = __shfl_xor_sync(0xffffffffu, o ? v[0] : v[1], 1);
  uint32_t b = __shfl_xor_sync(0xffffffffu, o ? v[2] : v[3], 1);
  if (o) v[0] = a, v[2] = b;
  else v[1] = a, v[3] = b;
  a = __shfl_xor_sync(0xffffffffu, t ? v[0] : v[2], 2);
  b = __shfl_xor_sync(0xffffffffu, t ? v[1] : v[3], 2);
  if (t) v[0] = a, v[1] = b;
  else v[2] = a, v[3] = b;
}

// dx: a unit is (128 rows of K, MT columns of M, expert), rows of K fastest
// so the units in flight share dy's tile; warpgroup w takes K rows 64 w ..
// 64 w + 63 of it.  One ring of stages (64 of N each) runs on across units.
__global__ void __launch_bounds__(THREADS, 1) dx_wdy_kernel(const __grid_constant__ CUtensorMap mw,
                                                            const __grid_constant__ CUtensorMap mdy,
                                                            const __grid_constant__ Params p) {
  using L = Dx;
  constexpr int H = DX_HALVES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * DX_STAGES];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = sm90::smem_u32(bars), empty = full + 8 * DX_STAGES;
  const int nK = (p.K + 127) / 128, nM = (p.M + L::MT - 1) / L::MT, nsteps = (p.N + 63) / 64;
  const int units = nK * nM * p.E;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DX_STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      sm90::mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival a consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int n = 0;  // stages filled, across units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int kt = u % nK, mt = (u / nK) % nM, e = u / (nK * nM);
        for (int it = 0; it < nsteps; ++it, ++n) {
          const int s = n % DX_STAGES;
          if (n >= DX_STAGES) sm90::mbar_wait(empty + 8 * s, ((n / DX_STAGES) - 1) & 1);
          const uint32_t st = base + s * L::STAGE, bar = full + 8 * s;
          sm90::mbar_expect_tx(bar, L::STAGE);
          // w as (N, K, E), dy as (N, M, E): K-major boxes, TMA zeros past K, M and N
          for (int j = 0; j < 2; ++j) sm90::tma_load_3d(st + j * BOX, &mw, bar, it * 64, kt * 128 + 64 * j, e);
          for (int j = 0; j < L::DY_BOXES; ++j)
            sm90::tma_load_3d(st + (2 + j) * BOX, &mdy, bar, it * 64, mt * L::MT + 64 * j, e);
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x, w = tid >> 7, lane = tid & 31;
    const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2), q2 = 2 * (lane & 3);
    float acc[H][80];
    int n = 0;  // stages consumed, across units
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int kt = u % nK, mt = (u / nK) % nM, e = u / (nK * nM);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int i = 0; i < 80; ++i) acc[h][i] = 0.f;
      int prev = -1;
      for (int it = 0; it < nsteps; ++it, ++n) {
        const int s = n % DX_STAGES;
        sm90::mbar_wait(full + 8 * s, (n / DX_STAGES) & 1);
        const uint32_t sa = base + s * L::STAGE + w * BOX, sb = base + s * L::STAGE + 2 * BOX;
#pragma unroll
        for (int h = 0; h < H; ++h) sm90::fence_operands(acc[h]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 of N a step: 32 bytes on in every row
          const uint64_t da = sm90::desc_kmajor(sa + 32 * kk);
#pragma unroll
          for (int h = 0; h < H; ++h)  // half h: dy's rows 160 h .., 20 groups of 8 rows on
            sm90::wgmma_m64n160k16<0, 0>(acc[h], da, sm90::desc_kmajor(sb + h * DX_HALF * 128 + 32 * kk));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
#pragma unroll
        for (int h = 0; h < H; ++h) sm90::fence_operands(acc[h]);
        if (prev >= 0) warp_arrive(empty + 8 * prev);
        prev = s;
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < H; ++h) sm90::fence_operands(acc[h]);
      if (prev >= 0) warp_arrive(empty + 8 * prev);
      // acc[h][4 c + 2 i + b] is D's row r0 + 8 i (K) and column 8 c + q2 + b of half h (M):
      // dx[e][m][k], the 8 lanes of a column writing 8 neighbouring k
      const int k0 = kt * 128 + 64 * w + r0;
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int c = 0; c < 20; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int m = mt * L::MT + h * DX_HALF + 8 * c + q2 + b, k = k0 + 8 * i;
              if (m < p.M && k < p.K) p.out[((long)e * p.M + m) * p.K + k] = __float2bfloat16(acc[h][4 * c + 2 * i + b]);
            }
    }
  }
}

// dw: a unit is (256 columns of N, expert), columns fastest so the units in
// flight share x[e].  RES: the unit's dy slice (ceil(M / 64) chunks of 64 rows
// x 256 columns) is loaded once into shared memory and kept while x's 64-row
// K tiles stream past it; otherwise each stage brings x's tile and dy's chunk.
// Tile j of a block's sequence (its units' K tiles in order) is warpgroup
// j % 2's, and the two take turns: a warpgroup issues a tile's products once
// the other has issued its previous tile's, then stores while the other
// multiplies.  The turns also keep the shared ring sound: a warpgroup never
// waits on a stage more than a tile past the last one loaded, so a slot's
// barrier cannot show it a phase one round old (without them a warpgroup
// ran a whole tile ahead and read stale stages).  A chunk of dy is released
// when both warpgroups' last products on it in the unit are done, and
// reloaded for the next unit.
template <bool RES>
__global__ void __launch_bounds__(THREADS, 1) dw_xdy_kernel(const __grid_constant__ CUtensorMap mx,
                                                            const __grid_constant__ CUtensorMap mdy,
                                                            const __grid_constant__ Params p) {
  using L = Dw<RES>;
  constexpr int ST = L::STAGES, NC = DW_RESIDENT_CHUNKS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * ST + 2 * NC + 2];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = sm90::smem_u32(bars), empty = full + 8 * ST, dyfull = empty + 8 * ST,
                 dyempty = dyfull + 8 * NC, turn = dyempty + 8 * NC;
  const uint32_t ring = base + (RES ? NC * DW_CHUNK : 0);
  const int R = (p.M + 63) / 64, nK = (p.K + 63) / 64, nN = (p.N + DW_NB - 1) / DW_NB;
  const int units = nN * p.E;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      sm90::mbar_init(empty + 8 * s, 4);  // the consuming warpgroup's warps
    }
    for (int c = 0; c < NC; ++c) {
      sm90::mbar_init(dyfull + 8 * c, 1);
      sm90::mbar_init(dyempty + 8 * c, CONSUMERS / 32);  // both warpgroups' warps
    }
    for (int w = 0; w < 2; ++w) sm90::mbar_init(turn + 8 * w, 4);  // warpgroup w's warps: its tile is issued
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      int g = 0, lu = 0;  // stages filled across units; units so far
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++lu) {
        const int nu = u % nN, e = u / nN;
        for (int kt = 0; kt < nK; ++kt)
          for (int mc = 0; mc < R; ++mc, ++g) {
            // x as (K, M, E), dy as (N, M, E): MN-major boxes, TMA zeros past M, K and N
            if (RES && kt == 0) {  // the unit's dy chunk mc, just before the first stage that reads it
              if (lu > 0) sm90::mbar_wait(dyempty + 8 * mc, (lu - 1) & 1);
              const uint32_t c = base + mc * DW_CHUNK, bar = dyfull + 8 * mc;
              sm90::mbar_expect_tx(bar, DW_CHUNK);
              for (int j = 0; j < DW_NB / 64; ++j)
                sm90::tma_load_3d(c + j * BOX, &mdy, bar, nu * DW_NB + 64 * j, mc * 64, e);
            }
            const int s = g % ST;
            if (g >= ST) sm90::mbar_wait(empty + 8 * s, ((g / ST) - 1) & 1);
            const uint32_t st = ring + s * L::STAGE, bar = full + 8 * s;
            sm90::mbar_expect_tx(bar, L::STAGE);
            sm90::tma_load_3d(st, &mx, bar, kt * 64, mc * 64, e);
            if (!RES)
              for (int j = 0; j < DW_NB / 64; ++j)
                sm90::tma_load_3d(st + BOX + j * BOX, &mdy, bar, nu * DW_NB + 64 * j, mc * 64, e);
          }
      }
    }
  } else {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x, w = tid >> 7, lane = tid & 31, q = lane & 3;
    const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
    float acc[128];
    int lu = 0, waits = 0;  // units so far; waits on the other warpgroup's turn
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++lu) {
      const int nu = u % nN, e = u / nN, j0 = lu * nK;  // the unit's first tile in the sequence
      int kt = (j0 & 1) == w ? 0 : 1;
      if (RES && kt >= nK)  // no tile of this unit (nK 1): pass its dy chunks on, in order
        for (int mc = 0; mc < R; ++mc) {
          sm90::mbar_wait(dyfull + 8 * mc, lu & 1);
          warp_arrive(dyempty + 8 * mc);
        }
      for (; kt < nK; kt += 2) {
        const int j = j0 + kt;
        const bool last = kt + 2 >= nK;  // this warpgroup's last tile of the unit
        if (j > 0) sm90::mbar_wait(turn + 8 * (w ^ 1), waits++ & 1);
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
        int prev = -1;
        for (int mc = 0; mc < R; ++mc) {
          const int g = j * R + mc, s = g % ST;
          sm90::mbar_wait(full + 8 * s, (g / ST) & 1);
          if (RES) sm90::mbar_wait(dyfull + 8 * mc, lu & 1);
          const uint32_t sa = ring + s * L::STAGE, sb = RES ? base + mc * DW_CHUNK : sa + BOX;
          sm90::fence_operands(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // 16 rows of M a step: 2,048 bytes on
            const uint32_t o = kk * 16 * 128;
            sm90::wgmma_m64n256k16<1, 1>(acc, sm90::desc_mnmajor(sa + o, BOX), sm90::desc_mnmajor(sb + o, BOX));
          }
          sm90::wgmma_commit();
          if (mc == R - 1) warp_arrive(turn + 8 * w);  // the tile's products are issued: the other's turn
          sm90::wgmma_wait<1>();
          sm90::fence_operands(acc);
          if (prev >= 0) {
            warp_arrive(empty + 8 * prev);
            if (RES && last) warp_arrive(dyempty + 8 * (mc - 1));
          }
          prev = s;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_operands(acc);
        warp_arrive(empty + 8 * prev);
        if (RES && last) warp_arrive(dyempty + 8 * (R - 1));
        // acc[4 c + 2 i + b] is D's row r0 + 8 i (K) and column 8 c + 2 q + b (N).
        // Columns c0 and c0 + 1 go out as one 16-byte vector a lane: after the
        // quad's transpose lane q holds row r0 + 8 (q & 1), columns 8 (c0 + q / 2) ..
        const int row = kt * 64 + r0 + 8 * (q & 1);
        __nv_bfloat16* const out = p.out + ((long)e * p.K + row) * p.N;
#pragma unroll
        for (int c0 = 0; c0 < 32; c0 += 2) {
          uint32_t v[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int a = 4 * (c0 + (t >> 1)) + 2 * (t & 1);
            v[t] = bf16x2(acc[a], acc[a + 1]);
          }
          quad_transpose(v, q);
          const int col = nu * DW_NB + 8 * (c0 + (q >> 1));
          if (row < p.K && col < p.N)  // N is a multiple of 8: a vector is all in or all out
            *reinterpret_cast<uint4*>(out + col) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
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

// one persistent block an SM over `units`
template <typename Kernel>
int run(Kernel kernel, cudaError_t opted, int bytes, long units, const CUtensorMap& ma, const CUtensorMap& mb,
        const Params& p, cudaStream_t st) {
  if (opted != cudaSuccess) return (int)opted;
  if (units == 0) return 0;
  if (units > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)std::min<long>(units, sm_count()), THREADS, bytes, st>>>(ma, mb, p);
  return (int)cudaGetLastError();
}

// each kernel's shared memory opted in above 48 KB once a process (the port drives one card a process)
inline int run_dx(const CUtensorMap& mw, const CUtensorMap& mdy, const Params& p, cudaStream_t st) {
  static const cudaError_t opted =
      cudaFuncSetAttribute(dx_wdy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Dx::BYTES);
  const long units = (long)((p.K + 127) / 128) * ((p.M + Dx::MT - 1) / Dx::MT) * p.E;
  return run(dx_wdy_kernel, opted, Dx::BYTES, units, mw, mdy, p, st);
}

template <bool RES>
int run_dw(const CUtensorMap& mx, const CUtensorMap& mdy, const Params& p, cudaStream_t st) {
  static const cudaError_t opted =
      cudaFuncSetAttribute(dw_xdy_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dw<RES>::BYTES);
  const long units = (long)((p.N + DW_NB - 1) / DW_NB) * p.E;
  return run(dw_xdy_kernel<RES>, opted, Dw<RES>::BYTES, units, mx, mdy, p, st);
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
// (E, M, K) and dw (E, K, N) bf16.  Three launches: the context's touch, dx,
// dw, the last on the host's schedule: `resident` 1 keeps each unit's dy
// slice in shared memory (refused past DW_RESIDENT_CHUNKS chunks of 64 rows
// of M), 0 streams it beside x.
extern "C" int repro_grouped_gemm_bwd_tc(const void* x, const void* w, const void* dy, void* dx, void* dw, int E,
                                         int M, int K, int N, int resident, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return 0;
  if (K % 8 != 0 || N % 8 != 0 || E > 65535) return (int)cudaErrorInvalidValue;
  if (resident && (M + 63) / 64 > tcb::DW_RESIDENT_CHUNKS) return (int)cudaErrorInvalidValue;
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
  if ((err = tcb::run_dx(mw, mdy, p, st))) return err;
  p.out = (__nv_bfloat16*)dw;
  return resident ? tcb::run_dw<true>(mx, mdy, p, st) : tcb::run_dw<false>(mx, mdy, p, st);
}

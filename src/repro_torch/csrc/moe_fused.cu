// Prefill MoE data plane: plan-steered gather -> gate/up + SwiGLU, then
// down projection -> weighted combine in a fixed order.  No gathered (E, C,
// d) input tensor is ever written to device memory; the weighted expert
// outputs go through one f32 scratch so the combine is deterministic.
//
// Replaces: src/repro/kernels/moe_fused/kernel.py,
//   fused_gather_swiglu_pallas (kernel _gather_swiglu_kernel) and
//   fused_down_combine_pallas (kernel _down_combine_kernel).
//
// What they compute, with flat_idx (E*C,) naming the token of each expert
// slot (T = empty slot) and slot_w (E*C,) its combine weight:
//   gather_swiglu: h[e, c] = silu(x[idx] @ Wg[e]) * (x[idx] @ Wu[e]),
//                  x[T] read as a zero row; h (E, C, f) in x's type.
//   down_combine:  y[t] = sum over the slots c of token t, in slot order, of
//                  slot_w * (h[e, c] @ Wd[e]); y (T, d) f32.
//
// What bounds them on the card: at an admission prefill (128 tokens, 128
// experts, top-8: C = 16 slots per expert) each expert's weights are used by
// at most C rows, ~16 FLOPs per weight byte, so the weight bytes of the
// experts the plan occupies bound both launches (gather_swiglu: 128 x 2 x
// 4096 x 1536 bf16 = 3.22 GB, 0.96 ms at 3.35 TB/s; down_combine: 1.61 GB,
// 0.48 ms); FLOPs would bound only at C in the hundreds.
//
// Each has two builds, chosen by the wrapper from dtype, d, f and alignment
// alone (ops.gather_swiglu_path, ops.down_combine_path): tensor cores for
// bf16 with d and f multiples of 8 and 16-byte-aligned bases, CUDA cores
// (the first versions, kept as they were) for f32 and every other shape.
// The CUDA-core builds reached 24 % (gather_swiglu) and 16 % (down_combine)
// of their byte bounds: f32 FMAs, weights as scalar 2-byte loads widened
// into f32 tiles, two __syncthreads a 32-deep K step with no load in flight
// during the FMAs.
//
// gather_swiglu on tensor cores: grouped_gemm.cu's design (A and B
// swapped) with the gather as its prologue and two products:
//  * gate^T = Wg[e]^T . x[idx]^T and up^T = Wu[e]^T . x[idx]^T: the weight
//    tile is wgmma's A, 64 output columns read MN-major from shared memory
//    (W is (d, f) row-major), and the block's gathered slots are the N
//    operand, K-major: 16 wide (m64n16k16) at C <= 16, the 128-token
//    admission, and 64 (m64n64k16) above it, tiled over the grid.
//  * One producer warp keeps a ring of 4 stages full: lane 0 brings 64 K
//    rows of the block's 128 columns of both Wg and Wu by TMA (32 KB), and
//    the warp gathers the slots' 64-element x row pieces with 16-byte
//    cp.async copies straight to the 128-byte-swizzled addresses the B
//    descriptor reads (an empty slot, index T, and K past d copy zeros).
//    A stage is complete when its TMA bytes have landed and every lane has
//    arrived after its copies of that stage are done (cp.async.wait_group,
//    two stages behind, then a proxy fence).  128 columns a block: 92.5 %
//    of the byte bound on the card, against 88.5 % at 64 (PERF.md, §6).
//  * Two f32 accumulator sets, gate and up; SwiGLU in f32, and h written
//    once in bf16 through shared memory, 16-byte row pieces.
//  * A block whose slots are all empty writes zeros and reads no weights.
//
// down_combine on tensor cores: grouped_tc.cuh's main loop, the one kernel
// 8 runs, over h[e] (the x operand, its 16- or 64-slot tile by TMA) and
// Wd[e] (the weight tile): y[e]^T = Wd[e]^T . h[e]^T with f32 accumulators,
// h and Wd both bf16, so every product is exact and no hi + lo split is
// needed.  Its epilogue writes slot_w * y in f32 straight from the
// accumulators into the rows scratch below, only for occupied slots (8
// neighbouring columns of 4 slots a warp store: whole 32-byte sectors); a
// slot tile whose slots are all empty reads no weights and writes nothing.
// 0.570 ms (device 0.552, 87 % of the byte bound) at the admission shape
// against bmm + index_add_'s 0.666 in turns and the CUDA-core build's
// 3.070 in the same call (H100 80GB HBM3, 700 W; PERF.md, section 6).
//
// CUDA cores:
//  * One block per (expert, 16-slot block, 64-column tile).  The block loads
//    its slots' token indices itself and gathers those x rows tile by tile
//    straight into shared memory (the gather is the GEMM prologue).
//  * Weight tiles are read coalesced, once per slot block; a block whose
//    slots are all empty writes zeros (gather_swiglu) or nothing
//    (down_combine) and reads no weights, so an expert the plan leaves idle
//    costs no bytes.
//
// down_combine's combine is fixed-order in both builds, so an admission is
// bitwise repeatable (the serve fabric's byte-identical re-run rests on
// it).  The TPU kernel's serial scatter has no parallel counterpart; atomics
// would add a token's top_k rows in whatever order the blocks finish.  So
// the down launch writes each occupied slot's weighted row w * y into an
// (E*C, d) f32 scratch (empty slots, idx == T, write nothing), and a second
// launch sums each token's slots in one thread per column, in ascending
// slot order: one block per (token, 256 columns) finds its token's slots
// with warp ballots over flat_idx.  The scratch is the (E, C, d) tensor the
// TPU kernel kept out of HBM: at a 128-token admission (E 128, C 16, d
// 4096) ~34 MB written and read once more, ~20 us at the card's rate.
// gather_swiglu's sums are fixed-order too: every repeated launch is
// bitwise equal.
#include "common.cuh"
#include "grouped_tc.cuh"

namespace {

constexpr int BM = 16;   // slots per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // contraction tile
constexpr int THREADS = 256;
constexpr int RPT = BM / (THREADS / BN);  // rows per thread = 4

template <typename T>
__global__ void __launch_bounds__(THREADS) gather_swiglu_kernel(
    const T* __restrict__ x,            // (T, d)
    const int* __restrict__ flat_idx,   // (E*C,)
    const T* __restrict__ wg,           // (E, d, f)
    const T* __restrict__ wu,           // (E, d, f)
    T* __restrict__ h,                  // (E, C, f)
    int Tn, int C, int d, int f) {
  __shared__ int idx_s[BM];
  __shared__ int any_s;
  __shared__ float xs[BM][BK];
  __shared__ float gs[BK][BN];
  __shared__ float us[BK][BN];
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % BN, ty = tid / BN;
  if (tid == 0) any_s = 0;
  __syncthreads();
  if (tid < BM) {
    const int c = c0 + tid;
    const int tok = c < C ? flat_idx[e * C + c] : Tn;
    idx_s[tid] = tok;
    if (tok < Tn) atomicOr(&any_s, 1);
  }
  __syncthreads();
  const int col = n0 + tx;
  float g[RPT] = {0.f}, u[RPT] = {0.f};
  if (any_s) {
    const T* pg = wg + e * d * f;
    const T* pu = wu + e * d * f;
    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        const int tok = idx_s[r];
        xs[r][kk] = (tok < Tn && k0 + kk < d) ? to_f32(x[(long)tok * d + k0 + kk]) : 0.f;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, nn = i % BN;
        const bool in = (k0 + kk < d) && (n0 + nn < f);
        const long off = (long)(k0 + kk) * f + n0 + nn;
        gs[kk][nn] = in ? to_f32(pg[off]) : 0.f;
        us[kk][nn] = in ? to_f32(pu[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float bg = gs[kk][tx], bu = us[kk][tx];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float a = xs[ty * RPT + r][kk];
          g[r] += a * bg;
          u[r] += a * bu;
        }
      }
      __syncthreads();
    }
  }
  if (col < f) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int c = c0 + ty * RPT + r;
      if (c < C) h[(e * C + c) * f + col] = from_f32<T>(silu_f32(g[r]) * u[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) down_combine_kernel(
    const T* __restrict__ h,            // (E, C, f)
    const T* __restrict__ wd,           // (E, f, d)
    const int* __restrict__ flat_idx,   // (E*C,)
    const float* __restrict__ slot_w,   // (E*C,)
    float* __restrict__ rows,           // (E*C, d): occupied slots' weighted rows
    int Tn, int C, int d, int f) {
  __shared__ int idx_s[BM];
  __shared__ int any_s;
  __shared__ float hs[BM][BK];
  __shared__ float ws[BK][BN];
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % BN, ty = tid / BN;
  if (tid == 0) any_s = 0;
  __syncthreads();
  if (tid < BM) {
    const int c = c0 + tid;
    const int tok = c < C ? flat_idx[e * C + c] : Tn;
    idx_s[tid] = tok;
    if (tok < Tn) atomicOr(&any_s, 1);
  }
  __syncthreads();
  if (!any_s) return;  // no occupied slot: no row any token reads
  const T* pd = wd + e * f * d;
  float y[RPT] = {0.f};
  for (int k0 = 0; k0 < f; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int c = c0 + r;
      hs[r][kk] = (idx_s[r] < Tn && k0 + kk < f) ? to_f32(h[(e * C + c) * f + k0 + kk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const bool in = (k0 + kk < f) && (n0 + nn < d);
      ws[kk][nn] = in ? to_f32(pd[(long)(k0 + kk) * d + n0 + nn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float b = ws[kk][tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r) y[r] += hs[ty * RPT + r][kk] * b;
    }
    __syncthreads();
  }
  const int col = n0 + tx;
  if (col < d) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int c = c0 + ty * RPT + r;
      const int tok = idx_s[ty * RPT + r];
      if (tok < Tn) rows[(e * C + c) * d + col] = slot_w[e * C + c] * y[r];
    }
  }
}

constexpr int CB_THREADS = 256;  // combine: output columns per block
constexpr int CB_LIST = 64;      // slot indices gathered per pass

// out[t, :] = the sum of rows[s, :] over the slots s with flat_idx[s] == t,
// in ascending s, one thread per column.  Warp 0 lists the token's slots
// (a ballot over 32 slots at a time keeps them in order); a token with more
// than CB_LIST slots is summed over several passes.  A token no slot names
// gets zeros.
__global__ void __launch_bounds__(CB_THREADS) combine_rows_kernel(
    const float* __restrict__ rows,     // (E*C, d)
    const int* __restrict__ flat_idx,   // (E*C,)
    float* __restrict__ out,            // (T, d)
    int EC, int d) {
  __shared__ int list[CB_LIST];
  __shared__ int total;
  const int t = blockIdx.x;
  const int col = blockIdx.y * CB_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 0.f;
  for (int start = 0;; start += CB_LIST) {
    if (warp == 0) {
      int seen = 0;
      for (int s0 = 0; s0 < EC; s0 += 32) {
        const int s = s0 + lane;
        const bool hit = s < EC && flat_idx[s] == t;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        const int rank = seen + __popc(bal & ((1u << lane) - 1u));
        if (hit && rank >= start && rank < start + CB_LIST) list[rank - start] = s;
        seen += __popc(bal);
      }
      if (lane == 0) total = seen;
    }
    __syncthreads();
    const int n = min(total - start, CB_LIST);
    if (col < d)
      for (int i = 0; i < n; ++i) acc += rows[(long)list[i] * d + col];
    const bool more = start + CB_LIST < total;
    __syncthreads();  // the list is rewritten by the next pass
    if (!more) break;
  }
  if (col < d) out[(long)t * d + col] = acc;
}

// the combine launch both builds of down_combine end with
int combine_rows(const void* rows, const void* flat_idx, void* out, int Tn, int EC, int d, cudaStream_t stream) {
  if (Tn > 0) {
    dim3 grid(Tn, (d + CB_THREADS - 1) / CB_THREADS);
    combine_rows_kernel<<<grid, CB_THREADS, 0, stream>>>((const float*)rows, (const int*)flat_idx, (float*)out, EC, d);
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// gather_swiglu on tensor cores: wgmma on bf16 tiles, weights by TMA, the
// slots' x rows by cp.async
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 64;                   // K rows a stage: one 128-byte row piece of x
constexpr int STAGES = 4;
constexpr int LAG = 2;                   // stages by which the gather's publication trails its copies
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX = BK * 128;            // bytes of a (64 K rows x 64 columns) box of Wg or Wu
constexpr int NT = 2;                    // 64-column boxes of each of Wg and Wu a block
constexpr int BN = 64 * NT;              // output columns a block

// shared memory: STAGES x (NT boxes of Wg, NT of Wu, the BM x 64 x tile),
// then the full and empty mbarriers of each stage; the base is aligned to
// 1,024 bytes (the 128-byte swizzle's period) by hand
template <int BM>
struct Tile {
  static constexpr int STAGE = 2 * NT * BOX + BM * 128;
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;
  static constexpr int YS = BN + 8;  // row stride of the output tile (bf16), 16-byte rows
  static_assert(BM * YS * 2 <= STAGE, "the output tile reuses stage 0");
};

// One block per (BN-column tile, BM-slot tile, expert).
template <int BM>
__global__ void __launch_bounds__(THREADS, 1) gather_swiglu_tc_kernel(
    const __grid_constant__ CUtensorMap tg,  // Wg as (f, d, E): boxes of (64, BK, 1)
    const __grid_constant__ CUtensorMap tu,  // Wu the same
    const __nv_bfloat16* __restrict__ x,     // (T, d)
    const int* __restrict__ flat_idx,        // (E*C,)
    __nv_bfloat16* __restrict__ h,           // (E, C, f)
    int Tn, int C, int d, int f) {
  using L = Tile<BM>;
  constexpr int NA = BM / 2;  // accumulator registers a thread, each of gate and up
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tok_s[BM];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  const int nk = (d + BK - 1) / BK;
  // the block's slots: a token row, or Tn for an empty slot and past C
  bool occupied = false;
  if (tid < BM) {
    const int c = c0 + tid;
    const int tok = c < C ? flat_idx[(long)e * C + c] : Tn;
    tok_s[tid] = tok;
    occupied = tok < Tn;
  }
  if (!__syncthreads_or(occupied)) {  // every slot empty: zeros, and no weight is read
    for (int i = tid; i < BM * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = c0 + r, n = n0 + (i % (BN / 8)) * 8;
      if (c < C && n < f) *reinterpret_cast<uint4*>(h + ((long)e * C + c) * f + n) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1 + 32);           // lane 0's expect_tx, then every producer lane
      sm90::mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    const int lane = tid - CONSUMERS;
    for (int it = 0; it < nk; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) sm90::mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
      const uint32_t st = base + s * L::STAGE;
      if (lane == 0) {
        sm90::mbar_expect_tx(full + 8 * s, 2 * NT * BOX);
        for (int j = 0; j < NT; ++j) {
          sm90::tma_load_3d(st + j * BOX, &tg, full + 8 * s, n0 + 64 * j, it * BK, e);
          sm90::tma_load_3d(st + (NT + j) * BOX, &tu, full + 8 * s, n0 + 64 * j, it * BK, e);
        }
      }
      // the gather: 16-byte piece j of slot r's row lands at chunk j ^ (r % 8)
      for (int i = lane; i < BM * 8; i += 32) {
        const int r = i >> 3, j = i & 7;
        const int tok = tok_s[r], k = it * BK + 8 * j;
        const bool in = tok < Tn && k < d;  // d is a multiple of 8: a piece is all in or all out
        sm90::cp_async16(st + 2 * NT * BOX + r * 128 + ((j ^ (r & 7)) << 4), in ? x + (long)tok * d + k : x,
                         in ? 16 : 0);
      }
      sm90::cp_async_commit();
      if (it >= LAG) {  // stage it - LAG's copies have landed: publish them to the consumers
        sm90::cp_async_wait<LAG>();
        sm90::fence_proxy_async();
        sm90::mbar_arrive(full + 8 * ((it - LAG) % STAGES));
      }
    }
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    for (int it = max(nk - LAG, 0); it < nk; ++it) sm90::mbar_arrive(full + 8 * (it % STAGES));
    return;
  }

  // the consumer warpgroup: g[j] / u[j] hold gate^T / up^T: output columns
  // n0 + 64 j .. + 63 by BM slots
  const int warp = tid >> 5, lane = tid & 31;
  float g[NT][NA], u[NT][NA];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < NA; ++i) g[j][i] = u[j][i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    sm90::mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const uint32_t st = base + s * L::STAGE, sx = st + 2 * NT * BOX;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sm90::fence_operands(g[j]);
      sm90::fence_operands(u[j]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // step kk: K rows 16 kk .. 16 kk + 15 of the boxes (2,048 bytes on), bytes 32 kk of x's rows
      const uint64_t dx = sm90::desc_kmajor(sx + kk * 32);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        gtc::wgmma_tn<BM>(g[j], sm90::desc_mnmajor(st + j * BOX + kk * 16 * 128, BOX), dx);
        gtc::wgmma_tn<BM>(u[j], sm90::desc_mnmajor(st + (NT + j) * BOX + kk * 16 * 128, BOX), dx);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sm90::fence_operands(g[j]);
      sm90::fence_operands(u[j]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + 8 * s);
  }

  // epilogue: g[j][4 c + 2 i + hh] is output column n0 + 64 j + 16 warp +
  // lane / 4 + 8 i, slot c0 + 8 c + 2 (lane % 4) + hh; silu(g) u staged as
  // (BM, BN) bf16 in stage 0 (every load has landed and every wgmma is done once all
  // four warps pass the barrier), then stored a 16-byte row piece a thread
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - sm90::smem_u32(smem_raw)));
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < BM / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 64 * j + 16 * warp + (lane >> 2) + 8 * i, row = 8 * c + 2 * (lane & 3) + hh;
          const int a = 4 * c + 2 * i + hh;
          ys[row * L::YS + col] = __float2bfloat16(silu_f32(g[j][a]) * u[j][a]);
        }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  for (int i = tid; i < BM * (BN / 8); i += CONSUMERS) {
    const int r = i / (BN / 8), c8 = (i - r * (BN / 8)) * 8;
    const int c = c0 + r, n = n0 + c8;
    if (c < C && n < f)  // f is a multiple of 8: a piece is all in or all out
      *reinterpret_cast<uint4*>(h + ((long)e * C + c) * f + n) = *reinterpret_cast<const uint4*>(ys + r * L::YS + c8);
  }
}

template <int BM>
int launch(const void* x, const void* flat_idx, const void* wg, const void* wu, void* h, int Tn, int E, int C,
           int d, int f, cudaStream_t stream) {
  using L = Tile<BM>;
  const cuuint64_t b = sizeof(__nv_bfloat16);
  const cuuint64_t wdims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)E};
  const cuuint64_t wstr[2] = {f * b, (cuuint64_t)d * f * b};
  const cuuint32_t wbox[3] = {64, BK, 1};
  CUtensorMap tg, tu;
  if (!sm90::bf16_tensor_map(&tg, wg, 3, wdims, wstr, wbox) || !sm90::bf16_tensor_map(&tu, wu, 3, wdims, wstr, wbox))
    return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted =
      cudaFuncSetAttribute(gather_swiglu_tc_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  gather_swiglu_tc_kernel<BM><<<grid, THREADS, L::BYTES, stream>>>(
      tg, tu, (const __nv_bfloat16*)x, (const int*)flat_idx, (__nv_bfloat16*)h, Tn, C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// down_combine on tensor cores: grouped_tc.cuh's main loop over h[e] and
// Wd[e], the weighted rows of the occupied slots as its epilogue
// ---------------------------------------------------------------------------

namespace down_tc {

using gtc::CONSUMERS;

// One block per (BN-column tile of d, BM-slot tile, expert).
template <int BM>
__global__ void __launch_bounds__(gtc::THREADS, 1) down_rows_tc_kernel(
    const __grid_constant__ CUtensorMap tw,  // Wd as (d, f, E): boxes of (64, BK, 1)
    const __grid_constant__ CUtensorMap th,  // h as (f, C, E): boxes of (64, BM, 1)
    const int* __restrict__ flat_idx,        // (E*C,)
    const float* __restrict__ slot_w,        // (E*C,)
    float* __restrict__ rows,                // (E*C, d): occupied slots' weighted rows
    int Tn, int C, int d, int f) {
  using L = gtc::Tile<BM>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int tok_s[BM];
  __shared__ float w_s[BM];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * L::BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  bool occupied = false;
  if (tid < BM) {
    const int c = c0 + tid;
    const int tok = c < C ? flat_idx[(long)e * C + c] : Tn;
    tok_s[tid] = tok;
    w_s[tid] = tok < Tn ? slot_w[(long)e * C + c] : 0.f;
    occupied = tok < Tn;
  }
  if (!__syncthreads_or(occupied)) return;  // no occupied slot: no row any token reads, no weight read
  gtc::init_ring<BM>(base);
  __syncthreads();
  const int nk = (f + gtc::BK - 1) / gtc::BK;
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) gtc::produce<BM>(&tw, &th, base, n0, c0, e, nk);
    return;
  }
  float acc[L::NT][L::NA];
  gtc::consume<BM>(acc, base, nk);
  // slot_w * y in f32 for the occupied slots; a warp's stores are 8
  // neighbouring columns of 4 slot rows: 32-byte pieces
  gtc::for_each_acc<BM>(acc, [&](int row, int col, float v) {
    const int n = n0 + col;
    if (tok_s[row] < Tn && n < d) rows[((long)e * C + c0 + row) * d + n] = w_s[row] * v;
  });
}

template <int BM>
int launch(const void* h, const void* wd, const void* flat_idx, const void* slot_w, void* rows, int Tn, int E, int C,
           int d, int f, cudaStream_t stream) {
  using L = gtc::Tile<BM>;
  CUtensorMap tw, th;  // h (E, C, f) is grouped_tc's x (E, M, K); Wd (E, f, d) its w (E, K, N)
  if (!gtc::make_maps<BM>(&tw, &th, wd, h, E, C, f, d)) return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted =
      cudaFuncSetAttribute(down_rows_tc_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((d + L::BN - 1) / L::BN, (C + BM - 1) / BM, E);
  down_rows_tc_kernel<BM><<<grid, gtc::THREADS, L::BYTES, stream>>>(
      tw, th, (const int*)flat_idx, (const float*)slot_w, (float*)rows, Tn, C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace down_tc

}  // namespace

extern "C" int repro_gather_swiglu(int dtype, const void* x, const void* flat_idx, const void* wg, const void* wu,
                                   void* h, int Tn, int E, int C, int d, int f, void* stream) {
  dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  REPRO_DISPATCH(dtype, Tp, {
    gather_swiglu_kernel<Tp><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const Tp*)x, (const int*)flat_idx, (const Tp*)wg, (const Tp*)wu, (Tp*)h, Tn, C, d, f);
  });
  return (int)cudaGetLastError();
}

// The tensor-core build: bf16 x (T, d), Wg and Wu (E, d, f), h (E, C, f),
// all contiguous with 16-byte-aligned bases, d and f multiples of 8.
extern "C" int repro_gather_swiglu_tc(const void* x, const void* flat_idx, const void* wg, const void* wu, void* h,
                                      int Tn, int E, int C, int d, int f, void* stream) {
  if (E <= 0 || C <= 0 || f <= 0) return 0;
  if (d <= 0 || d % 8 != 0 || f % 8 != 0 || E > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C <= 16) return tc::launch<16>(x, flat_idx, wg, wu, h, Tn, E, C, d, f, s);
  return tc::launch<64>(x, flat_idx, wg, wu, h, Tn, E, C, d, f, s);
}

// rows_scratch: (E*C, d) f32, its contents on entry unused; out (T, d) f32,
// every element written.
extern "C" int repro_down_combine(int dtype, const void* h, const void* wd, const void* flat_idx,
                                  const void* slot_w, void* rows_scratch, void* out, int Tn, int E, int C, int d,
                                  int f, void* stream) {
  dim3 grid((d + BN - 1) / BN, (C + BM - 1) / BM, E);
  REPRO_DISPATCH(dtype, Tp, {
    down_combine_kernel<Tp><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const Tp*)h, (const Tp*)wd, (const int*)flat_idx, (const float*)slot_w, (float*)rows_scratch, Tn, C, d,
        f);
  });
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return combine_rows(rows_scratch, flat_idx, out, Tn, E * C, d, (cudaStream_t)stream);
}

// The tensor-core build: bf16 h (E, C, f) and Wd (E, f, d), contiguous with
// 16-byte-aligned bases, d and f multiples of 8; rows_scratch and out as
// repro_down_combine's.
extern "C" int repro_down_combine_tc(const void* h, const void* wd, const void* flat_idx, const void* slot_w,
                                     void* rows_scratch, void* out, int Tn, int E, int C, int d, int f,
                                     void* stream) {
  if (Tn <= 0 || d <= 0) return 0;
  if (f <= 0 || f % 8 != 0 || d % 8 != 0 || E <= 0 || E > 65535 || C <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = C <= 16 ? down_tc::launch<16>(h, wd, flat_idx, slot_w, rows_scratch, Tn, E, C, d, f, s)
                         : down_tc::launch<64>(h, wd, flat_idx, slot_w, rows_scratch, Tn, E, C, d, f, s);
  if (rc != 0) return rc;
  return combine_rows(rows_scratch, flat_idx, out, Tn, E * C, d, s);
}

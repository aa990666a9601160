// Backward of the prefill MoE data plane (kernels 3 and 4, csrc/moe_fused.cu)
// for training: hand-written, f32 accumulation, every sum in a fixed order
// and no atomics, so a repeated launch is bitwise equal.  Two builds each,
// chosen by the wrapper from dtype, d, f and alignment alone
// (ops.down_combine_bwd_path, ops.gather_swiglu_bwd_path): tensor cores for
// bf16 with d and f multiples of 8 and 16-byte-aligned bases (namespace tc,
// below the CUDA-core build), CUDA cores for f32 and every other shape.
//
// Differentiates: src/repro/kernels/moe_fused/kernel.py,
//   fused_gather_swiglu_pallas and fused_down_combine_pallas (the TPU
//   kernels have no VJP; the reference trains through jnp dispatch ->
//   local_experts_fn -> combine, which computes the same function).
//
// With flat_idx (E*C,) the token of each slot (T = empty), slot_w (E*C,) its
// combine weight, flat_cidx (T*k,) the slot of each assignment (E*C =
// dropped), xs[e, c] = x[flat_idx[e*C + c]] and dy (T, d) f32 the gradient of
// down_combine's output:
//
// down_combine_bwd (4_bwd), three launches:
//   dh_kernel:  q[s] = dy[idx_s] Wd[e]^T (the unweighted row, f wide);
//               dh[s] = slot_w_s q[s], and per 64-column tile the partial
//               <h[s], q[s]> of d slot_w_s = <h_s Wd, dy[idx_s]> (the same
//               dot through the product this launch forms anyway: nothing
//               recomputed, nothing saved by the forward);
//   dw_kernel:  dWd[e] = h[e]^T (slot_w * dy[idx]), over slots in ascending order;
//   dsw_kernel: d slot_w_s = the tile partials summed in ascending tile order.
//   An empty slot (idx = T) contributes nothing: dh 0, d slot_w 0.
//
// gather_swiglu_bwd (3_bwd), four launches:
//   dgu_kernel: g = xs Wg and u = xs Wu recomputed per (expert, slot tile);
//               dg = dh u silu'(g), du = dh silu(g), into an f32 scratch;
//   dw_kernel:  dWg[e] = xs[e]^T dg[e] and dWu[e] = xs[e]^T du[e], over
//               slots in ascending order;
//   dxs_kernel: dxs = dg Wg^T + du Wu^T (f32 scratch, (E*C, d)): Wg's f
//               columns first, then Wu's;
//   dx_kernel:  dx[t] = the sum of its <= k slot rows in ascending j of the
//               combine words: a gather per token, not a scatter-add.
//
// CUDA cores: every product is one tiled SIMT GEMM (tile_products): 64 x
// 64 outputs a block of 256 threads, 4 x 4 a thread, K in steps of 16
// through shared memory, operands widened to f32 as they are staged.  Each
// output element sums its K products in ascending K, whatever the grid's
// shape or timing.  A slot tile (or a K step of slots) whose slots are all
// empty is skipped.  At Qwen3-MoE's training shapes (T 4,096, 128 experts
// top-8, C 320, d 4,096, f 1,536) ~20 TFLOP/s: 44.2 ms for 4_bwd, 120.5 for
// 3_bwd, ten times the bf16 composition of torch.bmm calls (PERF.md, s. 6).
//
// What bounds them on the card: operations.  At those shapes each product
// is 2 x 32,768 occupied slots x d x f = 0.41 TFLOP: 4_bwd two, 3_bwd six.
//
// Tensor cores (repro_down_combine_bwd_tc, repro_gather_swiglu_bwd_tc): the
// same launches' products as bf16 wgmma with f32 accumulators, one
// persistent template (tc::gemm) for all five.  A block an SM walks tiles
// of 64 output rows x 256 columns, one warpgroup a 128-column half; one
// producer lane keeps a ring of stages full by TMA (128-byte swizzle), the
// consumers issue a stage's products, then wait for the previous stage's
// and release its buffers, and the ring runs on across tiles, so one tile's
// epilogue overlaps the next one's loads.  The f32 operands enter as hi =
// bf16(v) plus lo = bf16(v - hi), both into one accumulator (bf16 alone
// misses row 3's gate on every output it feeds, and d slot_w's 1e-4 bound
// eighteen times over: tests/test_torch_moe_bwd_tc.py,
// tests/test_torch_cuda_builds.py): the slots' dy rows, the weighted slot
// rows and dg/du, as the A operand of 64 rows a stage that both
// warpgroups share.  The slots' rows are gathered once into scratch and
// read by TMA like every other operand (gathered into each stage by
// cp.async, the products ran at 0.5-0.65 of the rate; PERF.md, s. 6).
// The products and what feeds them:
//   4_bwd  the slots' dy rows R and weighted rows w R as bf16 pairs
//          (split_rows_kernel: 2 E C d bf16 each, +1.34 GB at Qwen3-MoE's
//          training shapes); dh: q = R Wd^T, then dh = w q and each row's
//          <h, q> over the tile's 256 columns (both warpgroups' halves
//          added in order); dWd^T = (w R)^T h, both read MN-major; d slot_w
//          summed over the tiles as before.
//   3_bwd  the slots' x rows gathered once into the dxs scratch's first
//          half (gather_rows_kernel); dg/du: g = xs Wg and u = xs Wu
//          recomputed (two accumulators), dg and du written as bf16 pairs
//          (the bytes of the f32 scratch); dWg^T = dg^T xs and dWu^T = du^T
//          xs (A the pairs, B xs, both MN-major; a pass each); dxs = dg Wg^T
//          + du Wu^T (Wg's f stages first, then Wu's); dx as before.
// The tiles of the slot-major products (dh, dg/du, dxs) are the occupied
// slot units, an expert's units fastest, so the tiles in flight share one
// 256-row slice of the expert's weights and it is read from memory once
// (units_kernel lists them; it is launched first, and as a runtime launch
// it also makes the context current on autograd's thread, which
// cuTensorMapEncodeTiled needs); the slot sums (dWd, dWg/dWu) skip a K
// stage of 64 empty slots.
#include "common.cuh"
#include "sm90.cuh"

#include <algorithm>

namespace {

constexpr int BM = 64;       // output rows a block
constexpr int BN = 64;       // output columns a block
constexpr int BK = 16;       // K a step
constexpr int PAD = 4;       // row padding of the staged tiles: a 272-byte row keeps float4 reads aligned
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

// Staged operand tiles: A as [k][m], NB B operands as [k][n].
template <int NB>
struct alignas(16) Tiles {
  float a[BK][BM + PAD];
  float b[NB][BK][BN + PAD];
};

// acc[q][i][j] += sum over the step's 16 k, in ascending k, of a[k][4 ty + i] * b[q][k][4 tx + j]
template <int NB>
__device__ __forceinline__ void tile_products(float (&acc)[NB][4][4], const Tiles<NB>& s, int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
    const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[q][k][tx * 4]);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][i][j] = fmaf(a4[i], b4[j], acc[q][i][j]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4][4]) {
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;
}

// The block's slots (rows c0 .. c0 + BM - 1 of expert e): token words into
// tok_s (Tn past C), their weights into w_s when given; returns whether any
// slot is occupied (every thread gets the answer).
__device__ __forceinline__ bool load_slots(const int* __restrict__ flat_idx, const float* __restrict__ slot_w,
                                           int* tok_s, float* w_s, long e, int c0, int C, int Tn) {
  bool occ = false;
  if (threadIdx.x < BM) {
    const int c = c0 + threadIdx.x;
    const int tok = c < C ? flat_idx[e * C + c] : Tn;
    tok_s[threadIdx.x] = tok;
    if (w_s) w_s[threadIdx.x] = tok < Tn ? slot_w[e * C + c] : 0.f;
    occ = tok < Tn;
  }
  return __syncthreads_or(occ);
}

// A K step's slots (slots k0 .. k0 + BK - 1 of expert e), for the products
// that sum over slots; returns whether any is occupied.
__device__ __forceinline__ bool load_step_slots(const int* __restrict__ flat_idx, const float* __restrict__ slot_w,
                                                int* tok_k, float* w_k, long e, int k0, int C, int Tn) {
  bool occ = false;
  if (threadIdx.x < BK) {
    const int c = k0 + threadIdx.x;
    const int tok = c < C ? flat_idx[e * C + c] : Tn;
    tok_k[threadIdx.x] = tok;
    if (w_k) w_k[threadIdx.x] = tok < Tn ? slot_w[e * C + c] : 0.f;
    occ = tok < Tn;
  }
  return __syncthreads_or(occ);
}

// ---------------------------------------------------------------------------
// 4_bwd
// ---------------------------------------------------------------------------

// One block per (64 columns of f, 64 slots, expert): q = dy[idx] Wd^T (K = d).
template <typename T>
__global__ void __launch_bounds__(THREADS) down_dh_kernel(
    const float* __restrict__ dy,       // (T, d)
    const T* __restrict__ h,            // (E, C, f)
    const T* __restrict__ wd,           // (E, f, d)
    const int* __restrict__ flat_idx,   // (E*C,)
    const float* __restrict__ slot_w,   // (E*C,)
    float* __restrict__ part,           // (E*C, ntiles): <h, q> over each tile's columns
    T* __restrict__ dh,                 // (E, C, f)
    int Tn, int C, int d, int f, int ntiles) {
  __shared__ Tiles<1> s;
  __shared__ int tok_s[BM];
  __shared__ float w_s[BM];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  const bool any = load_slots(flat_idx, slot_w, tok_s, w_s, e, c0, C, Tn);
  float acc[1][4][4];
  zero(acc);
  if (any) {
    const T* pw = wd + e * f * d;
    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int m = i / BK, kk = i % BK, tok = tok_s[m];
        s.a[kk][m] = (tok < Tn && k0 + kk < d) ? dy[(long)tok * d + k0 + kk] : 0.f;
      }
      for (int i = tid; i < BN * BK; i += THREADS) {
        const int n = i / BK, kk = i % BK;
        s.b[0][kk][n] = (n0 + n < f && k0 + kk < d) ? to_f32(pw[(long)(n0 + n) * d + k0 + kk]) : 0.f;
      }
      __syncthreads();
      tile_products(acc, s, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i, c = c0 + m;
    const bool occ = tok_s[m] < Tn;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (c < C && n < f) {
        const long at = (e * C + c) * f + n;
        const float q = acc[0][i][j];
        if (occ) dot = fmaf(to_f32(h[at]), q, dot);
        dh[at] = from_f32<T>(occ ? w_s[m] * q : 0.f);
      }
    }
    // the row's 64 columns: 16 lanes of one half-warp, summed by a fixed butterfly
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (tx == 0 && c < C) part[(e * C + c) * ntiles + blockIdx.x] = occ ? dot : 0.f;
  }
}

// One block per (64 columns of d, 64 rows of f, expert): dWd[e] = h[e]^T (w dy[idx]) (K = C slots).
template <typename T>
__global__ void __launch_bounds__(THREADS) down_dw_kernel(
    const float* __restrict__ dy, const T* __restrict__ h, const int* __restrict__ flat_idx,
    const float* __restrict__ slot_w, T* __restrict__ dwd,  // (E, f, d)
    int Tn, int C, int d, int f) {
  __shared__ Tiles<1> s;
  __shared__ int tok_k[BK];
  __shared__ float w_k[BK];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  float acc[1][4][4];
  zero(acc);
  for (int k0 = 0; k0 < C; k0 += BK) {
    if (!load_step_slots(flat_idx, slot_w, tok_k, w_k, e, k0, C, Tn)) continue;
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int kk = i / BM, m = i % BM;
      s.a[kk][m] = (tok_k[kk] < Tn && m0 + m < f) ? to_f32(h[(e * C + k0 + kk) * f + m0 + m]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN, tok = tok_k[kk];
      s.b[0][kk][n] = (tok < Tn && n0 + n < d) ? w_k[kk] * dy[(long)tok * d + n0 + n] : 0.f;
    }
    __syncthreads();
    tile_products(acc, s, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < f && n < d) dwd[(e * f + m) * d + n] = from_f32<T>(acc[0][i][j]);
    }
  }
}

// d slot_w: one thread a slot, its tile partials in ascending tile order.
__global__ void down_dsw_kernel(const float* __restrict__ part, const int* __restrict__ flat_idx,
                                float* __restrict__ dsw, int Tn, int EC, int ntiles) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= EC) return;
  float acc = 0.f;
  if (flat_idx[s] < Tn)
    for (int t = 0; t < ntiles; ++t) acc += part[(long)s * ntiles + t];
  dsw[s] = acc;
}

// ---------------------------------------------------------------------------
// 3_bwd
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sigmoid_f32(float g) { return 1.0f / (1.0f + expf(-g)); }

// One block per (64 columns of f, 64 slots, expert): g, u = xs Wg, xs Wu (K =
// d) recomputed, then dg = dh u silu'(g), du = dh silu(g) into the f32
// scratch dgu: dg (E*C, f), then du (E*C, f).
template <typename T>
__global__ void __launch_bounds__(THREADS) gate_up_dgu_kernel(
    const T* __restrict__ dh, const T* __restrict__ x, const int* __restrict__ flat_idx,
    const T* __restrict__ wg, const T* __restrict__ wu, float* __restrict__ dgu, int Tn, int C, int d, int f) {
  __shared__ Tiles<2> s;
  __shared__ int tok_s[BM];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  const long EC = (long)gridDim.z * C;
  const bool any = load_slots(flat_idx, nullptr, tok_s, nullptr, e, c0, C, Tn);
  float acc[2][4][4];
  zero(acc);
  if (any) {
    const T* pg = wg + e * d * f;
    const T* pu = wu + e * d * f;
    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int m = i / BK, kk = i % BK, tok = tok_s[m];
        s.a[kk][m] = (tok < Tn && k0 + kk < d) ? to_f32(x[(long)tok * d + k0 + kk]) : 0.f;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, n = i % BN;
        const bool in = k0 + kk < d && n0 + n < f;
        const long at = (long)(k0 + kk) * f + n0 + n;
        s.b[0][kk][n] = in ? to_f32(pg[at]) : 0.f;
        s.b[1][kk][n] = in ? to_f32(pu[at]) : 0.f;
      }
      __syncthreads();
      tile_products(acc, s, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i, c = c0 + m;
    const bool occ = tok_s[m] < Tn;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (c < C && n < f) {
        const long at = (e * C + c) * f + n;
        float dg = 0.f, du = 0.f;
        if (occ) {
          const float g = acc[0][i][j], u = acc[1][i][j], dv = to_f32(dh[at]);
          const float sg = sigmoid_f32(g);
          dg = dv * u * (sg * (1.0f + g * (1.0f - sg)));
          du = dv * (g * sg);
        }
        dgu[at] = dg;
        dgu[EC * f + at] = du;
      }
    }
  }
}

// One block per (64 columns of f, 64 rows of d, expert): dWg[e] = xs^T dg,
// dWu[e] = xs^T du (K = C slots, both from one staged x tile).
template <typename T>
__global__ void __launch_bounds__(THREADS) gate_up_dw_kernel(
    const float* __restrict__ dgu, const T* __restrict__ x, const int* __restrict__ flat_idx,
    T* __restrict__ dwg, T* __restrict__ dwu, int Tn, int C, int d, int f) {
  __shared__ Tiles<2> s;
  __shared__ int tok_k[BK];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  const long EC = (long)gridDim.z * C;
  float acc[2][4][4];
  zero(acc);
  for (int k0 = 0; k0 < C; k0 += BK) {
    if (!load_step_slots(flat_idx, nullptr, tok_k, nullptr, e, k0, C, Tn)) continue;
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int kk = i / BM, m = i % BM, tok = tok_k[kk];
      s.a[kk][m] = (tok < Tn && m0 + m < d) ? to_f32(x[(long)tok * d + m0 + m]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, n = i % BN;
      const bool in = tok_k[kk] < Tn && n0 + n < f;
      const long at = (e * C + k0 + kk) * f + n0 + n;
      s.b[0][kk][n] = in ? dgu[at] : 0.f;
      s.b[1][kk][n] = in ? dgu[EC * f + at] : 0.f;
    }
    __syncthreads();
    tile_products(acc, s, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < d && n < f) {
        const long at = (e * d + m) * f + n;
        dwg[at] = from_f32<T>(acc[0][i][j]);
        dwu[at] = from_f32<T>(acc[1][i][j]);
      }
    }
  }
}

// One block per (64 columns of d, 64 slots, expert): dxs = dg Wg^T + du Wu^T
// (K = f twice: Wg's products first, then Wu's), f32.  Empty slots are left
// unwritten: no combine word names them.
template <typename T>
__global__ void __launch_bounds__(THREADS) gate_up_dxs_kernel(
    const float* __restrict__ dgu, const int* __restrict__ flat_idx, const T* __restrict__ wg,
    const T* __restrict__ wu, float* __restrict__ dxs, int Tn, int C, int d, int f) {
  __shared__ Tiles<1> s;
  __shared__ int tok_s[BM];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM;
  const long e = blockIdx.z;
  const long EC = (long)gridDim.z * C;
  if (!load_slots(flat_idx, nullptr, tok_s, nullptr, e, c0, C, Tn)) return;
  float acc[1][4][4];
  zero(acc);
  for (int q = 0; q < 2; ++q) {
    const float* pd = dgu + q * EC * f;
    const T* pw = (q == 0 ? wg : wu) + e * d * f;
    for (int k0 = 0; k0 < f; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int m = i / BK, kk = i % BK, c = c0 + m;
        s.a[kk][m] = (tok_s[m] < Tn && k0 + kk < f) ? pd[(e * C + c) * f + k0 + kk] : 0.f;
      }
      for (int i = tid; i < BN * BK; i += THREADS) {
        const int n = i / BK, kk = i % BK;
        s.b[0][kk][n] = (n0 + n < d && k0 + kk < f) ? to_f32(pw[(long)(n0 + n) * f + k0 + kk]) : 0.f;
      }
      __syncthreads();
      tile_products(acc, s, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i, c = c0 + m;
    if (c >= C || tok_s[m] >= Tn) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < d) dxs[(e * C + c) * d + n] = acc[0][i][j];
    }
  }
}

constexpr int DX_THREADS = 256;

// dx[t] = sum over j ascending of dxs[cidx[t k + j]] (a dropped assignment,
// cidx = E*C, adds nothing); one block per (token, 256 columns).
template <typename T>
__global__ void __launch_bounds__(DX_THREADS) gate_up_dx_kernel(
    const float* __restrict__ dxs, const int* __restrict__ cidx, T* __restrict__ dx, int EC, int d, int k) {
  const long t = blockIdx.x;
  const int col = blockIdx.y * DX_THREADS + threadIdx.x;
  if (col >= d) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const int s = cidx[t * k + j];
    if (s < EC) acc += dxs[(long)s * d + col];
  }
  dx[t * d + col] = from_f32<T>(acc);
}

// ---------------------------------------------------------------------------
// the tensor-core builds (bf16, d and f multiples of 8, 16-byte-aligned bases)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 64;                   // K a stage
constexpr int UNIT = 64;                 // slots a unit: M rows of a slot-major product, a stage of a slot sum
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX = 64 * 128;            // bytes of a 64 x 64 bf16 tile (128-byte swizzle)
constexpr int BN = 256;                  // B columns a tile: 128 a warpgroup
constexpr int HALF = BN / 2 * 128;       // bytes of a warpgroup's half of a B tile, in either layout

// The five products, each D (64 x BN) = A (64 x K) . B (K x BN) per tile:
//   DH   q = R Wd^T: A the slots' dy rows (hi + lo, pair scratch), B Wd's f rows;
//   DWD  dWd^T = (w R)^T h: A the weighted rows (hi + lo, pair scratch), B h;
//   DGU  g, u = xs Wg, xs Wu: A the slots' x rows (xs scratch), B Wg and Wu;
//   DW   dWg^T, dWu^T = dg^T xs, du^T xs: A dg or du (hi + lo), B xs;
//   DXS  dxs = dg Wg^T + du Wu^T: A dg then du (hi + lo), B Wg's then Wu's d rows.
enum Prod { DH, DWD, DGU, DW, DXS };

// NA: A tiles a stage (2: the hi and lo halves of one operand, both into
// one accumulator); NB: B tiles of BN columns, an accumulator each (DGU:
// Wg's and Wu's); A_MN / B_MN: the operand MN-major (read transposed);
// every operand comes by TMA (the slots' rows from copies gathered once: by
// the producer warps' cp.async each product ran at 0.5-0.65 of its rate
// fed by TMA, PERF.md s. 6); UNIT_FAST: the
// tiles are the occupied slot units (in the order of units_kernel's list)
// by N tiles, an expert's units fastest, so the tiles in flight share one
// slice of the expert's weights and it is read from memory once (with the
// empty units left in the grid and skipped, the blocks fell out of step and
// read each slice again, unit by unit)
template <int P>
struct Cfg {
  static constexpr int NA = P == DGU ? 1 : 2;
  static constexpr int NB = P == DGU ? 2 : 1;
  static constexpr int A_MN = P == DWD || P == DW;
  static constexpr int B_MN = P != DH && P != DXS;
  static constexpr bool SLOT_SUM = P == DWD || P == DW;  // K = the expert's slots, a unit a stage
  static constexpr bool UNIT_FAST = P == DH || P == DGU || P == DXS;
  static constexpr int STAGE = NA * BOX + NB * BN * 128;
  static constexpr int STAGES = P == DGU ? 3 : 4;
  static constexpr int BYTES = STAGES * STAGE + 1024;
};

struct Params {
  const __nv_bfloat16* h;    // DH: h, DGU: dh; (E, C, f)
  const int* flat_idx;       // (E*C,)
  const float* slot_w;       // (E*C,)
  const int* occ;            // (E, nU): whether a unit holds an occupied slot
  const int* ulist;          // the occupied units, e nU + u, ascending
  const int* ustart;         // (E + 1,): the position of expert e's first in ulist
  float* part;               // DH: (E*C, nN) <h, q> over each tile's columns
  float* dxs;                // DXS: (E*C, d)
  __nv_bfloat16* out0;       // DH dh, DWD dWd, DGU the dg/du pairs, DW dWg
  __nv_bfloat16* out1;       // DW dWu
  int Tn, E, C, d, f, nU;
  int nN, nM, npass;         // tiles: N tiles, M units, passes, experts (slot-major: see decode)
};

struct Tile {
  int e, mu, nu, pass;
};

template <int P>
__device__ __forceinline__ Tile decode(const Params& p, int t) {
  Tile x;
  if (Cfg<P>::UNIT_FAST) {
    // expert e's tiles are [ustart[e] nN, ustart[e + 1] nN): the last e
    // whose tiles start at or before t (an expert with no occupied unit
    // starts where the next one does)
    int lo = 0, hi = p.E;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (p.ustart[mid] * p.nN <= t) lo = mid;
      else hi = mid;
    }
    const int u0 = p.ustart[lo], ne = p.ustart[lo + 1] - u0, local = t - u0 * p.nN;
    x.e = lo;
    x.nu = local / ne;
    x.mu = p.ulist[u0 + local - x.nu * ne] - lo * p.nU;
    x.pass = 0;
  } else {
    x.nu = t % p.nN;
    t /= p.nN;
    x.mu = t % p.nM;
    t /= p.nM;
    x.pass = t % p.npass;
    x.e = t / p.npass;
  }
  return x;
}

template <int P>
__device__ __forceinline__ int steps(const Params& p) {
  if constexpr (P == DH || P == DGU) return (p.d + BK - 1) / BK;
  else if constexpr (P == DXS) return 2 * ((p.f + BK - 1) / BK);
  else return p.nU;
}

// whether tile x runs stage it: a slot sum skips the units with no
// occupied slot (a slot-major tile is an occupied unit: it runs them all)
template <int P>
__device__ __forceinline__ bool live(const Params& p, const Tile& x, int it) {
  return !Cfg<P>::SLOT_SUM || p.occ[x.e * p.nU + it] != 0;
}

template <int MN>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return MN ? sm90::desc_mnmajor(addr, BOX) : sm90::desc_kmajor(addr);
}

// the producer (one lane): fills stage after stage of the block's tiles,
// a ring of STAGES
template <int P>
__device__ __forceinline__ void produce(const CUtensorMap* ma, const CUtensorMap* mb0, const CUtensorMap* mb1,
                                        const Params& p, uint32_t base, uint32_t full, uint32_t empty, int ntiles) {
  using L = Cfg<P>;
  const int nk = steps<P>(p), nkf = (p.f + BK - 1) / BK;
  int n = 0;  // stages filled, across tiles
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile x = decode<P>(p, t);
    for (int it = 0; it < nk; ++it) {
      if (!live<P>(p, x, it)) continue;
      const int s = n % L::STAGES;
      if (n >= L::STAGES) sm90::mbar_wait(empty + 8 * s, ((n / L::STAGES) - 1) & 1);
      const uint32_t sa = base + s * L::STAGE, sb = sa + L::NA * BOX, bar = full + 8 * s;
      if constexpr (P == DH) {  // the dy pairs (d, C, 2E), K-major; Wd (d, f, E): 256 f rows, K-major
        sm90::mbar_expect_tx(bar, 2 * BOX + BN * 128);
        sm90::tma_load_3d(sa, ma, bar, it * BK, x.mu * UNIT, x.e);
        sm90::tma_load_3d(sa + BOX, ma, bar, it * BK, x.mu * UNIT, p.E + x.e);
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_3d(sb + j * BOX, mb0, bar, it * BK, x.nu * BN + 64 * j, x.e);
      } else if constexpr (P == DWD) {  // the weighted pairs (d, C, 2E), h (f, C, E): both MN-major
        sm90::mbar_expect_tx(bar, 2 * BOX + BN * 128);
        sm90::tma_load_3d(sa, ma, bar, x.mu * 64, it * UNIT, x.e);
        sm90::tma_load_3d(sa + BOX, ma, bar, x.mu * 64, it * UNIT, p.E + x.e);
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_3d(sb + j * BOX, mb0, bar, x.nu * BN + 64 * j, it * UNIT, x.e);
      } else if constexpr (P == DGU) {  // xs (d, C, E), K-major; Wg and Wu (f, d, E), MN-major
        sm90::mbar_expect_tx(bar, BOX + 2 * BN * 128);
        sm90::tma_load_3d(sa, ma, bar, it * BK, x.mu * UNIT, x.e);
        for (int j = 0; j < BN / 64; ++j) {
          sm90::tma_load_3d(sb + j * BOX, mb0, bar, x.nu * BN + 64 * j, it * BK, x.e);
          sm90::tma_load_3d(sb + BN * 128 + j * BOX, mb1, bar, x.nu * BN + 64 * j, it * BK, x.e);
        }
      } else if constexpr (P == DW) {  // dg or du pairs (f, C, 4E), xs (d, C, E): both MN-major
        sm90::mbar_expect_tx(bar, 2 * BOX + BN * 128);
        sm90::tma_load_3d(sa, ma, bar, x.mu * 64, it * UNIT, 2 * x.pass * p.E + x.e);
        sm90::tma_load_3d(sa + BOX, ma, bar, x.mu * 64, it * UNIT, (2 * x.pass + 1) * p.E + x.e);
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_3d(sb + j * BOX, mb0, bar, x.nu * BN + 64 * j, it * UNIT, x.e);
      } else {  // DXS: dg then du pairs, K-major; Wg then Wu (f, d, E), 256 d rows, K-major
        const int q = it / nkf, kf = it - q * nkf;
        sm90::mbar_expect_tx(bar, 2 * BOX + BN * 128);
        sm90::tma_load_3d(sa, ma, bar, kf * BK, x.mu * UNIT, 2 * q * p.E + x.e);
        sm90::tma_load_3d(sa + BOX, ma, bar, kf * BK, x.mu * UNIT, (2 * q + 1) * p.E + x.e);
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_3d(sb + j * BOX, q ? mb1 : mb0, bar, kf * BK, x.nu * BN + 64 * j, x.e);
      }
      ++n;
    }
  }
}

// The epilogues.  acc[o][4 c + 2 i + hh] is row 16 warp + lane / 4 + 8 i of
// the tile's 64 and column 8 c + 2 (lane % 4) + hh of warpgroup w's 128.
template <int P>
__device__ __forceinline__ void epilogue(const Params& p, const Tile& x, float (&acc)[Cfg<P>::NB][64],
                                         float* red) {
  const int tid = threadIdx.x, w = tid >> 7, lane = tid & 31;
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2), c2 = 2 * (lane & 3);
  const int n0 = x.nu * BN + 128 * w;
  if constexpr (P == DH) {
    // dh = slot_w q (bf16); the row's <h, q> over its 256 columns: each
    // thread's columns, its quad by a fixed butterfly, then warpgroup 0's
    // half plus warpgroup 1's
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = x.mu * UNIT + r0 + 8 * i;
      const long s = (long)x.e * p.C + c;
      const bool in = c < p.C, occ = in && p.flat_idx[s] < p.Tn;
      const float wt = occ ? p.slot_w[s] : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const int n = n0 + 8 * cc + c2;
        if (in && n < p.f) {  // f is a multiple of 8: n + 1 < f too
          const float q0 = acc[0][4 * cc + 2 * i], q1 = acc[0][4 * cc + 2 * i + 1];
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(p.h + s * p.f + n);
          if (occ) dot = fmaf(__high2float(hv), q1, fmaf(__low2float(hv), q0, dot));
          *reinterpret_cast<__nv_bfloat162*>(p.out0 + s * p.f + n) = __floats2bfloat162_rn(wt * q0, wt * q1);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if ((lane & 3) == 0) red[w * UNIT + r0 + 8 * i] = dot;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    if (tid < UNIT) {
      const int c = x.mu * UNIT + tid;
      if (c < p.C) {
        const long s = (long)x.e * p.C + c;
        p.part[s * p.nN + x.nu] = p.flat_idx[s] < p.Tn ? red[tid] + red[UNIT + tid] : 0.f;
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // red is free for the next tile
  } else if constexpr (P == DGU) {
    // dg = dh u silu'(g), du = dh silu(g) in f32, each written as hi =
    // bf16(v) and lo = bf16(v - hi): four (E*C, f) arrays dg hi, dg lo, du
    // hi, du lo; an empty slot's rows zeros (an empty unit's are never read)
    const long X = (long)p.E * p.C * p.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = x.mu * UNIT + r0 + 8 * i;
      if (c >= p.C) continue;
      const long s = (long)x.e * p.C + c;
      const bool occ = p.flat_idx[s] < p.Tn;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const int n = n0 + 8 * cc + c2;
        if (n >= p.f) continue;
        float dg[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
        if (occ) {
          const __nv_bfloat162 dv2 = *reinterpret_cast<const __nv_bfloat162*>(p.h + s * p.f + n);
          const float dv[2] = {__low2float(dv2), __high2float(dv2)};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float g = acc[0][4 * cc + 2 * i + hh], u = acc[1][4 * cc + 2 * i + hh];
            const float sg = sigmoid_f32(g);
            dg[hh] = dv[hh] * u * (sg * (1.0f + g * (1.0f - sg)));
            du[hh] = dv[hh] * (g * sg);
          }
        }
        const __nv_bfloat162 gh = __floats2bfloat162_rn(dg[0], dg[1]), uh = __floats2bfloat162_rn(du[0], du[1]);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p.out0 + s * p.f + n);
        o[0] = gh;
        o[X / 2] = __floats2bfloat162_rn(dg[0] - __low2float(gh), dg[1] - __high2float(gh));
        o[X] = uh;
        o[3 * X / 2] = __floats2bfloat162_rn(du[0] - __low2float(uh), du[1] - __high2float(uh));
      }
    }
  } else if constexpr (P == DXS) {
    // the occupied slots' rows of dxs, f32 (no combine word names an empty slot)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = x.mu * UNIT + r0 + 8 * i;
      if (c >= p.C) continue;
      const long s = (long)x.e * p.C + c;
      if (p.flat_idx[s] >= p.Tn) continue;
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const int n = n0 + 8 * cc + c2;
        if (n < p.d)
          *reinterpret_cast<float2*>(p.dxs + s * p.d + n) =
              make_float2(acc[0][4 * cc + 2 * i], acc[0][4 * cc + 2 * i + 1]);
      }
    }
  } else {
    // DWD, DW: D's row m (of d, or f) and column n (of f, or d) is
    // out[e][n][m].  A lane and its quad partner (lane ^ 4) hold rows m and
    // m + 1 of the same two columns: they swap one value so that each
    // stores two neighbouring rows of one column (bf16 pairs)
    const int MT = P == DWD ? p.d : p.f, NT = P == DWD ? p.f : p.d;
    __nv_bfloat16* out = P == DW && x.pass ? p.out1 : p.out0;
    const bool odd = (lane >> 2) & 1;
#pragma unroll
    for (int cc = 0; cc < 16; ++cc)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v0 = acc[0][4 * cc + 2 * i], v1 = acc[0][4 * cc + 2 * i + 1];
        const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const int m = x.mu * 64 + r0 + 8 * i - (odd ? 1 : 0), n = n0 + 8 * cc + c2 + (odd ? 1 : 0);
        if (m < MT && n < NT)  // both multiples of 8: m + 1 < MT too
          *reinterpret_cast<__nv_bfloat162*>(out + ((long)x.e * NT + n) * MT + m) =
              odd ? __floats2bfloat162_rn(got, v1) : __floats2bfloat162_rn(v0, got);
      }
  }
}

// the consumer warpgroups: warpgroup w takes B's columns 128 w .. 128 w +
// 127.  A stage's products are issued, then the previous stage's are
// waited for and its buffers released, so one stage's products run while
// the next is issued
template <int P>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, uint32_t full, uint32_t empty, float* red,
                                        int ntiles) {
  using L = Cfg<P>;
  const int w = threadIdx.x >> 7, lane = threadIdx.x & 31, nk = steps<P>(p);
  float acc[L::NB][64];
  int n = 0;  // stages consumed, across tiles
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile x = decode<P>(p, t);
#pragma unroll
    for (int o = 0; o < L::NB; ++o)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[o][i] = 0.f;
    int prev = -1;  // the ring slot whose products are still in flight
    for (int it = 0; it < nk; ++it) {
      if (!live<P>(p, x, it)) continue;
      const int s = n % L::STAGES;
      sm90::mbar_wait(full + 8 * s, (n / L::STAGES) & 1);
      const uint32_t sa = base + s * L::STAGE, sb = sa + L::NA * BOX + w * HALF;
#pragma unroll
      for (int o = 0; o < L::NB; ++o) sm90::fence_operands(acc[o]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // step kk: K rows 16 kk .. of an MN-major tile (2,048 bytes on), bytes 32 kk of a K-major one's rows
        const uint32_t ao = L::A_MN ? kk * 16 * 128 : kk * 32, bo = L::B_MN ? kk * 16 * 128 : kk * 32;
        const uint64_t db = desc<L::B_MN>(sb + bo);
        if constexpr (P == DGU) {
          const uint64_t da = desc<0>(sa + ao);
          sm90::wgmma_m64n128k16<0, 1>(acc[0], da, db);
          sm90::wgmma_m64n128k16<0, 1>(acc[1], da, desc<1>(sb + BN * 128 + bo));
        } else {  // hi, then lo, into the one accumulator
          sm90::wgmma_m64n128k16<L::A_MN, L::B_MN>(acc[0], desc<L::A_MN>(sa + ao), db);
          sm90::wgmma_m64n128k16<L::A_MN, L::B_MN>(acc[0], desc<L::A_MN>(sa + BOX + ao), db);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
#pragma unroll
      for (int o = 0; o < L::NB; ++o) sm90::fence_operands(acc[o]);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      ++n;
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int o = 0; o < L::NB; ++o) sm90::fence_operands(acc[o]);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + 8 * prev);
    }
    epilogue<P>(p, x, acc, red);
  }
}

// One persistent block an SM walks the tiles t = blockIdx.x + i gridDim.x;
// the ring runs on across tiles, so the producer fills the next tile's
// stages while the consumers finish the last one's.
template <int P>
__device__ __forceinline__ void gemm(const CUtensorMap* ma, const CUtensorMap* mb0, const CUtensorMap* mb1,
                                     const Params& p) {
  using L = Cfg<P>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * L::STAGES];
  __shared__ float red[2 * UNIT];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = sm90::smem_u32(bars), empty = full + 8 * L::STAGES;
  const int ntiles = L::UNIT_FAST ? p.ustart[p.E] * p.nN : p.nN * p.nM * p.npass * p.E;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      sm90::mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival a consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == CONSUMERS) produce<P>(ma, mb0, mb1, p, base, full, empty, ntiles);
  else if (threadIdx.x < CONSUMERS) consume<P>(p, base, full, empty, red, ntiles);
}

#define REPRO_BWD_TC_ARGS                                                                      \
  const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb0,             \
      const __grid_constant__ CUtensorMap mb1, const __grid_constant__ Params p
__global__ void __launch_bounds__(THREADS, 1) down_dh_tc_kernel(REPRO_BWD_TC_ARGS) {
  gemm<DH>(&ma, &mb0, &mb1, p);
}
__global__ void __launch_bounds__(THREADS, 1) down_dw_tc_kernel(REPRO_BWD_TC_ARGS) {
  gemm<DWD>(&ma, &mb0, &mb1, p);
}
__global__ void __launch_bounds__(THREADS, 1) gate_up_dgu_tc_kernel(REPRO_BWD_TC_ARGS) {
  gemm<DGU>(&ma, &mb0, &mb1, p);
}
__global__ void __launch_bounds__(THREADS, 1) gate_up_dw_tc_kernel(REPRO_BWD_TC_ARGS) {
  gemm<DW>(&ma, &mb0, &mb1, p);
}
__global__ void __launch_bounds__(THREADS, 1) gate_up_dxs_tc_kernel(REPRO_BWD_TC_ARGS) {
  gemm<DXS>(&ma, &mb0, &mb1, p);
}
#undef REPRO_BWD_TC_ARGS

// The slot units: occ[e nU + u], whether unit u (slots 64 u .. 64 u + 63)
// of expert e holds an occupied slot; ulist, the occupied units' indices e
// nU + u in ascending order; ustart[e], the position in ulist of expert e's
// first (ustart[E]: their count).  One block of 1,024 threads, a unit a
// thread, 1,024 units at a time.
__global__ void __launch_bounds__(1024) units_kernel(const int* __restrict__ flat_idx, int* __restrict__ occ,
                                                     int* __restrict__ ulist, int* __restrict__ ustart, int Tn,
                                                     int E, int C, int nU) {
  __shared__ int wsum[32];
  __shared__ int base;
  const int n = E * nU, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += 1024) {
    const int i = i0 + threadIdx.x;
    int any = 0;
    if (i < n) {
      const int e = i / nU, c0 = (i - e * nU) * UNIT, c1 = min(C, c0 + UNIT);
      for (int c = c0; c < c1; c += 16) {
#pragma unroll
        for (int j = 0; j < 16; ++j) any |= c + j < c1 && flat_idx[(long)e * C + c + j] < Tn;
      }
      occ[i] = any;
    }
    int incl = any;  // the warp's inclusive scan, then the warps' exclusive one
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int mine = wsum[lane];
      int w = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += v;
      }
      wsum[lane] = w - mine;
    }
    __syncthreads();
    if (any) ulist[base + wsum[warp] + incl - 1] = i;
    __syncthreads();
    if (threadIdx.x == 1023) base += wsum[warp] + incl;
    __syncthreads();
  }
  for (int e = threadIdx.x; e <= E; e += 1024) {  // the first position holding a unit of e or later
    int lo = 0, hi = base;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ulist[mid] < e * nU) lo = mid + 1;
      else hi = mid;
    }
    ustart[e] = lo;
  }
}

// hi = bf16(v) and lo = bf16(v - hi) of 8 floats, as two 16-byte words
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hp = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const __nv_bfloat162 lp = __floats2bfloat162_rn(v[2 * i] - __low2float(hp), v[2 * i + 1] - __high2float(hp));
    h[i] = *reinterpret_cast<const uint32_t*>(&hp);
    l[i] = *reinterpret_cast<const uint32_t*>(&lp);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// Slot s's dy row R = dy[idx_s] and its weighted row w_s R (an empty
// slot's: zeros), each split by split8 into rpairs and spairs (hi at s d,
// lo E C d further on), and an empty slot's dh row zeros (the dh launch's
// tiles are the occupied units).  A block is SPLIT_COLS columns of one
// slot, 8 a thread; the grid takes every slot of a column chunk before the
// next chunk, so the chunk of dy the slots read (Tn x SPLIT_COLS f32) stays
// in L2 for the k slots of each token.
constexpr int SPLIT_COLS = 1024;

__global__ void __launch_bounds__(SPLIT_COLS / 8) split_rows_kernel(
    const float* __restrict__ dy, const int* __restrict__ flat_idx, const float* __restrict__ slot_w,
    __nv_bfloat16* __restrict__ rpairs, __nv_bfloat16* __restrict__ spairs, __nv_bfloat16* __restrict__ dh, int Tn,
    int EC, int d, int f) {
  const long s = blockIdx.x, lo = (long)EC * d;
  const int tok = flat_idx[s], k = blockIdx.y * SPLIT_COLS + 8 * threadIdx.x;
  const bool occ = tok < Tn;
  if (!occ && blockIdx.y == 0)
    for (int c = 8 * threadIdx.x; c < f; c += SPLIT_COLS)
      *reinterpret_cast<uint4*>(dh + s * f + c) = make_uint4(0u, 0u, 0u, 0u);
  if (k >= d) return;
  float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, v[8];
  if (occ) {
    const float4 a = *reinterpret_cast<const float4*>(dy + (long)tok * d + k);
    const float4 b = *reinterpret_cast<const float4*>(dy + (long)tok * d + k + 4);
    r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w, r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
  }
  const float wt = occ ? slot_w[s] : 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = wt * r[i];
  uint4 h, l;
  split8(r, h, l);
  *reinterpret_cast<uint4*>(rpairs + s * d + k) = h;
  *reinterpret_cast<uint4*>(rpairs + lo + s * d + k) = l;
  split8(v, h, l);
  *reinterpret_cast<uint4*>(spairs + s * d + k) = h;
  *reinterpret_cast<uint4*>(spairs + lo + s * d + k) = l;
}

// xs (E*C, d): slot s's x row (an empty slot's: zeros), 16 bytes a thread
__global__ void __launch_bounds__(256) gather_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                                          const int* __restrict__ flat_idx,
                                                          __nv_bfloat16* __restrict__ xs, int Tn, long EC, int d) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x, per_row = d / 8;
  if (i >= EC * per_row) return;
  const long s = i / per_row;
  const int k = (int)(i - s * per_row) * 8, tok = flat_idx[s];
  *reinterpret_cast<uint4*>(xs + s * d + k) =
      tok < Tn ? *reinterpret_cast<const uint4*>(x + (long)tok * d + k) : make_uint4(0u, 0u, 0u, 0u);
}

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
inline auto kernel_of() {
  if constexpr (P == DH) return down_dh_tc_kernel;
  else if constexpr (P == DWD) return down_dw_tc_kernel;
  else if constexpr (P == DGU) return gate_up_dgu_tc_kernel;
  else if constexpr (P == DW) return gate_up_dw_tc_kernel;
  else return gate_up_dxs_tc_kernel;
}

// one persistent launch of product P: a block an SM, at most one a tile
template <int P>
int run(const CUtensorMap& ma, const CUtensorMap& mb0, const CUtensorMap& mb1, const Params& p, cudaStream_t st) {
  const auto kernel = kernel_of<P>();
  // the opt-in above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<P>::BYTES);
  if (opted != cudaSuccess) return (int)opted;
  const long ntiles = (long)p.nN * p.nM * p.npass * p.E;
  if (ntiles == 0) return 0;
  if (ntiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)std::min<long>(ntiles, sm_count()), THREADS, Cfg<P>::BYTES, st>>>(ma, mb0, mb1, p);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// 4_bwd: dy (T, d) f32; h (E, C, f), wd (E, f, d) in the dtype code's type;
// part: (E*C) * ceil(f / 64) f32 scratch; outputs dh (E, C, f) and dwd (E, f,
// d) in that type, dslot_w (E*C,) f32.  Three launches.
extern "C" int repro_down_combine_bwd(int dtype, const void* dy, const void* h, const void* wd, const void* flat_idx,
                                      const void* slot_w, void* part, void* dh, void* dwd, void* dslot_w, int Tn,
                                      int E, int C, int d, int f, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return 0;
  if (E > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (f + BN - 1) / BN, EC = E * C;
  REPRO_DISPATCH(dtype, Tp, {
    down_dh_kernel<Tp><<<dim3(ntiles, (C + BM - 1) / BM, E), THREADS, 0, st>>>(
        (const float*)dy, (const Tp*)h, (const Tp*)wd, (const int*)flat_idx, (const float*)slot_w, (float*)part,
        (Tp*)dh, Tn, C, d, f, ntiles);
    down_dw_kernel<Tp><<<dim3((d + BN - 1) / BN, (f + BM - 1) / BM, E), THREADS, 0, st>>>(
        (const float*)dy, (const Tp*)h, (const int*)flat_idx, (const float*)slot_w, (Tp*)dwd, Tn, C, d, f);
  });
  down_dsw_kernel<<<(EC + 255) / 256, 256, 0, st>>>((const float*)part, (const int*)flat_idx, (float*)dslot_w, Tn,
                                                    EC, ntiles);
  return (int)cudaGetLastError();
}

// 3_bwd: dh (E, C, f), x (T, d), wg and wu (E, d, f) in the dtype code's
// type; flat_cidx (T*k,) int32; dgu: 2 * E*C*f f32 scratch, dxs: E*C*d f32
// scratch; outputs dx (T, d), dwg and dwu (E, d, f) in that type.  Four
// launches.
extern "C" int repro_gather_swiglu_bwd(int dtype, const void* dh, const void* x, const void* flat_idx,
                                       const void* flat_cidx, const void* wg, const void* wu, void* dgu, void* dxs,
                                       void* dx, void* dwg, void* dwu, int Tn, int E, int C, int d, int f, int k,
                                       void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return 0;
  if (E > 65535 || k <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 slots_f((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  const dim3 rows_d((f + BN - 1) / BN, (d + BM - 1) / BM, E);
  const dim3 slots_d((d + BN - 1) / BN, (C + BM - 1) / BM, E);
  REPRO_DISPATCH(dtype, Tp, {
    gate_up_dgu_kernel<Tp><<<slots_f, THREADS, 0, st>>>((const Tp*)dh, (const Tp*)x, (const int*)flat_idx,
                                                        (const Tp*)wg, (const Tp*)wu, (float*)dgu, Tn, C, d, f);
    gate_up_dw_kernel<Tp><<<rows_d, THREADS, 0, st>>>((const float*)dgu, (const Tp*)x, (const int*)flat_idx,
                                                      (Tp*)dwg, (Tp*)dwu, Tn, C, d, f);
    gate_up_dxs_kernel<Tp><<<slots_d, THREADS, 0, st>>>((const float*)dgu, (const int*)flat_idx, (const Tp*)wg,
                                                        (const Tp*)wu, (float*)dxs, Tn, C, d, f);
    if (Tn > 0)
      gate_up_dx_kernel<Tp><<<dim3(Tn, (d + DX_THREADS - 1) / DX_THREADS), DX_THREADS, 0, st>>>(
          (const float*)dxs, (const int*)flat_cidx, (Tp*)dx, E * C, d, k);
  });
  return (int)cudaGetLastError();
}

// 4_bwd's tensor-core build: dy (T, d) f32, h (E, C, f) and wd (E, f, d)
// bf16, contiguous with 16-byte-aligned bases, d and f multiples of 8.
// Scratch: units (2 E nU + E + 1 int32, nU = ceil(C / 64): units_kernel's
// occ, ulist and ustart), rpairs and spairs (2 E C d bf16 each: the hi and
// lo halves of the slots' dy rows and of their weighted rows), part (E C *
// ceil(f / 256) f32).  Outputs dh (E, C, f) and dwd (E, f, d) bf16, dslot_w (E*C,) f32.
// Five launches: the slot units, the splits, dh with the partial dots,
// dWd, the partials' sum.
extern "C" int repro_down_combine_bwd_tc(const void* dy, const void* h, const void* wd, const void* flat_idx,
                                         const void* slot_w, void* units, void* rpairs, void* spairs, void* part,
                                         void* dh, void* dwd, void* dslot_w, int Tn, int E, int C, int d, int f,
                                         void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return 0;
  if (E > 65535 || Tn < 0 || d % 8 != 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nU = (C + tc::UNIT - 1) / tc::UNIT, EC = E * C, nF = (f + tc::BN - 1) / tc::BN;
  // launch 1 first: as a runtime call it also makes the card's context
  // current on this host thread, which cuTensorMapEncodeTiled (libcuda's,
  // not the runtime's) needs; autograd runs the backward on a thread of its
  // own, where this may be the first CUDA call
  int* occ = (int*)units;
  tc::units_kernel<<<1, 1024, 0, st>>>((const int*)flat_idx, occ, occ + E * nU, occ + 2 * E * nU, Tn, E, C, nU);
  tc::split_rows_kernel<<<dim3(EC, (d + tc::SPLIT_COLS - 1) / tc::SPLIT_COLS), tc::SPLIT_COLS / 8, 0, st>>>(
      (const float*)dy, (const int*)flat_idx, (const float*)slot_w, (__nv_bfloat16*)rpairs, (__nv_bfloat16*)spairs,
      (__nv_bfloat16*)dh, Tn, EC, d, f);
  int err = (int)cudaGetLastError();
  if (err) return err;
  CUtensorMap mrp, mwd, msp, mh;  // the dy pairs and Wd's f rows (K-major), the weighted pairs and h (MN-major)
  if (!tc::map3(&mrp, rpairs, d, C, 2L * E) || !tc::map3(&mwd, wd, d, f, E) ||
      !tc::map3(&msp, spairs, d, C, 2L * E) || !tc::map3(&mh, h, f, C, E))
    return (int)cudaErrorInvalidValue;
  tc::Params p{};
  p.h = (const __nv_bfloat16*)h;
  p.flat_idx = (const int*)flat_idx;
  p.slot_w = (const float*)slot_w;
  p.occ = occ;
  p.ulist = occ + E * nU;
  p.ustart = occ + 2 * E * nU;
  p.part = (float*)part;
  p.out0 = (__nv_bfloat16*)dh;
  p.Tn = Tn, p.E = E, p.C = C, p.d = d, p.f = f, p.nU = nU;
  p.nN = nF, p.nM = nU, p.npass = 1;
  if ((err = tc::run<tc::DH>(mrp, mwd, mwd, p, st))) return err;
  p.out0 = (__nv_bfloat16*)dwd;
  p.nM = (d + 63) / 64;
  if ((err = tc::run<tc::DWD>(msp, mh, mh, p, st))) return err;
  down_dsw_kernel<<<(EC + 255) / 256, 256, 0, st>>>((const float*)part, (const int*)flat_idx, (float*)dslot_w, Tn,
                                                    EC, nF);
  return (int)cudaGetLastError();
}

// 3_bwd's tensor-core build: dh (E, C, f), x (T, d), wg and wu (E, d, f)
// bf16, contiguous with 16-byte-aligned bases, d and f multiples of 8;
// flat_cidx (T*k,) int32.  Scratch: units (as repro_down_combine_bwd_tc's),
// dgu (4 E C f bf16: dg hi, dg lo, du hi, du lo), dxs (E C d f32; its first
// half holds the slots' x rows, xs (E C d bf16), until the dxs launch).
// Outputs dx (T, d), dwg and dwu (E, d, f) bf16.  Six launches: the slot
// units, xs, dg/du, dWg and dWu, dxs, dx.
extern "C" int repro_gather_swiglu_bwd_tc(const void* dh, const void* x, const void* flat_idx, const void* flat_cidx,
                                          const void* wg, const void* wu, void* units, void* dgu, void* dxs, void* dx,
                                          void* dwg, void* dwu, int Tn, int E, int C, int d, int f, int k,
                                          void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return 0;
  if (E > 65535 || Tn < 0 || k <= 0 || d % 8 != 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nU = (C + tc::UNIT - 1) / tc::UNIT;
  const long EC = (long)E * C;
  // launch 1 first, for the context (see repro_down_combine_bwd_tc)
  int* occ = (int*)units;
  tc::units_kernel<<<1, 1024, 0, st>>>((const int*)flat_idx, occ, occ + E * nU, occ + 2 * E * nU, Tn, E, C, nU);
  void* xs = dxs;  // dead before the dxs launch writes dxs
  tc::gather_rows_kernel<<<(unsigned)((EC * (d / 8) + 255) / 256), 256, 0, st>>>(
      (const __nv_bfloat16*)x, (const int*)flat_idx, (__nv_bfloat16*)xs, Tn, EC, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  CUtensorMap mxs, mg, mu, mp;  // xs; Wg and Wu (MN-major for dg/du, K-major for dxs); the dg/du pairs
  if (!tc::map3(&mxs, xs, d, C, E) || !tc::map3(&mg, wg, f, d, E) || !tc::map3(&mu, wu, f, d, E) ||
      !tc::map3(&mp, dgu, f, C, 4L * E))
    return (int)cudaErrorInvalidValue;
  tc::Params p{};
  p.h = (const __nv_bfloat16*)dh;
  p.flat_idx = (const int*)flat_idx;
  p.occ = occ;
  p.ulist = occ + E * nU;
  p.ustart = occ + 2 * E * nU;
  p.dxs = (float*)dxs;
  p.out0 = (__nv_bfloat16*)dgu;
  p.Tn = Tn, p.E = E, p.C = C, p.d = d, p.f = f, p.nU = nU;
  p.nN = (f + tc::BN - 1) / tc::BN, p.nM = nU, p.npass = 1;
  if ((err = tc::run<tc::DGU>(mxs, mg, mu, p, st))) return err;
  p.out0 = (__nv_bfloat16*)dwg;
  p.out1 = (__nv_bfloat16*)dwu;
  p.nN = (d + tc::BN - 1) / tc::BN, p.nM = (f + 63) / 64, p.npass = 2;
  if ((err = tc::run<tc::DW>(mp, mxs, mxs, p, st))) return err;
  p.nM = nU, p.npass = 1;
  if ((err = tc::run<tc::DXS>(mp, mg, mu, p, st))) return err;
  if (Tn > 0)
    gate_up_dx_kernel<__nv_bfloat16><<<dim3(Tn, (d + DX_THREADS - 1) / DX_THREADS), DX_THREADS, 0, st>>>(
        (const float*)dxs, (const int*)flat_cidx, (__nv_bfloat16*)dx, E * C, d, k);
  return (int)cudaGetLastError();
}

// Prefill MoE data plane: plan-steered gather -> gate/up + SwiGLU, then
// down projection -> weighted scatter-combine.  Two launches; no (E, C, d)
// tensor is ever written to device memory.
//
// Replaces: src/repro/kernels/moe_fused/kernel.py,
//   fused_gather_swiglu_pallas (kernel _gather_swiglu_kernel) and
//   fused_down_combine_pallas (kernel _down_combine_kernel).
//
// What they compute, with flat_idx (E*C,) naming the token of each expert
// slot (T = empty slot) and slot_w (E*C,) its combine weight:
//   gather_swiglu: h[e, c] = silu(x[idx] @ Wg[e]) * (x[idx] @ Wu[e]),
//                  x[T] read as a zero row; h (E, C, f) in x's type.
//   down_combine:  y[idx] += slot_w * (h[e, c] @ Wd[e]); y (T, d) f32.
//
// What bounds them on the card: at an admission prefill (128 tokens, 128
// experts, top-8: C = 16 slots per expert) each expert's weights are used by
// at most C rows, ~16 FLOPs per weight byte, so the weight bytes of the
// experts the plan occupies bound both launches; FLOPs would bound only at
// C in the hundreds.
//
// What the design does about it:
//  * One block per (expert, 16-slot block, 64-column tile).  The block loads
//    its slots' token indices itself and gathers those x rows tile by tile
//    straight into shared memory (the gather is the GEMM prologue).
//  * Weight tiles are read coalesced, once per slot block; a block whose
//    slots are all empty writes zeros (gather_swiglu) or nothing
//    (down_combine) and reads no weights, so an expert the plan leaves idle
//    costs no bytes.
//  * down_combine's epilogue adds w * y rows into the token-major f32
//    output with atomicAdd.  The TPU kernel's serial scatter has no parallel
//    counterpart, and a deterministic second pass would need the (E, C, d)
//    expert outputs in device memory, the very tensor this plane removes.
//    Each output element receives at most top_k adds, so the reordering
//    costs a few f32 ulps (tolerance 1e-4 relative in the tests).  Empty
//    slots (idx == T, weight 0) skip the epilogue, so no dump row is needed.
// The tile products run on CUDA cores in f32 (simple and right first;
// wgmma/TMA come in a later PR).
#include "common.cuh"

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
    float* __restrict__ out,            // (T, d), zero-initialised
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
  if (!any_s) return;  // no occupied slot: nothing to add anywhere
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
      if (tok < Tn) atomicAdd(&out[(long)tok * d + col], slot_w[e * C + c] * y[r]);
    }
  }
}

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

extern "C" int repro_down_combine(int dtype, const void* h, const void* wd, const void* flat_idx,
                                  const void* slot_w, void* out, int Tn, int E, int C, int d, int f, void* stream) {
  dim3 grid((d + BN - 1) / BN, (C + BM - 1) / BM, E);
  REPRO_DISPATCH(dtype, Tp, {
    down_combine_kernel<Tp><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const Tp*)h, (const Tp*)wd, (const int*)flat_idx, (const float*)slot_w, (float*)out, Tn, C, d, f);
  });
  return (int)cudaGetLastError();
}

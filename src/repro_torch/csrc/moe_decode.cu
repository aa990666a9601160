// Plan-steered expert SwiGLU for tiny T (the Agile decode plane).
//
// Replaces: src/repro/kernels/moe_decode/kernel.py, decode_moe_pallas
// (kernel _decode_moe_kernel), its full-precision and int8 branches.
//
// What it computes: for each assignment (t, j), expert e = ids[t*k + j]
// selects w_gate[e], w_up[e] (d, f) and w_down[e] (f, d);
//   y[t] = sum_j w[t*k + j] * (silu(x[t] @ w_gate[e]) * (x[t] @ w_up[e])) @ w_down[e]
// accumulated in f32, out (T, d) f32.  No capacity, no slot tensors.
//
// What bounds it on the card: bytes — the weights of the distinct experts
// the plan names (3 * d * f elements each); every weight element is used
// for 2 FLOPs per assignment that names its expert, ~1 FLOP/byte at decode.
//
// What the design does about it: the plan's expert ids steer which weight
// rows are read, and nothing else of the (E, d, f) stacks moves.  The TPU
// kernel carried its (T, d) accumulator across a sequential grid; blocks on
// the GPU run in parallel, so the work is split in two launches with no
// atomics (deterministic):
//   1. per (assignment, f tile): h = silu(x @ Wg[e]) * (x @ Wu[e]) into a
//      small (T*k, f) f32 scratch;
//   2. per (token, d tile): a loop over the token's k assignments,
//      y = sum_j w_j * h_j @ Wd[e_j].
// Both launches read weight rows coalesced (neighbouring threads take
// neighbouring output columns) and split the contraction over four thread
// slices reduced through shared memory.
//
// The int8 branch (stacks int8, per-expert (E,) f32 scales sg, su, sd for
// gate, up and down; x f32 or bf16) is the same template with the weight
// type apart from x's: each weight element becomes __fmul_rn(float(w),
// s[e]) as it is loaded, before it meets x (the TPU kernel's
// dequantize-before-dot), so the launch is bitwise the f32 launch on the
// dequantized stacks and f32 x.  The plan's experts move 1 byte a weight
// instead of 2: at 83 distinct experts of d 4096, f 1536 that is ~1.57 GB
// against ~3.13 GB.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int COLS = 64;    // output columns per block
constexpr int SLICES = 4;   // contraction slices per block
constexpr int THREADS = COLS * SLICES;

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS) gate_up_kernel(
    const TX* __restrict__ x,         // (T, d)
    const int* __restrict__ ids,      // (T*k,)
    const TW* __restrict__ wg,        // (E, d, f)
    const TW* __restrict__ wu,        // (E, d, f)
    const float* __restrict__ sg,     // int8: (E,) gate scales; otherwise unused
    const float* __restrict__ su,     // int8: (E,) up scales; otherwise unused
    float* __restrict__ h,            // (T*k, f)
    int k, int d, int f) {
  extern __shared__ float smem[];
  float* xs = smem;                       // d
  float* red = xs + d;                    // 2 * SLICES * COLS
  const int a = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int tid = threadIdx.x, cx = tid % COLS, sl = tid / COLS;
  const int t = a / k;
  const long e = ids[a];
  const bool q8 = std::is_same<TW, int8_t>::value;
  const float sge = q8 ? sg[e] : 1.f, sue = q8 ? su[e] : 1.f;
  for (int i = tid; i < d; i += THREADS) xs[i] = to_f32(x[(long)t * d + i]);
  __syncthreads();
  const int c = c0 + cx;
  float g = 0.f, u = 0.f;
  if (c < f) {
    const TW* pg = wg + e * d * f + c;
    const TW* pu = wu + e * d * f + c;
#pragma unroll 4
    for (int dd = sl; dd < d; dd += SLICES) {
      const float xv = xs[dd];
      g += xv * load_scaled(pg[(long)dd * f], sge);
      u += xv * load_scaled(pu[(long)dd * f], sue);
    }
  }
  red[sl * COLS + cx] = g;
  red[(SLICES + sl) * COLS + cx] = u;
  __syncthreads();
  if (sl == 0 && c < f) {
    float gs = 0.f, us = 0.f;
    for (int s = 0; s < SLICES; ++s) {
      gs += red[s * COLS + cx];
      us += red[(SLICES + s) * COLS + cx];
    }
    h[(long)a * f + c] = silu_f32(gs) * us;
  }
}

template <typename TW>
__global__ void __launch_bounds__(THREADS) down_kernel(
    const float* __restrict__ h,      // (T*k, f)
    const int* __restrict__ ids,      // (T*k,)
    const float* __restrict__ w,      // (T*k,)
    const TW* __restrict__ wd,        // (E, f, d)
    const float* __restrict__ sd,     // int8: (E,) down scales; otherwise unused
    float* __restrict__ out,          // (T, d)
    int k, int d, int f) {
  extern __shared__ float smem[];
  float* hs = smem;                 // f
  float* red = hs + f;              // SLICES * COLS
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int tid = threadIdx.x, cx = tid % COLS, sl = tid / COLS;
  const int c = c0 + cx;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const int a = t * k + j;
    __syncthreads();  // the previous assignment's h row is no longer read
    for (int i = tid; i < f; i += THREADS) hs[i] = h[(long)a * f + i];
    __syncthreads();
    if (c < d) {
      const long e = ids[a];
      const TW* pd = wd + e * f * d + c;
      const float sde = std::is_same<TW, int8_t>::value ? sd[e] : 1.f;
      float y = 0.f;
#pragma unroll 4
      for (int ff = sl; ff < f; ff += SLICES) y += hs[ff] * load_scaled(pd[(long)ff * d], sde);
      acc += w[a] * y;
    }
  }
  red[sl * COLS + cx] = acc;
  __syncthreads();
  if (sl == 0 && c < d) {
    float s = 0.f;
    for (int i = 0; i < SLICES; ++i) s += red[i * COLS + cx];
    out[(long)t * d + c] = s;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// x_dtype / w_dtype: 0 f32, 1 bf16 (the same for both), or w_dtype 2 (int8
// stacks, then sg, su, sd (E,) f32 each; otherwise they may be null).
extern "C" int repro_decode_moe(int x_dtype, int w_dtype, const void* x, const void* ids, const void* w,
                                const void* wg, const void* wu, const void* wd, const void* sg, const void* su,
                                const void* sd, void* h_scratch, void* out, int T, int k, int d, int f,
                                void* stream) {
  if (w_dtype == 2 && (sg == nullptr || su == nullptr || sd == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem1 = sizeof(float) * ((size_t)d + 2 * SLICES * COLS);
  const size_t smem2 = sizeof(float) * ((size_t)f + SLICES * COLS);
  dim3 grid1(T * k, (f + COLS - 1) / COLS);
  dim3 grid2(T, (d + COLS - 1) / COLS);
  REPRO_DISPATCH_PAIR(x_dtype, w_dtype, TX, TW, {
    cudaError_t e = allow_smem(gate_up_kernel<TX, TW>, smem1);
    if (e != cudaSuccess) return (int)e;
    e = allow_smem(down_kernel<TW>, smem2);
    if (e != cudaSuccess) return (int)e;
    gate_up_kernel<TX, TW><<<grid1, THREADS, smem1, (cudaStream_t)stream>>>(
        (const TX*)x, (const int*)ids, (const TW*)wg, (const TW*)wu, (const float*)sg, (const float*)su,
        (float*)h_scratch, k, d, f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    down_kernel<TW><<<grid2, THREADS, smem2, (cudaStream_t)stream>>>(
        (const float*)h_scratch, (const int*)ids, (const float*)w, (const TW*)wd, (const float*)sd,
        (float*)out, k, d, f);
  });
  return (int)cudaGetLastError();
}

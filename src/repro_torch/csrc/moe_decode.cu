// Plan-steered expert SwiGLU for tiny T (the Agile decode plane).
//
// Replaces: src/repro/kernels/moe_decode/kernel.py, decode_moe_pallas
// (kernel _decode_moe_kernel; the int8 branch waits for a later slice).
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
#include "common.cuh"

namespace {

constexpr int COLS = 64;    // output columns per block
constexpr int SLICES = 4;   // contraction slices per block
constexpr int THREADS = COLS * SLICES;

template <typename T>
__global__ void __launch_bounds__(THREADS) gate_up_kernel(
    const T* __restrict__ x,      // (T, d)
    const int* __restrict__ ids,  // (T*k,)
    const T* __restrict__ wg,     // (E, d, f)
    const T* __restrict__ wu,     // (E, d, f)
    float* __restrict__ h,        // (T*k, f)
    int k, int d, int f) {
  extern __shared__ float smem[];
  float* xs = smem;                       // d
  float* red = xs + d;                    // 2 * SLICES * COLS
  const int a = blockIdx.x;
  const int c0 = blockIdx.y * COLS;
  const int tid = threadIdx.x, cx = tid % COLS, sl = tid / COLS;
  const int t = a / k;
  const long e = ids[a];
  for (int i = tid; i < d; i += THREADS) xs[i] = to_f32(x[(long)t * d + i]);
  __syncthreads();
  const int c = c0 + cx;
  float g = 0.f, u = 0.f;
  if (c < f) {
    const T* pg = wg + e * d * f + c;
    const T* pu = wu + e * d * f + c;
#pragma unroll 4
    for (int dd = sl; dd < d; dd += SLICES) {
      const float xv = xs[dd];
      g += xv * to_f32(pg[(long)dd * f]);
      u += xv * to_f32(pu[(long)dd * f]);
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

template <typename T>
__global__ void __launch_bounds__(THREADS) down_kernel(
    const float* __restrict__ h,    // (T*k, f)
    const int* __restrict__ ids,    // (T*k,)
    const float* __restrict__ w,    // (T*k,)
    const T* __restrict__ wd,       // (E, f, d)
    float* __restrict__ out,        // (T, d)
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
      const T* pd = wd + (long)ids[a] * f * d + c;
      float y = 0.f;
#pragma unroll 4
      for (int ff = sl; ff < f; ff += SLICES) y += hs[ff] * to_f32(pd[(long)ff * d]);
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

extern "C" int repro_decode_moe(int dtype, const void* x, const void* ids, const void* w, const void* wg,
                                const void* wu, const void* wd, void* h_scratch, void* out, int T, int k, int d,
                                int f, void* stream) {
  const size_t smem1 = sizeof(float) * ((size_t)d + 2 * SLICES * COLS);
  const size_t smem2 = sizeof(float) * ((size_t)f + SLICES * COLS);
  dim3 grid1(T * k, (f + COLS - 1) / COLS);
  dim3 grid2(T, (d + COLS - 1) / COLS);
  REPRO_DISPATCH(dtype, Tp, {
    cudaError_t e = allow_smem(gate_up_kernel<Tp>, smem1);
    if (e != cudaSuccess) return (int)e;
    e = allow_smem(down_kernel<Tp>, smem2);
    if (e != cudaSuccess) return (int)e;
    gate_up_kernel<Tp><<<grid1, THREADS, smem1, (cudaStream_t)stream>>>(
        (const Tp*)x, (const int*)ids, (const Tp*)wg, (const Tp*)wu, (float*)h_scratch, k, d, f);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    down_kernel<Tp><<<grid2, THREADS, smem2, (cudaStream_t)stream>>>(
        (const float*)h_scratch, (const int*)ids, (const float*)w, (const Tp*)wd, (float*)out, k, d, f);
  });
  return (int)cudaGetLastError();
}

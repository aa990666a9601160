// Plan-steered token dispatch into expert slots and weighted combine back to
// tokens: the two data-movement steps around the expert-parallel a2a body's
// all_to_alls (src/repro_torch/parallel/moe_parallel.py).
//
// Replaces: src/repro/kernels/moe_dispatch/kernel.py,
//   dispatch_pallas (kernel _dispatch_kernel) and
//   combine_pallas (kernel _combine_kernel).
//
// What they compute, with the DispatchPlan's flat control words:
//   dispatch: slots[s] = x[flat_idx[s]] for every flat slot s = e*C + c;
//             flat_idx == T (an empty slot) reads as a zero row, as does any
//             index outside [0, T).  Every slot row is written.
//   combine:  y[t] = sum_{j < k} w[t*k + j] * slots[cidx[t*k + j]],
//             accumulated in f32 in the fixed order j = 0..k-1 and rounded
//             once to the output type; cidx == E*C (a dropped assignment)
//             adds nothing.
//
// What bounds them on the card: they are row copies and a k-term weighted
// sum per element, a handful of operations per byte, so the bytes bound
// both: at one 128-token admission (E 128, C 16, d 4096, top-8, bf16)
// dispatch writes 16.8 MB of slots and reads at most the 1 MB of tokens,
// combine reads at most 8.4 MB of slot rows and writes the (T, d) output.
//
// What the design does about it:
//  * One block of 128 threads per (destination row, 128-unit column range):
//    a thread moves one unit, a 16-byte vector when the row width allows it
//    (a scalar otherwise), neighbouring threads on neighbouring addresses,
//    so thousands of blocks keep the memory system busy whatever the row
//    count.  The TPU kernels' one-row-per-grid-step DMA becomes a row range
//    per block, many in flight on every SM.
//  * dispatch writes zeros for an empty slot without touching x, so the
//    wrapper builds no padded copy of x (the TPU wrapper appends a zero row).
//  * combine stages the token's k control words in shared memory, issues
//    the loads of up to 8 source rows before it accumulates them (in the
//    order j = 0..k-1), and never uses atomics: every output element is
//    written once, with the same sums in the same order on every run (the
//    TPU kernel's serial accumulation over its j grid axis becomes the loop
//    inside the thread).
//
// combine's backward (10_bwd), for the a2a body's gradient (the TPU kernel
// has no VJP; the reference trains through jax's transpose of its jnp
// combine), with dy (T, d) the gradient of combine's output:
//   dslots[cidx[t, j]] = w[t, j] dy[t] for every kept assignment, zero rows
//   in the slots no word points to (flat_idx[s] outside [0, T)), in the
//   slots' type; dw[t, j] = <dy[t], slots[cidx[t, j]]> in f32 (0 for a
//   dropped assignment), which reaches the router through the plan's weights.
//   One launch, two kinds of block: one a token (its dy row read once, its k
//   slot rows written and dotted, the k dots summed across the block by a
//   fixed tree) and one a slot (a zero row for an empty slot, nothing
//   otherwise).  Every output is written by one owner: a kept slot by its
//   one (t, j), an empty one by its slot block; no atomics, a repeated
//   launch is bitwise equal.
// dispatch's backward is combine itself with unit weights (every kept slot
// belongs to one (t, j), a dropped assignment adds nothing): dx[t] = the
// sum of its slot rows in ascending j, no kernel of its own.
// What bounds 10_bwd: bytes.  At the a2a body's training shapes (T 4,096,
// top-8 of E 128, C 320, d 4,096, bf16) it reads dy (34 MB) and the slots
// (336 MB) and writes dslots (336 MB): ~0.71 GB, 0.21 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int KMAX = 32;   // top_k the combine kernel takes
constexpr int JBATCH = 8;  // source rows whose loads combine issues together

// a unit: 16 bytes of T when the rows allow vectors, one T otherwise
template <typename T, bool VEC>
struct Unit {
  using type = T;
  static constexpr int N = 1;
};
template <typename T>
struct Unit<T, true> {
  using type = uint4;
  static constexpr int N = 16 / sizeof(T);
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) dispatch_kernel(
    const T* __restrict__ x,           // (T, d)
    const int* __restrict__ flat_idx,  // (n_slots,)
    T* __restrict__ slots,             // (n_slots, d)
    int Tn, int units) {               // units a row: d / N
  using U = typename Unit<T, VEC>::type;
  const int u = blockIdx.y * THREADS + threadIdx.x;
  if (u >= units) return;
  const long s = blockIdx.x;
  const int tok = flat_idx[s];
  U v;
  if (tok >= 0 && tok < Tn) {
    v = reinterpret_cast<const U*>(x)[(long)tok * units + u];
  } else {
    memset(&v, 0, sizeof(U));  // an empty slot: the zero row
  }
  reinterpret_cast<U*>(slots)[s * units + u] = v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) combine_kernel(
    const T* __restrict__ y,            // (n_slots, d)
    const int* __restrict__ cidx,       // (T*k,) flat slot per assignment
    const float* __restrict__ w,        // (T*k,)
    T* __restrict__ out,                // (T, d)
    int n_slots, int k, int units) {
  using U = typename Unit<T, VEC>::type;
  constexpr int N = Unit<T, VEC>::N;
  __shared__ int c_s[KMAX];
  __shared__ float w_s[KMAX];
  const long t = blockIdx.x;
  if (threadIdx.x < k) {
    const int c = cidx[t * k + threadIdx.x];
    c_s[threadIdx.x] = (c >= 0 && c < n_slots) ? c : -1;  // a dropped assignment adds nothing
    w_s[threadIdx.x] = w[t * k + threadIdx.x];
  }
  __syncthreads();
  const int u = blockIdx.y * THREADS + threadIdx.x;
  if (u >= units) return;
  const U* rows = reinterpret_cast<const U*>(y);
  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < k; j0 += JBATCH) {
    U r[JBATCH];
#pragma unroll
    for (int jj = 0; jj < JBATCH; ++jj) {
      const int j = j0 + jj;
      const int c = j < k ? c_s[j] : -1;
      if (c >= 0) r[jj] = rows[(long)c * units + u];
    }
#pragma unroll
    for (int jj = 0; jj < JBATCH; ++jj) {
      const int j = j0 + jj;
      if (j >= k || c_s[j] < 0) continue;
      const float wj = w_s[j];
      const T* e = reinterpret_cast<const T*>(&r[jj]);
#pragma unroll
      for (int q = 0; q < N; ++q) acc[q] += wj * to_f32(e[q]);
    }
  }
  U o;
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int q = 0; q < N; ++q) oe[q] = from_f32<T>(acc[q]);
  reinterpret_cast<U*>(out)[t * units + u] = o;
}

// 10_bwd.  Blocks [0, T): token t; blocks [T, T + n_slots): slot s = b - T.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) combine_bwd_kernel(
    const T* __restrict__ dy,           // (T, d)
    const T* __restrict__ y,            // (n_slots, d)
    const int* __restrict__ cidx,       // (T*k,)
    const float* __restrict__ w,        // (T*k,)
    const int* __restrict__ flat_idx,   // (n_slots,) token of each slot
    T* __restrict__ dslots,             // (n_slots, d)
    float* __restrict__ dw,             // (T*k,)
    int Tn, int n_slots, int k, int units) {
  using U = typename Unit<T, VEC>::type;
  constexpr int N = Unit<T, VEC>::N;
  __shared__ int c_s[KMAX];
  __shared__ float w_s[KMAX];
  __shared__ float red[THREADS / 32][JBATCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x >= Tn) {  // a slot block: a zero row for a slot no word points to
    const long s = blockIdx.x - Tn;
    const int tok = flat_idx[s];
    if (tok >= 0 && tok < Tn) return;
    U z;
    memset(&z, 0, sizeof(U));
    for (int u = tid; u < units; u += THREADS) reinterpret_cast<U*>(dslots)[s * units + u] = z;
    return;
  }
  const long t = blockIdx.x;
  if (tid < k) {
    const int c = cidx[t * k + tid];
    c_s[tid] = (c >= 0 && c < n_slots) ? c : -1;
    w_s[tid] = w[t * k + tid];
  }
  __syncthreads();
  const U* rows = reinterpret_cast<const U*>(y);
  const U* dyr = reinterpret_cast<const U*>(dy) + t * units;
  U* out = reinterpret_cast<U*>(dslots);
  for (int j0 = 0; j0 < k; j0 += JBATCH) {
    float acc[JBATCH];
#pragma unroll
    for (int jj = 0; jj < JBATCH; ++jj) acc[jj] = 0.f;
    for (int u = tid; u < units; u += THREADS) {
      const U gv = dyr[u];
      const T* ge = reinterpret_cast<const T*>(&gv);
      float g[N];
#pragma unroll
      for (int q = 0; q < N; ++q) g[q] = to_f32(ge[q]);
#pragma unroll
      for (int jj = 0; jj < JBATCH; ++jj) {
        const int j = j0 + jj;
        const int c = j < k ? c_s[j] : -1;
        if (c < 0) continue;
        const U r = rows[(long)c * units + u];
        const T* re = reinterpret_cast<const T*>(&r);
        const float wj = w_s[j];
        U o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int q = 0; q < N; ++q) {
          acc[jj] = fmaf(g[q], to_f32(re[q]), acc[jj]);
          oe[q] = from_f32<T>(wj * g[q]);
        }
        out[(long)c * units + u] = o;
      }
    }
    // each dot across the block: the warp's by a fixed butterfly, then the warps in order
#pragma unroll
    for (int jj = 0; jj < JBATCH; ++jj) {
      float v = acc[jj];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][jj] = v;
    }
    __syncthreads();
    if (tid < JBATCH && j0 + tid < k) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < THREADS / 32; ++q) v += red[q][tid];
      dw[t * k + j0 + tid] = c_s[j0 + tid] >= 0 ? v : 0.f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_moe_dispatch(int dtype, const void* x, const void* flat_idx, void* slots, int Tn,
                                  int n_slots, int d, int vec, void* stream) {
  if (n_slots <= 0 || d <= 0) return 0;
  REPRO_DISPATCH(dtype, Tp, {
    const int units = vec ? d / Unit<Tp, true>::N : d;
    dim3 grid(n_slots, (units + THREADS - 1) / THREADS);
    if (vec) {
      dispatch_kernel<Tp, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const Tp*)x, (const int*)flat_idx, (Tp*)slots, Tn, units);
    } else {
      dispatch_kernel<Tp, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const Tp*)x, (const int*)flat_idx, (Tp*)slots, Tn, units);
    }
  });
  return (int)cudaGetLastError();
}

extern "C" int repro_moe_combine(int dtype, const void* y, const void* cidx, const void* w, void* out, int Tn,
                                 int n_slots, int k, int d, int vec, void* stream) {
  if (Tn <= 0 || d <= 0) return 0;
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, Tp, {
    const int units = vec ? d / Unit<Tp, true>::N : d;
    dim3 grid(Tn, (units + THREADS - 1) / THREADS);
    if (vec) {
      combine_kernel<Tp, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const Tp*)y, (const int*)cidx, (const float*)w, (Tp*)out, n_slots, k, units);
    } else {
      combine_kernel<Tp, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const Tp*)y, (const int*)cidx, (const float*)w, (Tp*)out, n_slots, k, units);
    }
  });
  return (int)cudaGetLastError();
}

// 10_bwd: dy (T, d) and y (n_slots, d) in the dtype code's type, cidx and w
// (T*k,), flat_idx (n_slots,); outputs dslots (n_slots, d) in that type and
// dw (T*k,) f32.  One launch.
extern "C" int repro_moe_combine_bwd(int dtype, const void* dy, const void* y, const void* cidx, const void* w,
                                     const void* flat_idx, void* dslots, void* dw, int Tn, int n_slots, int k, int d,
                                     int vec, void* stream) {
  if (d <= 0 || Tn + (long)n_slots <= 0) return 0;
  if (k < 1 || k > KMAX || Tn < 0 || n_slots < 0 || Tn + (long)n_slots > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, Tp, {
    const int units = vec ? d / Unit<Tp, true>::N : d;
    const unsigned grid = (unsigned)(Tn + n_slots);
    if (vec) {
      combine_bwd_kernel<Tp, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const Tp*)dy, (const Tp*)y, (const int*)cidx, (const float*)w, (const int*)flat_idx, (Tp*)dslots,
          (float*)dw, Tn, n_slots, k, units);
    } else {
      combine_bwd_kernel<Tp, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const Tp*)dy, (const Tp*)y, (const int*)cidx, (const float*)w, (const int*)flat_idx, (Tp*)dslots,
          (float*)dw, Tn, n_slots, k, units);
    }
  });
  return (int)cudaGetLastError();
}

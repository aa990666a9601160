// Backward of the prefill MoE data plane (kernels 3 and 4, csrc/moe_fused.cu)
// for training: hand-written, CUDA cores, f32 accumulation, every sum in a
// fixed order and no atomics, so a repeated launch is bitwise equal.
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
// Every product is one tiled SIMT GEMM (tile_products): 64 x 64 outputs a
// block of 256 threads, 4 x 4 a thread, K in steps of 16 through shared
// memory, operands widened to f32 as they are staged.  Each output element
// sums its K products in ascending K, whatever the grid's shape or timing.
// A slot tile (or a K step of slots) whose slots are all empty is skipped.
#include "common.cuh"

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

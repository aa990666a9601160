// Chunked SSD scan of Mamba-2 (state-space duality, arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_scan_pallas (kernel
// _ssd_kernel).  Per head h with an (N, P) f32 state, over chunks of q steps
// whose inclusive cumsum of dt * a is `cum` (computed by the wrapper):
//
//   S = (C B^T) o causal(exp(cum_i - cum_j)) o dt_j            (q x q)
//   y = S @ x + (C o exp(cum)) @ h                              (q x P)
//   h = exp(cum_last) h + (B o exp(cum_last - cum) dt)^T @ x    (N x P)
//
// Inputs: x (B, T, H, P) read through its batch and time strides (head
// stride P, unit inner stride), dt and cum (B, T, H) f32, B and C (B, T, N)
// through their strides, h0 (B, H, N, P) f32 or null.  x, B and C are f32 or
// bf16 and are widened to f32 as they are staged.  Outputs: y (B, T, H, P)
// f32 and the final state (B, H, N, P) f32, as the TPU kernel returns them.
//
// What bounds it on the card: operations.  Per chunk and head the three
// products cost 2 q^2 P (causal half of it needed) + 4 q N P flops against
// q (P + 2 N) input values, hundreds of flops per byte, in f32 on the CUDA
// cores (67 TFLOP/s).
//
// What the design does about it:
//  * One block per (b, h) walks the chunks in order and keeps the state in
//    shared memory: the TPU kernel's VMEM scratch carried across the
//    sequential chunk axis of its grid becomes a loop inside the block (no
//    two blocks of the grid share state).
//  * q <= 64 so that the C, B, x and S tiles and the state fit one SM's
//    shared memory (135 KB at N 128, P 64; the launch opts in above 48 KB).
//    The function is the same as at the model's chunk of 256, summed in
//    another order.
//  * 512 threads (16 warps, one block an SM) each own a 2 x 4 tile of S, 2
//    rows x 4 columns of y or 4 state rows x 4 columns, reading float4 rows
//    of the tiles: tile rows are padded to N + 4 floats so neighbouring
//    threads' float4 reads fall on distinct banks, and rows shared by a
//    quarter-warp are broadcast.  Each float read from shared memory feeds
//    only 2-4 FMAs, so shared-memory bandwidth, not the f32 rate, is what
//    this simple design runs into.
//  * The causal mask is applied before the exponential: above the diagonal
//    cum_i - cum_j is positive (|a| reaches 16) and exp of it would be inf;
//    it is never evaluated.  Rows of a ragged tail are staged as zeros with
//    dt = 0, so they add nothing to the state, and their y is not written.
//  * C B^T does not depend on the head (one B/C group); each block computes
//    it again, as the TPU kernel does.
// At B = 1 Mamba-2-2.7B gives 80 blocks for 132 SMs; splitting the chunks
// over blocks (chunk states in parallel, then a short pass over them) and
// tensor-core products are later steps.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int RSTEP = THREADS / 16;  // rows a pass of the 16-wide thread grid covers
constexpr int QMAX = 64;             // rows of a chunk tile
constexpr int NMAX = 128;            // state size
constexpr int PMAX = 64;             // head dim
constexpr int SS = QMAX + 4;
constexpr int RQ = QMAX / RSTEP, RN = NMAX / RSTEP;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__host__ __device__ inline size_t smem_floats(int N, int P) {
  return (size_t)2 * QMAX * (N + 4) + (size_t)QMAX * P + (size_t)QMAX * SS + (size_t)N * P + 4 * QMAX;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(
    const T* __restrict__ x, long long x_sb, long long x_st, const float* __restrict__ dt,
    const float* __restrict__ cum, const T* __restrict__ bm, long long b_sb, long long b_st,
    const T* __restrict__ cm, long long c_sb, long long c_st, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, int Tn, int H, int N, int P, int q) {
  extern __shared__ __align__(16) float smem[];
  const int ns = N + 4;
  float* sC = smem;                 // [QMAX][ns]
  float* sB = sC + QMAX * ns;       // [QMAX][ns]
  float* sX = sB + QMAX * ns;       // [QMAX][P]
  float* sS = sX + QMAX * P;        // [QMAX][SS]
  float* sH = sS + QMAX * SS;       // [N][P]
  float* sCum = sH + N * P;         // [QMAX]
  float* sDt = sCum + QMAX;         // [QMAX], 0 past the valid rows
  float* sE = sDt + QMAX;           // exp(cum_i)
  float* sW = sE + QMAX;            // exp(cum_last - cum_j) * dt_j

  const int b = blockIdx.x / H, hh = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int lo = tid & 15, hi = tid >> 4;  // a 16-wide grid of threads, RSTEP rows tall
  const bool pcol = 4 * lo < P;            // this thread's 4 columns of y / the state exist
  const long long hbase = ((long long)b * H + hh) * N * P;
  const T* xb = x + b * x_sb + (long long)hh * P;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;

  for (int e = tid; e < N * P; e += THREADS) sH[e] = h0 ? h0[hbase + e] : 0.f;

  for (int t0 = 0; t0 < Tn; t0 += q) {
    const int nv = min(q, Tn - t0);  // valid rows of this chunk
    __syncthreads();                 // the previous chunk is done with the tiles
    // unrolled so that each thread has several loads in flight before its stores
#pragma unroll 8
    for (int e = tid; e < QMAX * N; e += THREADS) {
      const int i = e / N, n = e - i * N;
      float cv = 0.f, bv = 0.f;
      if (i < nv) {
        cv = to_f32(cb[(long long)(t0 + i) * c_st + n]);
        bv = to_f32(bb[(long long)(t0 + i) * b_st + n]);
      }
      sC[i * ns + n] = cv;
      sB[i * ns + n] = bv;
    }
#pragma unroll 8
    for (int e = tid; e < QMAX * P; e += THREADS) {
      const int i = e / P, p = e - i * P;
      sX[e] = i < nv ? to_f32(xb[(long long)(t0 + i) * x_st + p]) : 0.f;
    }
    if (tid < QMAX) {
      const long long row = ((long long)b * Tn + t0) * H + hh;
      const int i = tid, iv = min(i, nv - 1);  // rows past nv repeat the last cum: every exponent stays <= 0
      const float last = cum[row + (long long)(nv - 1) * H];
      const float c = cum[row + (long long)iv * H];
      const float d = i < nv ? dt[row + (long long)i * H] : 0.f;
      sCum[i] = c;
      sDt[i] = d;
      sE[i] = expf(c);
      sW[i] = expf(last - c) * d;
    }
    __syncthreads();

    // S: thread (hi, lo) owns rows hi + RSTEP r and columns lo + 16 c
    {
      float acc[RQ][4];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[RQ], bv[4];
#pragma unroll
        for (int r = 0; r < RQ; ++r) cv[r] = ld4(sC + (hi + RSTEP * r) * ns + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = ld4(sB + (lo + 16 * c) * ns + n);
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] += cv[r].x * bv[c].x + cv[r].y * bv[c].y + cv[r].z * bv[c].z + cv[r].w * bv[c].w;
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = hi + RSTEP * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = lo + 16 * c;
          float s = 0.f;
          if (j <= i && i < nv) s = acc[r][c] * expf(sCum[i] - sCum[j]) * sDt[j];  // masked before exp
          sS[i * SS + j] = s;
        }
      }
    }
    __syncthreads();

    // y: thread (hi, lo) owns rows hi + RSTEP r, columns 4 lo .. 4 lo + 3
    if (pcol) {
      float4 ai[RQ], ae[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) ai[r] = ae[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int jend = (nv + 3) & ~3;  // S is zero in columns >= nv
#pragma unroll 4
      for (int j = 0; j < jend; j += 4) {
        float4 s[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) s[r] = ld4(sS + (hi + RSTEP * r) * SS + j);
        const float4 x0 = ld4(sX + (j + 0) * P + 4 * lo), x1 = ld4(sX + (j + 1) * P + 4 * lo);
        const float4 x2 = ld4(sX + (j + 2) * P + 4 * lo), x3 = ld4(sX + (j + 3) * P + 4 * lo);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          fma4(ai[r], s[r].x, x0);
          fma4(ai[r], s[r].y, x1);
          fma4(ai[r], s[r].z, x2);
          fma4(ai[r], s[r].w, x3);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 c[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) c[r] = ld4(sC + (hi + RSTEP * r) * ns + n);
        const float4 h0v = ld4(sH + (n + 0) * P + 4 * lo), h1v = ld4(sH + (n + 1) * P + 4 * lo);
        const float4 h2v = ld4(sH + (n + 2) * P + 4 * lo), h3v = ld4(sH + (n + 3) * P + 4 * lo);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          fma4(ae[r], c[r].x, h0v);
          fma4(ae[r], c[r].y, h1v);
          fma4(ae[r], c[r].z, h2v);
          fma4(ae[r], c[r].w, h3v);
        }
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = hi + RSTEP * r;
        if (i < nv) {
          const float e = sE[i];
          float4 o;
          o.x = ai[r].x + e * ae[r].x;
          o.y = ai[r].y + e * ae[r].y;
          o.z = ai[r].z + e * ae[r].z;
          o.w = ai[r].w + e * ae[r].w;
          *reinterpret_cast<float4*>(y + (((long long)b * Tn + t0 + i) * H + hh) * P + 4 * lo) = o;
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // state: thread (hi, lo) owns rows hi + RSTEP r, columns 4 lo .. 4 lo + 3
    if (pcol) {
      const float decay = expf(sCum[nv - 1]);
      float4 acc[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int n = hi + RSTEP * r;
        acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < N) {
          const float4 hv = ld4(sH + n * P + 4 * lo);
          acc[r] = make_float4(decay * hv.x, decay * hv.y, decay * hv.z, decay * hv.w);
        }
      }
#pragma unroll 4
      for (int j = 0; j < nv; ++j) {
        const float w = sW[j];
        float4 xv = ld4(sX + j * P + 4 * lo);
        xv = make_float4(w * xv.x, w * xv.y, w * xv.z, w * xv.w);
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const int n = hi + RSTEP * r;
          if (n < N) fma4(acc[r], sB[j * ns + n], xv);
        }
      }
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int n = hi + RSTEP * r;
        if (n < N) *reinterpret_cast<float4*>(sH + n * P + 4 * lo) = acc[r];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * P; e += THREADS) h_out[hbase + e] = sH[e];
}

template <typename T>
int launch(const void* x, long long x_sb, long long x_st, const void* dt, const void* cum, const void* bm,
           long long b_sb, long long b_st, const void* cm, long long c_sb, long long c_st, const void* h0,
           void* y, void* h_out, int B, int Tn, int H, int N, int P, int q, void* stream) {
  const size_t smem = smem_floats(N, P) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_scan_kernel<T><<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, x_sb, x_st, (const float*)dt, (const float*)cum, (const T*)bm, b_sb, b_st, (const T*)cm, c_sb,
      c_st, (const float*)h0, (float*)y, (float*)h_out, Tn, H, N, P, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ssd_scan(int dtype, const void* x, long long x_sb, long long x_st, const void* dt,
                              const void* cum, const void* bm, long long b_sb, long long b_st, const void* cm,
                              long long c_sb, long long c_st, const void* h0, void* y, void* h_out, int B, int Tn,
                              int H, int N, int P, int q, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || q <= 0 || q > QMAX || N <= 0 || N > NMAX || N % 4 || P <= 0 || P > PMAX ||
      P % 4)
    return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, T, {
    return launch<T>(x, x_sb, x_st, dt, cum, bm, b_sb, b_st, cm, c_sb, c_st, h0, y, h_out, B, Tn, H, N, P, q,
                     stream);
  });
  return (int)cudaErrorInvalidValue;
}

// Chunked SSD scan of Mamba-2 (state-space duality, arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_scan_pallas (kernel
// _ssd_kernel).  Per head h with an (N, P) f32 state, over chunks of q steps
// whose inclusive cumsum of dt * a is `cum`:
//
//   S = (C B^T) o causal(exp(cum_i - cum_j)) o dt_j            (q x q)
//   y = S @ x + (C o exp(cum)) @ h                              (q x P)
//   h = exp(cum_last) h + (B o exp(cum_last - cum) dt)^T @ x    (N x P)
//
// Inputs: x (B, T, H, P) read through its batch and time strides (head
// stride P, unit inner stride), dt (B, T, H) f32, B and C (B, T, N) through
// their strides, h0 (B, H, N, P) f32 or null.  Outputs: y (B, T, H, P) f32
// and the final state (B, H, N, P) f32, as the TPU kernel returns them.
//
// Two builds, chosen by the wrapper from dtype, shape and alignment alone
// (ops.ssd_scan_path):
//
// Tensor cores (bf16 x, B and C; P 64, N 128; 16-byte-aligned bases and
// strides, what TMA needs: the serving path, where x, B and C are views of
// the conv output).  What bounds it: bytes.  At Mamba-2-2.7B's 4,096-token
// admission the inputs and outputs are 133 MB (0.040 ms at 3.35 TB/s) and
// the products 16 GFLOP at chunk 256 (0.016 ms at the bf16 tensor rate).
// The CUDA-core build below reaches neither: 80 blocks for 132 SMs, f32
// products paced by shared-memory reads, chunks of 64, no load in flight
// during the products, and C B^T recomputed for each of the 80 heads.
// This build splits the scan over chunks of Q = 256 (the model's own
// chunk, so the chunking is the plain version's at the model's chunk) in
// three launches, as Mamba-2's own GPU kernels do:
//  (i)   chunk states, one block per (chunk, 10 heads): the chunk's cumsum
//        of dt * a (a fixed-order scan in the block, in f64: |cum| reaches
//        thousands over 256 steps, where an f32 parallel scan's rounding
//        reaches the 1e-4 gate on the state; the wrapper launches nothing
//        else), and s_c^T = (w o x)^T B with w = exp(cum_last - cum) dt,
//        for each head, into an f32 scratch (B, nc, H, N, P).
//  (ii)  state passing, one thread per 4 state elements of a (batch, head):
//        h_c = exp(cum_last,c) h_{c-1} + s_c in chunk order from h0; the
//        state entering each chunk is stored for (iii), the last is the
//        final state.
//  (iii) chunk outputs, one block per (64-row tile i, chunk, 8 heads):
//        y_i = exp(cum_i) (C_i h_{c-1}) + sum over j <= i of
//        (C_i B_j^T o exp(cum_i - cum_j) dt_j) x_j.  C_i B_j^T does not
//        depend on the head: the block computes it once, keeps it in f32
//        in shared memory over B_j's tile, and runs its heads over it.
//        Off the diagonal tile the decay is a factor per row times one per
//        column, exp(cum_i - cum_r) exp(cum_r - cum_j) at the tile's first
//        row r (both exponents <= 0); on it the exponential is whole.
// At T 4,096 that is 128, 640 and 640 blocks where the CUDA-core build has
// 80.  The chunk-state scratch is nc H N P f32 (42 MB at T 4,096), written
// by (i), read by (ii), which writes the entering states (42 MB) that
// (iii) reads: ~0.17 GB of traffic, the price of the parallel split; at
// chunk 64 it would be four times that.
//  * Products on wgmma (bf16 in, f32 accumulators).  C B^T has bf16
//    operands: exact products.  The other three multiply a bf16 input by an
//    f32 value (S, the state h, w o x); each f32 operand is carried as hi =
//    bf16(v) and lo = bf16(v - hi), both products into the same
//    accumulator: v to ~2^-17 of itself, for twice the tensor work.  bf16
//    operands alone would carry a 2^-9 relative error into y, above the
//    1e-4 gate (tests/test_torch_cuda_builds.py builds this file with the
//    lo halves zeroed and counts the misses).  S and w o x enter as the
//    register A operand; h is stored by (ii) as hi and lo bf16 planes that
//    TMA brings to (iii) as the MN-major B operand; the row scale
//    exp(cum_i) is applied to C h afterwards, in f32.
//  * Loads by TMA from one producer warp: x, B and C through their strides
//    as 64 x 64 boxes, 128-byte swizzled, rows past T as zeros.  (i) and
//    (iii) run two consumer warpgroups on alternate heads, each with its
//    own stage of a two-stage ring, so one head's tiles load while the
//    other warpgroup computes.
//  * Above the diagonal the exponent is clamped to <= 0 and the product
//    dropped, by a select (no branch, no inf); rows past T have dt = 0 and
//    repeat the last cum, so they add nothing and every other exponent
//    stays <= 0.  Every sum runs in a fixed order, without atomics: a
//    repeated launch is bitwise equal.
//
// CUDA cores (f32 x, B and C, and bf16 at any other shape; the first
// version, kept as it was; the wrapper computes `cum`).  What bounds it:
// operations.  Per chunk and head the three products cost 2 q^2 P (causal
// half of it needed) + 4 q N P flops against q (P + 2 N) input values,
// hundreds of flops per byte, in f32 on the CUDA cores (67 TFLOP/s).
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
// At B = 1 Mamba-2-2.7B gives 80 blocks for 132 SMs.
#include "common.cuh"
#include "sm90.cuh"

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


// ---------------------------------------------------------------------------
// tensor cores: chunk states, state passing, chunk outputs; wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int Q = 256;                   // rows of a chunk
constexpr int NS = 128;                  // state size N
constexpr int PD = 64;                   // head dim P
constexpr int NP = NS * PD;              // elements of a state
constexpr int RB = 64;                   // rows of a row tile (one wgmma M tile)
constexpr int NRB = Q / RB;              // row tiles a chunk
constexpr int BOX = RB * 128;            // a box of 64 rows x 64 bf16: 8 KB
constexpr int RBLK = 2 * BOX;            // a row tile of B or C (N 128: two boxes side by side)
constexpr int HALF = NS * 128;           // one bf16 plane of a state: N rows of 64 bf16
constexpr int WG = 128;                  // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;        // two consumer warpgroups, alternate heads
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int HG1 = 10;                  // heads a chunk-state block
constexpr int HG3 = 8;                   // heads a chunk-output block

// (v0, v1) as hi = bf16(v) and lo = bf16(v - hi), each pair packed as a
// wgmma A register (or a 4-byte store): v is carried to ~2^-17 of itself
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// byte offset of bf16 element (row, col < 64) in a tile of 128-byte rows that
// TMA wrote with the 128-byte swizzle from a 1,024-byte-aligned base
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ float bf16_at(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory"); }
// the 128 threads of consumer warpgroup w alone
__device__ __forceinline__ void wg_sync(int w) { asm volatile("bar.sync %0, %1;\n" ::"r"(2 + w), "n"(WG) : "memory"); }

// (i) shared memory: B's rows of the chunk (4 row tiles), two x stages (a
// head's 4 boxes; warpgroup w takes stage w), w of each head, the warps'
// scan totals and the heads' last cums, and the barriers (B, full[2],
// empty[2]); every TMA region 1,024-aligned
struct StateSmem {
  static constexpr int B_OFF = 0;
  static constexpr int X_OFF = NRB * RBLK;
  static constexpr int X_STAGE = NRB * BOX;
  static constexpr int W_OFF = X_OFF + 2 * X_STAGE;
  static constexpr int TOT_OFF = W_OFF + HG1 * Q * 4;
  static constexpr int BAR_OFF = (TOT_OFF + (CONSUMERS / 32 + 1) * HG1 * 8 + 15) / 16 * 16;
  static constexpr int BYTES = BAR_OFF + 5 * 8 + 1024;
};

// (i) chunk states: one block per (chunk, HG1 heads, batch)
__global__ void __launch_bounds__(THREADS, 1) chunk_state_kernel(
    const __grid_constant__ CUtensorMap tx,  // x as (P, H, T, B): boxes of (64, 1, 64, 1)
    const __grid_constant__ CUtensorMap tb,  // B as (N, T, B): boxes of (64, 64, 1)
    const float* __restrict__ dt,            // (B, T, H)
    const float* __restrict__ a,             // (H,)
    float* __restrict__ s_out,               // (B, nc, H, N, P): each chunk's own state
    float* __restrict__ cd,                  // (B, nc, H, 2, Q): cum, then dt (0 past T)
    float* __restrict__ decay,               // (B, nc, H): exp(cum_last)
    int Tn, int H, int nc) {
  using L = StateSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t bar_b = base + L::BAR_OFF, full = bar_b + 8, empty = full + 16;
  const int c = blockIdx.x, h_first = blockIdx.y * HG1, b = blockIdx.z;
  const int nh = min(HG1, H - h_first);
  const int t0 = c * Q, nv = min(Q, Tn - t0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_b, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, WG / 32);  // one arrival per warp of the stage's warpgroup
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane starts every load
    if (tid == CONSUMERS) {
      sm90::mbar_expect_tx(bar_b, NRB * RBLK);
      for (int r = 0; r < NRB; ++r)
        for (int cb = 0; cb < 2; ++cb)
          sm90::tma_load_3d(base + L::B_OFF + r * RBLK + cb * BOX, &tb, bar_b, 64 * cb, t0 + RB * r, b);
      for (int k = 0; k < nh; ++k) {
        const int s = k & 1;
        if (k >= 2) sm90::mbar_wait(empty + 8 * s, ((k >> 1) - 1) & 1);
        const uint32_t st = base + L::X_OFF + s * L::X_STAGE;
        sm90::mbar_expect_tx(full + 8 * s, L::X_STAGE);
        for (int r = 0; r < NRB; ++r)
          sm90::tma_load_4d(st + r * BOX, &tx, full + 8 * s, 0, h_first + k, t0 + RB * r, b);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  float* sw = reinterpret_cast<float*>(gb + L::W_OFF);      // [HG1][Q]: w of each head
  double* tot = reinterpret_cast<double*>(gb + L::TOT_OFF);  // [8][HG1] warp totals, then [HG1] last cums
  // every head's inclusive cumsum of dt * a over the chunk, row tid here,
  // in f64: a warp scan, then the earlier warps' totals in order (the
  // heads' scans are independent chains).  |cum| reaches thousands over 256
  // steps; an f32 parallel scan's rounding there carries ~2e-4 of the scale
  // into the state through w and the decays.  The exponents last - cum are
  // taken before rounding to f32.
  constexpr int NW = CONSUMERS / 32;
  float dv[HG1];
  double cum[HG1];
#pragma unroll
  for (int k = 0; k < HG1; ++k) {
    const int hh = min(h_first + k, H - 1);
    dv[k] = tid < nv ? dt[((long)b * Tn + t0 + tid) * H + hh] : 0.f;
    double inc = (double)dv[k] * (double)a[hh];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += n;
    }
    if (lane == 31) tot[warp * HG1 + k] = inc;
    cum[k] = inc;  // the warp's part; the earlier warps' totals follow
  }
  consumers_sync();
#pragma unroll
  for (int k = 0; k < HG1; ++k) {
    double pre = 0.0;
    for (int w = 0; w < warp; ++w) pre += tot[w * HG1 + k];
    cum[k] = pre + cum[k];
    if (tid == nv - 1) tot[NW * HG1 + k] = cum[k];
  }
  consumers_sync();
#pragma unroll
  for (int k = 0; k < HG1; ++k) {
    if (k >= nh) break;
    const long u = ((long)b * nc + c) * H + h_first + k;
    const double last = tot[NW * HG1 + k];
    if (tid >= nv) cum[k] = last;  // rows past T repeat the last cum
    sw[k * Q + tid] = expf((float)(last - cum[k])) * dv[k];
    float* cdu = cd + u * 2 * Q;
    cdu[tid] = (float)cum[k];
    cdu[Q + tid] = dv[k];
    if (tid == 0) decay[u] = expf((float)last);
  }
  consumers_sync();  // every head's w is written
  sm90::mbar_wait(bar_b, 0);

  // warpgroup w takes heads w, w + 2, ... from stage w
  const int w = tid / WG, wt = tid % WG;
  const int prow = 16 * (wt >> 5) + (lane >> 2), jq = 2 * (lane & 3);
  for (int k = w; k < nh; k += 2) {
    const long u = ((long)b * nc + c) * H + h_first + k;
    const float* wk = sw + k * Q;
    // s_c^T (P x N) = (w o x)^T (P x Q) . B (Q x N): A from registers, hi and
    // lo halves; A's element (p, j) of k-step kq is register 4 kq + q, p =
    // prow + 8 (q & 1), j = 16 kq + 8 (q >> 1) + jq (+1 in the high half)
    sm90::mbar_wait(full + 8 * w, (k >> 1) & 1);
    const unsigned char* xs = gb + L::X_OFF + w * L::X_STAGE;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int r = 0; r < NRB; ++r) {  // 64 rows of the chunk (one x box) a round: 4 k-steps
      uint32_t ah4[16], al4[16];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = prow + 8 * (q & 1), jl = 16 * kq + 8 * (q >> 1) + jq;
          const float x0 = bf16_at(xs + r * BOX + swz(jl, p)), x1 = bf16_at(xs + r * BOX + swz(jl + 1, p));
          split2(wk[RB * r + jl] * x0, wk[RB * r + jl + 1] * x1, ah4[4 * kq + q], al4[4 * kq + q]);
        }
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        // B's rows 64 r + 16 kq .. + 15, MN-major: its two 64-column boxes BOX apart
        const uint64_t db = sm90::desc_mnmajor(base + L::B_OFF + r * RBLK + kq * 16 * 128, BOX);
        const uint32_t hi[4] = {ah4[4 * kq], ah4[4 * kq + 1], ah4[4 * kq + 2], ah4[4 * kq + 3]};
        const uint32_t lo[4] = {al4[4 * kq], al4[4 * kq + 1], al4[4 * kq + 2], al4[4 * kq + 3]};
        sm90::wgmma_rs_m64n128k16(acc, hi, db);
        sm90::wgmma_rs_m64n128k16(acc, lo, db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + 8 * w);
    // acc[4 jj + 2 i + e] is row p = prow + 8 i, column n = 8 jj + jq + e of s_c^T
    float* so = s_out + u * NP;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) so[(8 * jj + jq + e) * PD + prow + 8 * i] = acc[4 * jj + 2 * i + e];
  }
}

// (ii) state passing: a thread owns 4 elements of one (batch, head)'s state
// and walks the chunks in order
__global__ void __launch_bounds__(256) state_pass_kernel(
    const float* __restrict__ s_in,      // (B, nc, H, N, P)
    const float* __restrict__ decay,     // (B, nc, H)
    const float* __restrict__ h0,        // (B, H, N, P) or null
    __nv_bfloat16* __restrict__ states,  // (B, nc, H, 2, N, P): the entering state's hi and lo planes
    float* __restrict__ h_out,           // (B, H, N, P)
    int H, int nc) {
  const int e4 = blockIdx.x * 256 + threadIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + hh;
  float4 h = h0 ? reinterpret_cast<const float4*>(h0 + bh * NP)[e4] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const long u = ((long)b * nc + c) * H + hh;
    uint2 hi, lo;
    split2(h.x, h.y, hi.x, lo.x);
    split2(h.z, h.w, hi.y, lo.y);
    reinterpret_cast<uint2*>(states + u * 2 * NP)[e4] = hi;
    reinterpret_cast<uint2*>(states + u * 2 * NP + NP)[e4] = lo;
    const float4 sv = reinterpret_cast<const float4*>(s_in + u * NP)[e4];
    const float g = decay[u];
    h = make_float4(g * h.x + sv.x, g * h.y + sv.y, g * h.z + sv.z, g * h.w + sv.w);
  }
  reinterpret_cast<float4*>(h_out + bh * NP)[e4] = h;
}

// (iii) tile j of S_i. as the register A operand, scaled and split into hi
// and lo halves (register x packs elements 2x and 2x + 1; element e is row
// r0 + 8 ((e >> 1) & 1), column 8 (e >> 2) + q2 + (e & 1)); cum, dtv and
// colf start at the tile's first column.  Off the diagonal the factors are
// the row's and the column's; on it the exponential is taken whole, its
// exponent clamped to <= 0 and the product dropped above the diagonal (no
// branch, and never an inf).
template <bool DIAG>
__device__ __forceinline__ void scaled_tile(const float4* sj, int wt, const float* colf, const float* cum,
                                            const float* dtv, const float (&ri)[2], const float (&ci)[2], int r0,
                                            int q2, uint32_t (&ph)[16], uint32_t (&pl)[16]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float4 sv = sj[v * WG + wt];
    const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
    float pv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = 4 * v + q, ii = (e >> 1) & 1, jl = 8 * (e >> 2) + q2 + (e & 1);
      if constexpr (DIAG) {
        const float dec = __expf(fminf(ci[ii] - cum[jl], 0.f)) * dtv[jl];
        pv[q] = jl <= r0 + 8 * ii ? sa[q] * dec : 0.f;
      } else {
        pv[q] = sa[q] * ri[ii] * colf[jl];
      }
    }
    split2(pv[0], pv[1], ph[2 * v], pl[2 * v]);
    split2(pv[2], pv[3], ph[2 * v + 1], pl[2 * v + 1]);
  }
}

// (iii) shared memory: C's row tile i, B's row tiles 0..i (then S_ij in
// f32 over them), two head stages (x tiles 0..i, the entering state's hi
// and lo planes; warpgroup w takes stage w), each stage's cum and dt rows,
// two column-factor buffers a warpgroup, the barriers (C and B, full[2],
// empty[2])
struct ScanSmem {
  static constexpr int C_OFF = 0;
  static constexpr int BS_OFF = RBLK;
  static constexpr int ST_OFF = BS_OFF + NRB * RBLK;
  static constexpr int X_BYTES = NRB * BOX;
  static constexpr int STAGE = X_BYTES + 2 * HALF;
  static constexpr int CD_OFF = ST_OFF + 2 * STAGE;
  static constexpr int CD_STAGE = 2 * Q * 4;
  static constexpr int COLF_OFF = CD_OFF + 2 * CD_STAGE;
  static constexpr int BAR_OFF = COLF_OFF + 4 * Q * 4;
  static constexpr int BYTES = BAR_OFF + 5 * 8 + 1024;
};

// (iii) chunk outputs: one block per (row tile i, chunk, HG3 heads x batch)
__global__ void __launch_bounds__(THREADS, 1) chunk_scan_kernel(
    const __grid_constant__ CUtensorMap tx,   // x as (P, H, T, B): boxes of (64, 1, 64, 1)
    const __grid_constant__ CUtensorMap tb,   // B as (N, T, B): boxes of (64, 64, 1)
    const __grid_constant__ CUtensorMap tcm,  // C as (N, T, B): boxes of (64, 64, 1)
    const __grid_constant__ CUtensorMap ts,   // states as (P, N, 2 B nc H): boxes of (64, 128, 1)
    const float* __restrict__ cd,             // (B, nc, H, 2, Q)
    float* __restrict__ y,                    // (B, T, H, P)
    int Tn, int H, int nc) {
  using L = ScanSmem;
  const int I = NRB - 1 - (int)blockIdx.x;  // the longest row tiles first
  const int c = blockIdx.y;
  const int ng = (H + HG3 - 1) / HG3;
  const int g = blockIdx.z % ng, b = blockIdx.z / ng;
  const int t0 = c * Q, row0 = t0 + RB * I;
  if (row0 >= Tn) return;  // a row tile past the ragged end
  const int h_first = g * HG3, nh = min(HG3, H - h_first), nI = I + 1;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t bar_cb = base + L::BAR_OFF, full = bar_cb + 8, empty = full + 16;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_cb, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, WG / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      sm90::mbar_expect_tx(bar_cb, (1 + nI) * RBLK);
      for (int cb = 0; cb < 2; ++cb) sm90::tma_load_3d(base + L::C_OFF + cb * BOX, &tcm, bar_cb, 64 * cb, row0, b);
      for (int j = 0; j < nI; ++j)
        for (int cb = 0; cb < 2; ++cb)
          sm90::tma_load_3d(base + L::BS_OFF + j * RBLK + cb * BOX, &tb, bar_cb, 64 * cb, t0 + RB * j, b);
      for (int k = 0; k < nh; ++k) {
        const int s = k & 1, hh = h_first + k;
        if (k >= 2) sm90::mbar_wait(empty + 8 * s, ((k >> 1) - 1) & 1);
        const long u = ((long)b * nc + c) * H + hh;
        const uint32_t st = base + L::ST_OFF + s * L::STAGE, cds = base + L::CD_OFF + s * L::CD_STAGE;
        sm90::mbar_expect_tx(full + 8 * s, nI * BOX + 2 * HALF + 2 * nI * RB * 4);
        for (int j = 0; j < nI; ++j) sm90::tma_load_4d(st + j * BOX, &tx, full + 8 * s, 0, hh, t0 + RB * j, b);
        sm90::tma_load_3d(st + L::X_BYTES, &ts, full + 8 * s, 0, 0, (int)(2 * u));
        sm90::tma_load_3d(st + L::X_BYTES + HALF, &ts, full + 8 * s, 0, 0, (int)(2 * u + 1));
        sm90::bulk_load(cds, cd + u * 2 * Q, nI * RB * 4, full + 8 * s);
        sm90::bulk_load(cds + Q * 4, cd + u * 2 * Q + Q, nI * RB * 4, full + 8 * s);
      }
    }
    return;
  }

  // warpgroup w; accumulator element e of a 64 x 64 tile: row r0 + 8 ((e
  // >> 1) & 1), column 8 (e >> 2) + q2 + (e & 1)
  const int w = tid / WG, wt = tid % WG, lane = tid & 31;
  const int r0 = 16 * (wt >> 5) + (lane >> 2), q2 = 2 * (lane & 3);
  sm90::mbar_wait(bar_cb, 0);
  // S_ij = C_i B_j^T, once for all heads (warpgroup w takes j = w, w + 2,
  // ...): f32 over B_j, in the register order of a warpgroup's thread (a
  // thread of either warpgroup reads back the elements its own index holds)
  for (int j = w; j < nI; j += 2) {
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
    sm90::fence_operands(sacc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      sm90::wgmma_ss_m64n64k16(sacc, sm90::desc_kmajor(base + L::C_OFF + off),
                               sm90::desc_kmajor(base + L::BS_OFF + j * RBLK + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sacc);
    wg_sync(w);  // every warp of this warpgroup is done reading B_j
    float4* sj = reinterpret_cast<float4*>(gb + L::BS_OFF + j * RBLK);
#pragma unroll
    for (int v = 0; v < 8; ++v)
      sj[v * WG + wt] = make_float4(sacc[4 * v], sacc[4 * v + 1], sacc[4 * v + 2], sacc[4 * v + 3]);
  }
  consumers_sync();  // every S_ij is written

  // warpgroup w takes heads w, w + 2, ... from stage w
  for (int k = w; k < nh; k += 2) {
    const int hh = h_first + k;
    sm90::mbar_wait(full + 8 * w, (k >> 1) & 1);
    const uint32_t st = base + L::ST_OFF + w * L::STAGE;
    const float* cum = reinterpret_cast<const float*>(gb + L::CD_OFF + w * L::CD_STAGE);
    const float* dtv = cum + Q;
    // the carried-in state: C_i (h_hi + h_lo), then the rows' exp(cum_i)
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      const uint64_t da = sm90::desc_kmajor(base + L::C_OFF + (kk >> 2) * BOX + (kk & 3) * 32);
      sm90::wgmma_ss_m64n64k16_bmn(acc, da, sm90::desc_mnmajor(st + L::X_BYTES + kk * 16 * 128, BOX));
      sm90::wgmma_ss_m64n64k16_bmn(acc, da, sm90::desc_mnmajor(st + L::X_BYTES + HALF + kk * 16 * 128, BOX));
    }
    sm90::wgmma_commit();

    // while it runs: the factors of (S_ij o exp(cum_i - cum_j) dt_j) x_j,
    // j <= i.  Off the diagonal exp(cum_i - cum_j) = exp(cum_i - cum_r)
    // exp(cum_r - cum_j) at the tile's first row r, both exponents <= 0: a
    // factor per row and one per column (with dt_j, computed once a head in
    // shared memory, in one of the warpgroup's two buffers by turns).
    const float ci[2] = {cum[RB * I + r0], cum[RB * I + r0 + 8]};
    const float cr = cum[RB * I];
    float* colf = reinterpret_cast<float*>(gb + L::COLF_OFF) + (2 * w + ((k >> 1) & 1)) * Q;
    for (int jc = wt; jc < RB * I; jc += WG) colf[jc] = __expf(cr - cum[jc]) * dtv[jc];
    wg_sync(w);  // colf is written; the other buffer's readers are a head behind
    const float ri[2] = {__expf(ci[0] - cr), __expf(ci[1] - cr)};
    const float ei[2] = {expf(ci[0]), expf(ci[1])};
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= ei[(e >> 1) & 1];

    // the scaled tiles as the register A operand, x_j MN-major
    for (int j = 0; j < nI; ++j) {
      const float4* sj = reinterpret_cast<const float4*>(gb + L::BS_OFF + j * RBLK);
      uint32_t ph[16], pl[16];
      if (j < I)
        scaled_tile<false>(sj, wt, colf + RB * j, cum + RB * j, dtv + RB * j, ri, ci, r0, q2, ph, pl);
      else
        scaled_tile<true>(sj, wt, colf + RB * j, cum + RB * j, dtv + RB * j, ri, ci, r0, q2, ph, pl);
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < RB / 16; ++ks) {
        const uint64_t db = sm90::desc_mnmajor(st + j * BOX + ks * 16 * 128, BOX);
        const uint32_t hi[4] = {ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2], ph[4 * ks + 3]};
        const uint32_t lo[4] = {pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2], pl[4 * ks + 3]};
        sm90::wgmma_rs_m64n64k16(acc, hi, db);
        sm90::wgmma_rs_m64n64k16(acc, lo, db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + 8 * w);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int t = row0 + r0 + 8 * ii;
      if (t >= Tn) continue;
      float* yr = y + (((long)b * Tn + t) * H + hh) * PD;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(yr + 8 * jj + q2) = make_float2(acc[4 * jj + 2 * ii], acc[4 * jj + 2 * ii + 1]);
    }
  }
}

int launch(const void* x, long long x_sb, long long x_st, const void* dt, const void* a, const void* bm,
           long long b_sb, long long b_st, const void* cm, long long c_sb, long long c_st, const void* h0, void* y,
           void* h_out, void* scratch, int B, int Tn, int H, cudaStream_t stream) {
  const int nc = (Tn + Q - 1) / Q;
  const long long u = (long long)B * nc * H;
  float* s_buf = reinterpret_cast<float*>(scratch);                             // u NP f32
  __nv_bfloat16* states = reinterpret_cast<__nv_bfloat16*>(s_buf + u * NP);  // u 2 NP bf16
  float* cd = s_buf + 2 * u * NP;                                              // u 2 Q f32
  float* dec = cd + u * 2 * Q;                                                 // u f32
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t xdims[4] = {(cuuint64_t)PD, (cuuint64_t)H, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {PD * e, (cuuint64_t)x_st * e, (cuuint64_t)x_sb * e};
  const cuuint32_t xbox[4] = {64, 1, RB, 1};
  const cuuint64_t ndims[3] = {(cuuint64_t)NS, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t bstr[2] = {(cuuint64_t)b_st * e, (cuuint64_t)b_sb * e};
  const cuuint64_t cstr[2] = {(cuuint64_t)c_st * e, (cuuint64_t)c_sb * e};
  const cuuint32_t nbox[3] = {64, RB, 1};
  const cuuint64_t sdims[3] = {(cuuint64_t)PD, (cuuint64_t)NS, (cuuint64_t)(2 * u)};
  const cuuint64_t sstr[2] = {PD * e, (cuuint64_t)NP * e};
  const cuuint32_t sbox[3] = {64, NS, 1};
  CUtensorMap tx, tb, tcm, ts;
  if (!sm90::bf16_tensor_map(&tx, x, 4, xdims, xstr, xbox) || !sm90::bf16_tensor_map(&tb, bm, 3, ndims, bstr, nbox) ||
      !sm90::bf16_tensor_map(&tcm, cm, 3, ndims, cstr, nbox) ||
      !sm90::bf16_tensor_map(&ts, states, 3, sdims, sstr, sbox))
    return (int)cudaErrorInvalidValue;
  // the opt-ins above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted1 = cudaFuncSetAttribute(chunk_state_kernel,
                                                         cudaFuncAttributeMaxDynamicSharedMemorySize, StateSmem::BYTES);
  static const cudaError_t opted3 = cudaFuncSetAttribute(chunk_scan_kernel,
                                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ScanSmem::BYTES);
  if (opted1 != cudaSuccess) return (int)opted1;
  if (opted3 != cudaSuccess) return (int)opted3;
  chunk_state_kernel<<<dim3(nc, (H + HG1 - 1) / HG1, B), THREADS, StateSmem::BYTES, stream>>>(
      tx, tb, (const float*)dt, (const float*)a, s_buf, cd, dec, Tn, H, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  state_pass_kernel<<<dim3(NP / 4 / 256, H, B), 256, 0, stream>>>(s_buf, dec, (const float*)h0, states,
                                                                   (float*)h_out, H, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_scan_kernel<<<dim3(NRB, nc, ((H + HG3 - 1) / HG3) * B), THREADS, ScanSmem::BYTES, stream>>>(
      tx, tb, tcm, ts, cd, (float*)y, Tn, H, nc);
  return (int)cudaGetLastError();
}

}  // namespace tc


// ---------------------------------------------------------------------------
// backward (11_bwd): chunks of Q = 64 steps, no atomics
// ---------------------------------------------------------------------------
//
// With g the gradient of the state a chunk leaves, hp the state it enters,
// E_ij = exp(cum_i - cum_j) (i >= j), w_j = exp(cum_last - cum_j) dt_j:
//
//   dS_ij = dy_i . x_j        S_ij = (C_i . B_j) E_ij dt_j
//   dx_j  = sum_i S_ij dy_i + w_j (g^T B_j)
//   dC_i  = sum_j dCB_ij B_j + exp(cum_i) hp dy_i,   dCB_ij = dS_ij E_ij dt_j
//   dB_j  = sum_i dCB_ij C_i + w_j g x_j
//   g_prev = exp(cum_last) g + sum_i exp(cum_i) C_i dy_i^T
//
// and the gradient of cum (through E, w, exp(cum_i) and exp(cum_last))
// becomes ddt and da by a reverse cumsum within the chunk (cum = cumsum(dt
// a)).  What bounds it: bytes on paper (0.052 ms at Mamba-2-2.7B's training
// shape: dy in f32 and x, dx in bf16 dominate), operations as built: per
// (chunk, head) eight products of 64 x 64 x N, 64 x 64 x P or 64 x N x P
// (3.7 M multiply-adds at N 128, P 64) against ~100 KB of inputs.  Four
// launches:
//  (1) per (chunk, head, batch): the chunk's cumsum of dt a (in f64, in
//      order, as the tensor-core forward computes it), its decay
//      exp(cum_last), s_c = sum_j w_j B_j x_j^T and r_c = sum_i exp(cum_i)
//      C_i dy_i^T (N x P each) into the scratch.  The chunk-start states
//      are recomputed here and in (2), not saved by the forward: the
//      forward stays the serving launch (its builds keep no per-chunk
//      states, and under remat a saved copy would be dropped anyway), and
//      this costs one pass over x and B.
//  (2) per (batch, head), one thread per 4 state elements: the states
//      entering the chunks (h0 folded with s_c in chunk order) written over
//      s_c, then the gradients of the states leaving them (dh_final folded
//      with r_c in descending order) written over r_c, each chunk's loads
//      issued a chunk ahead; dh0 is the last.
//  (3) per (chunk, head, batch), 512 threads and ~214-227 KB of shared
//      memory (one block an SM): C, B, x, dy, hp and g in f32 (each thread's
//      loads all issued before its stores), C B^T and dS,
//      then S, dCB and M_ij = dS_ij (C_i . B_j) E_ij as 64 x 64 tiles; dx,
//      ddt, this head's share of dB and dC (B, T, H, N), and of da (a value
//      per (batch, chunk, head)).  Row sums (the chunk's dcum terms) go
//      through a shared buffer summed in column order; the reverse cumsum
//      runs in order on one thread.
//  (4) dB and dC summed over heads in ascending order, and da over (batch,
//      chunk) in order, by the last block.
// Every sum runs in a fixed order: a repeated launch is bitwise equal.
// Rows past T are staged as zeros with dt = 0 and the last cum, add
// nothing, and are not written.
//
// Two builds of (1) and (3), chosen by the wrapper (ops.ssd_scan_bwd_path):
//  * CUDA cores (f32, and bf16 at any N <= 128, P <= 64 in multiples of 4):
//    each product a loop of rank-1 updates into a 4 x 4 (or 2 x 4)
//    register tile a thread, rows and columns strided so that a warp's
//    reads fall on distinct banks (tile rows padded to an odd length).
//    Each f32 read from shared memory feeds 1-2 FMAs: shared-memory
//    bandwidth bounds its products.
//  * Tensor cores (bf16 x, B and C at N 128, P 64: every Mamba-2 layer):
//    the same products on mma.sync m16n8k8 in TF32, one 16 x 8 NB tile a
//    warp, fragments read from the same f32 tiles (rows padded to 4 mod 32
//    words).  x, B and C are bf16 values, exact in TF32; every other
//    operand (dy, the states, S, dCB, the scaled rows) is carried as hi +
//    lo TF32 (v - hi rounded again), and each product with such an operand
//    issues the hi x hi, hi x lo and lo x hi terms: f32 operands to ~2^-21
//    of themselves, sums in f32.  (1) runs two blocks an SM (64 registers).
//    What still bounds it is latency: each block stages, scans, multiplies
//    and reduces in turn, one block an SM in (3), with serial steps (the
//    f64 cumsum, the reverse cumsum) on one thread.
namespace bwd {

constexpr int Q = 64;          // rows of a chunk
constexpr int THREADS = 512;   // threads of (1) and (3)
constexpr int TC_N = 128, TC_P = 64;  // the tensor-core build's state size and head dim

// row padding of the f32 tiles: odd on CUDA cores (a warp walks rows or
// columns), 4 words on tensor cores (an mma fragment reads 8 rows x 4 words)
template <bool TC>
struct Pad {
  static constexpr int V = TC ? 4 : 1;
  static constexpr int LDQ = Q + V;
};

// ---- CUDA cores: register tiles ------------------------------------------

template <int R, int C>
struct Tile {
  int r[R], c[C];
  float v[R][C];
};

// t.v += sum over k < K of a(row, k) b(k, col), in ascending k
template <int R, int C, typename A, typename B>
__device__ __forceinline__ void mac(Tile<R, C>& t, int K, A a, B b) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a(t.r[i], k);
#pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b(k, t.c[j]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) t.v[i][j] = fmaf(av[i], bv[j], t.v[i][j]);
  }
}

// f(tile) for each R x C tile of an M x Nc output (M a multiple of R, Nc of
// C): the tile owns rows tr + i M / R and columns tc + j Nc / C, consecutive
// threads taking consecutive tc
template <int R, int C, typename F>
__device__ __forceinline__ void for_tiles(int M, int Nc, F f) {
  const int rt = M / R, ct = Nc / C;
  for (int u = threadIdx.x; u < rt * ct; u += THREADS) {
    Tile<R, C> t;
    const int tr = u / ct, tc = u - tr * ct;
#pragma unroll
    for (int i = 0; i < R; ++i) t.r[i] = tr + i * rt;
#pragma unroll
    for (int j = 0; j < C; ++j) t.c[j] = tc + j * ct;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) t.v[i][j] = 0.f;
    f(t);
  }
}

// ---- tensor cores: TF32 mma.sync, one tile a warp --------------------------

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 16 x 8 NB tile of an M x Nc output: rows r0 = 16 (w mod M / 16)
// and columns c0 = 8 NB (w div M / 16) (16 warps cover it); a fragment
// element i of column block nb sits at (r0 + g + 8 (i / 2), c0 + 8 nb + 2 t
// + i mod 2), g = lane / 4, t = lane mod 4.
template <int NB>
struct Frag {
  int r0, c0, g, t;
  float c[NB][4];
  __device__ __forceinline__ Frag(int M) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, rt = M / 16;
    r0 = 16 * (w % rt);
    c0 = 8 * NB * (w / rt);
    g = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nb][i] = 0.f;
  }
  __device__ __forceinline__ int row(int i) const { return r0 + g + 8 * (i >> 1); }
  __device__ __forceinline__ int col(int nb, int i) const { return c0 + 8 * nb + 2 * t + (i & 1); }
};

// f.c += sum over k < K (a multiple of 8) of a(row, k) b(k, col) on TF32
// tensor cores; ALO / BLO: the operand is an f32 value carried as hi + lo
// (without, it must be exact in TF32, as a bf16 value is)
template <bool ALO, bool BLO, int NB, typename A, typename B>
__device__ __forceinline__ void mma(Frag<NB>& f, int K, A a, B b) {
  const int r = f.r0 + f.g, t = f.t;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    const float av[4] = {a(r, k + t), a(r + 8, k + t), a(r, k + t + 4), a(r + 8, k + t + 4)};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = tf32(av[i]);
      al[i] = ALO ? tf32(av[i] - __uint_as_float(ah[i])) : 0u;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = f.c0 + 8 * nb + f.g;
      const float b0 = b(k + t, col), b1 = b(k + t + 4, col);
      const uint32_t bh0 = tf32(b0), bh1 = tf32(b1);
      if (ALO) mma_tf32(f.c[nb], al, bh0, bh1);
      if (BLO) mma_tf32(f.c[nb], ah, tf32(b0 - __uint_as_float(bh0)), tf32(b1 - __uint_as_float(bh1)));
      mma_tf32(f.c[nb], ah, bh0, bh1);
    }
  }
}

// ---- shared by both builds -------------------------------------------------

// four consecutive elements from global memory in f32: one 16-byte (f32)
// or 8-byte (bf16) load where `vec`, else four
template <typename T>
__device__ __forceinline__ void load4(const T* p, bool vec, float (&v)[4]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
      v[0] = __low2float(lo), v[1] = __high2float(lo), v[2] = __low2float(hi), v[3] = __high2float(hi);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = to_f32(p[j]);
  }
}

// A thread's share of a rows x width block (width a multiple of 4, rows x
// width <= 4 U THREADS) in f32, U groups of four elements: load() issues
// every load (zeros in rows >= nv) before store() writes shared memory at
// row stride ld, so that a kernel's loads of several blocks are all in
// flight at once (one block an SM: the staging is latency-bound otherwise)
template <int U, typename T>
struct Rows {
  float v[U][4];
  int total, w4;
  __device__ __forceinline__ void load(const T* src, long long st, int rows, int width, int nv) {
    const bool vec = reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0 && st % 4 == 0;
    w4 = width / 4;
    total = rows * w4;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * THREADS, i = e / w4, k = 4 * (e - i * w4);
      if (e < total && i < nv) {
        load4(src + (long long)i * st + k, vec, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * THREADS, i = e / w4, k = 4 * (e - i * w4);
      if (e < total)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[i * ld + k + j] = v[u][j];
    }
  }
};

// two adjacent outputs (an mma fragment's pair of columns) in one store
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dt of the chunk's rows (0 past nv) and, on thread 0, cum in f64 in order
__device__ __forceinline__ void stage_cum(double* cum, float* sdt, const float* dt, long long row, int H, float a,
                                          int nv) {
  if (threadIdx.x < Q) sdt[threadIdx.x] = threadIdx.x < nv ? dt[row + (long long)threadIdx.x * H] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    double c = 0.0;
    for (int i = 0; i < Q; ++i) {
      c += (double)sdt[i] * (double)a;  // 0 past nv: the last cum repeats
      cum[i] = c;
    }
  }
  __syncthreads();
}

__host__ __device__ inline size_t terms_smem_floats(int N, int P, int pad) {
  return 2 * Q + 2 * (size_t)Q * (N + pad) + 2 * (size_t)Q * (P + pad) + 3 * Q;
}

// (1) s_c and r_c into the scratch, and the chunk's decay
template <typename T, bool TC>
__global__ void __launch_bounds__(THREADS, TC ? 2 : 1) state_terms_kernel(
    const T* __restrict__ x, long long x_sb, long long x_st, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm, long long b_sb, long long b_st, const T* __restrict__ cm,
    long long c_sb, long long c_st, const float* __restrict__ dy, float* __restrict__ s_out,
    float* __restrict__ r_out, float* __restrict__ dec, int Tn, int H, int N, int P, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int ldn = N + Pad<TC>::V, ldp = P + Pad<TC>::V;
  double* cum = reinterpret_cast<double*>(smem);  // [Q]
  float* sB = smem + 2 * Q;                       // [Q][ldn]
  float* sC = sB + Q * ldn;                       // [Q][ldn]
  float* sX = sC + Q * ldn;                       // [Q][ldp]
  float* sDY = sX + Q * ldp;                      // [Q][ldp]
  float* sDt = sDY + Q * ldp;                     // [Q]
  float* sW = sDt + Q;                            // w_j
  float* sE = sW + Q;                             // exp(cum_i)
  const int t0 = c * Q, nv = min(Q, Tn - t0);
  {
    Rows<4, T> lb, lc;
    Rows<2, T> lx;
    Rows<2, float> ldy;
    lb.load(bm + b * b_sb + (long long)t0 * b_st, b_st, Q, N, nv);
    lc.load(cm + b * c_sb + (long long)t0 * c_st, c_st, Q, N, nv);
    lx.load(x + b * x_sb + (long long)t0 * x_st + (long long)hh * P, x_st, Q, P, nv);
    ldy.load(dy + (((long long)b * Tn + t0) * H + hh) * P, (long long)H * P, Q, P, nv);
    lb.store(sB, ldn);
    lc.store(sC, ldn);
    lx.store(sX, ldp);
    ldy.store(sDY, ldp);
  }
  stage_cum(cum, sDt, dt, ((long long)b * Tn + t0) * H + hh, H, a[hh], nv);
  if (threadIdx.x < Q) {
    const int i = threadIdx.x;
    sW[i] = expf((float)(cum[Q - 1] - cum[i])) * sDt[i];
    sE[i] = expf((float)cum[i]);
  }
  __syncthreads();
  const long long base = (((long long)b * nc + c) * H + hh) * N * P;
  if (threadIdx.x == 0) dec[((long long)b * nc + c) * H + hh] = expf((float)cum[Q - 1]);
  const auto sa = [&](int n, int j) { return sW[j] * sB[j * ldn + n]; };
  const auto sb = [&](int j, int p) { return sX[j * ldp + p]; };
  const auto ra = [&](int n, int i) { return sE[i] * sC[i * ldn + n]; };
  const auto rb = [&](int i, int p) { return sDY[i * ldp + p]; };
  if constexpr (TC) {
    Frag<4> fs(TC_N), fr(TC_N);
    mma<true, false>(fs, Q, sa, sb);
    mma<true, true>(fr, Q, ra, rb);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const long long e = base + (long long)fs.row(i) * P + fs.col(nb, i);
        store2(s_out + e, fs.c[nb][i], fs.c[nb][i + 1]);
        store2(r_out + e, fr.c[nb][i], fr.c[nb][i + 1]);
      }
  } else {
    for_tiles<4, 4>(N, P, [&](Tile<4, 4>& t) {
      mac(t, nv, sa, sb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s_out[base + (long long)t.r[i] * P + t.c[j]] = t.v[i][j];
    });
    for_tiles<4, 4>(N, P, [&](Tile<4, 4>& t) {
      mac(t, nv, ra, rb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r_out[base + (long long)t.r[i] * P + t.c[j]] = t.v[i][j];
    });
  }
}

// (2) entering states over s, gradients of the leaving states over r, dh0;
// four elements a thread (N P is a multiple of 16), the next chunk's loads
// issued before this chunk's store
__global__ void __launch_bounds__(256) state_pass_kernel(float4* __restrict__ s, float4* __restrict__ r,
                                                         const float* __restrict__ dec, const float4* __restrict__ h0,
                                                         const float4* __restrict__ dh_final, float4* __restrict__ dh0,
                                                         int H, int NP4, int nc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, hh = blockIdx.y, b = blockIdx.z;
  if (e >= NP4) return;
  const long long bh = (long long)b * H + hh;
  const auto at = [&](int c) { return (((long long)b * nc + c) * H + hh) * NP4 + e; };
  const auto decay = [&](int c) { return dec[((long long)b * nc + c) * H + hh]; };
  float4 h = h0 ? h0[bh * NP4 + e] : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 nxt = s[at(0)];
  float dn = decay(0);
  for (int c = 0; c < nc; ++c) {
    const float4 sc = nxt;
    const float d = dn;
    if (c + 1 < nc) {
      nxt = s[at(c + 1)];
      dn = decay(c + 1);
    }
    s[at(c)] = h;
    h = make_float4(d * h.x + sc.x, d * h.y + sc.y, d * h.z + sc.z, d * h.w + sc.w);
  }
  float4 g = dh_final ? dh_final[bh * NP4 + e] : make_float4(0.f, 0.f, 0.f, 0.f);
  nxt = r[at(nc - 1)];
  dn = decay(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const float4 rc = nxt;
    const float d = dn;
    if (c > 0) {
      nxt = r[at(c - 1)];
      dn = decay(c - 1);
    }
    r[at(c)] = g;
    g = make_float4(d * g.x + rc.x, d * g.y + rc.y, d * g.z + rc.z, d * g.w + rc.w);
  }
  if (dh0) dh0[bh * NP4 + e] = g;
}

__host__ __device__ inline size_t grad_smem_floats(int N, int P, int pad) {
  return 2 * Q + 2 * (size_t)Q * (N + pad) + 2 * (size_t)Q * (P + pad) + 2 * (size_t)N * (P + pad) +
         3 * (size_t)Q * (Q + pad) + 10 * Q;
}

// (3) dx, ddt, this head's shares of dB, dC and da
template <typename T, bool TC>
__global__ void __launch_bounds__(THREADS, 1) grad_kernel(
    const T* __restrict__ x, long long x_sb, long long x_st, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm, long long b_sb, long long b_st, const T* __restrict__ cm,
    long long c_sb, long long c_st, const float* __restrict__ dy, const float* __restrict__ hps,
    const float* __restrict__ gs, T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbp,
    float* __restrict__ dcp, float* __restrict__ dap, int Tn, int H, int N, int P, int nc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDQ = Pad<TC>::LDQ;
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ldn = N + Pad<TC>::V, ldp = P + Pad<TC>::V;
  double* cum = reinterpret_cast<double*>(smem);  // [Q]
  float* sC = smem + 2 * Q;                       // [Q][ldn]
  float* sB = sC + Q * ldn;                       // [Q][ldn]
  float* sX = sB + Q * ldn;                       // [Q][ldp]
  float* sDY = sX + Q * ldp;                      // [Q][ldp]
  float* sHp = sDY + Q * ldp;                     // [N][ldp] the entering state
  float* sG = sHp + N * ldp;                      // [N][ldp] the leaving state's gradient
  float* sT1 = sG + N * ldp;                      // [Q][LDQ] C B^T, then S
  float* sT2 = sT1 + Q * LDQ;                     // [Q][LDQ] dS, then dCB
  float* sT3 = sT2 + Q * LDQ;                     // [Q][LDQ] M, then row-sum partials
  float* sDt = sT3 + Q * LDQ;                     // [Q]
  float* sEi = sDt + Q;                           // exp(cum_i)
  float* sW = sEi + Q;                            // w_j
  float* sWx = sW + Q;                            // exp(cum_last - cum_j)
  float* sRs = sWx + Q;                           // sum_j M_ij dt_j
  float* sCs = sRs + Q;                           // sum_i M_ij
  float* sDw = sCs + Q;                           // dL/dw_j
  float* sIn = sDw + Q;                           // exp(cum_i) C_i . (hp dy_i)
  float* sRed = sIn + Q;                          // [2 Q]: block sums
  const int t0 = c * Q, nv = min(Q, Tn - t0);
  const long long row0 = ((long long)b * Tn + t0) * H + hh;  // (b, t0, hh) in (B, T, H)
  const long long st = (((long long)b * nc + c) * H + hh) * N * P;
  {
    Rows<4, T> lc, lb;
    Rows<2, T> lx;
    Rows<2, float> ldy;
    lc.load(cm + b * c_sb + (long long)t0 * c_st, c_st, Q, N, nv);
    lb.load(bm + b * b_sb + (long long)t0 * b_st, b_st, Q, N, nv);
    lx.load(x + b * x_sb + (long long)t0 * x_st + (long long)hh * P, x_st, Q, P, nv);
    ldy.load(dy + row0 * P, (long long)H * P, Q, P, nv);
    lc.store(sC, ldn);
    lb.store(sB, ldn);
    lx.store(sX, ldp);
    ldy.store(sDY, ldp);
  }
  {
    Rows<4, float> lh, lg;
    lh.load(hps + st, P, N, P, N);
    lg.load(gs + st, P, N, P, N);
    lh.store(sHp, ldp);
    lg.store(sG, ldp);
  }
  const float ah = a[hh];
  stage_cum(cum, sDt, dt, row0, H, ah, nv);
  if (tid < Q) {
    const int i = tid;
    sEi[i] = expf((float)cum[i]);
    sWx[i] = expf((float)(cum[Q - 1] - cum[i]));
    sW[i] = sWx[i] * sDt[i];
  }
  // the products' operands
  const auto c_in = [&](int i, int n) { return sC[i * ldn + n]; };     // C_i[n], k = n
  const auto b_jn = [&](int n, int j) { return sB[j * ldn + n]; };     // B_j[n], k = n
  const auto dy_ip = [&](int i, int p) { return sDY[i * ldp + p]; };   // dy_i[p], k = p
  const auto x_jp = [&](int p, int j) { return sX[j * ldp + p]; };     // x_j[p], k = p
  const auto hp_np = [&](int p, int n) { return sHp[n * ldp + p]; };   // hp[n][p], k = p
  const auto g_np = [&](int p, int n) { return sG[n * ldp + p]; };     // g[n][p], k = p
  const auto x_row = [&](int j, int p) { return sX[j * ldp + p]; };    // x_j[p], row j
  const auto dcb = [&](int i, int j) { return sT2[i * LDQ + j]; };     // dCB_ij, row i
  const auto dcb_t = [&](int j, int i) { return sT2[i * LDQ + j]; };   // dCB_ij, row j
  const auto s_t = [&](int j, int i) { return sT1[i * LDQ + j]; };     // S_ij, row j
  const auto b_kn = [&](int j, int n) { return sB[j * ldn + n]; };     // B_j[n], k = j
  const auto c_kn = [&](int i, int n) { return sC[i * ldn + n]; };     // C_i[n], k = i
  const auto g_kp = [&](int n, int p) { return sG[n * ldp + p]; };     // g[n][p], k = n
  const auto dy_kp = [&](int i, int p) { return sDY[i * ldp + p]; };   // dy_i[p], k = i
  const auto b_row = [&](int j, int n) { return sB[j * ldn + n]; };    // B_j[n], row j
  // C B^T and dS = dy x^T
  if constexpr (TC) {
    Frag<2> f1(Q), f2(Q);
    mma<false, false>(f1, N, c_in, b_jn);
    mma<true, false>(f2, P, dy_ip, x_jp);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sT1[f1.row(i) * LDQ + f1.col(nb, i)] = f1.c[nb][i];
        sT2[f2.row(i) * LDQ + f2.col(nb, i)] = f2.c[nb][i];
      }
  } else {
    for_tiles<2, 4>(Q, Q, [&](Tile<2, 4>& t) {
      mac(t, N, c_in, b_jn);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sT1[t.r[i] * LDQ + t.c[j]] = t.v[i][j];
    });
    for_tiles<2, 4>(Q, Q, [&](Tile<2, 4>& t) {
      mac(t, P, dy_ip, x_jp);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sT2[t.r[i] * LDQ + t.c[j]] = t.v[i][j];
    });
  }
  __syncthreads();
  // S, dCB and M; the causal mask before the exponential
  for (int e = tid; e < Q * Q; e += THREADS) {
    const int i = e / Q, j = e - i * Q;
    const float E = (j <= i && i < nv) ? expf((float)(cum[i] - cum[j])) : 0.f;
    const float cb = sT1[i * LDQ + j], ds = sT2[i * LDQ + j];
    sT1[i * LDQ + j] = cb * E * sDt[j];
    sT2[i * LDQ + j] = ds * E * sDt[j];
    sT3[i * LDQ + j] = ds * cb * E;
  }
  __syncthreads();
  if (tid < Q) {
    float rs = 0.f;
    for (int j = 0; j < Q; ++j) rs = fmaf(sT3[tid * LDQ + j], sDt[j], rs);
    sRs[tid] = rs;
  } else if (tid < 2 * Q) {
    const int j = tid - Q;
    float cs = 0.f;
    for (int i = 0; i < Q; ++i) cs += sT3[i * LDQ + j];
    sCs[j] = cs;
  }
  __syncthreads();  // M is spent: sT3 holds the row-sum partials from here
  float* red_in = sT3;           // [Q][32]: C_i . (exp(cum_i) hp dy_i) by column group
  float* red_dw = sT3 + Q * 32;  // [Q][32]: B_j . (g x_j) by column group
  const int nred = TC ? TC_N / 32 : N / 4;  // column groups a row: a warp's 32 columns, or a thread's 4
  if constexpr (TC) {
    // dC_i = exp(cum_i) hp dy_i + sum_j dCB_ij B_j
    {
      Frag<4> f(Q);
      mma<true, true>(f, P, dy_ip, hp_np);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          f.c[nb][i] *= sEi[f.row(i)];
          part[i >> 1] = fmaf(sC[f.row(i) * ldn + f.col(nb, i)], f.c[nb][i], part[i >> 1]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
        if (f.t == 0) red_in[(f.r0 + f.g + 8 * h) * 32 + f.c0 / 32] = part[h];
      }
      mma<true, false>(f, Q, dcb, b_kn);
#pragma unroll
      for (int i = 0; i < 4; i += 2)
        if (f.row(i) < nv)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
            store2(dcp + (row0 + (long long)f.row(i) * H) * N + f.col(nb, i), f.c[nb][i], f.c[nb][i + 1]);
    }
    // dB_j = w_j g x_j + sum_i dCB_ij C_i; and dL/dw_j = B_j . (g x_j)
    {
      Frag<4> f(Q);
      mma<false, true>(f, P, x_row, g_np);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[i >> 1] = fmaf(sB[f.row(i) * ldn + f.col(nb, i)], f.c[nb][i], part[i >> 1]);
          f.c[nb][i] *= sW[f.row(i)];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
        if (f.t == 0) red_dw[(f.r0 + f.g + 8 * h) * 32 + f.c0 / 32] = part[h];
      }
      mma<true, false>(f, Q, dcb_t, c_kn);
#pragma unroll
      for (int i = 0; i < 4; i += 2)
        if (f.row(i) < nv)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
            store2(dbp + (row0 + (long long)f.row(i) * H) * N + f.col(nb, i), f.c[nb][i], f.c[nb][i + 1]);
    }
    // dx_j = w_j g^T B_j + sum_i S_ij dy_i
    {
      Frag<2> f(Q);
      mma<false, true>(f, N, b_row, g_kp);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) f.c[nb][i] *= sW[f.row(i)];
      mma<true, true>(f, Q, s_t, dy_kp);
#pragma unroll
      for (int i = 0; i < 4; i += 2)
        if (f.row(i) < nv)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            store2(dx + (row0 + (long long)f.row(i) * H) * P + f.col(nb, i), f.c[nb][i], f.c[nb][i + 1]);
    }
  } else {
    // dC_i = exp(cum_i) hp dy_i + sum_j dCB_ij B_j
    for_tiles<4, 4>(Q, N, [&](Tile<4, 4>& t) {
      mac(t, P, dy_ip, hp_np);
      const int tc = t.c[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = t.r[i];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t.v[i][j] *= sEi[r];
          part = fmaf(sC[r * ldn + t.c[j]], t.v[i][j], part);
        }
        red_in[r * 32 + tc] = part;
      }
      mac(t, Q, dcb, b_kn);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t.r[i] < nv)
#pragma unroll
          for (int j = 0; j < 4; ++j) dcp[(row0 + (long long)t.r[i] * H) * N + t.c[j]] = t.v[i][j];
    });
    // dB_j = w_j g x_j + sum_i dCB_ij C_i; and dL/dw_j = B_j . (g x_j)
    for_tiles<4, 4>(Q, N, [&](Tile<4, 4>& t) {
      mac(t, P, x_row, g_np);
      const int tc = t.c[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = t.r[i];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          part = fmaf(sB[r * ldn + t.c[j]], t.v[i][j], part);
          t.v[i][j] *= sW[r];
        }
        red_dw[r * 32 + tc] = part;
      }
      mac(t, Q, dcb_t, c_kn);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t.r[i] < nv)
#pragma unroll
          for (int j = 0; j < 4; ++j) dbp[(row0 + (long long)t.r[i] * H) * N + t.c[j]] = t.v[i][j];
    });
    // dx_j = w_j g^T B_j + sum_i S_ij dy_i
    for_tiles<2, 4>(Q, P, [&](Tile<2, 4>& t) {
      mac(t, N, b_row, g_kp);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) t.v[i][j] *= sW[t.r[i]];
      mac(t, Q, s_t, dy_kp);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (t.r[i] < nv)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dx[(row0 + (long long)t.r[i] * H) * P + t.c[j]] = from_f32<T>(t.v[i][j]);
    });
  }
  // exp(cum_last) sum g o hp: per-thread partials in element order, then a
  // fixed tree (warp butterflies, the warps' sums in order)
  float gh = 0.f;
  for (int e = tid; e < N * P; e += THREADS) {
    const int n = e / P, p = e - n * P;
    gh = fmaf(sG[n * ldp + p], sHp[n * ldp + p], gh);
  }
  gh = warp_sum(gh);
  if ((tid & 31) == 0) sRed[tid >> 5] = gh;
  __syncthreads();
  if (tid < Q) {
    float in = 0.f, dw = 0.f;
    for (int k = 0; k < nred; ++k) {
      in += red_in[tid * 32 + k];
      dw += red_dw[tid * 32 + k];
    }
    sIn[tid] = in;
    sDw[tid] = dw;
  }
  __syncthreads();
  if (tid == 0) {
    float ghs = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) ghs += sRed[w];
    float dlast = 0.f;
    for (int j = 0; j < nv; ++j) dlast = fmaf(sW[j], sDw[j], dlast);
    dlast = fmaf(expf((float)cum[Q - 1]), ghs, dlast);
    // the reverse cumsum of dcum over the chunk's rows, in order
    float dl = 0.f, da = 0.f;
    for (int i = nv - 1; i >= 0; --i) {
      float dcum = sRs[i] - sDt[i] * sCs[i] + sIn[i] - sW[i] * sDw[i];
      if (i == nv - 1) dcum += dlast;
      dl += dcum;
      ddt[row0 + (long long)i * H] = sCs[i] + sWx[i] * sDw[i] + dl * ah;
      da = fmaf(dl, sDt[i], da);
    }
    dap[((long long)b * nc + c) * H + hh] = da;
  }
}

// (4) dB, dC over heads in ascending order; da (the last block) over
// (batch, chunk) in order
template <typename T>
__global__ void sum_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                           const float* __restrict__ dap, T* __restrict__ db, T* __restrict__ dc,
                           float* __restrict__ da, long long rows, int H, int N, int nbc) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float s = 0.f;
      for (int k = 0; k < nbc; ++k) s += dap[(long long)k * H + hh];
      da[hh] = s;
    }
    return;
  }
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * N) return;
  const long long r = e / N;
  const int n = (int)(e - r * N);
  float sb = 0.f, sc = 0.f;
  for (int hh = 0; hh < H; ++hh) {
    sb += dbp[(r * H + hh) * N + n];
    sc += dcp[(r * H + hh) * N + n];
  }
  db[e] = from_f32<T>(sb);
  dc[e] = from_f32<T>(sc);
}

template <typename T, bool TC>
int launch(const void* x, long long x_sb, long long x_st, const void* dt, const void* a, const void* bm,
           long long b_sb, long long b_st, const void* cm, long long c_sb, long long c_st, const void* dy,
           const void* dh_final, const void* h0, void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
           void* scratch, int B, int Tn, int H, int N, int P, cudaStream_t stream) {
  const int nc = (Tn + Q - 1) / Q;
  const long long NP = (long long)N * P, bch = (long long)B * nc * H;
  float* s_buf = (float*)scratch;
  float* r_buf = s_buf + bch * NP;
  float* dec = r_buf + bch * NP;
  float* dap = dec + bch;
  float* dbp = dap + bch;
  float* dcp = dbp + (long long)B * Tn * H * N;
  const size_t smem1 = terms_smem_floats(N, P, Pad<TC>::V) * sizeof(float);
  const size_t smem3 = grad_smem_floats(N, P, Pad<TC>::V) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(state_terms_kernel<T, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_kernel<T, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nc, H, B);
  state_terms_kernel<T, TC><<<grid, THREADS, smem1, stream>>>(
      (const T*)x, x_sb, x_st, (const float*)dt, (const float*)a, (const T*)bm, b_sb, b_st, (const T*)cm, c_sb, c_st,
      (const float*)dy, s_buf, r_buf, dec, Tn, H, N, P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int NP4 = (int)(NP / 4);
  state_pass_kernel<<<dim3((unsigned)((NP4 + 255) / 256), H, B), 256, 0, stream>>>(
      (float4*)s_buf, (float4*)r_buf, dec, (const float4*)h0, (const float4*)dh_final, (float4*)dh0, H, NP4, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_kernel<T, TC><<<grid, THREADS, smem3, stream>>>(
      (const T*)x, x_sb, x_st, (const float*)dt, (const float*)a, (const T*)bm, b_sb, b_st, (const T*)cm, c_sb, c_st,
      (const float*)dy, s_buf, r_buf, (T*)dx, (float*)ddt, dbp, dcp, dap, Tn, H, N, P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rows = (long long)B * Tn;
  sum_kernel<T><<<(unsigned)((rows * N + 255) / 256 + 1), 256, 0, stream>>>(
      dbp, dcp, dap, (T*)db, (T*)dc, (float*)da, rows, H, N, B * nc);
  return (int)cudaGetLastError();
}

}  // namespace bwd

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

// The tensor-core build: bf16 x (B, T, H, 64) with head stride 64, B and C
// (B, T, 128), all with unit inner strides, batch and time strides that are
// multiples of 8 elements and 16-byte-aligned bases; dt (B, T, H) and a (H,)
// f32 contiguous; h0 (B, H, 128, 64) f32 or null.  scratch: f32, B nc H
// (2 N P + 2 Q + 1) elements at nc = ceil(T / 256), its contents on entry
// unused.  Three launches.
extern "C" int repro_ssd_scan_tc(const void* x, long long x_sb, long long x_st, const void* dt, const void* a,
                                 const void* bm, long long b_sb, long long b_st, const void* cm, long long c_sb,
                                 long long c_st, const void* h0, void* y, void* h_out, void* scratch, int B, int Tn,
                                 int H, int N, int P, void* stream) {
  const long long strides[6] = {x_sb, x_st, b_sb, b_st, c_sb, c_st};
  const void* bases[4] = {x, bm, cm, scratch};
  if (B <= 0 || Tn <= 0 || H <= 0 || N != tc::NS || P != tc::PD || B > 65535) return (int)cudaErrorInvalidValue;
  for (long long st : strides)
    if (st <= 0 || st % 8 != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  return tc::launch(x, x_sb, x_st, dt, a, bm, b_sb, b_st, cm, c_sb, c_st, h0, y, h_out, scratch, B, Tn, H,
                    (cudaStream_t)stream);
}

// The backward (11_bwd): x (B, T, H, P) with head stride P and unit inner
// stride, B and C (B, T, N) with unit inner strides, all read through their
// batch and time strides, in f32 or bf16 (`dtype`); dt (B, T, H), a (H,), dy
// (B, T, H, P) f32 contiguous; dh_final and h0 (B, H, N, P) f32 or null.
// Writes dx (B, T, H, P) and dB, dC (B, T, N) in x's type, ddt (B, T, H) and
// da (H,) f32, and dh0 (B, H, N, P) f32 where it is not null; h0,
// dh_final and dh0 16-byte aligned.  scratch: f32, B nc H (2 N P + 2) + 2 B
// T H N elements at nc = ceil(T / 64), its contents on entry unused.  Four
// launches.
extern "C" int repro_ssd_scan_bwd(int dtype, const void* x, long long x_sb, long long x_st, const void* dt,
                                  const void* a, const void* bm, long long b_sb, long long b_st, const void* cm,
                                  long long c_sb, long long c_st, const void* dy, const void* dh_final,
                                  const void* h0, void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
                                  void* scratch, int B, int Tn, int H, int N, int P, void* stream) {
  if (B <= 0 || B > 65535 || Tn <= 0 || H <= 0 || H > 65535 || N <= 0 || N > NMAX || N % 4 || P <= 0 ||
      P > PMAX || P % 4)
    return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, T, {
    return bwd::launch<T, false>(x, x_sb, x_st, dt, a, bm, b_sb, b_st, cm, c_sb, c_st, dy, dh_final, h0, dx, ddt,
                                 da, db, dc, dh0, scratch, B, Tn, H, N, P, (cudaStream_t)stream);
  });
  return (int)cudaErrorInvalidValue;
}

// The backward's tensor-core build: bf16 x, B and C at N 128, P 64, the
// rest as repro_ssd_scan_bwd takes it (h0, dh_final and dh0 16-byte
// aligned, as there).  Four launches.
extern "C" int repro_ssd_scan_bwd_tc(const void* x, long long x_sb, long long x_st, const void* dt, const void* a,
                                     const void* bm, long long b_sb, long long b_st, const void* cm, long long c_sb,
                                     long long c_st, const void* dy, const void* dh_final, const void* h0, void* dx,
                                     void* ddt, void* da, void* db, void* dc, void* dh0, void* scratch, int B, int Tn,
                                     int H, int N, int P, void* stream) {
  if (B <= 0 || B > 65535 || Tn <= 0 || H <= 0 || H > 65535 || N != bwd::TC_N || P != bwd::TC_P)
    return (int)cudaErrorInvalidValue;
  return bwd::launch<__nv_bfloat16, true>(x, x_sb, x_st, dt, a, bm, b_sb, b_st, cm, c_sb, c_st, dy, dh_final, h0,
                                          dx, ddt, da, db, dc, dh0, scratch, B, Tn, H, N, P, (cudaStream_t)stream);
}

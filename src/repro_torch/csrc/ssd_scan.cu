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
// backward (11_bwd): two builds, no atomics
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
// shape: dy in f32 and x, dx in bf16 dominate); operations as built.  Every
// sum runs in a fixed order: a repeated launch is bitwise equal.  Rows past
// T are staged as zeros with dt = 0 and the last cum, add nothing, and are
// not written.  The wrapper picks the build (ops.ssd_scan_bwd_path): the
// tensor-core one (namespace bwd_tc below) for bf16 x, B and C at N 128, P
// 64 that TMA reads in place (every Mamba-2 layer), this one otherwise.
//
// CUDA cores (f32, and bf16 at any N <= 128, P <= 64 in multiples of 4):
// chunks of Q = 64 steps, four launches:
//  (1) per (chunk, head, batch): the chunk's cumsum of dt a (in f64, in
//      order, as the tensor-core forward computes it), its decay
//      exp(cum_last), s_c = sum_j w_j B_j x_j^T and r_c = sum_i exp(cum_i)
//      C_i dy_i^T (N x P each) into the scratch.  The chunk-start states
//      are recomputed here and in (2), not saved by the forward.
//  (2) per (batch, head), one thread per 4 state elements: the states
//      entering the chunks (h0 folded with s_c in chunk order) written over
//      s_c, then the gradients of the states leaving them (dh_final folded
//      with r_c in descending order) written over r_c, each chunk's loads
//      issued a chunk ahead; dh0 is the last.
//  (3) per (chunk, head, batch), 512 threads and ~214 KB of shared memory
//      (one block an SM): C, B, x, dy, hp and g in f32 (each thread's loads
//      all issued before its stores), C B^T and dS, then S, dCB and M_ij =
//      dS_ij (C_i . B_j) E_ij as 64 x 64 tiles; dx, ddt, this head's share
//      of dB and dC (B, T, H, N), and of da (a value per (batch, chunk,
//      head)).  Row sums (the chunk's dcum terms) go through a shared
//      buffer summed in column order; the reverse cumsum runs in order on
//      one thread.
//  (4) dB and dC summed over heads in ascending order, and da over (batch,
//      chunk) in order, by the last block.
// Each product is a loop of rank-1 updates into a 4 x 4 (or 2 x 4)
// register tile a thread, rows and columns strided so that a warp's reads
// fall on distinct banks (tile rows padded to an odd length).  Each f32
// read from shared memory feeds 1-2 FMAs: shared-memory bandwidth bounds
// its products.
namespace bwd {

constexpr int Q = 64;          // rows of a chunk
constexpr int THREADS = 512;   // threads of (1) and (3)
constexpr int PAD = 1;         // row padding of the f32 tiles: odd, a warp walks rows or columns
constexpr int LDQ = Q + PAD;

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

__host__ __device__ inline size_t terms_smem_floats(int N, int P) {
  return 2 * Q + 2 * (size_t)Q * (N + PAD) + 2 * (size_t)Q * (P + PAD) + 3 * Q;
}

// (1) s_c and r_c into the scratch, and the chunk's decay
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) state_terms_kernel(
    const T* __restrict__ x, long long x_sb, long long x_st, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm, long long b_sb, long long b_st, const T* __restrict__ cm,
    long long c_sb, long long c_st, const float* __restrict__ dy, float* __restrict__ s_out,
    float* __restrict__ r_out, float* __restrict__ dec, int Tn, int H, int N, int P, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int ldn = N + PAD, ldp = P + PAD;
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

__host__ __device__ inline size_t grad_smem_floats(int N, int P) {
  return 2 * Q + 2 * (size_t)Q * (N + PAD) + 2 * (size_t)Q * (P + PAD) + 2 * (size_t)N * (P + PAD) +
         3 * (size_t)Q * LDQ + 10 * Q;
}

// (3) dx, ddt, this head's shares of dB, dC and da
template <typename T>
__global__ void __launch_bounds__(THREADS, 1) grad_kernel(
    const T* __restrict__ x, long long x_sb, long long x_st, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm, long long b_sb, long long b_st, const T* __restrict__ cm,
    long long c_sb, long long c_st, const float* __restrict__ dy, const float* __restrict__ hps,
    const float* __restrict__ gs, T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbp,
    float* __restrict__ dcp, float* __restrict__ dap, int Tn, int H, int N, int P, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int ldn = N + PAD, ldp = P + PAD;
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
  const int nred = N / 4;        // column groups a row: a thread's 4
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

template <typename T>
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
  const size_t smem1 = terms_smem_floats(N, P) * sizeof(float);
  const size_t smem3 = grad_smem_floats(N, P) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(state_terms_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nc, H, B);
  state_terms_kernel<T><<<grid, THREADS, smem1, stream>>>(
      (const T*)x, x_sb, x_st, (const float*)dt, (const float*)a, (const T*)bm, b_sb, b_st, (const T*)cm, c_sb, c_st,
      (const float*)dy, s_buf, r_buf, dec, Tn, H, N, P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int NP4 = (int)(NP / 4);
  state_pass_kernel<<<dim3((unsigned)((NP4 + 255) / 256), H, B), 256, 0, stream>>>(
      (float4*)s_buf, (float4*)r_buf, dec, (const float4*)h0, (const float4*)dh_final, (float4*)dh0, H, NP4, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_kernel<T><<<grid, THREADS, smem3, stream>>>(
      (const T*)x, x_sb, x_st, (const float*)dt, (const float*)a, (const T*)bm, b_sb, b_st, (const T*)cm, c_sb, c_st,
      (const float*)dy, s_buf, r_buf, (T*)dx, (float*)ddt, dbp, dcp, dap, Tn, H, N, P, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rows = (long long)B * Tn;
  sum_kernel<T><<<(unsigned)((rows * N + 255) / 256 + 1), 256, 0, stream>>>(
      dbp, dcp, dap, (T*)db, (T*)dc, (float*)da, rows, H, N, B * nc);
  return (int)cudaGetLastError();
}

}  // namespace bwd

// Tensor cores (bf16 x, B and C at N 128, P 64 that TMA reads in place:
// every Mamba-2 layer): chunks of tc::Q = 256 in row tiles of 64, so the
// chunk states and their gradients are a quarter of the CUDA-core build's
// and the state passes walk a quarter of the chunks.  What bounds it as
// built: latency inside the blocks (each head's tile runs product,
// elementwise, product in turn) and the scratch that passes between the
// launches (~1 GB at Mamba-2-2.7B's training shape), not the 0.052 ms of
// the bound's bytes.  Eight launches:
//  (1) the forward's chunk-state launch (tc::chunk_state_kernel, as it is):
//      s_c, the chunk's decay, and its cum (f32) and dt rows.
//  (2) r_c = sum_i exp(cum_i) C_i dy_i^T, one block per (chunk, 10 heads)
//      shaped as (1) (a producer warp's TMA loads of C and each head's dy
//      in f32, two consumer warpgroups on alternate heads, wgmma with
//      (exp(cum) o dy)^T as the register A operand and C's rows as B); the
//      chunk's cumsum of dt a in f64 as (1) takes it, kept per row in f64.
//  (3) both state passes, one thread per 4 state elements of a (batch,
//      head): the entering states hp and the leaving states' gradients g,
//      each stored as hi and lo bf16 planes that TMA brings to (4), and
//      each chunk's sum of g o hp (a value a block); dh0.
//  (4) row blocks, one per (row tile T, chunk, 8 heads x batch): per head,
//      the two state terms that share a head's state across all 128
//      columns of B and C, summed over the block's heads in ascending order
//      in registers, each warpgroup owning 64 of the N columns:
//      dC_T += (exp(cum) o dy_T) hp^T and dB_T += (w o x_T) g^T; the
//      carried-in state's share of dcum, exp(cum_i) dy_i . (C_i hp) (each
//      warpgroup its half of N); and, by the warpgroups in turn, u = B_T g,
//      whence dL/dw_j = x_j . u_j and dx's state term w_j u_j (f32, read by
//      (5)).  Each head's products in four wgmma groups, the ALU work
//      between them while they run.  Only H / 8 partials of dB and dC reach
//      HBM.
//  (5) column blocks, one per (column tile T, chunk, 8 heads x batch), the
//      longest first: C B^T_TI once for the block's heads (over C's tiles I
//      >= T, then in f32 over them), and per head (in pairs, one a
//      warpgroup; x, dy and the next pair's tiles by TMA from one producer
//      warp) and row tile I >= T: dy_I's f32 tile split into hi and lo bf16
//      tiles in place, dS^T = x_T dy_I^T, S^T, dCB^T and M^T (the causal
//      mask before the exponential on the diagonal tile; off it a decay
//      factor per row times one per column, each column's computed once),
//      dx_T += S^T dy_I from the state term, M's row sums and its
//      dt-weighted column sums (a partial per (T, I)); dCB^T summed over the
//      block's heads on chip (each pair's two, then the pairs in order),
//      one tile to HBM.
//  (6) ddt and da's share per (batch, chunk, head): dcum from those terms,
//      its reverse cumsum by a block scan in f64.
//  (7) the dCB tiles summed over the column blocks' head groups in order.
//  (8) dC_T = the row blocks' partials + sum_{J <= T} dCB_TJ B_J and dB_T =
//      theirs + sum_{I >= T} dCB_IT^T C_I (f32 on CUDA cores: 0.3 GFLOP),
//      and da over (batch, chunk) by the last block.
//  * Products on wgmma (bf16 in, f32 accumulators).  x, B and C are exact
//    in bf16.  The f32 operands (dy, S, the states and their gradients, the
//    scaled rows exp(cum) o dy and w o x) are carried as hi + lo bf16
//    pairs, and a product of two of them takes hi x hi + hi x lo + lo x hi:
//    f32 operands to ~2^-17 of themselves, sums in f32.  Each set of lo
//    halves is needed at the training shape (tests/test_torch_cuda_builds.py
//    builds this file with each set zeroed and counts the misses).
//  * Every sum runs in a fixed order, without atomics: a repeated launch is
//    bitwise equal.  Rows past T are TMA zeros with dt = 0 and the last
//    cum: they add nothing and are not written.
namespace bwd_tc {

using tc::BOX;
using tc::CONSUMERS;
using tc::HALF;
using tc::NP;
using tc::NRB;
using tc::NS;
using tc::PD;
using tc::Q;
using tc::RB;
using tc::RBLK;
using tc::THREADS;
using tc::WG;
using tc::consumers_sync;
using tc::swz;
using tc::wg_sync;

constexpr int HG3 = 10;                      // heads a state-term block (2)
constexpr int HGR = 8;                       // heads a row block (4)
constexpr int HGC = 8;                       // heads a column block (5): in pairs, one a warpgroup
constexpr int NPAIR = NRB * (NRB + 1) / 2;   // causal (column tile, row tile) pairs of a chunk
constexpr int NBLK = NP / 4 / 256;           // blocks of (3) a (batch, head)
constexpr int TILE = RB * RB;                // elements of a 64 x 64 tile

// the pair of column tile J and row tile I >= J
__host__ __device__ inline int pair_of(int J, int I) { return I * (I + 1) / 2 + J; }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }

// two adjacent bf16 elements of a tile in shared memory (4-byte aligned) in f32
__device__ __forceinline__ float2 bf2_at(const unsigned char* p) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(h), __high2float(h));
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__low2float(h), __high2float(h));
}

// S^T's pairs as register A operands: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_s(float s0, float s1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(s0, s1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(s0 - __low2float(h), s1 - __high2float(h)));
}

// the scaled rows' pairs (exp(cum) o dy, w o x) as register A operands
__device__ __forceinline__ void split_rows(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));
}

// four state elements as entries of a hi and a lo bf16 plane
__device__ __forceinline__ void split_state(const float4& v, uint2& hi, uint2& lo) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[2], l[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const __nv_bfloat162 hk = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    h[k] = bits(hk);
    l[k] = bits(__floats2bfloat162_rn(x[2 * k] - __low2float(hk), x[2 * k + 1] - __high2float(hk)));
  }
  hi = make_uint2(h[0], h[1]);
  lo = make_uint2(l[0], l[1]);
}

// D (64 x 64) += A (64 x 16, registers) . B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the k-step ks slice of a 16-register A operand
__device__ __forceinline__ void a_of(const uint32_t (&r)[16], int ks, uint32_t (&a)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) a[m] = r[4 * ks + m];
}

// the sum over the four lanes of a quad (the four threads of a row of an
// accumulator), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// byte offset of f32 element (row, col < 64) in a tile of two boxes of 32
// columns (BOX bytes apart) that TMA wrote with the 128-byte swizzle
__device__ __forceinline__ int swz32(int row, int col) {
  return (col >> 5) * BOX + row * 128 + (((((col & 31) >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// eight f32 values as a 16-byte chunk of a hi and of a lo bf16 tile
__device__ __forceinline__ void split8(const float4& a, const float4& c, uint4& hi, uint4& lo) {
  const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 hk = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    h[k] = bits(hk);
    l[k] = bits(__floats2bfloat162_rn(v[2 * k] - __low2float(hk), v[2 * k + 1] - __high2float(hk)));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// (2) shared memory: C's rows of the chunk (4 row tiles), two dy stages (a
// head's 4 row tiles in f32, two boxes of 32 columns each; warpgroup w
// takes stage w), exp(cum) of each head, the warps' scan totals and the
// heads' last cums, the barriers (C, full[2], empty[2])
struct TermSmem {
  static constexpr int C_OFF = 0;
  static constexpr int D_OFF = NRB * RBLK;
  static constexpr int D_STAGE = 2 * NRB * BOX;
  static constexpr int E_OFF = D_OFF + 2 * D_STAGE;
  static constexpr int TOT_OFF = E_OFF + HG3 * Q * 4;
  static constexpr int BAR_OFF = (TOT_OFF + (CONSUMERS / 32 + 1) * HG3 * 8 + 15) / 16 * 16;
  static constexpr int BYTES = BAR_OFF + 5 * 8 + 1024;
};

// (2) r_c and the rows' cum in f64: one block per (chunk, HG3 heads, batch)
__global__ void __launch_bounds__(THREADS, 1) rterm_kernel(
    const __grid_constant__ CUtensorMap tdy,  // dy (f32) as (P, H, T, B): boxes of (32, 1, 64, 1)
    const __grid_constant__ CUtensorMap tcm,  // C as (N, T, B): boxes of (64, 64, 1)
    const float* __restrict__ dt,             // (B, T, H)
    const float* __restrict__ a,              // (H,)
    float* __restrict__ r_out,                // (B, nc, H, N, P)
    double* __restrict__ cum_out,             // (B, nc, H, Q): rows past T repeat the last
    int Tn, int H, int nc) {
  using L = TermSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t bar_c = base + L::BAR_OFF, full = bar_c + 8, empty = full + 16;
  const int c = blockIdx.x, h_first = blockIdx.y * HG3, b = blockIdx.z;
  const int nh = min(HG3, H - h_first);
  const int t0 = c * Q, nv = min(Q, Tn - t0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_c, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, WG / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane starts every load
    if (tid == CONSUMERS) {
      sm90::mbar_expect_tx(bar_c, NRB * RBLK);
      for (int r = 0; r < NRB; ++r)
        for (int cb = 0; cb < 2; ++cb)
          sm90::tma_load_3d(base + L::C_OFF + r * RBLK + cb * BOX, &tcm, bar_c, 64 * cb, t0 + RB * r, b);
      for (int k = 0; k < nh; ++k) {
        const int s = k & 1;
        if (k >= 2) sm90::mbar_wait(empty + 8 * s, ((k >> 1) - 1) & 1);
        const uint32_t st = base + L::D_OFF + s * L::D_STAGE;
        sm90::mbar_expect_tx(full + 8 * s, L::D_STAGE);
        for (int r = 0; r < NRB; ++r)
          for (int hb = 0; hb < 2; ++hb)
            sm90::tma_load_4d(st + (2 * r + hb) * BOX, &tdy, full + 8 * s, 32 * hb, h_first + k, t0 + RB * r, b);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  float* se = reinterpret_cast<float*>(gb + L::E_OFF);        // [HG3][Q]: exp(cum) of each head
  double* tot = reinterpret_cast<double*>(gb + L::TOT_OFF);  // [8][HG3] warp totals, then [HG3] last cums
  // every head's inclusive cumsum of dt * a over the chunk, row tid here,
  // in f64, as the forward's chunk-state launch takes it
  constexpr int NW = CONSUMERS / 32;
  double cum[HG3];
#pragma unroll
  for (int k = 0; k < HG3; ++k) {
    const int hh = min(h_first + k, H - 1);
    const float dv = tid < nv ? dt[((long)b * Tn + t0 + tid) * H + hh] : 0.f;
    double inc = (double)dv * (double)a[hh];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += n;
    }
    if (lane == 31) tot[warp * HG3 + k] = inc;
    cum[k] = inc;
  }
  consumers_sync();
#pragma unroll
  for (int k = 0; k < HG3; ++k) {
    double pre = 0.0;
    for (int w = 0; w < warp; ++w) pre += tot[w * HG3 + k];
    cum[k] = pre + cum[k];
    if (tid == nv - 1) tot[NW * HG3 + k] = cum[k];
  }
  consumers_sync();
#pragma unroll
  for (int k = 0; k < HG3; ++k) {
    if (k >= nh) break;
    const long u = ((long)b * nc + c) * H + h_first + k;
    if (tid >= nv) cum[k] = tot[NW * HG3 + k];  // rows past T repeat the last cum
    se[k * Q + tid] = expf((float)cum[k]);
    cum_out[u * Q + tid] = cum[k];
  }
  consumers_sync();  // every head's exp(cum) is written
  sm90::mbar_wait(bar_c, 0);

  // warpgroup w takes heads w, w + 2, ... from stage w
  const int w = tid / WG, wt = tid % WG;
  const int prow = 16 * (wt >> 5) + (lane >> 2), jq = 2 * (lane & 3);
  for (int k = w; k < nh; k += 2) {
    const long u = ((long)b * nc + c) * H + h_first + k;
    const float* ek = se + k * Q;
    // r_c^T (P x N) = (exp(cum) o dy)^T (P x Q) . C (Q x N): A's element (p,
    // i) of k-step kq is register 4 kq + q, p = prow + 8 (q & 1), i = 16 kq +
    // 8 (q >> 1) + jq (+1 in the high half)
    sm90::mbar_wait(full + 8 * w, (k >> 1) & 1);
    const unsigned char* ds = gb + L::D_OFF + w * L::D_STAGE;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int r = 0; r < NRB; ++r) {  // 64 rows of the chunk a round: 4 k-steps
      uint32_t ah4[16], al4[16];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = prow + 8 * (q & 1), il = 16 * kq + 8 * (q >> 1) + jq;
          const unsigned char* tile = ds + 2 * r * BOX;
          const float d0 = *reinterpret_cast<const float*>(tile + swz32(il, p));
          const float d1 = *reinterpret_cast<const float*>(tile + swz32(il + 1, p));
          split_rows(ek[RB * r + il] * d0, ek[RB * r + il + 1] * d1, ah4[4 * kq + q], al4[4 * kq + q]);
        }
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const uint64_t db = sm90::desc_mnmajor(base + L::C_OFF + r * RBLK + kq * 16 * 128, BOX);
        uint32_t hi[4], lo[4];
        a_of(ah4, kq, hi);
        a_of(al4, kq, lo);
        sm90::wgmma_rs_m64n128k16(acc, hi, db);
        sm90::wgmma_rs_m64n128k16(acc, lo, db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + 8 * w);
    // acc[4 jj + 2 i + e] is row p = prow + 8 i, column n = 8 jj + jq + e of r_c^T
    float* ro = r_out + u * NP;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) ro[(8 * jj + jq + e) * PD + prow + 8 * i] = acc[4 * jj + 2 * i + e];
  }
}

// (3) the states entering the chunks (h0 folded with s_c in chunk order)
// and the gradients of the states leaving them (dh_final folded with r_c in
// descending order), each as its chunk's hi and lo bf16 planes, and each
// chunk's sum of g o hp over the block's 1,024 elements; four elements a
// thread
__global__ void __launch_bounds__(256) pass_kernel(
    const float4* __restrict__ s, const float4* __restrict__ r, const float* __restrict__ dec,
    const float4* __restrict__ h0, const float4* __restrict__ dh_final,
    uint2* __restrict__ hp,    // (B, nc, H, 2, N, P) bf16: a chunk's hi plane, then its lo plane
    uint2* __restrict__ gp,    // the same for the gradients
    float* __restrict__ ghp,   // (B, nc, H, NBLK)
    float4* __restrict__ dh0, int H, int nc) {
  constexpr int NP4 = NP / 4, PL = NP / 4;  // float4s of a state; uint2s of a plane
  __shared__ float red[2][8];
  const int e4 = blockIdx.x * 256 + threadIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + hh;
  const auto at = [&](int c) { return ((long)b * nc + c) * H + hh; };
  float4 h = h0 ? h0[bh * NP4 + e4] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const long u = at(c);
    uint2 hi, lo;
    split_state(h, hi, lo);
    hp[u * 2 * PL + e4] = hi;
    hp[u * 2 * PL + PL + e4] = lo;
    const float4 sv = s[u * NP4 + e4];
    const float d = dec[u];
    h = make_float4(d * h.x + sv.x, d * h.y + sv.y, d * h.z + sv.z, d * h.w + sv.w);
  }
  float4 g = dh_final ? dh_final[bh * NP4 + e4] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const long u = at(c);
    uint2 hi, lo;
    split_state(g, hi, lo);
    gp[u * 2 * PL + e4] = hi;
    gp[u * 2 * PL + PL + e4] = lo;
    const uint2 ph = hp[u * 2 * PL + e4], pl = hp[u * 2 * PL + PL + e4];
    const float2 h01 = bf2(ph.x), h23 = bf2(ph.y), l01 = bf2(pl.x), l23 = bf2(pl.y);
    float part = g.x * (h01.x + l01.x);
    part = fmaf(g.y, h01.y + l01.y, part);
    part = fmaf(g.z, h23.x + l23.x, part);
    part = fmaf(g.w, h23.y + l23.y, part);
    part = warp_sum(part);
    if ((threadIdx.x & 31) == 0) red[c & 1][threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int k = 0; k < 8; ++k) t += red[c & 1][k];
      ghp[u * NBLK + blockIdx.x] = t;
    }
    const float4 rv = r[u * NP4 + e4];
    const float d = dec[u];
    g = make_float4(d * g.x + rv.x, d * g.y + rv.y, d * g.z + rv.z, d * g.w + rv.w);
  }
  if (dh0) dh0[bh * NP4 + e4] = g;
}

// (4) shared memory: C's and B's row tile T, two head stages (dy's tile in
// f32, x's tile, hp's and g's hi and lo planes), each stage's cum
// (f64) and dt rows, the barriers (C and B, full[2], empty[2])
struct RowSmem {
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = RBLK;
  static constexpr int ST_OFF = 2 * RBLK;
  static constexpr int DY = 0, X = 2 * BOX, HP = 3 * BOX, G = 3 * BOX + 2 * HALF;
  static constexpr int STAGE = G + 2 * HALF;
  static constexpr int CD_OFF = ST_OFF + 2 * STAGE;
  static constexpr int CD_STAGE = Q * 8 + Q * 4;
  static constexpr int BAR_OFF = CD_OFF + 2 * CD_STAGE;
  static constexpr int BYTES = BAR_OFF + 5 * 8 + 1024;
};

// (4) row blocks: one per (row tile T, chunk, HGR heads x batch); warpgroup
// w owns columns 64 w .. 64 w + 63 of dB and dC
__global__ void __launch_bounds__(THREADS, 1) row_kernel(
    const __grid_constant__ CUtensorMap tdy,  // dy (f32) as (P, H, T, B): boxes of (32, 1, 64, 1)
    const __grid_constant__ CUtensorMap tx,   // x as (P, H, T, B): boxes of (64, 1, 64, 1)
    const __grid_constant__ CUtensorMap tb,   // B as (N, T, B): boxes of (64, 64, 1)
    const __grid_constant__ CUtensorMap tcm,  // C as (N, T, B)
    const __grid_constant__ CUtensorMap ts,   // hp's planes as (P, N, 2 B nc H): boxes of (64, 128, 1)
    const __grid_constant__ CUtensorMap tg,   // g's planes, the same
    const double* __restrict__ cum64,         // (B, nc, H, Q)
    const float* __restrict__ cd,             // (B, nc, H, 2, Q): cum (f32), then dt (0 past T)
    float* __restrict__ dxi,                  // (B, T, H, P): dx's state term w_j u_j
    float* __restrict__ dw,                   // (B, nc, H, Q): dL/dw_j
    float* __restrict__ inp,                  // (B, nc, H, 2, Q): each warpgroup's share of the carried-in term
    float* __restrict__ dbi, float* __restrict__ dci,  // (B, T, ngr, N): the heads' dB and dC state terms
    int Tn, int H, int nc) {
  using L = RowSmem;
  const int T = blockIdx.x, c = blockIdx.y;
  const int ngr = (H + HGR - 1) / HGR;
  const int gr = blockIdx.z % ngr, b = blockIdx.z / ngr;
  const int t0 = c * Q, row0 = t0 + RB * T;
  if (row0 >= Tn) return;  // a row tile past the ragged end
  const int h_first = gr * HGR, nh = min(HGR, H - h_first);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t bar_cb = base + L::BAR_OFF, full = bar_cb + 8, empty = full + 16;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_cb, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, CONSUMERS / 32);  // both warpgroups read every stage
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      sm90::mbar_expect_tx(bar_cb, 2 * RBLK);
      for (int cb = 0; cb < 2; ++cb) {
        sm90::tma_load_3d(base + L::C_OFF + cb * BOX, &tcm, bar_cb, 64 * cb, row0, b);
        sm90::tma_load_3d(base + L::B_OFF + cb * BOX, &tb, bar_cb, 64 * cb, row0, b);
      }
      for (int k = 0; k < nh; ++k) {
        const int s = k & 1, hh = h_first + k;
        if (k >= 2) sm90::mbar_wait(empty + 8 * s, ((k >> 1) - 1) & 1);
        const long u = ((long)b * nc + c) * H + hh;
        const uint32_t st = base + L::ST_OFF + s * L::STAGE, cds = base + L::CD_OFF + s * L::CD_STAGE;
        const uint32_t bar = full + 8 * s;
        sm90::mbar_expect_tx(bar, L::STAGE + L::CD_STAGE);
        sm90::tma_load_4d(st + L::DY, &tdy, bar, 0, hh, row0, b);
        sm90::tma_load_4d(st + L::DY + BOX, &tdy, bar, 32, hh, row0, b);
        sm90::tma_load_4d(st + L::X, &tx, bar, 0, hh, row0, b);
        sm90::tma_load_3d(st + L::HP, &ts, bar, 0, 0, (int)(2 * u));
        sm90::tma_load_3d(st + L::HP + HALF, &ts, bar, 0, 0, (int)(2 * u + 1));
        sm90::tma_load_3d(st + L::G, &tg, bar, 0, 0, (int)(2 * u));
        sm90::tma_load_3d(st + L::G + HALF, &tg, bar, 0, 0, (int)(2 * u + 1));
        sm90::bulk_load(cds, cum64 + u * Q, Q * 8, bar);
        sm90::bulk_load(cds + Q * 8, cd + u * 2 * Q + Q, Q * 4, bar);
      }
    }
    return;
  }

  // warpgroup w; accumulator element e of a 64 x 64 tile: row r0 + 8 ((e
  // >> 1) & 1), column 8 (e >> 2) + q2 + (e & 1)
  const int w = tid / WG, wt = tid % WG, lane = tid & 31;
  const int r0 = 16 * (wt >> 5) + (lane >> 2), q2 = 2 * (lane & 3);
  sm90::mbar_wait(bar_cb, 0);
  float acc_c[32], acc_b[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc_c[e] = acc_b[e] = 0.f;
  for (int k = 0; k < nh; ++k) {
    const int s = k & 1, hh = h_first + k;
    const long u = ((long)b * nc + c) * H + hh;
    sm90::mbar_wait(full + 8 * s, (k >> 1) & 1);
    const uint32_t st = base + L::ST_OFF + s * L::STAGE;
    const unsigned char* sp = gb + L::ST_OFF + s * L::STAGE;
    const double* cum = reinterpret_cast<const double*>(gb + L::CD_OFF + s * L::CD_STAGE);
    const float* dtv = reinterpret_cast<const float*>(cum + Q);
    const double last = cum[Q - 1];
    float ein[2], wv[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int i = RB * T + r0 + 8 * ii;
      ein[ii] = expf((float)cum[i]);
      wv[ii] = expf((float)(last - cum[i])) * dtv[i];
    }
    // dy's and x's elements (row, p) and (row, p + 1), p even: one read
    const auto dy2 = [&](int row, int p) { return *reinterpret_cast<const float2*>(sp + L::DY + swz32(row, p)); };
    const auto x2 = [&](int row, int p) { return bf2_at(sp + L::X + swz(row, p)); };
    // Each head in four wgmma groups, the ALU work between them while they
    // run: (a) C_T[:, half w] hp[half w, :] (hi and lo), the carried-in
    // state's share of dcum; (b) dC_T += (exp(cum) o dy_T) hp^T over this
    // warpgroup's 64 columns; (c) dB_T += (w o x_T) g^T; (d) by the
    // warpgroups in turn, u = B_T g, whence dL/dw_j = x_j . u_j and dx's
    // state term w_j u_j.  A's element (row, p) of k-step ks is register
    // 4 ks + m, row r0 + 8 (m & 1), p = 16 ks + 8 (m >> 1) + q2 (+1 high).
    float acc3[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc3[e] = 0.f;
    sm90::fence_operands(acc3);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = sm90::desc_kmajor(base + L::C_OFF + w * BOX + ks * 32);
      const uint32_t rows = (64 * w + 16 * ks) * 128;
      sm90::wgmma_ss_m64n64k16_bmn(acc3, da, sm90::desc_mnmajor(st + L::HP + rows, BOX));
      sm90::wgmma_ss_m64n64k16_bmn(acc3, da, sm90::desc_mnmajor(st + L::HP + HALF + rows, BOX));
    }
    sm90::wgmma_commit();  // (a)
    uint32_t fh[16], fl[16];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 v = dy2(r0 + 8 * (m & 1), 16 * ks + 8 * (m >> 1) + q2);
        split_rows(ein[m & 1] * v.x, ein[m & 1] * v.y, fh[4 * ks + m], fl[4 * ks + m]);
      }
    sm90::fence_operands(acc_c);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t off = w * BOX + ks * 32;  // rows 64 w .. of the planes, K = p
      const uint64_t hph = sm90::desc_kmajor(st + L::HP + off), hpl = sm90::desc_kmajor(st + L::HP + HALF + off);
      uint32_t ah[4], al[4];
      a_of(fh, ks, ah);
      a_of(fl, ks, al);
      wgmma_rs_kb(acc_c, ah, hph);
      wgmma_rs_kb(acc_c, ah, hpl);
      wgmma_rs_kb(acc_c, al, hph);
    }
    sm90::wgmma_commit();  // (b)
    sm90::wgmma_wait<1>();
    sm90::fence_operands(acc3);
    {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float2 v = dy2(r0 + 8 * ii, 8 * jj + q2);
          part[ii] = fmaf(v.x, acc3[4 * jj + 2 * ii], part[ii]);
          part[ii] = fmaf(v.y, acc3[4 * jj + 2 * ii + 1], part[ii]);
        }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float v = quad_sum(part[ii]);
        if ((lane & 3) == 0) inp[(u * 2 + w) * Q + RB * T + r0 + 8 * ii] = ein[ii] * v;
      }
    }
    uint32_t gh[16], gl[16];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 v = x2(r0 + 8 * (m & 1), 16 * ks + 8 * (m >> 1) + q2);
        split_rows(wv[m & 1] * v.x, wv[m & 1] * v.y, gh[4 * ks + m], gl[4 * ks + m]);
      }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc_c);
    sm90::fence_operands(fh);
    sm90::fence_operands(fl);
    sm90::fence_operands(acc_b);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t off = w * BOX + ks * 32;
      const uint64_t gph = sm90::desc_kmajor(st + L::G + off), gpl = sm90::desc_kmajor(st + L::G + HALF + off);
      uint32_t bh[4], bl[4];
      a_of(gh, ks, bh);
      a_of(gl, ks, bl);
      wgmma_rs_kb(acc_b, bh, gph);
      wgmma_rs_kb(acc_b, bh, gpl);
      wgmma_rs_kb(acc_b, bl, gph);
    }
    sm90::wgmma_commit();  // (c)
    if ((k & 1) == w) {
      float acc4[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc4[e] = 0.f;
      sm90::fence_operands(acc4);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NS / 16; ++ks) {
        const uint64_t da = sm90::desc_kmajor(base + L::B_OFF + (ks >> 2) * BOX + (ks & 3) * 32);
        sm90::wgmma_ss_m64n64k16_bmn(acc4, da, sm90::desc_mnmajor(st + L::G + ks * 16 * 128, BOX));
        sm90::wgmma_ss_m64n64k16_bmn(acc4, da, sm90::desc_mnmajor(st + L::G + HALF + ks * 16 * 128, BOX));
      }
      sm90::wgmma_commit();  // (d)
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc4);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float2 v = x2(r0 + 8 * ii, 8 * jj + q2);
          part[ii] = fmaf(v.x, acc4[4 * jj + 2 * ii], part[ii]);
          part[ii] = fmaf(v.y, acc4[4 * jj + 2 * ii + 1], part[ii]);
        }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float v = quad_sum(part[ii]);
        if ((lane & 3) == 0) dw[u * Q + RB * T + r0 + 8 * ii] = v;
        const int t = row0 + r0 + 8 * ii;
        if (t >= Tn) continue;
        float* o = dxi + (((long)b * Tn + t) * H + hh) * PD;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<float2*>(o + 8 * jj + q2) =
              make_float2(wv[ii] * acc4[4 * jj + 2 * ii], wv[ii] * acc4[4 * jj + 2 * ii + 1]);
      }
    } else {
      sm90::wgmma_wait<0>();
    }
    sm90::fence_operands(acc_b);
    sm90::fence_operands(gh);
    sm90::fence_operands(gl);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + 8 * s);
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int t = row0 + r0 + 8 * ii;
    if (t >= Tn) continue;
    const long o = (((long)b * Tn + t) * ngr + gr) * NS + 64 * w;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int e = 4 * jj + 2 * ii;
      *reinterpret_cast<float2*>(dci + o + 8 * jj + q2) = make_float2(acc_c[e], acc_c[e + 1]);
      *reinterpret_cast<float2*>(dbi + o + 8 * jj + q2) = make_float2(acc_b[e], acc_b[e + 1]);
    }
  }
}

// (5) a thread's share of tile (T, I): S^T = C B^T o E o dt_j, dCB^T = dS^T
// o E o dt_j and M^T = dS^T o C B^T o E from dS^T (`ds`, replaced by dCB^T)
// and C B^T (`cbt`, the register order of a warpgroup's thread); S^T as hi
// and lo A operands, M's row sums into csum and its dt-weighted column sums
// over the thread's two rows into colp.  Off the diagonal tile E = cfh[i]
// rh[j] (a factor per column and one per row); on it E = exp((cfh[i] -
// rh[j]) + (cfl[i] - rl[j])), cum less the tile's first row's carried as hi
// + lo f32 so that the difference is exact to f32 rounding of itself, and
// the mask applied before the exponential.
template <bool DIAG>
__device__ __forceinline__ void col_tile(float (&ds)[32], const float4* cbt, const float* cfh, const float* cfl,
                                         const float (&rh)[2], const float (&rl)[2], const float (&dtj)[2], int wt,
                                         int r0, int q2, uint32_t (&sh)[16], uint32_t (&sl)[16], float (&csum)[2],
                                         float (&colp)[16]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const float4 c4 = cbt[v * WG + wt];
    const float cbv[4] = {c4.x, c4.y, c4.z, c4.w};
    float sv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // element 4 v + q: row r0 + 8 ii, column il
      const int ii = q >> 1, il = 8 * v + q2 + (q & 1), k2 = 2 * v + (q & 1);
      float E;
      if constexpr (DIAG)
        E = il >= r0 + 8 * ii ? __expf((cfh[il] - rh[ii]) + (cfl[il] - rl[ii])) : 0.f;
      else
        E = cfh[il] * rh[ii];
      const float dsv = ds[4 * v + q], ed = E * dtj[ii], mv = dsv * cbv[q] * E;
      sv[q] = cbv[q] * ed;
      ds[4 * v + q] = dsv * ed;
      csum[ii] += mv;
      colp[k2] = ii == 0 ? mv * dtj[0] : fmaf(mv, dtj[1], colp[k2]);
    }
    split_s(sv[0], sv[1], sh[2 * v], sl[2 * v]);
    split_s(sv[2], sv[3], sh[2 * v + 1], sl[2 * v + 1]);
  }
}

// (5) shared memory: B's row tile T, C's row tiles I >= T (then C B^T_TI in
// f32 over them, in the register order of a warpgroup's thread), per
// warpgroup two x tiles (its heads of two pairs in turn) and two dy slots
// (a tile in f32 from TMA, then its hi and lo bf16 tiles in place),
// warpgroup 1's dCB^T (in its threads' order), per warpgroup and x tile its
// head's cum (f64) and dt rows, per warpgroup its warps' column sums and
// the tile's column factors (hi, lo), the barriers (B and C; per
// warpgroup x full[2] and empty[2], dy full[2] and empty[2])
struct ColSmem {
  static constexpr int B_OFF = 0;
  static constexpr int CB_OFF = RBLK;
  static constexpr int W_OFF = CB_OFF + NRB * RBLK;
  static constexpr int X = 0, DYS = 2 * BOX, W_BYTES = 2 * BOX + 2 * 2 * BOX;
  static constexpr int XCH_OFF = W_OFF + 2 * W_BYTES;
  static constexpr int CD_OFF = XCH_OFF + TILE * 4;
  static constexpr int CD_BYTES = Q * 8 + Q * 4;
  static constexpr int RED_OFF = CD_OFF + 4 * CD_BYTES;
  static constexpr int COLF_OFF = RED_OFF + 2 * 4 * RB * 4;
  static constexpr int BAR_OFF = COLF_OFF + 2 * 2 * RB * 4;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * 8) * 8 + 1024;
};

// (5) column blocks: one per (column tile T, chunk, HGC heads x batch); the
// heads in pairs, warpgroup w taking head 2 k + w of pair k
__global__ void __launch_bounds__(THREADS, 1) col_kernel(
    const __grid_constant__ CUtensorMap tdy,  // dy (f32) as (P, H, T, B): boxes of (32, 1, 64, 1)
    const __grid_constant__ CUtensorMap tx,   // x as (P, H, T, B)
    const __grid_constant__ CUtensorMap tb,   // B as (N, T, B): boxes of (64, 64, 1)
    const __grid_constant__ CUtensorMap tcm,  // C as (N, T, B)
    const double* __restrict__ cum64,         // (B, nc, H, Q)
    const float* __restrict__ cd,             // (B, nc, H, 2, Q)
    const float* __restrict__ dxi,            // (B, T, H, P): dx's state term
    __nv_bfloat16* __restrict__ dx,           // (B, T, H, P)
    float* __restrict__ cs,                   // (B, nc, H, Q): sum_i M_ij
    float* __restrict__ rsp,                  // (B, nc, H, NRB, Q): sum_{j in T} M_ij dt_j
    float* __restrict__ dcbg,                 // (B, nc, ngc, NPAIR, 64, 64): dCB^T over the block's heads
    int Tn, int H, int nc) {
  using L = ColSmem;
  const int T = blockIdx.x, c = blockIdx.y;  // T = 0 (four row tiles) first
  const int ngc = (H + HGC - 1) / HGC;
  const int gc = blockIdx.z % ngc, b = blockIdx.z / ngc;
  const int t0 = c * Q, row0 = t0 + RB * T;
  if (row0 >= Tn) return;  // a column tile past the ragged end
  const int h_first = gc * HGC, nh = min(HGC, H - h_first), npair = (nh + 1) / 2, ntile = NRB - T;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t bar_cb = base + L::BAR_OFF;
  // per warpgroup w: x full[2], x empty[2], dy full[2], dy empty[2]
  const auto xfull = [&](int w, int s) { return bar_cb + 8 + 64 * w + 8 * s; };
  const auto xempty = [&](int w, int s) { return bar_cb + 24 + 64 * w + 8 * s; };
  const auto full = [&](int w, int s) { return bar_cb + 40 + 64 * w + 8 * s; };
  const auto empty = [&](int w, int s) { return bar_cb + 56 + 64 * w + 8 * s; };
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_cb, 1);
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < 2; ++s) {
        sm90::mbar_init(xfull(w, s), 1);
        sm90::mbar_init(xempty(w, s), WG / 32);
        sm90::mbar_init(full(w, s), 1);
        sm90::mbar_init(empty(w, s), WG / 32);
      }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane starts every load
    if (tid == CONSUMERS) {
      sm90::mbar_expect_tx(bar_cb, (1 + ntile) * RBLK);
      for (int cb = 0; cb < 2; ++cb) sm90::tma_load_3d(base + L::B_OFF + cb * BOX, &tb, bar_cb, 64 * cb, row0, b);
      for (int I = T; I < NRB; ++I)
        for (int cb = 0; cb < 2; ++cb)
          sm90::tma_load_3d(base + L::CB_OFF + I * RBLK + cb * BOX, &tcm, bar_cb, 64 * cb, t0 + RB * I, b);
      for (int k = 0; k < npair; ++k) {
        const int xs = k & 1;
        for (int w = 0; w < 2 && 2 * k + w < nh; ++w) {
          const int hh = h_first + 2 * k + w;
          const long u = ((long)b * nc + c) * H + hh;
          const uint32_t cds = base + L::CD_OFF + (2 * w + xs) * L::CD_BYTES;
          if (k >= 2) sm90::mbar_wait(xempty(w, xs), ((k >> 1) - 1) & 1);
          sm90::mbar_expect_tx(xfull(w, xs), BOX + L::CD_BYTES);
          sm90::tma_load_4d(base + L::W_OFF + w * L::W_BYTES + L::X + xs * BOX, &tx, xfull(w, xs), 0, hh, row0, b);
          sm90::bulk_load(cds, cum64 + u * Q, Q * 8, xfull(w, xs));
          sm90::bulk_load(cds + Q * 8, cd + u * 2 * Q + Q, Q * 4, xfull(w, xs));
        }
        for (int n = 0; n < ntile; ++n) {
          const int m = k * ntile + n, s = m & 1, I = T + n;
          for (int w = 0; w < 2 && 2 * k + w < nh; ++w) {
            if (m >= 2) sm90::mbar_wait(empty(w, s), ((m >> 1) - 1) & 1);
            const uint32_t dst = base + L::W_OFF + w * L::W_BYTES + L::DYS + s * 2 * BOX;
            sm90::mbar_expect_tx(full(w, s), 2 * BOX);
            sm90::tma_load_4d(dst, &tdy, full(w, s), 0, h_first + 2 * k + w, t0 + RB * I, b);
            sm90::tma_load_4d(dst + BOX, &tdy, full(w, s), 32, h_first + 2 * k + w, t0 + RB * I, b);
          }
        }
      }
    }
    return;
  }

  const int w = tid / WG, wt = tid % WG, lane = tid & 31;
  const int r0 = 16 * (wt >> 5) + (lane >> 2), q2 = 2 * (lane & 3);
  sm90::mbar_wait(bar_cb, 0);
  // C B^T_TI = B_T C_I^T, once for the block's heads (warpgroup w takes I =
  // T + w, T + w + 2, ...): f32 over C_I, in the register order of a
  // warpgroup's thread (a thread of either warpgroup reads back the
  // elements its own index holds)
  for (int I = T + w; I < NRB; I += 2) {
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
    sm90::fence_operands(sacc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      sm90::wgmma_ss_m64n64k16(sacc, sm90::desc_kmajor(base + L::B_OFF + off),
                               sm90::desc_kmajor(base + L::CB_OFF + I * RBLK + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sacc);
    wg_sync(w);  // every warp of this warpgroup is done reading C_I
    float4* sj = reinterpret_cast<float4*>(gb + L::CB_OFF + I * RBLK);
#pragma unroll
    for (int v = 0; v < 8; ++v)
      sj[v * WG + wt] = make_float4(sacc[4 * v], sacc[4 * v + 1], sacc[4 * v + 2], sacc[4 * v + 3]);
  }
  consumers_sync();  // every C B^T_TI is written

  float* red = reinterpret_cast<float*>(gb + L::RED_OFF) + w * 4 * RB;  // [4 warps][64 columns]
  float* cfh = reinterpret_cast<float*>(gb + L::COLF_OFF) + w * 2 * RB;  // [64] the tile's column factors
  float* cfl = cfh + RB;                                                 // [64] and their lo halves
  float4* xch = reinterpret_cast<float4*>(gb + L::XCH_OFF);
  for (int k = 0; k < npair; ++k) {
    const int xs = k & 1, hh = h_first + 2 * k + w;
    const bool mine = 2 * k + w < nh, pair = 2 * k + 1 < nh;
    const long u = ((long)b * nc + c) * H + hh;
    const uint32_t xa = base + L::W_OFF + w * L::W_BYTES + L::X + xs * BOX;
    const double* cum = reinterpret_cast<const double*>(gb + L::CD_OFF + (2 * w + xs) * L::CD_BYTES);
    const float* dtv = reinterpret_cast<const float*>(cum + Q);
    double cj[2] = {0.0, 0.0};
    float dtj[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
    float acc[32];  // dx_T: the state term from the row blocks, then S^T dy_I for each I
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    if (mine) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int t = row0 + r0 + 8 * ii;
        if (t >= Tn) continue;
        const float* o = dxi + (((long)b * Tn + t) * H + hh) * PD;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 v = *reinterpret_cast<const float2*>(o + 8 * jj + q2);
          acc[4 * jj + 2 * ii] = v.x;
          acc[4 * jj + 2 * ii + 1] = v.y;
        }
      }
      sm90::mbar_wait(xfull(w, xs), (k >> 1) & 1);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        cj[ii] = cum[RB * T + r0 + 8 * ii];
        dtj[ii] = dtv[RB * T + r0 + 8 * ii];
      }
    }
    for (int n = 0; n < ntile; ++n) {
      const int m = k * ntile + n, s = m & 1, I = T + n;
      float ds[32];  // dS^T_TI (rows j of T, columns i of I), then dCB^T_TI
      uint32_t sh[16], sl[16];
      if (mine) {
        sm90::mbar_wait(full(w, s), (m >> 1) & 1);
        const uint32_t dya = base + L::W_OFF + w * L::W_BYTES + L::DYS + s * 2 * BOX;
        {  // dy_I's tile as hi and lo bf16 tiles over its f32 boxes: each thread
           // reads its half row (a box's row), then writes its 4 chunks of each
          unsigned char* tile = gb + L::W_OFF + w * L::W_BYTES + L::DYS + s * 2 * BOX;
          const int r = wt >> 1, hb = wt & 1;
          float4 v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = *reinterpret_cast<const float4*>(tile + hb * BOX + r * 128 + ((j ^ (r & 7)) << 4));
          wg_sync(w);
          if (wt < RB) {  // the tile's column factors, once a column
            const double d = cum[RB * I + wt] - cum[RB * I];
            cfh[wt] = I == T ? (float)d : __expf((float)d);
            cfl[wt] = I == T ? (float)(d - (double)cfh[wt]) : 0.f;
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint4 hi4, lo4;
            split8(v[2 * jj], v[2 * jj + 1], hi4, lo4);
            const int off = r * 128 + (((4 * hb + jj) ^ (r & 7)) << 4);
            *reinterpret_cast<uint4*>(tile + off) = hi4;
            *reinterpret_cast<uint4*>(tile + BOX + off) = lo4;
          }
          sm90::fence_proxy_async();  // the tiles are read by wgmma next
          wg_sync(w);
        }
        // dS^T_TI = x_T dy_I^T, dy's hi and lo tiles
#pragma unroll
        for (int e = 0; e < 32; ++e) ds[e] = 0.f;
        sm90::fence_operands(ds);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t da = sm90::desc_kmajor(xa + ks * 32);
          sm90::wgmma_ss_m64n64k16(ds, da, sm90::desc_kmajor(dya + ks * 32), 1);
          sm90::wgmma_ss_m64n64k16(ds, da, sm90::desc_kmajor(dya + BOX + ks * 32), 1);
        }
        sm90::wgmma_commit();
        // while it runs: the rows' factors.  Off the diagonal tile
        // exp(cum_i - cum_j) = exp(cum_i - cum_r) exp(cum_r - cum_j) at I's
        // first row r (both exponents <= 0): a factor per column (cfh) and
        // one per row (rh); on it cum_j - cum_r as hi + lo
        float rh[2], rl[2];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const double d = cj[ii] - cum[RB * I];
          rh[ii] = I == T ? (float)d : __expf((float)-d);
          rl[ii] = I == T ? (float)(d - (double)rh[ii]) : 0.f;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_operands(ds);
        const float4* cbt = reinterpret_cast<const float4*>(gb + L::CB_OFF + I * RBLK);
        float colp[16];
        if (I == T)
          col_tile<true>(ds, cbt, cfh, cfl, rh, rl, dtj, wt, r0, q2, sh, sl, csum, colp);
        else
          col_tile<false>(ds, cbt, cfh, cfl, rh, rl, dtj, wt, r0, q2, sh, sl, csum, colp);
        // dx_T += S^T_TI dy_I: hi x hi, hi x lo, lo x hi
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t dbh = sm90::desc_mnmajor(dya + ks * 16 * 128, BOX);
          const uint64_t dbl = sm90::desc_mnmajor(dya + BOX + ks * 16 * 128, BOX);
          uint32_t hi[4], lo[4];
          a_of(sh, ks, hi);
          a_of(sl, ks, lo);
          sm90::wgmma_rs_m64n64k16(acc, hi, dbh);
          sm90::wgmma_rs_m64n64k16(acc, hi, dbl);
          sm90::wgmma_rs_m64n64k16(acc, lo, dbh);
        }
        sm90::wgmma_commit();
        // while it runs: the column sums of M^T dt_j over the warp's 16 rows
        // (the lanes of equal lane & 3), then over the warpgroup's 4 warps
#pragma unroll
        for (int k2 = 0; k2 < 16; ++k2) {
          float v = colp[k2];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          colp[k2] = v;
        }
        if (lane < 4)
#pragma unroll
          for (int k2 = 0; k2 < 16; ++k2) red[(wt >> 5) * RB + 8 * (k2 >> 1) + 2 * lane + (k2 & 1)] = colp[k2];
        if (w == 1)
#pragma unroll
          for (int v = 0; v < 8; ++v)
            xch[v * WG + wt] = make_float4(ds[4 * v], ds[4 * v + 1], ds[4 * v + 2], ds[4 * v + 3]);
      }
      consumers_sync();  // red and warpgroup 1's dCB^T are written
      if (mine) {
        if (wt < RB)
          rsp[(u * NRB + T) * Q + RB * I + wt] = red[wt] + red[RB + wt] + red[2 * RB + wt] + red[3 * RB + wt];
        if (w == 0) {  // dCB^T over the block's heads: the pairs' sums in order, each pair's heads in order
          float* o = dcbg + ((((long)b * nc + c) * ngc + gc) * NPAIR + pair_of(T, I)) * TILE;
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const float4 x4 = pair ? xch[v * WG + wt] : make_float4(0.f, 0.f, 0.f, 0.f);
            const float other[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int q = 0; q < 4; q += 2) {
              const int e = 4 * v + q, ii = (e >> 1) & 1, il = 8 * (e >> 2) + q2;
              float2* p = reinterpret_cast<float2*>(o + (r0 + 8 * ii) * RB + il);
              float2 sum = make_float2(ds[e] + other[q], ds[e + 1] + other[q + 1]);
              if (k > 0) {  // this thread wrote these elements for the pairs before
                const float2 prev = *p;
                sum = make_float2(prev.x + sum.x, prev.y + sum.y);
              }
              *p = sum;
            }
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_operands(acc);
        sm90::fence_operands(sh);
        sm90::fence_operands(sl);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty(w, s));  // the dy slot is read
      }
      consumers_sync();  // red and the exchange are free
    }
    if (!mine) continue;
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(xempty(w, xs));  // x and the rows are read
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const float v = quad_sum(csum[ii]);
      if ((lane & 3) == 0) cs[u * Q + RB * T + r0 + 8 * ii] = v;
      const int t = row0 + r0 + 8 * ii;
      if (t >= Tn) continue;
      __nv_bfloat16* o = dx + (((long)b * Tn + t) * H + hh) * PD;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * jj + q2) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * ii], acc[4 * jj + 2 * ii + 1]);
    }
  }
}

// a block's sum of one value a thread, in a fixed tree (warp butterflies,
// then the warps' sums in order); every thread gets it
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int k = 0; k < Q / 32; ++k) t += red[k];
  __syncthreads();
  return t;
}

// (6) ddt and da's share of a (batch, chunk, head): a thread a row
__global__ void __launch_bounds__(Q) ddt_kernel(
    const double* __restrict__ cum64, const float* __restrict__ cd, const float* __restrict__ cs,
    const float* __restrict__ rsp, const float* __restrict__ inp, const float* __restrict__ dw,
    const float* __restrict__ ghp, const float* __restrict__ a, float* __restrict__ ddt, float* __restrict__ dap,
    int Tn, int H, int nc) {
  __shared__ double red[Q / 32];
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z, i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const long u = ((long)b * nc + c) * H + hh;
  const int nv = min(Q, Tn - c * Q);
  const double cm = cum64[u * Q + i], last = cum64[u * Q + Q - 1];
  const float dti = cd[u * 2 * Q + Q + i];
  const float wx = expf((float)(last - cm)), wi = wx * dti;
  float csv = 0.f, rs = 0.f, in = 0.f, dwv = 0.f;
  if (i < nv) {
    csv = cs[u * Q + i];
    for (int T = 0; T <= i / RB; ++T) rs += rsp[(u * NRB + T) * Q + i];
    in = inp[(u * 2) * Q + i] + inp[(u * 2 + 1) * Q + i];
    dwv = dw[u * Q + i];
  }
  float dcum = rs - dti * csv + in - wi * dwv;
  float gh = 0.f;
  for (int k = 0; k < NBLK; ++k) gh += ghp[u * NBLK + k];
  const float dlast = (float)block_sum((double)(wi * dwv), red) + expf((float)last) * gh;
  if (i == nv - 1) dcum += dlast;
  // the reverse cumsum of dcum over the chunk's rows: within each warp from
  // its last lane, then the later warps' totals in order
  double v = dcum;
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += n;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  for (int k = warp + 1; k < Q / 32; ++k) v += red[k];
  __syncthreads();
  const float dl = (float)v;
  if (i < nv) ddt[((long)b * Tn + c * Q + i) * H + hh] = csv + wx * dwv + dl * a[hh];
  const double da = block_sum((double)dl * (double)dti, red);
  if (i == 0) dap[u] = (float)da;
}

// (7) the dCB tiles over the column blocks' head groups in order, four
// elements a thread; a pair whose column tile is past the ragged end was
// never written
__global__ void __launch_bounds__(256) dcb_sum_kernel(const float4* __restrict__ dcbg, float4* __restrict__ dcb,
                                                      long long n4, int ngc, int nc, int Tn) {
  constexpr int T4 = TILE / 4;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= n4) return;
  const long long bc = e / (NPAIR * T4);
  const int pr = (int)(e / T4 % NPAIR), k = (int)(e % T4);
  int I = 0;
  while (pair_of(0, I + 1) <= pr) ++I;
  if ((int)(bc % nc) * Q + RB * (pr - pair_of(0, I)) >= Tn) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < ngc; ++g) {
    const float4 v = dcbg[((bc * ngc + g) * NPAIR + pr) * T4 + k];
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  dcb[(bc * NPAIR + pr) * T4 + k] = s;
}

// (8) dB and dC of row tile T, 32 of N's columns a block (a thread: one
// column, every eighth row), in f32 on CUDA cores; da over (batch, chunk)
// in order by the last block
__global__ void __launch_bounds__(256) out_kernel(
    const float* __restrict__ dcb, const float* __restrict__ dbi, const float* __restrict__ dci,
    const __nv_bfloat16* __restrict__ bm, long long b_sb, long long b_st, const __nv_bfloat16* __restrict__ cm,
    long long c_sb, long long c_st, const float* __restrict__ dap, __nv_bfloat16* __restrict__ db,
    __nv_bfloat16* __restrict__ dc, float* __restrict__ da, int Tn, int H, int nc, int ngr, int nbc) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float s = 0.f;
      for (int k = 0; k < nbc; ++k) s += dap[(long long)k * H + hh];
      da[hh] = s;
    }
    return;
  }
  __shared__ float sd[RB][RB + 1];  // a dCB tile: [j][i]
  __shared__ float sv[RB][32];      // 64 rows of B or C, this block's 32 columns
  const int nq = blockIdx.x % 4, T = blockIdx.x / 4 % NRB, c = blockIdx.x / (4 * NRB) % nc;
  const int b = blockIdx.x / (4 * NRB * nc);
  const int t0 = c * Q, row0 = t0 + RB * T;
  if (row0 >= Tn) return;
  const int col = threadIdx.x % 32, rg = threadIdx.x / 32, n = 32 * nq + col;
  float oc[8], ob[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) oc[k] = ob[k] = 0.f;
  for (int g = 0; g < ngr; ++g)  // the row blocks' state terms, over their head groups in order
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = row0 + rg + 8 * k;
      if (t >= Tn) continue;
      const long o = (((long)b * Tn + t) * ngr + g) * NS + n;
      oc[k] += dci[o];
      ob[k] += dbi[o];
    }
  const float* dcb_c = dcb + (long)(b * nc + c) * NPAIR * TILE;
  // stage tile (J, I) of dCB and 64 rows of `src` from row `rows` on
  const auto stage = [&](int J, int I, const __nv_bfloat16* src, long long sb, long long st, int rows) {
    __syncthreads();
    const float* tl = dcb_c + pair_of(J, I) * TILE;
    for (int e = threadIdx.x; e < TILE; e += 256) sd[e / RB][e % RB] = tl[e];
    for (int e = threadIdx.x; e < RB * 32; e += 256) {
      const int rr = e / 32, k = e % 32, tt = rows + rr;
      sv[rr][k] = tt < Tn ? __bfloat162float(src[b * sb + (long long)tt * st + 32 * nq + k]) : 0.f;
    }
    __syncthreads();
  };
  // dC_T += sum_{J <= T} dCB_TJ B_J: tile (J, T) holds [j][i], i in T
  for (int J = 0; J <= T; ++J) {
    stage(J, T, bm, b_sb, b_st, t0 + RB * J);
    for (int j = 0; j < RB; ++j) {
      const float bv = sv[j][col];
#pragma unroll
      for (int k = 0; k < 8; ++k) oc[k] = fmaf(sd[j][rg + 8 * k], bv, oc[k]);
    }
  }
  // dB_T += sum_{I >= T} dCB_IT^T C_I: tile (T, I) holds [j][i], j in T
  for (int I = T; I < NRB && t0 + RB * I < Tn; ++I) {
    stage(T, I, cm, c_sb, c_st, t0 + RB * I);
    for (int i = 0; i < RB; ++i) {
      const float cv = sv[i][col];
#pragma unroll
      for (int k = 0; k < 8; ++k) ob[k] = fmaf(sd[rg + 8 * k][i], cv, ob[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int t = row0 + rg + 8 * k;
    if (t >= Tn) continue;
    const long o = ((long)b * Tn + t) * NS + n;
    dc[o] = __float2bfloat16(oc[k]);
    db[o] = __float2bfloat16(ob[k]);
  }
}

// An f32 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1) with boxes of `box` elements, 128-byte swizzle (a box's
// inner dim 32 floats), and zeros outside the tensor.  False if it cannot
// be made.
inline bool f32_tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                           const cuuint64_t* strides, const cuuint32_t* box) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32 elements of each scratch region, in order (ops.bwd_scratch_floats
// mirrors it); every region starts 256-byte aligned
struct Scratch {
  static constexpr int NREG = 18;
  long long n[NREG];
  Scratch(int B, int Tn, int H) {
    const long long nc = (Tn + Q - 1) / Q, u = B * nc * H, bthp = (long long)B * Tn * H * PD;
    const long long ngr = (H + HGR - 1) / HGR, ngc = (H + HGC - 1) / HGC;
    const long long sizes[NREG] = {u * NP,     u * 2 * Q,   u,           u * NP,      2 * u * Q,
                                   u * NP,     u * NP,      u * NBLK,    bthp,        u * Q,
                                   2 * u * Q,  u * Q,       NRB * u * Q, B * nc * ngc * NPAIR * TILE,
                                   B * nc * NPAIR * TILE,   (long long)B * Tn * ngr * NS, (long long)B * Tn * ngr * NS,
                                   B * nc * H};
    for (int k = 0; k < NREG; ++k) n[k] = (sizes[k] + 63) / 64 * 64;
  }
  float* at(void* scratch, int k) const {
    long long off = 0;
    for (int j = 0; j < k; ++j) off += n[j];
    return reinterpret_cast<float*>(scratch) + off;
  }
};
enum { S_S, S_CD, S_DEC, S_R, S_CUM, S_HP, S_G, S_GHP, S_DXI, S_DW, S_IN, S_CS, S_RS, S_DCBG, S_DCB, S_DBI, S_DCI,
       S_DAP };

int launch(const void* x, long long x_sb, long long x_st, const void* dt, const void* a, const void* bm,
           long long b_sb, long long b_st, const void* cm, long long c_sb, long long c_st, const void* dy,
           const void* dh_final, const void* h0, void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
           void* scratch, int B, int Tn, int H, cudaStream_t stream) {
  const int nc = (Tn + Q - 1) / Q;
  const int ngr = (H + HGR - 1) / HGR, ngc = (H + HGC - 1) / HGC;
  const long long u = (long long)B * nc * H;
  const Scratch sc(B, Tn, H);
  float* s_buf = sc.at(scratch, S_S);
  float* cdv = sc.at(scratch, S_CD);
  float* dec = sc.at(scratch, S_DEC);
  float* r_buf = sc.at(scratch, S_R);
  double* cum64 = reinterpret_cast<double*>(sc.at(scratch, S_CUM));
  __nv_bfloat16* hps = reinterpret_cast<__nv_bfloat16*>(sc.at(scratch, S_HP));
  __nv_bfloat16* gps = reinterpret_cast<__nv_bfloat16*>(sc.at(scratch, S_G));
  float* ghp = sc.at(scratch, S_GHP);
  float* dxi = sc.at(scratch, S_DXI);
  float* dwv = sc.at(scratch, S_DW);
  float* inp = sc.at(scratch, S_IN);
  float* csv = sc.at(scratch, S_CS);
  float* rsp = sc.at(scratch, S_RS);
  float* dcbg = sc.at(scratch, S_DCBG);
  float* dcb = sc.at(scratch, S_DCB);
  float* dbi = sc.at(scratch, S_DBI);
  float* dci = sc.at(scratch, S_DCI);
  float* dap = sc.at(scratch, S_DAP);
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t xdims[4] = {(cuuint64_t)PD, (cuuint64_t)H, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {PD * e, (cuuint64_t)x_st * e, (cuuint64_t)x_sb * e};
  const cuuint64_t f = sizeof(float);
  const cuuint64_t dstr[3] = {PD * f, (cuuint64_t)H * PD * f, (cuuint64_t)Tn * H * PD * f};
  const cuuint32_t dbox[4] = {32, 1, RB, 1};
  const cuuint32_t xbox[4] = {64, 1, RB, 1};
  const cuuint64_t ndims[3] = {(cuuint64_t)NS, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t bstr[2] = {(cuuint64_t)b_st * e, (cuuint64_t)b_sb * e};
  const cuuint64_t cstr[2] = {(cuuint64_t)c_st * e, (cuuint64_t)c_sb * e};
  const cuuint32_t nbox[3] = {64, RB, 1};
  const cuuint64_t sdims[3] = {(cuuint64_t)PD, (cuuint64_t)NS, (cuuint64_t)(2 * u)};
  const cuuint64_t sstr[2] = {PD * e, (cuuint64_t)NP * e};
  const cuuint32_t sbox[3] = {64, NS, 1};
  CUtensorMap tx, tb, tcm, tdy, ts, tg;
  if (!sm90::bf16_tensor_map(&tx, x, 4, xdims, xstr, xbox) || !sm90::bf16_tensor_map(&tb, bm, 3, ndims, bstr, nbox) ||
      !sm90::bf16_tensor_map(&tcm, cm, 3, ndims, cstr, nbox) ||
      !f32_tensor_map(&tdy, dy, 4, xdims, dstr, dbox) ||
      !sm90::bf16_tensor_map(&ts, hps, 3, sdims, sstr, sbox) || !sm90::bf16_tensor_map(&tg, gps, 3, sdims, sstr, sbox))
    return (int)cudaErrorInvalidValue;
  // the opt-ins above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted[4] = {
      cudaFuncSetAttribute(tc::chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::StateSmem::BYTES),
      cudaFuncSetAttribute(rterm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TermSmem::BYTES),
      cudaFuncSetAttribute(row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RowSmem::BYTES),
      cudaFuncSetAttribute(col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ColSmem::BYTES)};
  for (cudaError_t o : opted)
    if (o != cudaSuccess) return (int)o;
  cudaError_t err;
  tc::chunk_state_kernel<<<dim3(nc, (H + tc::HG1 - 1) / tc::HG1, B), THREADS, tc::StateSmem::BYTES, stream>>>(
      tx, tb, (const float*)dt, (const float*)a, s_buf, cdv, dec, Tn, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rterm_kernel<<<dim3(nc, (H + HG3 - 1) / HG3, B), THREADS, TermSmem::BYTES, stream>>>(
      tdy, tcm, (const float*)dt, (const float*)a, r_buf, cum64, Tn, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pass_kernel<<<dim3(NBLK, H, B), 256, 0, stream>>>((const float4*)s_buf, (const float4*)r_buf, dec,
                                                    (const float4*)h0, (const float4*)dh_final, (uint2*)hps,
                                                    (uint2*)gps, ghp, (float4*)dh0, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  row_kernel<<<dim3(NRB, nc, ngr * B), THREADS, RowSmem::BYTES, stream>>>(
      tdy, tx, tb, tcm, ts, tg, cum64, cdv, dxi, dwv, inp, dbi, dci, Tn, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  col_kernel<<<dim3(NRB, nc, ngc * B), THREADS, ColSmem::BYTES, stream>>>(
      tdy, tx, tb, tcm, cum64, cdv, dxi, (__nv_bfloat16*)dx, csv, rsp, dcbg, Tn, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ddt_kernel<<<dim3(nc, H, B), Q, 0, stream>>>(cum64, cdv, csv, rsp, inp, dwv, ghp, (const float*)a, (float*)ddt,
                                               dap, Tn, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long m4 = (long long)B * nc * NPAIR * TILE / 4;
  dcb_sum_kernel<<<(unsigned)((m4 + 255) / 256), 256, 0, stream>>>((const float4*)dcbg, (float4*)dcb, m4, ngc, nc,
                                                                  Tn);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  out_kernel<<<(unsigned)(4 * NRB * nc * B + 1), 256, 0, stream>>>(
      dcb, dbi, dci, (const __nv_bfloat16*)bm, b_sb, b_st, (const __nv_bfloat16*)cm, c_sb, c_st, dap,
      (__nv_bfloat16*)db, (__nv_bfloat16*)dc, (float*)da, Tn, H, nc, ngr, B * nc);
  return (int)cudaGetLastError();
}

}  // namespace bwd_tc

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
    return bwd::launch<T>(x, x_sb, x_st, dt, a, bm, b_sb, b_st, cm, c_sb, c_st, dy, dh_final, h0, dx, ddt, da, db,
                          dc, dh0, scratch, B, Tn, H, N, P, (cudaStream_t)stream);
  });
  return (int)cudaErrorInvalidValue;
}

// The backward's tensor-core build: bf16 x, B and C at N 128, P 64 as
// repro_ssd_scan_tc takes them (TMA reads them in place: unit inner strides,
// x's head stride 64, batch and time strides multiples of 8 elements,
// 16-byte-aligned bases), the rest as repro_ssd_scan_bwd takes it (dy, h0,
// dh_final and dh0 16-byte aligned).  scratch: f32, 256-byte aligned, as
// ops.bwd_scratch_floats counts it (bwd_tc::Scratch) at nc = ceil(T / 256),
// its contents on entry unused.  Eight launches.
extern "C" int repro_ssd_scan_bwd_tc(const void* x, long long x_sb, long long x_st, const void* dt, const void* a,
                                     const void* bm, long long b_sb, long long b_st, const void* cm, long long c_sb,
                                     long long c_st, const void* dy, const void* dh_final, const void* h0, void* dx,
                                     void* ddt, void* da, void* db, void* dc, void* dh0, void* scratch, int B, int Tn,
                                     int H, int N, int P, void* stream) {
  const long long strides[6] = {x_sb, x_st, b_sb, b_st, c_sb, c_st};
  const void* bases[5] = {x, bm, cm, dy, scratch};
  if (B <= 0 || Tn <= 0 || H <= 0 || H > 65535 || N != tc::NS || P != tc::PD ||
      (long long)B * ((H + bwd_tc::HGC - 1) / bwd_tc::HGC) > 65535)
    return (int)cudaErrorInvalidValue;
  for (long long st : strides)
    if (st <= 0 || st % 8 != 0) return (int)cudaErrorInvalidValue;
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 256 != 0) return (int)cudaErrorInvalidValue;
  return bwd_tc::launch(x, x_sb, x_st, dt, a, bm, b_sb, b_st, cm, c_sb, c_st, dy, dh_final, h0, dx, ddt, da, db, dc,
                        dh0, scratch, B, Tn, H, (cudaStream_t)stream);
}

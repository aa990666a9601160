// Kernel 7's backward: the gradients of blocked causal / local-window GQA
// attention with respect to q, k and v.
//
// Replaces: no TPU kernel.  The reference trains through jnp attention
// (layers.blockwise_attention under jax.value_and_grad); none of its Pallas
// kernels has a VJP.  The port's training forward runs kernel 7
// (flash_attention.cu, its LSE instantiations), so the gradient the
// reference takes by autodiff is computed here, by hand.
//
// What it computes: q, dO (B, Sq, nq, hd), k, v (B, Skv, nkv, hd), O the
// forward's output and lse (B, Sq, nq) its f32 row log-sum-exps; query head
// h reads KV head h // G; query position i sees key j iff j < Skv and
// (causal) j <= i and (window > 0) i - j < window.  With s = scale q.k and
// P = exp(s - lse), D = rowsum(dO o O), dS = P o (dO.v - D):
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
// dK and dV summed over the G query heads of each KV head.  Inputs f32 or
// bf16, every sum in f32, outputs in the inputs' type.
//
// What bounds it on the card: operations.  StarCoder2-3B's layer (24 q / 2
// kv heads of 128, 2,048 causal tokens, batch 4) has 2.1 M visible pairs a
// head, 5 products of 2 * hd FLOPs a pair: ~2.6e11 FLOPs against ~0.3 GB.
//
// Two builds, chosen by the wrapper from dtype and hd alone
// (ops.flash_attention_bwd_path):
//
// Tensor cores (repro_flash_attention_bwd_tc; bf16 at hd 64, 96, 128, 160
// and 256: every registered arch that trains).  wgmma (bf16 in, f32 out)
// from 128-byte-swizzled tiles that TMA brings into a two-stage ring
// completing on mbarriers, as kernel 7's forward (flash_attention.cu).  Four
// launches, no atomics, every sum in a fixed order (a repeat is bitwise
// equal):
//  1. D = rowsum(dO o O) and lse * log2(e), written per (sequence, head)
//     over positions padded to a multiple of 64, so the next launch takes a
//     step's values in one bulk copy.
//  2. dK, dV: one block per (query head, 64 keys, sequence), so 2 kv heads
//     still give nq x Skv / 64 x B blocks (3,072 for StarCoder2-3B at
//     batch 4) and the longest causal walk is Sq / 64 steps of one head,
//     not of the whole group.  The keys are the M rows of every product:
//     S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and dS^T on
//     the accumulator registers, then dV += P^T dO and dK += dS^T Q with
//     P^T and dS^T as register A operands and Q, dO read MN-major (as V in
//     the forward's P.V).  Query steps wholly outside the causal band or
//     the window are never loaded.  Each head's partial dK and dV go to an
//     f32 scratch (B, Skv, nq, hd).  At hd <= 160 one warpgroup a block
//     holds dK and dV, hd f32 registers a thread, so at hd 160 a step is 32
//     positions (S^T, dP^T 16 registers each), else 64; ptxas: 178 / 210 /
//     246 / 225 registers at hd 64 / 96 / 128 / 160, no spills.  At hd 256
//     (RecurrentGemma-2B) dK and dV would be 256 registers, above the 255 a
//     thread holds, and wgmma's M is 64 rows, so the 64 keys cannot be
//     halved instead: a block is two warpgroups over the same keys and the
//     same Q / dO stages, one keeping dV (S^T, P^T, dV), one dK (S^T,
//     dP^T, dS^T, dK), each in 128 registers; S^T is computed twice
//     (ptxas: 230 registers, no spills).  Two launches of one warpgroup
//     each, one keeping dV and one dK, read every Q / dO tile twice and
//     took 1.35x as long (tools/fa_bwd_variants.py).
//  3. dK, dV of each kv head: its G partials summed in ascending head
//     order, cast to bf16.
//  4. dQ: the forward's rows (64 (position, head) rows of one kv head's
//     group a block, so each K/V tile feeds the whole group), walking the
//     key tiles the rows see: S = Q K^T, dP = dO V^T, dS on the
//     registers, dQ += dS K with dS as the A operand and K read MN-major.
//     At hd 256 a step is 32 keys (dQ holds 128 registers, S and dP 16
//     each) and a block is two warpgroups over consecutive rows, which
//     share each K/V stage (ptxas: 249 registers, no spills); else 64 keys
//     and one warpgroup.
//  In 2 and 4 a step whose (key, position) pairs are all visible skips the
//  mask: at hd 256 the mask's integer work on every step took 1.6x as long.
//  bf16 P and dS alone would carry 2^-9 of each into dV, dK and dQ, past
//  row 7's bf16 gate where gradients cancel (tests/test_torch_cuda_builds.py
//  builds this file with the lo halves zeroed and counts the misses), so
//  both go into their products as hi = bf16(x) and lo = bf16(x - hi)
//  (split_pair): 10 products a (key, position) pair where 5 would do (11
//  at hd 256).
//  What still bounds it: each warpgroup runs its products, the
//  exponentials and the splits one after another (each wgmma waited on),
//  and S and dP are computed in both passes; at hd 256 the products run at
//  ~50-60 % of the tensor cores' rate.
//
// CUDA cores (repro_flash_attention_bwd; f32 at every hd, bf16 at 16 and
// 32).  Three launches, no atomics, every sum in a fixed order:
//  1. D = rowsum(dO o O): one warp a (position, head) row.
//  2. dK, dV: one block per (tile of 32 keys, kv head, sequence).  It walks
//     the query positions that can see the tile, ascending, 64 (position,
//     head) rows of the group at a time (rows as in the forward).  Step 1:
//     each warp owns 8 rows and lane j key j, and computes s and dO.v for
//     them (float4 reads of padded rows), P and dS into shared memory.
//     Step 2: warp w owns keys 4w .. 4w + 3, lane l dims l + 32 jj, and
//     adds P^T dO and dS^T Q over the 64 rows into registers.
//  3. dQ: one block per (tile of 64 / G query positions, kv head,
//     sequence), rows as in the forward (the group's heads share each K/V
//     tile), walking the key tiles the rows can see, ascending: s and dO.v
//     as in 2, then dQ += dS K with dS broadcast by warp shuffles and the
//     dims spread over the lanes (the forward's P.V).  Tiles are taken
//     last-first, the causal band's longest rows first.
// Q, dO, K and V tiles are kept in f32 in padded shared-memory rows: at hd
// 256 a block holds ~216 KB, so the launches opt in above 48 KB.  This
// build recomputes S and dP in both passes (7 products) on CUDA cores in
// f32 (67 TFLOP/s).
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 8;                 // (query, head) rows per warp
constexpr int MAX_ROWS = WARPS * RPW;  // 64 rows per block
constexpr int BK = 32;                 // keys per tile: one per lane
constexpr int KPW = BK / WARPS;        // keys per warp in the dK/dV sums

template <int HD>
__host__ __device__ constexpr int padded() { return HD + 4; }  // 16-byte aligned, conflict-free float4 rows

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO o O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) row_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                                          float* __restrict__ D, long rows, int hd) {
  const long r = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += to_f32(o[r * hd + d]) * to_f32(dout[r * hd + d]);
  s = warp_sum(s);
  if (lane == 0) D[r] = s;
}

// rows [0, nrows) of a tile: (query position p0 + r / G, head kvh * G + r % G),
// copied to f32 shared memory with row stride QS
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int nrows, int G, int p0, int b, int Sq, int nq,
                                          int kvh) {
  constexpr int QS = padded<HD>();
  for (int i = threadIdx.x; i < nrows * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    dst[r * QS + d] = to_f32(src[(((long)b * Sq + p0 + r / G) * nq + (long)kvh * G + r % G) * HD + d]);
  }
}

// keys [k0, k0 + nk) of KV head kvh, f32 with row stride QS
template <typename T, int HD>
__device__ __forceinline__ void load_keys(float* dst, const T* src, int nk, int k0, int b, int Skv, int nkv,
                                          int kvh) {
  constexpr int QS = padded<HD>();
  for (int i = threadIdx.x; i < nk * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    dst[r * QS + d] = to_f32(src[(((long)b * Skv + k0 + r) * nkv + kvh) * HD + d]);
  }
}

// s[i] = q_i . k_lane and dp[i] = dO_i . v_lane for the warp's 8 rows
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* dos, const float* ks, const float* vs,
                                       float s[RPW], float dp[RPW]) {
  constexpr int QS = padded<HD>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
  const float4* kr = reinterpret_cast<const float4*>(ks + lane * QS);
  const float4* vr = reinterpret_cast<const float4*>(vs + lane * QS);
  const float4* qw = reinterpret_cast<const float4*>(qs + warp * RPW * QS);
  const float4* dw = reinterpret_cast<const float4*>(dos + warp * RPW * QS);
#pragma unroll 2
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 k4 = kr[d4], v4 = vr[d4];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float4 q4 = qw[i * (QS / 4) + d4], g4 = dw[i * (QS / 4) + d4];
      s[i] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
      dp[i] += g4.x * v4.x + g4.y * v4.y + g4.z * v4.z + g4.w * v4.w;
    }
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// 2. dK, dV
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * (size_t)BK * padded<HD>() + 2 * (size_t)MAX_ROWS * padded<HD>() +
                          2 * (size_t)MAX_ROWS * BK + 2 * (size_t)MAX_ROWS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int Sq,
    int Skv, int nq, int nkv, int causal, int window, float scale) {
  constexpr int QS = padded<HD>();
  constexpr int NJ = (HD + 31) / 32;  // dims per lane
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = nq / nkv, BQ = MAX_ROWS / G;
  const int k0 = blockIdx.x * BK, nk = min(BK, Skv - k0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // BK * QS
  float* vs = ks + BK * QS;            // BK * QS
  float* qs = vs + BK * QS;            // MAX_ROWS * QS
  float* dos = qs + MAX_ROWS * QS;     // MAX_ROWS * QS
  float* ps = dos + MAX_ROWS * QS;     // MAX_ROWS * BK: P
  float* dss = ps + MAX_ROWS * BK;     // MAX_ROWS * BK: dS
  float* lse_s = dss + MAX_ROWS * BK;  // MAX_ROWS
  float* d_s = lse_s + MAX_ROWS;       // MAX_ROWS

  load_keys<T, HD>(ks, k, nk, k0, b, Skv, nkv, kvh);
  load_keys<T, HD>(vs, v, nk, k0, b, Skv, nkv, kvh);
  float acc_k[KPW][NJ], acc_v[KPW][NJ];
#pragma unroll
  for (int j = 0; j < KPW; ++j)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc_k[j][jj] = acc_v[j][jj] = 0.f;

  // the query positions that see a key of the tile
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
  for (int p0 = q_begin; p0 < q_end; p0 += BQ) {
    const int npos = min(BQ, q_end - p0), nrows = npos * G;
    __syncthreads();  // the previous rows' sums are done with qs, dos, ps, dss
    load_rows<T, HD>(qs, q, nrows, G, p0, b, Sq, nq, kvh);
    load_rows<T, HD>(dos, dout, nrows, G, p0, b, Sq, nq, kvh);
    for (int r = tid; r < nrows; r += THREADS) {
      const long row = ((long)b * Sq + p0 + r / G) * nq + (long)kvh * G + r % G;
      lse_s[r] = lse[row];
      d_s[r] = D[row];
    }
    __syncthreads();
    // step 1: P and dS of the warp's rows against key k0 + lane
    float s[RPW], dp[RPW];
    scores<HD>(qs, dos, ks, vs, s, dp);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const bool ok = r < nrows && lane < nk && visible(p0 + r / G, k0 + lane, causal, window);
      const float p = ok ? expf(s[i] * scale - lse_s[r]) : 0.f;
      ps[r * BK + lane] = p;
      dss[r * BK + lane] = ok ? p * (dp[i] - d_s[r]) : 0.f;
    }
    __syncthreads();
    // step 2: dV += P^T dO, dK += dS^T Q over the rows, in ascending order
    for (int r = 0; r < nrows; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + r * BK + warp * KPW);
      const float4 s4 = *reinterpret_cast<const float4*>(dss + r * BK + warp * KPW);
      const float pj[KPW] = {p4.x, p4.y, p4.z, p4.w};
      const float sj[KPW] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = lane + 32 * jj;
        if (d < HD) {
          const float g = dos[r * QS + d], x = qs[r * QS + d];
#pragma unroll
          for (int j = 0; j < KPW; ++j) {
            acc_v[j][jj] += pj[j] * g;
            acc_k[j][jj] += sj[j] * x;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int key = warp * KPW + j;
    if (key >= nk) continue;
    const long off = (((long)b * Skv + k0 + key) * nkv + kvh) * HD;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = lane + 32 * jj;
      if (d < HD) {
        dk[off + d] = from_f32<T>(acc_k[j][jj] * scale);
        dv[off + d] = from_f32<T>(acc_v[j][jj]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (size_t)MAX_ROWS * padded<HD>() + 2 * (size_t)BK * padded<HD>());
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D, T* __restrict__ dq, int Sq, int Skv, int nq,
    int nkv, int causal, int window, float scale) {
  constexpr int QS = padded<HD>();
  constexpr int NJ = (HD + 31) / 32;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = nq / nkv, BQ = MAX_ROWS / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int npos = min(BQ, Sq - q0), nrows = npos * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // MAX_ROWS * QS
  float* dos = qs + MAX_ROWS * QS;   // MAX_ROWS * QS
  float* ks = dos + MAX_ROWS * QS;   // BK * QS
  float* vs = ks + BK * QS;          // BK * QS

  load_rows<T, HD>(qs, q, nrows, G, q0, b, Sq, nq, kvh);
  load_rows<T, HD>(dos, dout, nrows, G, q0, b, Sq, nq, kvh);
  int qpos[RPW];
  bool live[RPW];
  float lse_r[RPW], d_r[RPW], acc[RPW][NJ];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    live[i] = r < nrows;
    qpos[i] = q0 + (live[i] ? r / G : 0);
    const long row = ((long)b * Sq + qpos[i]) * nq + (long)kvh * G + (live[i] ? r % G : 0);
    lse_r[i] = live[i] ? lse[row] : 0.f;
    d_r[i] = live[i] ? D[row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }
  const int q_last = q0 + npos - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    __syncthreads();  // the previous tile's products are done with ks, vs
    load_keys<T, HD>(ks, k, nk, k0, b, Skv, nkv, kvh);
    load_keys<T, HD>(vs, v, nk, k0, b, Skv, nkv, kvh);
    __syncthreads();
    float s[RPW], dp[RPW];
    scores<HD>(qs, dos, ks, vs, s, dp);  // lanes past nk read a stale row and are masked
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok = live[i] && lane < nk && visible(qpos[i], k0 + lane, causal, window);
      s[i] = ok ? expf(s[i] * scale - lse_r[i]) * (dp[i] - d_r[i]) : 0.f;  // dS
    }
    // dQ += dS K: dS of key j for row i sits in lane j
    for (int j = 0; j < nk; ++j) {
      float kj[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = lane + 32 * jj;
        kj[jj] = d < HD ? ks[j * QS + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float sj = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] += sj * kj[jj];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!live[i]) continue;
    const int g = (warp * RPW + i) % G;
    T* o = dq + (((long)b * Sq + qpos[i]) * nq + (long)kvh * G + g) * HD;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = lane + 32 * jj;
      if (d < HD) o[d] = from_f32<T>(acc[i][jj] * scale);
    }
  }
}

template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse, float* D,
           void* dq, void* dk, void* dv, int B, int Sq, int Skv, int nq, int nkv, int causal, int window,
           float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long rows = (long)B * Sq * nq;
  row_dot_kernel<T><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, st>>>((const T*)o, (const T*)dout, D,
                                                                                 rows, HD);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if ((e = opt_in(dkv_kernel<T, HD>, dkv_smem<HD>()))) return e;
  dkv_kernel<T, HD><<<dim3((Skv + BK - 1) / BK, nkv, B), THREADS, dkv_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, D, (T*)dk, (T*)dv, Sq, Skv, nq, nkv, causal,
      window, scale);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = opt_in(dq_kernel<T, HD>, dq_smem<HD>()))) return e;
  const int BQ = MAX_ROWS / (nq / nkv);
  dq_kernel<T, HD><<<dim3((Sq + BQ - 1) / BQ, nkv, B), THREADS, dq_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, D, (T*)dq, Sq, Skv, nq, nkv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* D, void* dq, void* dk, void* dv, int B, int Sq, int Skv, int nq, int nkv, int causal, int window,
              float scale, void* stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
  }
  if constexpr (std::is_same_v<T, float>) {  // bf16 at wider head dims takes repro_flash_attention_bwd_tc
    switch (hd) {
      case 64:
        return launch<T, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 96:
        return launch<T, 96>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 128:
        return launch<T, 128>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 160:
        return launch<T, 160>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 256:
        return launch<T, 256>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the tensor-core build (bf16 at hd 64, 96, 128, 160 and 256)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int THREADS = 128;                  // one warpgroup
constexpr int BK = 64;                        // keys a tile
constexpr int ROWS = 64;                      // (position, head) rows a dQ block
constexpr int BOX = 64 * 128;                 // bytes of a box of 64 rows x 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

// f32 -> hi = bf16(x) and lo = bf16(x - hi), two values packed a register:
// hi + lo carries x to ~2^-17 into an A operand, where bf16 alone would
// carry 2^-9 of every P and dS into dV, dK and dQ
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// D (64 x HD) += A (64 x 16, registers) . B (16 x HD, shared, MN-major)
template <int HD>
__device__ __forceinline__ void mma_rs(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) {
    sm90::wgmma_rs_m64n64k16(d, a, db);
  } else if constexpr (HD == 96) {
    sm90::wgmma_rs_m64n96k16(d, a, db);
  } else if constexpr (HD == 128) {
    sm90::wgmma_rs_m64n128k16(d, a, db);
  } else if constexpr (HD == 160) {
    sm90::wgmma_rs_m64n160k16(d, a, db);
  } else {
    static_assert(HD == 256, "the tensor-core backward's head dims: 64, 96, 128, 160, 256");
    sm90::wgmma_rs_m64n256k16(d, a, db);
  }
}

// 1. D = rowsum(dO o O) as row_dot_kernel sums it, and lse in base 2, both
// written per (sequence, head) over positions padded to Sp (a multiple of
// 64; the tail D 0, lse +inf), so a step's values are one contiguous copy
__global__ void __launch_bounds__(256) bwd_prep_tc_kernel(const __nv_bfloat16* __restrict__ o,
                                                          const __nv_bfloat16* __restrict__ dout,
                                                          const float* __restrict__ lse, float* __restrict__ lse2,
                                                          float* __restrict__ dsum, long rows, int Sq, int Sp,
                                                          int nq, int hd) {
  const long r = (long)blockIdx.x * 8 + (threadIdx.x >> 5);  // ((b * nq + h) * Sp + p)
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int p = (int)(r % Sp), h = (int)((r / Sp) % nq);
  const long b = r / ((long)Sp * nq);
  float s = 0.f, l = __int_as_float(0x7f800000);
  if (p < Sq) {
    const long row = (b * Sq + p) * nq + h;
    for (int d = lane; d < hd; d += 32) s += to_f32(o[row * hd + d]) * to_f32(dout[row * hd + d]);
    s = warp_sum(s);
    l = lse[row] * LOG2E;
  }
  if (lane == 0) {
    lse2[r] = l;
    dsum[r] = s;
  }
}

// S^T = K Q^T (N = 64 or 32 positions) and its like from shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    sm90::wgmma_ss_m64n64k16(d, da, db, scale_d);
  } else {
    static_assert(N == 32, "steps of 64 or 32 columns");
    sm90::wgmma_ss_m64n32k16(d, da, db, scale_d);
  }
}

// 2. dK, dV.  Shared memory: K and V (ceil(hd / 64) boxes of 64 keys each),
// then two stages of Q, dO (boxes of BQ positions), lse2 and D (BQ floats
// each), then the mbarriers (K/V, stage 0, stage 1); 1,024-byte aligned by
// hand.  BQ, the query positions of a step, is 64, or 32 at hd 160, where dK
// and dV alone hold 160 f32 registers a thread.
//
// What a warpgroup keeps: dV, dK or both.  At hd <= 160 one warpgroup a
// block keeps both (hd f32 registers a thread).  At hd 256 both would be 256
// registers, above the 255 a thread can hold, so a block is two warpgroups
// over the same keys and the same Q / dO stages (SPLIT): warpgroup 0 keeps dV
// (S^T, P^T, dV += P^T dO), warpgroup 1 dK (S^T, dP^T, dS^T, dK += dS^T Q),
// each in 128 registers; S^T is computed by both, 6 products a pair where 5
// would do, before the lo halves.
constexpr int SPLIT = 0, KEEP_DV = 1, KEEP_DK = 2, KEEP_BOTH = KEEP_DV | KEEP_DK;

template <int HD>
struct Dkv {
  static constexpr int ROLES = HD > 160 ? SPLIT : KEEP_BOTH;
  static constexpr int KB = (HD + 63) / 64;
  static constexpr int BQ = HD == 160 ? 32 : 64;
  static constexpr int QBOX = BQ * 128;
  static constexpr int ROWV = BQ * 4;
  static constexpr int KV = 2 * KB * BOX;
  static constexpr int STAGE = (2 * KB * QBOX + 2 * ROWV + 1023) / 1024 * 1024;
  static constexpr int BAR = KV + 2 * STAGE;
  static constexpr int BYTES = BAR + 3 * 8 + 1024;
};

// One block per (query head, key tile of 64, sequence): the keys are the M
// rows of every product.  It walks the query positions that see the tile,
// BQ at a time, ascending: S^T = K Q^T and dP^T = V dO^T from shared memory,
// P^T = exp2(S^T scale log2(e) - lse2) and dS^T = P^T o (dP^T - D) on the
// accumulators, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
// register A operands (hi + lo) and dO and Q read MN-major.  The head's
// partial dK (times scale) and dV go to f32 scratch (B, Skv, nq, hd).  A
// warpgroup computes only what the accumulators it keeps (ROLES) need.
template <int HD, int ROLES>
__global__ void __launch_bounds__(ROLES == SPLIT ? 2 * THREADS : THREADS) dkv_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse2,
    const float* __restrict__ dsum, float* __restrict__ dkp, float* __restrict__ dvp, int Sq, int Sp, int Skv,
    int nq, int nkv, int causal, int window, float scale_log2, float scale) {
  using L = Dkv<HD>;
  constexpr int BQ = L::BQ, NS = BQ / 2, NO = HD / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::BAR;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BK;  // under a causal mask the first tiles walk the most positions: they start first
  const int kvh = h / (nq / nkv);
  const int nk = min(BK, Skv - k0);
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window) : Sq;
  const int nsteps = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;

  // thread 0 fills stage it & 1 with step it's positions
  auto load_q = [&](int it) {
    const int st = it & 1, p0 = q_begin + it * BQ;
    const uint32_t bar = bars + 8 * (1 + st);
    const uint32_t sq = base + L::KV + st * L::STAGE, sdo = sq + L::KB * L::QBOX, srow = sdo + L::KB * L::QBOX;
    sm90::mbar_expect_tx(bar, 2 * L::KB * L::QBOX + 2 * L::ROWV);
    for (int kb = 0; kb < L::KB; ++kb) {
      sm90::tma_load_4d(sq + kb * L::QBOX, &tq, bar, kb * 64, h, p0, b);
      sm90::tma_load_4d(sdo + kb * L::QBOX, &tdo, bar, kb * 64, h, p0, b);
    }
    const long row = ((long)b * nq + h) * Sp + p0;
    sm90::bulk_load(srow, lse2 + row, L::ROWV, bar);
    sm90::bulk_load(srow + L::ROWV, dsum + row, L::ROWV, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && nsteps > 0) {
    sm90::mbar_expect_tx(bars, 2 * L::KB * BOX);
    for (int kb = 0; kb < L::KB; ++kb) {
      sm90::tma_load_4d(base + kb * BOX, &tk, bars, kb * 64, kvh, k0, b);
      sm90::tma_load_4d(base + (L::KB + kb) * BOX, &tv, bars, kb * 64, kvh, k0, b);
    }
    load_q(0);
  }
  __syncwarp();

  // this thread's keys (accumulator rows) r0 and r0 + 8; its query columns
  // in each group of 8: cq, cq + 1
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  if (nsteps > 0) sm90::mbar_wait(bars, 0);

  // the walk of a warpgroup that keeps KEEP (one instantiation a role)
  auto walk = [&](auto keep) {
    constexpr int KEEP = decltype(keep)::value;
    constexpr bool V = KEEP & KEEP_DV, K = KEEP & KEEP_DK;
    float dv[V ? NO : 1], dk[K ? NO : 1];
    if constexpr (V) {
#pragma unroll
      for (int j = 0; j < NO; ++j) dv[j] = 0.f;
    }
    if constexpr (K) {
#pragma unroll
      for (int j = 0; j < NO; ++j) dk[j] = 0.f;
    }

    for (int it = 0; it < nsteps; ++it) {
      const int st = it & 1, p0 = q_begin + it * BQ;
      if (tid == 0 && it + 1 < nsteps) load_q(it + 1);  // its stage was released at the end of it - 1
      __syncwarp();
      sm90::mbar_wait(bars + 8 * (1 + st), (it >> 1) & 1);
      const uint32_t sq = base + L::KV + st * L::STAGE, sdo = sq + L::KB * L::QBOX;
      const float* lrow = reinterpret_cast<const float*>(gbase + L::KV + st * L::STAGE + 2 * L::KB * L::QBOX);
      const float* drow = lrow + BQ;

      // S^T = K Q^T and dP^T = V dO^T: hd / 16 steps of k16 each
      float s[NS], dp[K ? NS : 1];
#pragma unroll
      for (int e = 0; e < NS; ++e) s[e] = 0.f;
      sm90::fence_operands(s);
      if constexpr (K) {
#pragma unroll
        for (int e = 0; e < NS; ++e) dp[e] = 0.f;
        sm90::fence_operands(dp);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t ko = (kk >> 2) * BOX + (kk & 3) * 32, qo = (kk >> 2) * L::QBOX + (kk & 3) * 32;
        mma_ss<BQ>(s, sm90::desc_kmajor(base + ko), sm90::desc_kmajor(sq + qo), kk > 0);
        if constexpr (K)
          mma_ss<BQ>(dp, sm90::desc_kmajor(base + L::KB * BOX + ko), sm90::desc_kmajor(sdo + qo), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      if constexpr (K) sm90::fence_operands(dp);

      // s[e] is key r0 + 8 ((e >> 1) & 1), position p0 + 8 (e >> 2) + cq + (e & 1);
      // a step whose pairs are all visible takes no mask
      auto probs = [&](auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const int kj = key[(e >> 1) & 1], c = 8 * (e >> 2) + cq + (e & 1), qpos = p0 + c;
          const bool ok = !MASKED || (kj < Skv && qpos < Sq && visible(qpos, kj, causal, window));
          const float p = ok ? exp2f(s[e] * scale_log2 - lrow[c]) : 0.f;
          s[e] = p;
          if constexpr (K) dp[e] = p * (dp[e] - drow[c]);
        }
      };
      const bool inside = p0 + BQ <= Sq && k0 + BK <= Skv && (!causal || k0 + BK - 1 <= p0) &&
                          (window <= 0 || p0 + BQ - 1 - k0 < window);
      if (inside)
        probs(std::false_type{});
      else
        probs(std::true_type{});
      uint32_t ph[V ? NS / 2 : 1], pl[V ? NS / 2 : 1], sh[K ? NS / 2 : 1], sl[K ? NS / 2 : 1];
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) {
        if constexpr (V) split_pair(s[2 * x], s[2 * x + 1], ph[x], pl[x]);
        if constexpr (K) split_pair(dp[2 * x], dp[2 * x + 1], sh[x], sl[x]);
      }

      // dV += P^T dO, dK += dS^T Q: BQ / 16 steps of k16 over the positions
      if constexpr (V) sm90::fence_operands(dv);
      if constexpr (K) sm90::fence_operands(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        if constexpr (V) {
          const uint64_t ddo = sm90::desc_mnmajor(sdo + ks * 16 * 128, L::QBOX);
          const uint32_t a0[4] = {ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2], ph[4 * ks + 3]};
          const uint32_t a1[4] = {pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2], pl[4 * ks + 3]};
          mma_rs<HD>(dv, a0, ddo);
          mma_rs<HD>(dv, a1, ddo);
        }
        if constexpr (K) {
          const uint64_t dq = sm90::desc_mnmajor(sq + ks * 16 * 128, L::QBOX);
          const uint32_t a2[4] = {sh[4 * ks], sh[4 * ks + 1], sh[4 * ks + 2], sh[4 * ks + 3]};
          const uint32_t a3[4] = {sl[4 * ks], sl[4 * ks + 1], sl[4 * ks + 2], sl[4 * ks + 3]};
          mma_rs<HD>(dk, a2, dq);
          mma_rs<HD>(dk, a3, dq);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      if constexpr (V) sm90::fence_operands(dv);
      if constexpr (K) sm90::fence_operands(dk);
      // every warp (of both warpgroups) is done with this stage before it is
      // refilled: bar.sync, which the two roles reach from their own code
      asm volatile("bar.sync 0;\n" ::: "memory");
    }

    // dk[4 j + 2 i + c] is key r0 + 8 i, column 8 j + cq + c
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= Skv) continue;
      const long off = (((long)b * Skv + key[i]) * nq + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if constexpr (K)
          *reinterpret_cast<float2*>(dkp + off + 8 * j + cq) =
              make_float2(dk[4 * j + 2 * i] * scale, dk[4 * j + 2 * i + 1] * scale);
        if constexpr (V)
          *reinterpret_cast<float2*>(dvp + off + 8 * j + cq) = make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  };
  if constexpr (ROLES == SPLIT) {
    if (tid < THREADS)
      walk(std::integral_constant<int, KEEP_DV>{});
    else
      walk(std::integral_constant<int, KEEP_DK>{});
  } else {
    walk(std::integral_constant<int, ROLES>{});
  }
}

// 3. dK, dV of each kv head: the G partials of its query heads summed in
// ascending head order, four columns a thread
__global__ void __launch_bounds__(256) dkv_reduce_kernel(const float4* __restrict__ dkp,
                                                         const float4* __restrict__ dvp, __nv_bfloat16* __restrict__ dk,
                                                         __nv_bfloat16* __restrict__ dv, long n4, int G, int hd4) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;  // ((b * Skv + j) * nkv + kvh) * hd / 4 + d4
  if (i >= n4) return;
  const long row = i / hd4;
  const long src = row * G * hd4 + (i - row * hd4);  // ((b * Skv + j) * nq + kvh * G) * hd / 4 + d4
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int g = 0; g < G; ++g) {
    const float4 x = dkp[src + (long)g * hd4], y = dvp[src + (long)g * hd4];
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + 4 * i);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + 4 * i);
  k2[0] = __floats2bfloat162_rn(a.x, a.y);
  k2[1] = __floats2bfloat162_rn(a.z, a.w);
  v2[0] = __floats2bfloat162_rn(c.x, c.y);
  v2[1] = __floats2bfloat162_rn(c.z, c.w);
}

// 4. dQ.  Shared memory: each warpgroup's Q and dO (the forward's rows: 64
// (position, head) rows of one kv head's group), then two stages of K and V
// (BK keys each), then the mbarriers (Q/dO, stage 0, stage 1).  At hd 256 a
// step is 32 keys (dQ alone holds 128 f32 registers a thread; S and dP at 64
// keys would add 64) and a block is two warpgroups over consecutive rows,
// which share each K/V stage; else 64 keys and one warpgroup.
template <int HD>
struct Dq {
  static constexpr int WG = HD > 160 ? 2 : 1;
  static constexpr int KB = (HD + 63) / 64;
  static constexpr int BK = HD > 160 ? 32 : 64;
  static constexpr int KBOX = BK * 128;
  static constexpr int QD = 2 * KB * BOX;  // a warpgroup's Q and dO
  static constexpr int STAGE = 2 * KB * KBOX;
  static constexpr int BAR = WG * QD + 2 * STAGE;
  static constexpr int BYTES = BAR + 3 * 8 + 1024;
};

// One block per (tile of WG x 64 / G query positions, kv head, sequence),
// rows as in the forward, so each K/V tile feeds the whole group.  It walks
// the key tiles the rows see, ascending: S = Q K^T and dP = dO V^T, P and dS
// on the accumulators, then dQ += dS K with dS as the register A operand
// (hi + lo) and K read MN-major; a warpgroup whose rows see none of a tile
// skips it.  Tiles are taken last-first, the causal band's longest rows
// first.
template <int HD>
__global__ void __launch_bounds__(Dq<HD>::WG * THREADS) dq_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse2,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int Sq, int Sp, int Skv, int nq, int nkv,
    int BQ, int causal, int window, float scale_log2, float scale) {
  using L = Dq<HD>;
  constexpr int NO = HD / 2, BKQ = L::BK, NS = BKQ / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR;
  const int tid = threadIdx.x, wg = tid / THREADS, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = nq / nkv;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * L::WG * BQ;
  const int nqpos = min(L::WG * BQ, Sq - q0);
  const int nw = (nqpos + BQ - 1) / BQ;  // warpgroups with rows
  const int q_last = q0 + nqpos - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BKQ - 1) / BKQ : 0;
  // this warpgroup's positions wq0 .. wq0 + wqpos - 1, and the keys they see
  const int wq0 = q0 + wg * BQ, wqpos = max(0, min(BQ, Sq - wq0)), nrows = wqpos * G;
  const int wk_end = causal ? min(Skv, wq0 + wqpos) : Skv;
  const int wk_begin = window > 0 ? max(0, wq0 - window + 1) : 0;
  const uint32_t sqw = base + wg * L::QD;

  auto load_kv = [&](int it) {
    const int st = it & 1, k0 = k_begin + it * BKQ;
    const uint32_t bar = bars + 8 * (1 + st);
    const uint32_t sk = base + L::WG * L::QD + st * L::STAGE, sv = sk + L::KB * L::KBOX;
    sm90::mbar_expect_tx(bar, 2 * L::KB * L::KBOX);
    for (int kb = 0; kb < L::KB; ++kb) {
      sm90::tma_load_4d(sk + kb * L::KBOX, &tk, bar, kb * 64, kvh, k0, b);
      sm90::tma_load_4d(sv + kb * L::KBOX, &tv, bar, kb * 64, kvh, k0, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // a Q (dO) box is G x BQ rows of 128 bytes: rows (position, head) in order
    sm90::mbar_expect_tx(bars, nw * 2 * L::KB * 128 * G * BQ);
    for (int w = 0; w < nw; ++w)
      for (int kb = 0; kb < L::KB; ++kb) {
        sm90::tma_load_5d(base + w * L::QD + kb * BOX, &tq, bars, kb * 64, 0, kvh, q0 + w * BQ, b);
        sm90::tma_load_5d(base + w * L::QD + (L::KB + kb) * BOX, &tdo, bars, kb * 64, 0, kvh, q0 + w * BQ, b);
      }
    if (ntiles > 0) load_kv(0);
  }
  __syncwarp();

  // this thread's rows r0 and r0 + 8, their lse2 and D
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  bool live[2];
  int qpos[2];
  float l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    live[i] = r < nrows;
    qpos[i] = wq0 + (live[i] ? r / G : 0);
    const long row = ((long)b * nq + (long)kvh * G + (live[i] ? r % G : 0)) * Sp + (live[i] ? qpos[i] : 0);
    l2[i] = live[i] ? lse2[row] : 0.f;
    dd[i] = live[i] ? dsum[row] : 0.f;
  }
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;
  sm90::mbar_wait(bars, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = k_begin + it * BKQ;
    if (tid == 0 && it + 1 < ntiles) load_kv(it + 1);
    __syncwarp();
    sm90::mbar_wait(bars + 8 * (1 + st), (it >> 1) & 1);
    const uint32_t sk = base + L::WG * L::QD + st * L::STAGE, sv = sk + L::KB * L::KBOX;

    if (nrows > 0 && k0 < wk_end && k0 + BKQ > wk_begin) {
      float s[NS], dp[NS];
#pragma unroll
      for (int e = 0; e < NS; ++e) s[e] = dp[e] = 0.f;
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32, ko = (kk >> 2) * L::KBOX + (kk & 3) * 32;
        mma_ss<BKQ>(s, sm90::desc_kmajor(sqw + off), sm90::desc_kmajor(sk + ko), kk > 0);
        mma_ss<BKQ>(dp, sm90::desc_kmajor(sqw + L::KB * BOX + off), sm90::desc_kmajor(sv + ko), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      sm90::fence_operands(dp);

      // s[e] is row r0 + 8 ((e >> 1) & 1), key k0 + 8 (e >> 2) + cq + (e & 1);
      // a tile every live row sees whole takes no mask (a dead row's dS
      // reaches only its own, unwritten, row of dQ)
      auto probs = [&](auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
        for (int e = 0; e < NS; ++e) {
          const int i = (e >> 1) & 1, kpos = k0 + 8 * (e >> 2) + cq + (e & 1);
          const bool ok = !MASKED || (live[i] && kpos < Skv && visible(qpos[i], kpos, causal, window));
          const float p = ok ? exp2f(s[e] * scale_log2 - l2[i]) : 0.f;
          dp[e] = p * (dp[e] - dd[i]);
        }
      };
      const bool inside = k0 + BKQ <= Skv && (!causal || k0 + BKQ - 1 <= wq0) &&
                          (window <= 0 || wq0 + wqpos - 1 - k0 < window);
      if (inside)
        probs(std::false_type{});
      else
        probs(std::true_type{});
      uint32_t sh[NS / 2], sl[NS / 2];
#pragma unroll
      for (int x = 0; x < NS / 2; ++x) split_pair(dp[2 * x], dp[2 * x + 1], sh[x], sl[x]);

      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKQ / 16; ++ks) {
        const uint64_t dkd = sm90::desc_mnmajor(sk + ks * 16 * 128, L::KBOX);
        const uint32_t ah[4] = {sh[4 * ks], sh[4 * ks + 1], sh[4 * ks + 2], sh[4 * ks + 3]};
        const uint32_t al[4] = {sl[4 * ks], sl[4 * ks + 1], sl[4 * ks + 2], sl[4 * ks + 3]};
        mma_rs<HD>(acc, ah, dkd);
        mma_rs<HD>(acc, al, dkd);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // acc[4 j + 2 i + c] is row r0 + 8 i, column 8 j + cq + c
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int g = (r0 + 8 * i) % G;
    __nv_bfloat16* o = dq + (((long)b * Sq + qpos[i]) * nq + (long)kvh * G + g) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// launch 2 in the form ROLES: one warpgroup a block keeping both dK and dV,
// or (SPLIT) two, one keeping each; the opt-in above 48 KB once a process
// (the port drives one card a process)
template <int HD, int ROLES>
int launch_dkv(const CUtensorMap& tq, const CUtensorMap& tdo, const CUtensorMap& tk, const CUtensorMap& tv,
               const float* lse2, const float* dsum, float* dkp, float* dvp, int B, int Sq, int Sp, int Skv, int nq,
               int nkv, int causal, int window, float scale_log2, float scale, cudaStream_t st) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      dkv_tc_kernel<HD, ROLES>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv<HD>::BYTES);
  if (opted != cudaSuccess) return (int)opted;
  dkv_tc_kernel<HD, ROLES><<<dim3(nq, (Skv + BK - 1) / BK, B), ROLES == SPLIT ? 2 * THREADS : THREADS,
                             Dkv<HD>::BYTES, st>>>(tq, tdo, tk, tv, lse2, dsum, dkp, dvp, Sq, Sp, Skv, nq, nkv,
                                                   causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
           float* scratch, void* dq, void* dk, void* dv, int B, int Sq, int Skv, int nq, int nkv, int causal,
           int window, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = nq / nkv, Sp = (Sq + 63) / 64 * 64, BQ = ROWS / G;
  float* lse2 = scratch;
  float* dsum = lse2 + (long)B * nq * Sp;
  float* dkp = dsum + (long)B * nq * Sp;
  float* dvp = dkp + (long)B * Skv * nq * HD;
  // launch 1 first: as a runtime call it also makes the card's context
  // current on this host thread, which cuTensorMapEncodeTiled (libcuda's,
  // not the runtime's) needs; autograd runs the backward on a thread of its
  // own, where this may be the first CUDA call
  const long rows = (long)B * nq * Sp;
  bwd_prep_tc_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, lse2, dsum, rows, Sq, Sp, nq, HD);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  // Q, dO as (hd, nq, Sq, B): a box of (64, 1, BQ, 1) is one head's step
  const cuuint64_t qdims[4] = {(cuuint64_t)HD, (cuuint64_t)nq, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstr[3] = {HD * e, (cuuint64_t)nq * HD * e, (cuuint64_t)Sq * nq * HD * e};
  const cuuint32_t qbox[4] = {64, 1, (cuuint32_t)Dkv<HD>::BQ, 1};
  // Q, dO as (hd, G, nkv, Sq, B): a box of (64, G, 1, BQ, 1) is one dQ block's rows
  const cuuint64_t gdims[5] = {(cuuint64_t)HD, (cuuint64_t)G, (cuuint64_t)nkv, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t gstr[4] = {HD * e, (cuuint64_t)G * HD * e, (cuuint64_t)nq * HD * e,
                              (cuuint64_t)Sq * nq * HD * e};
  const cuuint32_t gbox[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)BQ, 1};
  // K, V as (hd, nkv, Skv, B): a box of (64, 1, BK, 1) is one key tile's 64
  // columns; dQ's steps take boxes of Dq<HD>::BK keys
  const cuuint64_t kdims[4] = {(cuuint64_t)HD, (cuuint64_t)nkv, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * e, (cuuint64_t)nkv * HD * e, (cuuint64_t)Skv * nkv * HD * e};
  const cuuint32_t kbox[4] = {64, 1, BK, 1};
  const cuuint32_t dqkbox[4] = {64, 1, (cuuint32_t)Dq<HD>::BK, 1};
  CUtensorMap tq, tdo, gq, gdo, tk, tv, gk, gv;
  if (!sm90::bf16_tensor_map(&tq, q, 4, qdims, qstr, qbox) ||
      !sm90::bf16_tensor_map(&tdo, dout, 4, qdims, qstr, qbox) ||
      !sm90::bf16_tensor_map(&gq, q, 5, gdims, gstr, gbox) ||
      !sm90::bf16_tensor_map(&gdo, dout, 5, gdims, gstr, gbox) ||
      !sm90::bf16_tensor_map(&tk, k, 4, kdims, kstr, kbox) || !sm90::bf16_tensor_map(&tv, v, 4, kdims, kstr, kbox) ||
      !sm90::bf16_tensor_map(&gk, k, 4, kdims, kstr, dqkbox) || !sm90::bf16_tensor_map(&gv, v, 4, kdims, kstr, dqkbox))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t opted_dq = cudaFuncSetAttribute(
      dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<HD>::BYTES);
  if (opted_dq != cudaSuccess) return (int)opted_dq;
  const float scale_log2 = scale * LOG2E;
  if ((err = launch_dkv<HD, Dkv<HD>::ROLES>(tq, tdo, tk, tv, lse2, dsum, dkp, dvp, B, Sq, Sp, Skv, nq, nkv, causal,
                                            window, scale_log2, scale, st)))
    return err;
  const long n4 = (long)B * Skv * nkv * HD / 4;
  dkv_reduce_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      (const float4*)dkp, (const float4*)dvp, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n4, G, HD / 4);
  if ((err = (int)cudaGetLastError())) return err;
  constexpr int WG = Dq<HD>::WG;
  dq_tc_kernel<HD><<<dim3((Sq + WG * BQ - 1) / (WG * BQ), nkv, B), WG * THREADS, Dq<HD>::BYTES, st>>>(
      gq, gdo, gk, gv, lse2, dsum, (__nv_bfloat16*)dq, Sq, Sp, Skv, nq, nkv, BQ, causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, o, dout, dq (B, Sq, nq, hd); k, v, dk, dv (B, Skv, nkv, hd); lse and
// the scratch D (B, Sq, nq) f32; all contiguous, f32 or bf16 (dtype 0 / 1);
// hd in {16, 32, 64, 96, 128, 160, 256} for f32, {16, 32} for bf16;
// nq / nkv <= 64.  Three launches
// on ``stream``: D, then dK and dV, then dQ.
extern "C" int repro_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                                         int B, int Sq, int Skv, int nq, int nkv, int hd, int causal, int window,
                                         float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || nkv <= 0 || nq % nkv != 0 || nq / nkv > MAX_ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, T, return launch_hd<T>(hd, q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal,
                                               window, scale, stream));
  return (int)cudaErrorInvalidValue;
}

// The tensor-core build: bf16 q, o, dout, dq (B, Sq, nq, hd), k, v, dk, dv
// (B, Skv, nkv, hd), all contiguous and 16-byte aligned; lse (B, Sq, nq)
// f32; hd in {64, 96, 128, 160, 256}; nq / nkv <= 64.  The f32 scratch holds
// lse2 and D (B, nq, Sp), Sp = Sq rounded up to a multiple of 64, then the
// partial dK and dV (B, Skv, nq, hd): 2 B nq Sp + 2 B Skv nq hd floats.
// Four launches on ``stream``: D and lse per head, the per-head partial dK
// and dV, their sum over each group, dQ.
extern "C" int repro_flash_attention_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                                            const void* dout, const float* lse, float* scratch, void* dq, void* dk,
                                            void* dv, int B, int Sq, int Skv, int nq, int nkv, int hd, int causal,
                                            int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || nkv <= 0 || nq % nkv != 0 || nq / nkv > tc::ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64:
      return tc::launch<64>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale,
                            stream);
    case 96:
      return tc::launch<96>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale,
                            stream);
    case 128:
      return tc::launch<128>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale,
                             stream);
    case 160:
      return tc::launch<160>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale,
                             stream);
    case 256:
      return tc::launch<256>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale,
                             stream);
    default: return (int)cudaErrorInvalidValue;
  }
}


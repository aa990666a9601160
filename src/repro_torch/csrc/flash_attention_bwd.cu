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
// bf16, every product and sum in f32, outputs in the inputs' type.
//
// What bounds it on the card: operations.  StarCoder2-3B's layer (24 q / 2
// kv heads of 128, 2,048 causal tokens, batch 4) has 2.1 M visible pairs a
// head, 5 products of 2 * hd FLOPs a pair: ~1.3e11 FLOPs against ~0.3 GB.
// This build recomputes S and dP in both passes (7 products) on CUDA cores
// in f32 (67 TFLOP/s), so it is far from the bf16 tensor-core bound; a
// wgmma / TMA redesign is later work.
//
// Three launches, no atomics, every sum in a fixed order (a repeat is
// bitwise equal):
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
// 256 a block holds ~216 KB, so the launches opt in above 48 KB.
#include "common.cuh"

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
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 96: return launch<T, 96>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 160:
      return launch<T, 160>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (B, Sq, nq, hd); k, v, dk, dv (B, Skv, nkv, hd); lse and
// the scratch D (B, Sq, nq) f32; all contiguous, f32 or bf16 (dtype 0 / 1);
// hd in {16, 32, 64, 96, 128, 160, 256}; nq / nkv <= 64.  Three launches
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

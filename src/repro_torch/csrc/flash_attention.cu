// Blocked causal / local-window GQA flash-attention forward (prefill).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas
// (kernel _flash_kernel).
//
// What it computes: q (B, Sq, nq, hd), k/v (B, Skv, nkv, hd) in the model's
// layout; query head h reads KV head h // group.  Query position i sees key
// position j iff j < Skv, and (causal) j <= i, and (window > 0) i - j < window.
// Scores are scaled by 1/sqrt(hd); online softmax in f32; the output
// (B, Sq, nq, hd) has q's type.
//
// What bounds it on the card: operations.  A 4,096-token RecurrentGemma
// prompt under a 2,048 window makes 6.29 M visible (query, key) pairs per
// head, 4 * hd FLOPs each: ~6.4e10 FLOPs against ~63 MB of q, k, v and out.
//
// What the design does about it:
//  * One block per (tile of query positions, kv head, sequence) takes the
//    whole query group of that KV head: BQ positions x group heads = up to
//    64 (query, head) rows, so each K/V tile is read from memory once per
//    group (10 heads here), not once per query head as the TPU grid does.
//  * Key tiles that lie wholly outside the causal band or the window are
//    never visited: the walk runs from max(0, q0 - window + 1) to the tile's
//    last query position.  The ragged last query tile and the ragged last
//    key tile are masked.
//  * Each warp owns 8 rows; lane j scores key j of the 32-key tile for all 8
//    rows (float4 reads of padded Q and K rows: Q broadcast, K conflict-free),
//    so the row max and sum of the online softmax are warp reductions, and
//    the probabilities reach the P.V product through warp shuffles without
//    touching shared memory.  The output accumulator (8 rows x hd/32 dims a
//    lane) lives in registers.
//  * Q, K and V tiles are kept in f32 in shared memory: at hd 256 that is
//    ~130 KB, above the 48 KB default, so the launch opts in.
// The products run on CUDA cores in f32; wgmma on bf16 tiles fed by TMA is a
// later step.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 8;                  // (query, head) rows per warp
constexpr int MAX_ROWS = WARPS * RPW;   // 64 rows per block
constexpr int BK = 32;                  // keys per tile: one per lane

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)MAX_ROWS * (HD + 4) + (size_t)BK * (HD + 4) + (size_t)BK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    int Sq, int Skv, int nq, int nkv, int BQ, int causal, int window, float scale) {
  constexpr int QS = HD + 4;           // padded row stride: 16-byte aligned, conflict-free
  constexpr int NJ = (HD + 31) / 32;   // output dims per lane
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = nq / nkv;
  const int q0 = blockIdx.x * BQ;
  const int nqpos = min(BQ, Sq - q0);
  const int nrows = nqpos * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // MAX_ROWS * QS
  float* ks = qs + MAX_ROWS * QS;  // BK * QS
  float* vs = ks + BK * QS;        // BK * HD

  // row r = (query position q0 + r / G, head kvh * G + r % G)
  for (int i = tid; i < nrows * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    const int s = q0 + r / G, g = r % G;
    qs[r * QS + d] = to_f32(q[(((long)b * Sq + s) * nq + (long)kvh * G + g) * HD + d]);
  }
  int qpos[RPW];
  bool live[RPW];
  float m[RPW], l[RPW], acc[RPW][NJ];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    live[i] = r < nrows;
    qpos[i] = q0 + (live[i] ? r / G : 0);
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int q_last = q0 + nqpos - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const long kv_stride = (long)nkv * HD;
  const T* kb = k + (long)b * Skv * kv_stride + (long)kvh * HD;
  const T* vb = v + (long)b * Skv * kv_stride + (long)kvh * HD;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    for (int i = tid; i < nk * HD; i += THREADS) {
      const int r = i / HD, d = i - r * HD;
      const long off = (long)(k0 + r) * kv_stride + d;
      ks[r * QS + d] = to_f32(kb[off]);
      vs[r * HD + d] = to_f32(vb[off]);
    }
    __syncthreads();
    // scores of key k0 + lane against the warp's rows (lanes past nk read a
    // stale row and are masked below)
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(ks + lane * QS);
    const float4* qw = reinterpret_cast<const float4*>(qs + warp * RPW * QS);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kv4 = kr[d4];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qv = qw[i * (QS / 4) + d4];
        s[i] += qv.x * kv4.x + qv.y * kv4.y + qv.z * kv4.z + qv.w * kv4.w;
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      bool ok = live[i] && lane < nk;
      if (causal) ok = ok && kpos <= qpos[i];
      if (window > 0) ok = ok && qpos[i] - kpos < window;
      const float sc = ok ? s[i] * scale : REPRO_NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      s[i] = p;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    // P.V: the probability of key j for row i sits in lane j
    for (int j = 0; j < nk; ++j) {
      float vj[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = lane + 32 * jj;
        vj[jj] = d < HD ? vs[j * HD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] += pj * vj[jj];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!live[i]) continue;
    const int r = warp * RPW + i;
    const int g = r % G;
    T* o = out + (((long)b * Sq + qpos[i]) * nq + (long)kvh * G + g) * HD;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = lane + 32 * jj;
      if (d < HD) o[d] = from_f32<T>(acc[i][jj] / denom);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int nq, int nkv,
              int causal, int window, float scale, void* stream) {
  const int G = nq / nkv;
  const int BQ = MAX_ROWS / G;
  const size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, nkv, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, nq, nkv, BQ, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, nq, hd), k/v (B, Skv, nkv, hd), out (B, Sq, nq, hd), all
// contiguous; hd in {16, 32, 64, 128, 256}; nq / nkv <= 64.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                                     int Sq, int Skv, int nq, int nkv, int hd, int causal, int window, float scale,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || nkv <= 0 || nq % nkv != 0 || nq / nkv > MAX_ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, T, {
    switch (hd) {
      case 16: return launch_hd<T, 16>(q, k, v, out, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 32: return launch_hd<T, 32>(q, k, v, out, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 64: return launch_hd<T, 64>(q, k, v, out, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 128: return launch_hd<T, 128>(q, k, v, out, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 256: return launch_hd<T, 256>(q, k, v, out, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}

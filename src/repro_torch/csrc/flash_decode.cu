// Vector-steered flash-decode over the contiguous KV cache, and its paged
// twin over a flat page pool addressed through per-slot block tables.
//
// Replaces: src/repro/kernels/flash_attention/decode.py, flash_decode_pallas
// (kernel _flash_decode_kernel) and flash_decode_paged_pallas (kernel
// _flash_decode_paged_kernel); chain and tree words, no int8 scales.
//
// What it computes: token (b, t) with query heads q[b, t, :, :] attends to
// logical cache rows p < lengths[b*T + t] of KV head h // group, where a row
// is visible iff p < base[b] or bit (p - base[b]) of anc[t] is set (the chain
// word -1 keeps every bit: the pure length clamp).  Online softmax in f32;
// the output has q's type.  The two instantiations differ only in where
// logical row p of sequence b lives (the row-address policy):
//   contiguous  (b*S + p) * nkv*hd                  in k/v (B, S, nkv, hd)
//   paged       (phys*ps + p%ps) * nkv*hd           in the pool (R, nkv, hd),
//               phys = max(table[b*mp + min(p/ps, (L-1)/ps)], 0)
// (the length clamp first, then the block-table lookup, as the TPU kernel's
// index_map does).  Masking, tiles and the order of every sum are shared, so
// with an identity table the paged kernel is bitwise the contiguous one.
//
// What bounds it on the card: bytes.  At decode every K/V row is used by one
// token's group of query heads for 2 * group * hd FLOPs per 2 * hd elements,
// far below the ~295 FLOP/byte where the tensor cores would be the limit.
//
// What the design does about it:
//  * The cache (or the pool) is read in place in the model's row layout with
//    strides; the TPU wrapper's transpose per call (and, paged, its reshape
//    of the pool into pages) is gone.
//  * One block per (kv head, token, sequence) holds the whole GQA group of
//    query heads (16 for Qwen3-MoE), so each K/V row is read once per group,
//    not once per query head.
//  * The walk stops at the token's own length: no byte past the valid prefix
//    moves (the length-clamp contract); paged, only the pages backing that
//    prefix are touched, and the block loads its own block-table row into
//    shared memory once (the TPU kernel's scalar prefetch).
// Tiles are 32 rows; the K and V tiles share one f32 shared-memory buffer
// whose rows are padded by one word so the row-parallel dot products do not
// collide on a bank.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 128;

// PAGED selects the row-address policy; S is the logical row capacity of a
// sequence (max_len contiguous, mp * ps paged).
template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const T* __restrict__ q,    // (B, Tn, nq, hd)
    const T* __restrict__ k,    // contiguous (B, S, nkv, hd); paged (R, nkv, hd)
    const T* __restrict__ v,
    T* __restrict__ out,        // (B, Tn, nq, hd)
    const int* __restrict__ lengths,  // (B*Tn,)
    const int* __restrict__ anc,      // (Tn,)
    const int* __restrict__ base,     // (B,)
    const int* __restrict__ table,    // paged: (B*mp,) block tables; contiguous: unused
    int Tn, int S, int nq, int nkv, int hd, float scale, int mp, int ps) {
  const int kvh = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int G = nq / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KS = hd + 1;  // padded row stride of the K/V tile

  extern __shared__ float smem[];
  float* qs = smem;                 // G * hd
  float* kv = qs + G * hd;          // TILE * KS
  float* sc = kv + TILE * KS;       // G * TILE
  float* acc = sc + G * TILE;       // G * hd
  float* ms = acc + G * hd;         // G
  float* ls = ms + G;               // G
  float* cr = ls + G;               // G
  int* tbl = (int*)(cr + G);        // paged: mp

  const long q_row = ((long)(b * Tn + t) * nq + (long)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) {
    qs[i] = to_f32(q[q_row + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = REPRO_NEG_INF;
    ls[g] = 0.f;
  }
  if (PAGED) {
    for (int i = tid; i < mp; i += THREADS) tbl[i] = table[(long)b * mp + i];
  }
  int L = lengths[b * Tn + t];
  L = L < S ? L : S;
  const int word = anc[t];
  const int bs = base[b];
  const long row_stride = (long)nkv * hd;
  const long kv_off = (long)kvh * hd;
  const int last_page = PAGED ? (L - 1) / ps : 0;
  // the row-address policy: logical row p of sequence b -> physical row
  auto row_of = [&](int p) -> long {
    if (PAGED) {
      const int idx = min(p / ps, last_page);
      return (long)max(tbl[idx], 0) * ps + p % ps;
    }
    return (long)b * S + p;
  };
  __syncthreads();

  for (int p0 = 0; p0 < L; p0 += TILE) {
    const int n = min(TILE, L - p0);
    for (int i = tid; i < n * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      kv[r * KS + d] = to_f32(k[kv_off + row_of(p0 + r) * row_stride + d]);
    }
    __syncthreads();
    // scores: one (head, row) pair per thread step; masked rows are NEG_INF
    for (int i = tid; i < G * TILE; i += THREADS) {
      const int g = i / TILE, r = i - g * TILE;
      float s = REPRO_NEG_INF;
      if (r < n) {
        const int u = p0 + r - bs;
        const bool on_path = (u < 0) || (((word >> (u < 31 ? u : 31)) & 1) != 0);
        if (on_path) {
          const float* qg = qs + g * hd;
          const float* kr = kv + r * KS;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot += qg[d] * kr[d];
          s = dot * scale;
        }
      }
      sc[i] = s;
    }
    __syncthreads();
    // online-softmax update, one warp per query head (TILE == warp size);
    // meanwhile the V tile replaces the K tile
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s = sc[g * TILE + lane];
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = (s == REPRO_NEG_INF) ? 0.f : expf(s - m_new);
      sc[g * TILE + lane] = p;
      const float psum = warp_sum(p);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        cr[g] = c;
        ls[g] = ls[g] * c + psum;
        ms[g] = m_new;
      }
    }
    for (int i = tid; i < n * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      kv[r * KS + d] = to_f32(v[kv_off + row_of(p0 + r) * row_stride + d]);
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = sc + g * TILE;
      float a = acc[i] * cr[g];
      for (int r = 0; r < n; ++r) a += pg[r] * kv[r * KS + d];
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd;
    out[q_row + i] = from_f32<T>(acc[i] / fmaxf(ls[g], 1e-30f));
  }
}

template <bool PAGED>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, const void* lengths,
           const void* table, const void* anc, const void* base, int B, int Tn, int S, int nq, int nkv, int hd,
           float scale, int mp, int ps, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || hd <= 0 || (PAGED && (mp <= 0 || ps <= 0))) return (int)cudaErrorInvalidValue;
  const int G = nq / nkv;
  const size_t smem = sizeof(float) * ((size_t)G * hd * 2 + (size_t)TILE * (hd + 1) + (size_t)G * TILE + 3 * G) +
                      (PAGED ? sizeof(int) * (size_t)mp : 0);
  dim3 grid(nkv, Tn, B);
  REPRO_DISPATCH(dtype, T, {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T, PAGED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    flash_decode_kernel<T, PAGED><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, (const int*)lengths, (const int*)anc, (const int*)base,
        (const int*)table, Tn, S, nq, nkv, hd, scale, mp, ps);
  });
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_decode(int dtype, const void* q, const void* k, const void* v, void* out,
                                  const void* lengths, const void* anc, const void* base, int B, int Tn,
                                  int S, int nq, int nkv, int hd, float scale, void* stream) {
  return launch<false>(dtype, q, k, v, out, lengths, nullptr, anc, base, B, Tn, S, nq, nkv, hd, scale, 0, 1, stream);
}

// pool_k/pool_v (R, nkv, hd); table (B*mp,) int32 physical page per logical
// page (-1 = unallocated, reached only past a token's length clamp).
extern "C" int repro_flash_decode_paged(int dtype, const void* q, const void* pool_k, const void* pool_v, void* out,
                                        const void* lengths, const void* table, const void* anc, const void* base,
                                        int B, int Tn, int mp, int ps, int nq, int nkv, int hd, float scale,
                                        void* stream) {
  return launch<true>(dtype, q, pool_k, pool_v, out, lengths, table, anc, base, B, Tn, mp * ps, nq, nkv, hd, scale,
                      mp, ps, stream);
}

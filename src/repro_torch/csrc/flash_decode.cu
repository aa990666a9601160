// Vector-steered flash-decode over the contiguous KV cache, its paged twin
// over a flat page pool addressed through per-slot block tables, and its
// window-steered twin over a rolling (modulo-addressed) cache.
//
// Replaces: src/repro/kernels/flash_attention/decode.py, flash_decode_pallas
// (kernel _flash_decode_kernel), flash_decode_paged_pallas (kernel
// _flash_decode_paged_kernel) and flash_decode_window_pallas (kernel
// _flash_decode_window_kernel); chain and tree words, full-precision and
// int8 caches.
//
// What it computes: token (b, t) with query heads q[b, t, :, :] attends to a
// run of logical cache rows of KV head h // group, with online softmax in
// f32; the output has q's type.  The three instantiations differ in which
// logical rows a token sees and where logical row p of sequence b lives (the
// row-address policy):
//   contiguous  rows p < lengths[b*T + t], visible iff p < base[b] or bit
//               (p - base[b]) of anc[t] is set (the chain word -1 keeps every
//               bit: the pure length clamp); row (b*S + p) in k/v (B, S, nkv, hd)
//   paged       the same rows and mask; row phys*ps + p%ps in the pool
//               (R, nkv, hd), phys = max(table[b*mp + min(p/ps, (L-1)/ps)], 0)
//               (the length clamp first, then the block-table lookup, as the
//               TPU kernel's index_map does)
//   window      positions p in [max(0, pos - limit + 1, head - W + 1), pos],
//               pos = positions[b*T + t], head = positions[b*T + T - 1] (the
//               last row this launch wrote); row (b*W + p % W) in the rolling
//               buffer k/v (B, W, nkv, hd).  The lower bound head - W + 1
//               drops positions whose slot a later draft token of the launch
//               overwrote, exactly the TPU kernel's reconstruction of each
//               slot's absolute position from the write head.
// Contiguous and paged share masking, tiles and the order of every sum, so
// with an identity table the paged kernel is bitwise the contiguous one.  The
// window kernel walks positions in order where the TPU kernel walks slots in
// slot order, so its sums run in another order (equal within rounding).
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
//    query heads (16 for Qwen3-MoE, 10 for RecurrentGemma's one KV head), so
//    each K/V row is read once per group, not once per query head.
//  * The walk covers only the token's visible run: no byte past the valid
//    prefix moves (the length-clamp contract), at most min(limit, W) rows of
//    a rolling buffer move, and paged only the pages backing the prefix are
//    touched; the block loads its own block-table row into shared memory
//    once (the TPU kernel's scalar prefetch).
// Tiles are 32 rows; the K and V tiles share one f32 shared-memory buffer
// whose rows are padded by one word so the row-parallel dot products do not
// collide on a bank.  At hd 256 and a group of 10 the block needs ~55 KB of
// shared memory, above the 48 KB default: the launch opts in.
// With one KV head and T = 1 the window launch is only B blocks: it is
// latency-bound; a split of the window over blocks is a later step.
//
// The int8 branch (the TPU kernels' _load_kv_tile with quantized=True): K/V
// are int8 with one f32 scale per cache row, ks/vs, and the K/V element type
// is a template parameter apart from q's, so one template covers (q bf16, KV
// bf16), (q f32, KV f32), (q bf16, KV int8) and (q f32, KV int8).  The port
// reads K/V in row layout, so a row's scale sits at the index of its K/V
// row under each policy: b*S + p contiguous, phys*ps + p%ps paged (after the
// same length clamp and table lookup), b*W + p%W window.  Each element is
// multiplied by its row's scale with __fmul_rn as the tile lands in f32
// shared memory, before any dot, so an int8 launch is bitwise the f32
// launch on the dequantized cache (f32 q; a bf16 q reads the same f32
// values, and its output is that launch's rounded once to bf16).  The
// scales are read through L1 beside the tile; no shared memory is added.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 128;
constexpr int CONTIGUOUS = 0, PAGED = 1, WINDOW = 2;  // row-address policies

// POLICY selects the row-address policy; S is the row capacity of a sequence
// (max_len contiguous, mp * ps paged, the buffer's W slots for a window).
template <typename T, typename TKV, int POLICY>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const T* __restrict__ q,      // (B, Tn, nq, hd)
    const TKV* __restrict__ k,    // contiguous (B, S, nkv, hd); paged (R, nkv, hd)
    const TKV* __restrict__ v,
    const float* __restrict__ ks, // int8: one scale per K row (B*S; paged R); otherwise unused
    const float* __restrict__ vs,
    T* __restrict__ out,          // (B, Tn, nq, hd)
    const int* __restrict__ lengths,  // (B*Tn,) lengths; window: absolute positions
    const int* __restrict__ anc,      // (Tn,); window: unused
    const int* __restrict__ base,     // (B,); window: unused
    const int* __restrict__ table,    // paged: (B*mp,) block tables; otherwise unused
    int Tn, int S, int nq, int nkv, int hd, float scale, int mp, int ps, int limit) {
  constexpr bool Q8 = std::is_same<TKV, int8_t>::value;
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
  if (POLICY == PAGED) {
    for (int i = tid; i < mp; i += THREADS) tbl[i] = table[(long)b * mp + i];
  }
  // the token's visible run of logical rows [first, L)
  int first = 0, L;
  if (POLICY == WINDOW) {
    const int pos = lengths[b * Tn + t], head = lengths[b * Tn + Tn - 1];
    first = max(max(0, pos - limit + 1), head - S + 1);
    L = pos + 1;
  } else {
    L = lengths[b * Tn + t];
    L = L < S ? L : S;
  }
  const int word = POLICY == WINDOW ? -1 : anc[t];
  const int bs = POLICY == WINDOW ? 0 : base[b];
  const long row_stride = (long)nkv * hd;
  const long kv_off = (long)kvh * hd;
  const int last_page = POLICY == PAGED ? (L - 1) / ps : 0;
  // the row-address policy: logical row p of sequence b -> physical row
  auto row_of = [&](int p) -> long {
    if (POLICY == PAGED) {
      const int idx = min(p / ps, last_page);
      return (long)max(tbl[idx], 0) * ps + p % ps;
    }
    if (POLICY == WINDOW) return (long)b * S + p % S;
    return (long)b * S + p;
  };
  __syncthreads();

  for (int p0 = first; p0 < L; p0 += TILE) {
    const int n = min(TILE, L - p0);
    for (int i = tid; i < n * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      const long row = row_of(p0 + r);
      kv[r * KS + d] = load_scaled(k[kv_off + row * row_stride + d], Q8 ? ks[row] : 1.f);
    }
    __syncthreads();
    // scores: one (head, row) pair per thread step; masked rows are NEG_INF
    for (int i = tid; i < G * TILE; i += THREADS) {
      const int g = i / TILE, r = i - g * TILE;
      float s = REPRO_NEG_INF;
      if (r < n) {
        const int u = p0 + r - bs;
        const bool on_path = POLICY == WINDOW || (u < 0) || (((word >> (u < 31 ? u : 31)) & 1) != 0);
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
      const long row = row_of(p0 + r);
      kv[r * KS + d] = load_scaled(v[kv_off + row * row_stride + d], Q8 ? vs[row] : 1.f);
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

template <int POLICY>
int launch(int dtype, int kv_dtype, const void* q, const void* k, const void* v, const void* ks, const void* vs,
           void* out, const void* lengths, const void* table, const void* anc, const void* base, int B, int Tn,
           int S, int nq, int nkv, int hd, float scale, int mp, int ps, int limit, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || hd <= 0 || (POLICY == PAGED && (mp <= 0 || ps <= 0)) ||
      (POLICY == WINDOW && (limit <= 0 || Tn > S)) || (kv_dtype == 2 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = nq / nkv;
  const size_t smem = sizeof(float) * ((size_t)G * hd * 2 + (size_t)TILE * (hd + 1) + (size_t)G * TILE + 3 * G) +
                      (POLICY == PAGED ? sizeof(int) * (size_t)mp : 0);
  dim3 grid(nkv, Tn, B);
  REPRO_DISPATCH_PAIR(dtype, kv_dtype, T, TKV, {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T, TKV, POLICY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    flash_decode_kernel<T, TKV, POLICY><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const TKV*)k, (const TKV*)v, (const float*)ks, (const float*)vs, (T*)out,
        (const int*)lengths, (const int*)anc, (const int*)base, (const int*)table, Tn, S, nq, nkv, hd, scale, mp,
        ps, limit);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: q's (and out's) type code, 0 f32 or 1 bf16; kv_dtype: K/V's, the
// same as q's, or 2 (int8: ks/vs are the per-row f32 scales, indexed like the
// K/V rows; otherwise they may be null).
extern "C" int repro_flash_decode(int dtype, int kv_dtype, const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs, void* out, const void* lengths, const void* anc,
                                  const void* base, int B, int Tn, int S, int nq, int nkv, int hd, float scale,
                                  void* stream) {
  return launch<CONTIGUOUS>(dtype, kv_dtype, q, k, v, ks, vs, out, lengths, nullptr, anc, base, B, Tn, S, nq, nkv,
                            hd, scale, 0, 1, 0, stream);
}

// pool_k/pool_v (R, nkv, hd); table (B*mp,) int32 physical page per logical
// page (-1 = unallocated, reached only past a token's length clamp); int8:
// pool_ks/pool_vs (R,), one scale per pool row.
extern "C" int repro_flash_decode_paged(int dtype, int kv_dtype, const void* q, const void* pool_k,
                                        const void* pool_v, const void* pool_ks, const void* pool_vs, void* out,
                                        const void* lengths, const void* table, const void* anc, const void* base,
                                        int B, int Tn, int mp, int ps, int nq, int nkv, int hd, float scale,
                                        void* stream) {
  return launch<PAGED>(dtype, kv_dtype, q, pool_k, pool_v, pool_ks, pool_vs, out, lengths, table, anc, base, B, Tn,
                       mp * ps, nq, nkv, hd, scale, mp, ps, 0, stream);
}

// k/v (B, W, nkv, hd) rolling buffers (slot = position % W); positions (B*Tn,)
// int32 absolute position of each token, nondecreasing in t, with Tn <= W;
// limit = min(window, W); int8: ks/vs (B*W,), one scale per slot.
extern "C" int repro_flash_decode_window(int dtype, int kv_dtype, const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, void* out, const void* positions, int B,
                                         int Tn, int W, int nq, int nkv, int hd, int limit, float scale,
                                         void* stream) {
  return launch<WINDOW>(dtype, kv_dtype, q, k, v, ks, vs, out, positions, nullptr, nullptr, nullptr, B, Tn, W, nq,
                        nkv, hd, scale, 0, 1, limit, stream);
}

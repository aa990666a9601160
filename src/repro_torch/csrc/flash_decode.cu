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
// RecurrentGemma's window launch moves 8.4 MB (4 slots x 2,048 rows x hd
// 256, K and V): 2.5 us at the card's memory rate, so what bounds a launch
// in practice is how many SMs pull those bytes at once.
//
// What the design does about it:
//  * The cache (or the pool) is read in place in the model's row layout with
//    strides; the TPU wrapper's transpose per call (and, paged, its reshape
//    of the pool into pages) is gone.
//  * Each block holds the whole GQA group of query heads (16 for Qwen3-MoE,
//    10 for RecurrentGemma's one KV head), so each K/V row is read once per
//    group, not once per query head.
//  * The walk covers only the token's visible run: no byte past the valid
//    prefix moves (the length-clamp contract), at most min(limit, W) rows of
//    a rolling buffer move, and paged only the pages backing the prefix are
//    touched; the block loads its own block-table row into shared memory
//    once (the TPU kernel's scalar prefetch).
//
// Contiguous and paged: one block per (kv head, token, sequence) walks the
// run in tiles of 32 rows; the K and V tiles share one f32 shared-memory
// buffer whose rows are padded by one word so the row-parallel dot products
// do not collide on a bank (at hd 256 and a group of 10 ~55 KB, above the
// 48 KB default: the launch opts in).  Their runs are 71-212 rows at the
// serving shapes: latency-bound, and a later step.
//
// Window: the flash-decoding split.  One block per (kv head, token, sequence
// x split) would otherwise be 4 blocks for RecurrentGemma's decode (one KV
// head, T = 1, 4 slots), each walking 2,048 rows alone.  Instead split c of
// nsplit = ceil(limit / CHUNK) takes rows [first + c*CHUNK, first +
// (c+1)*CHUNK) of the token's visible run [first, pos], clipped to it, so
// every token's run is covered exactly once whatever its position (each
// token's bound head - W + 1 clips every split, not only the first); at
// CHUNK 64 that is 32 splits, 128 blocks for the card's 132 SMs.  A split
// (256 threads) pulls its K and V rows into shared memory in their stored
// type with 16-byte cp.async copies (one row's slot is p % W, so a chunk may
// wrap); V's copies land while the scores run.  Scores: one warp a row, lane
// l holding elements [l*hd/32, (l+1)*hd/32) of it and the same slice of up
// to 16 query heads in registers (hd is a template parameter: no division
// per element); the 16 partial dots are summed over the warp by one
// reduce-scatter (16 shuffles, not 16 x 5).  The chunk's softmax is one
// pass; the probabilities are stored row-major, so P.V reads a row's 16
// with four 16-byte loads.  Each split writes its max m, sum l and
// unnormalised accumulator (group x hd) to an f32 scratch the wrapper
// allocates; an empty split writes m = NEG_INF, l = 0 and zeros.  A second
// launch, one block per (query head, token, sequence), weighs the nsplit
// partials by exp(m_c - max m) and sums them in ascending split order,
// writing out in q's type: the order is fixed, so a repeated launch is
// bitwise equal.  CUDA cores suffice: the work is byte-bound.
//
// The int8 branch (the TPU kernels' _load_kv_tile with quantized=True): K/V
// are int8 with one f32 scale per cache row, ks/vs, and the K/V element type
// is a template parameter apart from q's, so one template covers (q bf16, KV
// bf16), (q f32, KV f32), (q bf16, KV int8) and (q f32, KV int8).  The port
// reads K/V in row layout, so a row's scale sits at the index of its K/V
// row under each policy: b*S + p contiguous, phys*ps + p%ps paged (after the
// same length clamp and table lookup), b*W + p%W window.  Each element is
// multiplied by its row's scale with __fmul_rn before any dot (contiguous
// and paged as the tile lands in f32 shared memory, window as the element
// leaves the stored tile), so an int8 launch is bitwise the f32 launch on
// the dequantized cache (f32 q; a bf16 q reads the same f32 values, and its
// output is that launch's rounded once to bf16).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 128;
constexpr int CONTIGUOUS = 0, PAGED = 1;  // row-address policies of the single-pass kernel

// POLICY selects the row-address policy; S is the row capacity of a sequence
// (max_len contiguous, mp * ps paged).
template <typename T, typename TKV, int POLICY>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const T* __restrict__ q,      // (B, Tn, nq, hd)
    const TKV* __restrict__ k,    // contiguous (B, S, nkv, hd); paged (R, nkv, hd)
    const TKV* __restrict__ v,
    const float* __restrict__ ks, // int8: one scale per K row (B*S; paged R); otherwise unused
    const float* __restrict__ vs,
    T* __restrict__ out,          // (B, Tn, nq, hd)
    const int* __restrict__ lengths,  // (B*Tn,)
    const int* __restrict__ anc,      // (Tn,)
    const int* __restrict__ base,     // (B,)
    const int* __restrict__ table,    // paged: (B*mp,) block tables; otherwise unused
    int Tn, int S, int nq, int nkv, int hd, float scale, int mp, int ps) {
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
  // the token's visible run of logical rows [0, L)
  int L = lengths[b * Tn + t];
  L = L < S ? L : S;
  const int word = anc[t];
  const int bs = base[b];
  const long row_stride = (long)nkv * hd;
  const long kv_off = (long)kvh * hd;
  const int last_page = POLICY == PAGED ? (L - 1) / ps : 0;
  // the row-address policy: logical row p of sequence b -> physical row
  auto row_of = [&](int p) -> long {
    if (POLICY == PAGED) {
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
           int S, int nq, int nkv, int hd, float scale, int mp, int ps, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || hd <= 0 || (POLICY == PAGED && (mp <= 0 || ps <= 0)) ||
      (kv_dtype == 2 && (ks == nullptr || vs == nullptr)))
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
        ps);
  });
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// window: split over chunks of the visible run, then a fixed-order merge
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int GP = 16;             // query heads a pass of the split kernel holds
constexpr int PS = GP + 4;         // row stride of the probability tile (16-byte rows, few bank conflicts)
constexpr int CHUNK = 64;          // rows a split takes; the wrapper's WINDOW_CHUNK
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// EPL consecutive stored elements starting at p (one 16-, 8-, 4-, 2- or
// 1-byte load, or several 16-byte ones), widened to f32 and multiplied by
// the row's scale.
template <typename TKV, int EPL>
__device__ __forceinline__ void load_run(const TKV* p, float scale, float (&x)[EPL]) {
  constexpr int BYTES = EPL * (int)sizeof(TKV);
  constexpr int PER = BYTES > 16 ? 16 / (int)sizeof(TKV) : EPL;  // elements a load
  struct alignas(PER * sizeof(TKV)) Raw { TKV e[PER]; };
#pragma unroll
  for (int h = 0; h < EPL / PER; ++h) {
    const Raw r = *reinterpret_cast<const Raw*>(p + h * PER);
#pragma unroll
    for (int e = 0; e < PER; ++e) x[h * PER + e] = load_scaled(r.e[e], scale);
  }
}

// Sixteen per-lane partial sums (one per head) reduced over the warp and
// scattered: the return value is head (lane >> 1)'s full sum.  Four halving
// exchanges and a last pairwise one: 16 shuffles, not 16 x 5.
__device__ __forceinline__ float reduce_scatter16(const float (&v)[16], int lane) {
  float a8[8], a4[4], a2[2];
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4, u2 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a8[i] = (u16 ? v[8 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, u16 ? v[i] : v[8 + i], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a4[i] = (u8 ? a8[4 + i] : a8[i]) + __shfl_xor_sync(0xffffffffu, u8 ? a8[i] : a8[4 + i], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a2[i] = (u4 ? a4[2 + i] : a4[i]) + __shfl_xor_sync(0xffffffffu, u4 ? a4[i] : a4[2 + i], 4);
  float a = (u2 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, u2 ? a2[0] : a2[1], 2);
  return a + __shfl_xor_sync(0xffffffffu, a, 1);
}

template <typename TKV, int HD>
constexpr size_t split_smem() {
  return 2 * (size_t)CHUNK * HD * sizeof(TKV) + sizeof(float) * ((size_t)CHUNK * PS + 2 * CHUNK);
}

// part: per (token, query head, split) HD accumulator floats, then m and l.
template <typename T, typename TKV, int HD>
__global__ void __launch_bounds__(SPLIT_THREADS) window_split_kernel(
    const T* __restrict__ q,        // (B, Tn, nq, HD)
    const TKV* __restrict__ k,      // (B, W, nkv, HD) rolling buffer, slot = position % W
    const TKV* __restrict__ v,
    const float* __restrict__ ks,   // int8: (B*W,) one scale per slot; otherwise unused
    const float* __restrict__ vs,
    float* __restrict__ part,       // (B*Tn*nq, nsplit, HD + 2)
    const int* __restrict__ positions,  // (B*Tn,) absolute positions
    int Tn, int W, int nq, int nkv, float scale, int limit, int nsplit) {
  constexpr bool Q8 = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;            // elements of a row a lane scores
  constexpr int VD = HD >= SPLIT_THREADS ? HD / SPLIT_THREADS : 1;  // output dims a thread owns
  constexpr int PIECE = 16 / (int)sizeof(TKV);           // elements a 16-byte copy
  constexpr int PPR = HD / PIECE;                        // copies a row
  static_assert(HD % PIECE == 0, "a row must be a whole number of 16-byte pieces");
  const int kvh = blockIdx.x, t = blockIdx.y, b = blockIdx.z / nsplit, c = blockIdx.z - b * nsplit;
  const int G = nq / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* kt = reinterpret_cast<TKV*>(smem_raw);             // CHUNK * HD, stored type
  TKV* vt = kt + CHUNK * HD;                              // CHUNK * HD
  float* sc = reinterpret_cast<float*>(vt + CHUNK * HD);  // CHUNK * PS: scores, then probabilities
  float* kscale = sc + CHUNK * PS;                        // CHUNK (int8)
  float* vscale = kscale + CHUNK;                         // CHUNK (int8)

  // split c's rows of the token's visible run [first, pos]; K's copies land
  // first (group 1) and V's meanwhile (group 2) while the scores run
  const int pos = positions[b * Tn + t], head = positions[b * Tn + Tn - 1];
  const int first = max(max(0, pos - limit + 1), head - W + 1);
  const int p0 = first + c * CHUNK;
  const int n = max(0, min(CHUNK, pos + 1 - p0));
  const long row_stride = (long)nkv * HD;
  for (int pass = 0; pass < 2; ++pass) {
    const TKV* src = (pass == 0 ? k : v) + (long)kvh * HD;
    TKV* dst = pass == 0 ? kt : vt;
    for (int i = tid; i < n * PPR; i += SPLIT_THREADS) {
      const int r = i / PPR, pc = (i - r * PPR) * PIECE;
      cp_async16(dst + r * HD + pc, src + ((long)b * W + (p0 + r) % W) * row_stride + pc);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (Q8) {
    for (int r = tid; r < n; r += SPLIT_THREADS) {
      const long row = (long)b * W + (p0 + r) % W;
      kscale[r] = ks[row];
      vscale[r] = vs[row];
    }
  }
  const long q_row = ((long)(b * Tn + t) * nq + (long)kvh * G) * HD;
  const long head_stride = (long)nsplit * (HD + 2);
  float* pbase = part + ((long)(b * Tn + t) * nq + (long)kvh * G) * head_stride + (long)c * (HD + 2);
  const bool holds = lane * EPL < HD;
  const int d0 = tid * VD;

  for (int g0 = 0; g0 < G; g0 += GP) {  // one pass for up to 16 heads
    const int gn = min(GP, G - g0);
    // lane l's slice of each head's query, in registers
    float qr[GP][EPL];
#pragma unroll
    for (int gg = 0; gg < GP; ++gg) {
      if (gg < gn && holds) {
        load_run<T, EPL>(q + q_row + (long)(g0 + gg) * HD + lane * EPL, 1.f, qr[gg]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[gg][e] = 0.f;
      }
    }
    if (g0 == 0) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    // scores: one warp per row; each lane's 16 partial dots, one reduce-scatter
    for (int r = warp; r < n; r += SPLIT_WARPS) {
      float x[EPL];
      if (holds) {
        load_run<TKV, EPL>(kt + r * HD + lane * EPL, Q8 ? kscale[r] : 1.f, x);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) x[e] = 0.f;
      }
      float dot[GP];
#pragma unroll
      for (int gg = 0; gg < GP; ++gg) {
        dot[gg] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot[gg] += qr[gg][e] * x[e];
      }
      const float s = reduce_scatter16(dot, lane);
      if ((lane & 1) == 0 && (lane >> 1) < gn) sc[r * PS + (lane >> 1)] = s * scale;
    }
    __syncthreads();
    // the chunk's softmax, one warp per head
    for (int gg = warp; gg < gn; gg += SPLIT_WARPS) {
      float m = REPRO_NEG_INF;
      for (int r = lane; r < n; r += 32) m = fmaxf(m, sc[r * PS + gg]);
      m = warp_max(m);
      float l = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(sc[r * PS + gg] - m);
        sc[r * PS + gg] = p;
        l += p;
      }
      l = warp_sum(l);
      if (lane == 0) {
        pbase[(g0 + gg) * head_stride + HD] = m;
        pbase[(g0 + gg) * head_stride + HD + 1] = l;
      }
    }
    if (g0 == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    // P.V: thread tid owns dims [d0, d0 + VD) of every head of the pass
    if (d0 < HD) {
      float a[GP][VD];
#pragma unroll
      for (int gg = 0; gg < GP; ++gg)
#pragma unroll
        for (int j = 0; j < VD; ++j) a[gg][j] = 0.f;
      for (int r = 0; r < n; ++r) {
        float x[VD];
        load_run<TKV, VD>(vt + r * HD + d0, Q8 ? vscale[r] : 1.f, x);
        const float4* pr = reinterpret_cast<const float4*>(sc + r * PS);
#pragma unroll
        for (int g4 = 0; g4 < GP / 4; ++g4) {
          const float4 p4 = pr[g4];
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < VD; ++j) a[4 * g4 + i][j] += pv[i] * x[j];
        }
      }
#pragma unroll
      for (int gg = 0; gg < GP; ++gg) {
        if (gg < gn) {
#pragma unroll
          for (int j = 0; j < VD; ++j) pbase[(g0 + gg) * head_stride + d0 + j] = a[gg][j];
        }
      }
    }
    __syncthreads();  // the probability tile is rewritten by the next pass
  }
}

// one block per (query head, token, sequence): the partials' weights
// exp(m_c - max m) once, then each output dim summed in ascending split order
template <typename T, int HD>
__global__ void __launch_bounds__(SPLIT_THREADS) window_merge_kernel(
    const float* __restrict__ part, T* __restrict__ out, int nq, int nsplit) {
  extern __shared__ float wsplit[];  // nsplit
  const int h = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const long tok = (long)b * gridDim.y + t;
  const float* pp = part + (tok * nq + h) * nsplit * (HD + 2);
  float m = REPRO_NEG_INF;
#pragma unroll 8
  for (int c = 0; c < nsplit; ++c) m = fmaxf(m, pp[c * (HD + 2) + HD]);
  for (int c = threadIdx.x; c < nsplit; c += SPLIT_THREADS) wsplit[c] = expf(pp[c * (HD + 2) + HD] - m);
  __syncthreads();
  float l = 0.f;
#pragma unroll 8
  for (int c = 0; c < nsplit; ++c) l += pp[c * (HD + 2) + HD + 1] * wsplit[c];
  const float den = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < HD; d += SPLIT_THREADS) {
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < nsplit; ++c) a += pp[c * (HD + 2) + d] * wsplit[c];
    out[(tok * nq + h) * HD + d] = from_f32<T>(a / den);
  }
}

template <typename T, typename TKV, int HD>
int launch_window_hd(const void* q, const void* k, const void* v, const void* ks, const void* vs, void* out,
                     void* part, const void* positions, int B, int Tn, int W, int nq, int nkv, int limit,
                     float scale, int nsplit, cudaStream_t stream) {
  const size_t smem = split_smem<TKV, HD>();
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted = cudaFuncSetAttribute(window_split_kernel<T, TKV, HD>,
                                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opted != cudaSuccess) return (int)opted;
  window_split_kernel<T, TKV, HD><<<dim3(nkv, Tn, B * nsplit), SPLIT_THREADS, smem, stream>>>(
      (const T*)q, (const TKV*)k, (const TKV*)v, (const float*)ks, (const float*)vs, (float*)part,
      (const int*)positions, Tn, W, nq, nkv, scale, limit, nsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  window_merge_kernel<T, HD><<<dim3(nq, Tn, B), SPLIT_THREADS, sizeof(float) * nsplit, stream>>>(
      (const float*)part, (T*)out, nq, nsplit);
  return (int)cudaGetLastError();
}

int launch_window(int dtype, int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, void* out, void* part, const void* positions, int B, int Tn, int W, int nq,
                  int nkv, int hd, int limit, float scale, int nsplit, void* stream) {
  if (nkv <= 0 || nq % nkv != 0 || limit <= 0 || Tn > W || nsplit != (limit + CHUNK - 1) / CHUNK ||
      (kv_dtype == 2 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define REPRO_WINDOW_HD(HD)                                                                                   \
  case HD:                                                                                                    \
    return launch_window_hd<T, TKV, HD>(q, k, v, ks, vs, out, part, positions, B, Tn, W, nq, nkv, limit, scale, \
                                        nsplit, s)
  REPRO_DISPATCH_PAIR(dtype, kv_dtype, T, TKV, {
    switch (hd) {
      REPRO_WINDOW_HD(16);
      REPRO_WINDOW_HD(32);
      REPRO_WINDOW_HD(64);
      REPRO_WINDOW_HD(128);
      REPRO_WINDOW_HD(256);
      default: return (int)cudaErrorInvalidValue;
    }
  });
#undef REPRO_WINDOW_HD
  return (int)cudaErrorInvalidValue;
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
                            hd, scale, 0, 1, stream);
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
                       mp * ps, nq, nkv, hd, scale, mp, ps, stream);
}

// k/v (B, W, nkv, hd) rolling buffers (slot = position % W); positions (B*Tn,)
// int32 absolute position of each token, nondecreasing in t, with Tn <= W;
// limit = min(window, W); int8: ks/vs (B*W,), one scale per slot.  part is
// the f32 scratch of (B*Tn*nq, nsplit, hd + 2) floats; nsplit =
// ceil(limit / 64), the rows a split takes; hd in {16, 32, 64, 128, 256}.
// Two launches on the stream: the splits, the merge.
extern "C" int repro_flash_decode_window(int dtype, int kv_dtype, const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, void* out, void* part,
                                         const void* positions, int B, int Tn, int W, int nq, int nkv, int hd,
                                         int limit, float scale, int nsplit, void* stream) {
  return launch_window(dtype, kv_dtype, q, k, v, ks, vs, out, part, positions, B, Tn, W, nq, nkv, hd, limit, scale,
                       nsplit, stream);
}

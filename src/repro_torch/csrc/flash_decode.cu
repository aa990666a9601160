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
// run of logical cache rows of KV head h // group, with softmax in f32; the
// output has q's type.  The three instantiations differ in which logical
// rows a token sees and where logical row p of sequence b lives (the
// row-address policy):
//   contiguous  rows p < L = min(lengths[b*T + t], S), visible iff p < base[b]
//               or bit (p - base[b]) of anc[t] is set (the chain word -1, or
//               no words at all, keeps every bit: the pure length clamp);
//               row (b*S + p) in k/v (B, S, nkv, hd)
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
// Contiguous and paged are one template with two row-address policies: the
// same masking, chunks and order of every sum, so with an identity table the
// paged launch is bitwise the contiguous one.  The window kernel walks
// positions in order where the TPU kernel walks slots in slot order, so its
// sums run in another order (equal within rounding).
//
// What bounds it on the card: bytes.  At decode every K/V row is used by one
// token's group of query heads for 2 * group * hd FLOPs per 2 * hd elements,
// far below the ~295 FLOP/byte where the tensor cores would be the limit.
// RecurrentGemma's window launch moves 8.4 MB (4 slots x 2,048 rows x hd
// 256, K and V): 2.5 us at the card's memory rate; Qwen3-MoE's contiguous
// launch ~1.3 MB.  What bounds a launch in practice is how many SMs pull
// those bytes at once, and then how fast the host issues the launch.
//
// What the design does about it:
//  * The cache (or the pool) is read in place in the model's row layout with
//    strides; the TPU wrapper's transpose per call (and, paged, its reshape
//    of the pool into pages) is gone.
//  * Each block holds a pass of up to 16 query heads of one KV head's group
//    (Qwen3-MoE's whole group of 16, RecurrentGemma's 10), so each K/V row is
//    read once per group, not once per query head.
//  * The walk covers only the token's visible run: no byte past the valid
//    prefix moves (the length-clamp contract), at most min(limit, W) rows of
//    a rolling buffer move, and paged only the pages backing the prefix are
//    touched; the block loads its own block-table row into shared memory
//    once (the TPU kernel's scalar prefetch).
//  * The flash-decoding split.  One block per (kv head, token, sequence)
//    walking its run alone is 16 blocks for Qwen3-MoE's decode at T = 1 (64
//    at T = 4) and 4 for RecurrentGemma's, on a card of 132 SMs.  Instead
//    the run is cut into chunks of CHUNK (64) rows, one block (256 threads)
//    a chunk.  A block pulls its K and V rows into shared memory in their
//    stored type with 16-byte cp.async copies; V's copies land while the
//    scores run.  Scores: one warp a row, lane l holding elements
//    [l*hd/32, (l+1)*hd/32) of it and the same slice of up to 16 query
//    heads in registers (hd is a template parameter: no division per
//    element); the 16 partial dots are summed over the warp by one
//    reduce-scatter (16 shuffles, not 16 x 5).  The chunk's softmax is one
//    pass; the probabilities are stored row-major, so P.V reads a row's
//    heads with 16-byte loads.  Each split writes its max m, sum l and
//    unnormalised accumulator (group x hd) to an f32 scratch the wrapper
//    allocates; an empty split writes m = NEG_INF, l = 0 and zeros.  The
//    partials are weighed by exp(m_c - max m) and summed in ascending split
//    order, writing out in q's type: the order is fixed, so a repeated
//    launch is bitwise equal.  CUDA cores suffice: the work is byte-bound.
//  * Window: split c of nsplit = ceil(limit / CHUNK) takes rows [first +
//    c*CHUNK, first + (c+1)*CHUNK) of the token's visible run [first, pos],
//    clipped to it, so every token's run is covered exactly once whatever
//    its position (each token's bound head - W + 1 clips every split, not
//    only the first; a chunk's slots p % W may wrap); at CHUNK 64 that is 32
//    splits, 128 blocks.  A second launch, one block per (query head, token,
//    sequence), merges the splits.
//  * Contiguous and paged: split c takes chunks [c*per, (c+1)*per) of the
//    row capacity S, nchunk = ceil(S / CHUNK), nsplit = min(nchunk,
//    MAX_SPLITS), per = ceil(nchunk / nsplit), each clipped to the token's
//    run [0, L); a block walking several chunks (S > 2,048) carries an
//    online softmax across them, so the grid and the f32 scratch stop
//    growing with the capacity there.  nsplit depends on S alone (the
//    wrapper's decode_splits), never on the lengths, which stay on the
//    device, and a token's sums depend only on its own run: a token of a
//    T-token launch is bitwise the same token launched alone.  The splits
//    are merged by window_merge_kernel in a second launch of the same C
//    call (none when nsplit is 1).  Three designs were timed on an H100
//    80GB HBM3 at 700 W at Qwen3-MoE's decode shape, q (4, 4, 64, 128) over
//    a 164-row cache, and at T = 1 (PERF.md, section 6):
//      (a) this one: 192 + 1,024 blocks, device 0.0150 ms (0.0109 at T = 1);
//      (b) the same split merged in the same launch by the last split block
//          of each (kv head, token, sequence), which took a ticket from a
//          per-call counter: 0.0220 (0.0187); one block merging 16 heads x
//          128 dims after a device-wide fence costs more than the second
//          launch;
//      (c) one block per (kv head, token, sequence) walking its chunks with
//          an online softmax: 0.0177 (0.0172); 64 (16) blocks each pay every
//          chunk's copy and compute in turn.
//    (a) took the least device time, so it alone is built.  Its second
//    launch adds one cudaLaunchKernel to the same C call, not a second trip
//    through the wrapper.
//
// The int8 branch (the TPU kernels' _load_kv_tile with quantized=True): K/V
// are int8 with one f32 scale per cache row, ks/vs, and the K/V element type
// is a template parameter apart from q's, so one template covers (q bf16, KV
// bf16), (q f32, KV f32), (q bf16, KV int8) and (q f32, KV int8).  The port
// reads K/V in row layout, so a row's scale sits at the index of its K/V
// row under each policy: b*S + p contiguous, phys*ps + p%ps paged (after the
// same length clamp and table lookup), b*W + p%W window.  Each element is
// multiplied by its row's scale with __fmul_rn as it leaves the stored tile,
// before any dot, so an int8 launch is bitwise the f32 launch on the
// dequantized cache (f32 q; a bf16 q reads the same f32 values, and its
// output is that launch's rounded once to bf16).
#include <type_traits>

#include "common.cuh"

namespace {

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

// the largest power of two dividing n, at most cap
__host__ __device__ constexpr int pow2_part(int n, int cap) {
  return (n % 2 == 0 && cap > 1) ? 2 * pow2_part(n / 2, cap / 2) : 1;
}

// EPL consecutive stored elements starting at p (one 16-, 8-, 4-, 2- or
// 1-byte load, or several 16-byte ones), widened to f32 and multiplied by
// the row's scale.  A load takes the largest power-of-two run dividing EPL
// that fits 16 bytes: EPL itself, or 16 bytes' worth, at the power-of-two
// head dims; one element at a time at hd 96 and 160 (EPL 3 and 5), whose
// runs start at odd multiples of the element size.
template <typename TKV, int EPL>
__device__ __forceinline__ void load_run(const TKV* p, float scale, float (&x)[EPL]) {
  constexpr int PER = pow2_part(EPL, 16 / (int)sizeof(TKV));  // elements a load
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
      REPRO_WINDOW_HD(96);
      REPRO_WINDOW_HD(128);
      REPRO_WINDOW_HD(160);
      REPRO_WINDOW_HD(256);
      default: return (int)cudaErrorInvalidValue;
    }
  });
#undef REPRO_WINDOW_HD
  return (int)cudaErrorInvalidValue;
}
// ---------------------------------------------------------------------------
// contiguous and paged: the split over chunks of the row capacity, steered
// by lengths, ancestor words and (paged) block tables
// ---------------------------------------------------------------------------

constexpr int CONTIGUOUS = 0, PAGED = 1;  // row-address policies
constexpr int MAX_SPLITS = 32;            // splits a (kv head, token, sequence) at most

constexpr int decode_nsplit(int S) {
  return (S + CHUNK - 1) / CHUNK < MAX_SPLITS ? (S + CHUNK - 1) / CHUNK : MAX_SPLITS;
}

template <typename TKV, int HD>
constexpr size_t decode_smem() {
  // K, V tiles; probability rows; two scale columns; m, l, correction of a pass's heads
  return 2 * (size_t)CHUNK * HD * sizeof(TKV) + sizeof(float) * ((size_t)CHUNK * PS + 2 * CHUNK + 3 * GP);
}

// One block per (sequence x split, token, kv head).  part: per (token, query
// head, split) HD accumulator floats, then m and l (window_merge_kernel's
// layout).  Up to hd 128 two blocks share an SM (128 registers a thread):
// row 1's 192 blocks then run in one wave on 132 SMs, where at the 158
// registers ptxas picks unbounded they take two (device 0.0171 ms against
// 0.0150, PERF.md).
template <typename T, typename TKV, int HD, int POLICY>
__global__ void __launch_bounds__(SPLIT_THREADS, HD <= 128 ? 2 : 1) decode_split_kernel(
    const T* __restrict__ q,       // (B, Tn, nq, HD)
    const TKV* __restrict__ k,     // contiguous (B, S, nkv, HD); paged (R, nkv, HD)
    const TKV* __restrict__ v,
    const float* __restrict__ ks,  // int8: one scale per K row (B*S; paged R); otherwise unused
    const float* __restrict__ vs,
    T* __restrict__ out,           // (B, Tn, nq, HD)
    float* __restrict__ part,      // nsplit > 1: (B*Tn*nq, nsplit, HD + 2)
    const int* __restrict__ lengths,  // (B*Tn,)
    const int* __restrict__ anc,      // (Tn,) ancestor words, or null (chain)
    const int* __restrict__ base,     // (B,) committed-prefix lengths, or null (0)
    const int* __restrict__ table,    // paged: (B*mp,) block tables; otherwise unused
    int Tn, int S, int nq, int nkv, float scale, int mp, int ps, int nsplit) {
  constexpr bool Q8 = std::is_same<TKV, int8_t>::value;
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;      // elements of a row a lane scores
  constexpr int PIECE = 16 / (int)sizeof(TKV);     // elements a 16-byte copy
  constexpr int PPR = HD / PIECE;                  // copies a row
  constexpr int HG = SPLIT_THREADS / HD;           // P.V: thread groups, one output dim a thread
  constexpr int GH = GP / HG;                      // heads a thread of P.V sums
  static_assert(HD % PIECE == 0 && HD <= SPLIT_THREADS && GP % HG == 0, "head dim");
  // Where HG * HD < SPLIT_THREADS (hd 96: 2 groups over 192 threads; hd 160:
  // 1 over 160) the threads past HG * HD hold no (group, dim) pair: they skip
  // P.V and write nothing, and every dim of every head still has one owner.
  const int b = blockIdx.x / nsplit, c = blockIdx.x - b * nsplit, t = blockIdx.y, kvh = blockIdx.z;
  const int G = nq / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* kt = reinterpret_cast<TKV*>(smem_raw);             // CHUNK * HD, stored type
  TKV* vt = kt + CHUNK * HD;                              // CHUNK * HD
  float* sc = reinterpret_cast<float*>(vt + CHUNK * HD);  // CHUNK * PS: scores, then probabilities
  float* kscale = sc + CHUNK * PS;                        // CHUNK (int8)
  float* vscale = kscale + CHUNK;                         // CHUNK (int8)
  float* mrun = vscale + CHUNK;                           // GP: running max of each head of the pass
  float* lrun = mrun + GP;                                // GP: running sum
  float* corr = lrun + GP;                                // GP: the last chunk's rescale
  int* tbl = reinterpret_cast<int*>(corr + GP);           // paged: mp

  if (POLICY == PAGED) {
    for (int i = tid; i < mp; i += SPLIT_THREADS) tbl[i] = table[(long)b * mp + i];
  }
  // the token's visible run of logical rows [0, L), masked by its word
  const int L = min(lengths[b * Tn + t], S);
  const int word = anc != nullptr ? anc[t] : -1;
  const int bs = base != nullptr ? base[b] : 0;
  const long row_stride = (long)nkv * HD;
  const int last_page = POLICY == PAGED ? max(L - 1, 0) / ps : 0;
  // the row-address policy: logical row p of sequence b -> physical row
  auto row_of = [&](int p) -> long {
    if (POLICY == PAGED) {
      const int idx = min(p / ps, last_page);
      return (long)max(tbl[idx], 0) * ps + p % ps;
    }
    return (long)b * S + p;
  };
  // this split's chunks of the row capacity
  const int nchunk = (S + CHUNK - 1) / CHUNK;
  const int per = (nchunk + nsplit - 1) / nsplit;
  const int j0 = c * per, j1 = min(nchunk, j0 + per);

  const long q_row = ((long)(b * Tn + t) * nq + (long)kvh * G) * HD;
  const long head_stride = (long)nsplit * (HD + 2);
  float* pbase = part + ((long)(b * Tn + t) * nq + (long)kvh * G) * head_stride + (long)c * (HD + 2);
  const bool holds = lane * EPL < HD;
  const int d = tid % HD, hg = tid / HD;  // P.V: output dim d of heads [hg*GH, (hg+1)*GH)
  const bool pv = hg < HG;                // a (group, dim) pair of P.V is this thread's

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
    if (tid < GP) {
      mrun[tid] = REPRO_NEG_INF;
      lrun[tid] = 0.f;
    }
    float a[GH];
#pragma unroll
    for (int i = 0; i < GH; ++i) a[i] = 0.f;

    for (int j = j0; j < j1; ++j) {
      const int p0 = j * CHUNK;
      const int n = min(CHUNK, L - p0);
      if (n <= 0) break;
      __syncthreads();  // the table is loaded; the last chunk's tiles and probabilities are free
      // K's copies land first (group 1) and V's meanwhile (group 2)
      for (int pass = 0; pass < 2; ++pass) {
        const TKV* src = (pass == 0 ? k : v) + (long)kvh * HD;
        TKV* dst = pass == 0 ? kt : vt;
        for (int i = tid; i < n * PPR; i += SPLIT_THREADS) {
          const int r = i / PPR, pc = (i - r * PPR) * PIECE;
          cp_async16(dst + r * HD + pc, src + row_of(p0 + r) * row_stride + pc);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      if (Q8) {
        for (int r = tid; r < n; r += SPLIT_THREADS) {
          const long row = row_of(p0 + r);
          kscale[r] = ks[row];
          vscale[r] = vs[row];
        }
      }
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      // scores: one warp per row; each lane's 16 partial dots, one
      // reduce-scatter; rows off the token's root path are NEG_INF
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
        const int u = p0 + r - bs;
        const bool on_path = (u < 0) || (((word >> (u < 31 ? u : 31)) & 1) != 0);
        if ((lane & 1) == 0 && (lane >> 1) < gn) sc[r * PS + (lane >> 1)] = on_path ? s * scale : REPRO_NEG_INF;
      }
      __syncthreads();
      // the chunk's softmax against the running max, one warp per head
      for (int gg = warp; gg < gn; gg += SPLIT_WARPS) {
        float m = REPRO_NEG_INF;
        for (int r = lane; r < n; r += 32) m = fmaxf(m, sc[r * PS + gg]);
        const float m_prev = mrun[gg];
        const float m_new = fmaxf(m_prev, warp_max(m));
        float l = 0.f;
        for (int r = lane; r < n; r += 32) {
          const float s = sc[r * PS + gg];
          const float p = s == REPRO_NEG_INF ? 0.f : expf(s - m_new);
          sc[r * PS + gg] = p;
          l += p;
        }
        l = warp_sum(l);
        if (lane == 0) {
          const float cr = expf(m_prev - m_new);
          corr[gg] = cr;
          lrun[gg] = lrun[gg] * cr + l;
          mrun[gg] = m_new;
        }
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      // P.V: thread (hg, d) sums dim d of heads [hg*GH, (hg+1)*GH)
      const float* ph = sc + (pv ? hg : 0) * GH;
#pragma unroll
      for (int i = 0; i < GH; ++i) a[i] *= corr[(pv ? hg : 0) * GH + i];
      for (int r = 0; r < (pv ? n : 0); ++r) {
        float x[1];
        load_run<TKV, 1>(vt + r * HD + d, Q8 ? vscale[r] : 1.f, x);
        if constexpr (GH % 4 == 0) {
          const float4* pr = reinterpret_cast<const float4*>(ph + r * PS);
#pragma unroll
          for (int g4 = 0; g4 < GH / 4; ++g4) {
            const float4 p4 = pr[g4];
            a[4 * g4 + 0] += p4.x * x[0];
            a[4 * g4 + 1] += p4.y * x[0];
            a[4 * g4 + 2] += p4.z * x[0];
            a[4 * g4 + 3] += p4.w * x[0];
          }
        } else {
#pragma unroll
          for (int i = 0; i < GH; ++i) a[i] += ph[r * PS + i] * x[0];
        }
      }
    }
    __syncthreads();  // m and l of every head are final
    if (pv) {
#pragma unroll
      for (int i = 0; i < GH; ++i) {
        const int gg = hg * GH + i;
        if (gg >= gn) continue;
        if (nsplit == 1) {
          out[q_row + (long)(g0 + gg) * HD + d] = from_f32<T>(a[i] / fmaxf(lrun[gg], 1e-30f));
        } else {
          pbase[(g0 + gg) * head_stride + d] = a[i];
        }
      }
    }
    if (nsplit > 1 && tid < gn) {
      pbase[(g0 + tid) * head_stride + HD] = mrun[tid];
      pbase[(g0 + tid) * head_stride + HD + 1] = lrun[tid];
    }
    __syncthreads();  // the running m, l and the probability tile are reset by the next pass
  }
}

template <typename T, typename TKV, int HD, int POLICY>
int launch_decode_hd(const void* q, const void* k, const void* v, const void* ks, const void* vs, void* out,
                     void* part, const void* lengths, const void* table, const void* anc, const void* base,
                     int B, int Tn, int S, int nq, int nkv, float scale, int mp, int ps, int nsplit,
                     cudaStream_t stream) {
  const size_t smem = decode_smem<TKV, HD>() + (POLICY == PAGED ? sizeof(int) * (size_t)mp : 0);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the opt-in above 48 KB, raised as a launch asks for more (paged: the
  // table row grows with mp; the port drives one card from one thread)
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, TKV, HD, POLICY>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  decode_split_kernel<T, TKV, HD, POLICY><<<dim3(B * nsplit, Tn, nkv), SPLIT_THREADS, smem, stream>>>(
      (const T*)q, (const TKV*)k, (const TKV*)v, (const float*)ks, (const float*)vs, (T*)out, (float*)part,
      (const int*)lengths, (const int*)anc, (const int*)base, (const int*)table, Tn, S, nq, nkv, scale, mp, ps,
      nsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  window_merge_kernel<T, HD><<<dim3(nq, Tn, B), SPLIT_THREADS, sizeof(float) * nsplit, stream>>>(
      (const float*)part, (T*)out, nq, nsplit);
  return (int)cudaGetLastError();
}

template <int POLICY>
int launch_decode(int dtype, int kv_dtype, const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, void* out, void* part, const void* lengths, const void* table, const void* anc,
                  const void* base, int B, int Tn, int S, int nq, int nkv, int hd, float scale, int mp, int ps,
                  int nsplit, void* stream) {
  if (B <= 0 || Tn <= 0 || S <= 0 || nkv <= 0 || nq % nkv != 0 || nsplit != decode_nsplit(S) ||
      (nsplit > 1 && part == nullptr) || (POLICY == PAGED && (mp <= 0 || ps <= 0)) ||
      (kv_dtype == 2 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define REPRO_DECODE_HD(HD)                                                                                     \
  case HD:                                                                                                      \
    return launch_decode_hd<T, TKV, HD, POLICY>(q, k, v, ks, vs, out, part, lengths, table, anc, base, B, Tn, S, \
                                                nq, nkv, scale, mp, ps, nsplit, s)
  REPRO_DISPATCH_PAIR(dtype, kv_dtype, T, TKV, {
    switch (hd) {
      REPRO_DECODE_HD(16);
      REPRO_DECODE_HD(32);
      REPRO_DECODE_HD(64);
      REPRO_DECODE_HD(96);
      REPRO_DECODE_HD(128);
      REPRO_DECODE_HD(160);
      REPRO_DECODE_HD(256);
      default: return (int)cudaErrorInvalidValue;
    }
  });
#undef REPRO_DECODE_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: q's (and out's) type code, 0 f32 or 1 bf16; kv_dtype: K/V's, the
// same as q's, or 2 (int8: ks/vs are the per-row f32 scales, indexed like the
// K/V rows; otherwise they may be null).  hd in {16, 32, 64, 96, 128, 160,
// 256}; q,
// k and v 16-byte aligned.  anc (Tn,) and base (B,) may be null: the chain
// word -1 and a committed prefix of 0.  nsplit = min(ceil(S / 64), 32)
// (any other is refused); with nsplit > 1 part is an f32 scratch of
// (B*Tn*nq, nsplit, hd + 2) floats and a second launch merges the splits.
extern "C" int repro_flash_decode(int dtype, int kv_dtype, const void* q, const void* k, const void* v,
                                  const void* ks, const void* vs, void* out, void* part, const void* lengths,
                                  const void* anc, const void* base, int B, int Tn, int S, int nq, int nkv, int hd,
                                  float scale, int nsplit, void* stream) {
  return launch_decode<CONTIGUOUS>(dtype, kv_dtype, q, k, v, ks, vs, out, part, lengths, nullptr, anc, base, B, Tn,
                                   S, nq, nkv, hd, scale, 0, 1, nsplit, stream);
}

// pool_k/pool_v (R, nkv, hd); table (B*mp,) int32 physical page per logical
// page (-1 = unallocated, reached only past a token's length clamp); int8:
// pool_ks/pool_vs (R,), one scale per pool row.  The row capacity S is
// mp * ps; the rest as repro_flash_decode.
extern "C" int repro_flash_decode_paged(int dtype, int kv_dtype, const void* q, const void* pool_k,
                                        const void* pool_v, const void* pool_ks, const void* pool_vs, void* out,
                                        void* part, const void* lengths, const void* table, const void* anc,
                                        const void* base, int B, int Tn, int mp, int ps, int nq, int nkv, int hd,
                                        float scale, int nsplit, void* stream) {
  return launch_decode<PAGED>(dtype, kv_dtype, q, pool_k, pool_v, pool_ks, pool_vs, out, part, lengths, table, anc,
                              base, B, Tn, mp * ps, nq, nkv, hd, scale, mp, ps, nsplit, stream);
}

// k/v (B, W, nkv, hd) rolling buffers (slot = position % W); positions (B*Tn,)
// int32 absolute position of each token, nondecreasing in t, with Tn <= W;
// limit = min(window, W); int8: ks/vs (B*W,), one scale per slot.  part is
// the f32 scratch of (B*Tn*nq, nsplit, hd + 2) floats; nsplit =
// ceil(limit / 64), the rows a split takes; hd in {16, 32, 64, 96, 128, 160,
// 256}.
// Two launches on the stream: the splits, the merge.
extern "C" int repro_flash_decode_window(int dtype, int kv_dtype, const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, void* out, void* part,
                                         const void* positions, int B, int Tn, int W, int nq, int nkv, int hd,
                                         int limit, float scale, int nsplit, void* stream) {
  return launch_window(dtype, kv_dtype, q, k, v, ks, vs, out, part, positions, B, Tn, W, nq, nkv, hd, limit, scale,
                       nsplit, stream);
}

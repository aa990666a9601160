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
// head, 4 * hd FLOPs each: ~6.4e10 FLOPs against ~63 MB of q, k, v and out,
// ~1,000 FLOP a byte, above the card's ~295; a 4,096-token causal prompt of
// Phi-3-Vision (32 heads of 96) or StableLM-12B (32 of 160) is 1.0e11 or
// 1.7e11 FLOPs against ~0.1 GB.  On CUDA cores in f32 that is ~1 ms at best
// (67 TFLOP/s); the bf16 tensor cores offer 989.
//
// Two paths, chosen by the wrapper from dtype and hd alone:
//
// Tensor cores (bf16, hd 64, 96, 128, 160 and 256: every registered arch's
// prefill), one template over hd.  One warpgroup (128 threads) per (tile of
// query positions, kv head, sequence):
//  * Rows are (query position, head) pairs of one KV head's group, 64 a
//    block: 6 positions x 10 heads + 4 dead rows for RecurrentGemma, 4 x 16
//    for Qwen3-MoE, 16 x 4 for StableLM-12B, 64 x 1 for Phi-3-Vision.  Each
//    K/V tile then feeds the whole group.  Dead rows and the ragged last
//    tile's rows are computed and never stored.
//  * TMA brings Q once and K/V tiles of 64 keys into a two-stage ring,
//    completing on mbarriers: tile i + 1 loads while tile i computes.  Each
//    tile is ceil(hd / 64) boxes of 64 rows x 128 bytes, 128-byte swizzled;
//    the tensor maps keep the true hd as their innermost dim, so at hd 96
//    and 160 TMA fills the columns past hd (32 of the last box) with zeros,
//    and each barrier expects the whole boxes' bytes, zeros included.  Q
//    16 / 24 / 32 KB and K, V as much each per stage at hd 96 / 160 / 256:
//    ~80 / 121 / 161 KB.  Keys past Skv arrive as zeros and are masked.
//  * S = Q K^T by hd / 16 steps of wgmma m64n64k16 (bf16 in, f32 out) from
//    shared memory (the zero columns are never multiplied); the causal /
//    window mask and the online softmax (exp2, f32) run on the accumulator
//    registers, each thread holding two rows.  Key tiles wholly outside the
//    band are never visited.
//  * O += P V by wgmma m64n{hd}k16 with P as the register A operand (the
//    accumulator layout of S is the A layout) and V read MN-major (V's rows
//    are keys, hd contiguous) across the 64-column boxes.  At hd 96 and 160
//    N is not a whole number of the swizzle's 64-column atoms; the
//    descriptor (column blocks a box apart) still addresses the partial
//    last atom (tests/test_torch_cuda_kernels.py holds it at ragged
//    shapes).  N padded to 128 / 192 over the zero columns was right too,
//    but it multiplies the zeros and holds 16 / 32 more accumulator
//    registers a thread.  bf16 P
//    alone would carry a 2^-9 relative error into every output (above the
//    bf16 gate's 1e-3 x rms floor where outputs cancel;
//    tests/test_torch_cuda_builds.py builds this file with the lo half
//    zeroed and counts the misses at hd 256 and 160), so P is split into
//    hi = bf16(P) and lo = bf16(P - hi) and both products go into the same
//    f32 accumulator: P is carried to ~2^-17, for twice the P.V work.
//    O (64 x hd f32, hd / 2 registers a thread) stays in registers.
//  * No atomics and a fixed key order: a repeated launch is bitwise equal.
//  * What still bounds it: S, the softmax and P.V run one after another in
//    the one warpgroup (each wgmma waited on before the softmax), so the
//    tensor cores idle while the exponentials run, and P.V is done twice
//    (hi, lo): ~5x the operation bound at 4,096 tokens.
//
// hd 64 (MusicGen's 32 heads of 64; LEAN<HD> below) has the least matrix
// work for each exponential, so the softmax's instructions bound it more
// than the tensor cores do.  Its instantiation keeps the rows, ring, hi + lo
// P and key order above, and cuts those instructions:
//  * Four blocks share an SM (116 registers and ~42 KB of shared memory a
//    block: Q 8 KB, two stages of K and V 8 KB each), so one block's
//    exponentials run while another's wgmma do.  The grid is one row of
//    (query tile, kv head) pairs, every head's last query tile (the most
//    causal keys) first: the heaviest blocks start in the first wave and
//    the lightest fill the tail (the template's order, each head's tiles
//    in turn, left the last head's heaviest tiles to start at the end).
//  * Only a tile that reaches past Skv, the causal diagonal or the window's
//    edge is masked; the row max is a tree over the raw scores, scaled
//    once; the exponentials one ex2.approx each (FFMA of the raw score,
//    scale and max); O rescaled only where a warp's row max moved; P packed
//    by cvt.rn.bf16x2 (no PRMTs); P.V issued 16 keys at a time as each
//    step's P is made.
//  * tools/fa_hd64_variants.py builds it without these cuts (the plain
//    template at hd 64) and times both beside SDPA.  The schedules it was
//    chosen over (a third ring stage, tile i + 1's S issued before tile
//    i's softmax, two warpgroups on one ring) were slower (PERF.md,
//    section 6).  P.V twice (hi, lo) keeps it above SDPA's device time.
//
// CUDA cores (f32 at every hd, bf16 at hd 16 and 32):
//  * One block per (tile of query positions, kv head, sequence) takes the
//    whole query group of that KV head: BQ positions x group heads = up to
//    64 (query, head) rows, so each K/V tile is read from memory once per
//    group, not once per query head as the TPU grid does.
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
//
// Training (repro_flash_attention_lse, repro_flash_attention_tc_lse): both
// builds are templates over LSE; the LSE instantiations also write each
// (query position, head) row's f32 log-sum-exp of its scaled scores, lse
// (B, Sq, nq), which kernel 7's backward (flash_attention_bwd.cu) recomputes
// P from.  The serving instantiations (LSE false) are unchanged, and the
// LSE ones compute O with the same instructions, so O is bitwise the
// serving entry's.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

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

template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, int Sq, int Skv, int nq, int nkv, int BQ, int causal, int window, float scale) {
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
    // the row's log-sum-exp of its scaled scores (+inf for a row that sees
    // no key, so the backward's exp(s - lse) is 0 there)
    if constexpr (LSE) {
      if (lane == 0)
        lse[((long)b * Sq + qpos[i]) * nq + (long)kvh * G + g] =
            l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(0x7f800000);
    }
  }
}

template <typename T, int HD, bool LSE>
int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq, int Skv, int nq,
              int nkv, int causal, int window, float scale, void* stream) {
  const int G = nq / nkv;
  const int BQ = MAX_ROWS / G;
  const size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, nkv, B);
  flash_attention_kernel<T, HD, LSE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, Sq, Skv, nq, nkv, BQ, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core path
// ---------------------------------------------------------------------------

namespace tc {

constexpr int THREADS = 128;       // one warpgroup
constexpr int ROWS = 64;           // (query position, head) rows a block
constexpr int BN = 64;             // keys a tile
constexpr int BOX = 64 * 128;      // bytes of one box: 64 rows x 64 bf16

// shared memory: Q (ceil(hd / 64) boxes), then two stages of K and V, then three
// mbarriers (Q, stage 0, stage 1); the base is aligned to 1,024 bytes (the
// 128-byte swizzle's period) by hand
template <int HD>
struct Layout {
  static constexpr int KB = (HD + 63) / 64;
  static constexpr int KV = KB * BOX;
  static constexpr int STAGE = 2 * KB * BOX;
  static constexpr int BAR = KV + 2 * STAGE;
  static constexpr int BYTES = BAR + 3 * 8 + 1024;
};

// hd 64 takes the loop's lean softmax and its own block order (the file's
// header says why)
template <int HD>
constexpr bool LEAN = HD == 64;

// two floats as a bf16 pair in one register (a in the low half), rounded
// to nearest: one F2FP, where __floats2bfloat162_rn and the halves' reads
// cost PRMTs around it
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

// 2^x by one MUFU.EX2 (relative error ~2^-22; results below 2^-126 flush
// to 0): exp2f adds a scaling of subnormal results around it
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
    int Skv, int nq, int nkv, int BQ, int causal, int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int NO = HD / 2;  // O accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // hd 64's grid is one row of (query tile, kv head) pairs, every head's
  // last query tile (the most causal keys) first
  const int kvh = LEAN<HD> ? blockIdx.x % nkv : blockIdx.y, b = blockIdx.z;
  const int G = nq / nkv;
  const int q0 = (LEAN<HD> ? gridDim.x / nkv - 1 - blockIdx.x / nkv : blockIdx.x) * BQ;
  const int nqpos = min(BQ, Sq - q0);
  const int nrows = nqpos * G;
  const int q_last = q0 + nqpos - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  // thread 0 fills stage it & 1 with key tile it
  auto load_kv = [&](int it) {
    const int st = it & 1, k0 = k_begin + it * BN;
    const uint32_t bar = bars + 8 * (1 + st);
    const uint32_t sk = base + L::KV + st * L::STAGE, sv = sk + L::KB * BOX;
    sm90::mbar_expect_tx(bar, 2 * L::KB * BOX);
    for (int kb = 0; kb < L::KB; ++kb) {
      sm90::tma_load_4d(sk + kb * BOX, &tk, bar, kb * 64, kvh, k0, b);
      sm90::tma_load_4d(sv + kb * BOX, &tv, bar, kb * 64, kvh, k0, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // a Q box is G x BQ rows of 128 bytes: rows (position, head) in order
    sm90::mbar_expect_tx(bars, L::KB * 128 * G * BQ);
    for (int kb = 0; kb < L::KB; ++kb) sm90::tma_load_5d(base + kb * BOX, &tq, bars, kb * 64, 0, kvh, q0, b);
    if (ntiles > 0) load_kv(0);
  }
  __syncwarp();

  // this thread's rows of the accumulators: r0 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);  // its first column in each group of 8
  bool live[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    live[i] = r < nrows;
    qpos[i] = q0 + (live[i] ? r / G : 0);
  }
  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  sm90::mbar_wait(bars, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = k_begin + it * BN;
    if (tid == 0 && it + 1 < ntiles) load_kv(it + 1);  // its stage was released at the end of it - 1
    __syncwarp();
    sm90::mbar_wait(bars + 8 * (1 + st), (it >> 1) & 1);
    const uint32_t sk = base + L::KV + st * L::STAGE, sv = sk + L::KB * BOX;

    // S = Q K^T: hd / 16 steps of k16; step kk is box kk / 4, bytes 32 (kk % 4)
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    sm90::fence_operands(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      sm90::wgmma_ss_m64n64k16(s, sm90::desc_kmajor(base + off), sm90::desc_kmajor(sk + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);

    if constexpr (LEAN<HD>) {
      // mask only a tile that reaches past Skv, the causal diagonal or the
      // window's edge; s[e] is row r0 + 8 ((e >> 1) & 1), key
      // k0 + 8 (e >> 2) + cq + (e & 1)
      if (k0 + BN > Skv || (causal && k0 + BN - 1 > q0) || (window > 0 && q_last - k0 >= window)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int i = (e >> 1) & 1;
          const int kpos = k0 + 8 * (e >> 2) + cq + (e & 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos[i];
          if (window > 0) ok = ok && qpos[i] - kpos < window;
          s[e] = ok ? s[e] : REPRO_NEG_INF;
        }
      }
      // the row max of the raw scores by a tree (depth 4, not a chain of
      // 16), scaled once; m stays in base-2 units of the scaled scores
      float ms[2], corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) t[n] = fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]);
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
        float mx = fmaxf(m[i], t[0] * scale_log2);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row that has seen no key keeps max REPRO_NEG_INF; its offset 0
        // sends its masked scores to 0.  corr is exactly 1 where the max
        // did not move
        ms[i] = mx == REPRO_NEG_INF ? 0.f : mx;
        corr[i] = mx == m[i] ? 1.f : exp2_ftz(m[i] - mx);
        m[i] = mx;
      }
      // O rescaled only where a row of the warp's moved its max (none,
      // often, once the max has settled)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < NO; ++j) o[j] *= corr[(j >> 1) & 1];
      }
      sm90::fence_operands(o);
      // P.V in steps of 16 keys, each issued as soon as its P is made, so
      // the tensor cores start on step 0 while step 1's exponentials run.
      // Step ks: P = 2^(s scale_log2 - ms) of s[8 ks .. 8 ks + 7], its row
      // sums, and its hi and lo bf16 halves as the A operand (register x
      // packs s[2x], s[2x + 1])
      float rsum[2] = {0.f, 0.f};
      uint32_t ph[16], pl[16];
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        float part[2][4];
#pragma unroll
        for (int e = 8 * ks; e < 8 * ks + 8; ++e) {
          const int i = (e >> 1) & 1;
          s[e] = exp2_ftz(fmaf(s[e], scale_log2, -ms[i]));
          part[i][((e - 8 * ks) >> 2) * 2 + (e & 1)] = s[e];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) rsum[i] += (part[i][0] + part[i][1]) + (part[i][2] + part[i][3]);
#pragma unroll
        for (int x = 4 * ks; x < 4 * ks + 4; ++x) {
          ph[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
          const float h0 = __uint_as_float(ph[x] << 16), h1 = __uint_as_float(ph[x] & 0xffff0000u);
          pl[x] = pack_bf16(s[2 * x] - h0, s[2 * x + 1] - h1);
        }
        const uint64_t dv = sm90::desc_mnmajor(sv + ks * 16 * 128, BOX);
        const uint32_t ah[4] = {ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2], ph[4 * ks + 3]};
        const uint32_t al[4] = {pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2], pl[4 * ks + 3]};
        sm90::wgmma_fence();
        sm90::wgmma_rs_m64n64k16(o, ah, dv);
        sm90::wgmma_rs_m64n64k16(o, al, dv);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
        l[i] = l[i] * corr[i] + rsum[i];
      }
      // P's registers are read by the wgmma after their issue: kept live
      // until it is done
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
      sm90::fence_operands(ph);
      sm90::fence_operands(pl);
    } else {
      // mask and online softmax; s[e] is row r0 + 8 ((e >> 1) & 1), key
      // k0 + 8 (e >> 2) + cq + (e & 1)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const int kpos = k0 + 8 * (e >> 2) + cq + (e & 1);
        bool ok = live[i] && kpos < Skv;
        if (causal) ok = ok && kpos <= qpos[i];
        if (window > 0) ok = ok && qpos[i] - kpos < window;
        s[e] = ok ? s[e] * scale_log2 : REPRO_NEG_INF;
        mx[i] = fmaxf(mx[i], s[e]);
      }
      float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        corr[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const float p = s[e] == REPRO_NEG_INF ? 0.f : exp2f(s[e] - mx[i]);
        s[e] = p;
        rsum[i] += p;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
        l[i] = l[i] * corr[i] + rsum[i];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] *= corr[(j >> 1) & 1];

      // P as the A operand, hi and lo bf16 halves: register x packs s[2x],
      // s[2x + 1]; step ks takes registers 4 ks .. 4 ks + 3
      uint32_t ph[16], pl[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * x], s[2 * x + 1]);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(s[2 * x] - __low2float(hi), s[2 * x + 1] - __high2float(hi));
        ph[x] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[x] = *reinterpret_cast<const uint32_t*>(&lo);
      }
      sm90::fence_operands(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        const uint64_t dv = sm90::desc_mnmajor(sv + ks * 16 * 128, BOX);
        const uint32_t ah[4] = {ph[4 * ks], ph[4 * ks + 1], ph[4 * ks + 2], ph[4 * ks + 3]};
        const uint32_t al[4] = {pl[4 * ks], pl[4 * ks + 1], pl[4 * ks + 2], pl[4 * ks + 3]};
        if constexpr (HD == 256) {
          sm90::wgmma_rs_m64n256k16(o, ah, dv);
          sm90::wgmma_rs_m64n256k16(o, al, dv);
        } else if constexpr (HD == 160) {
          sm90::wgmma_rs_m64n160k16(o, ah, dv);
          sm90::wgmma_rs_m64n160k16(o, al, dv);
        } else if constexpr (HD == 128) {
          sm90::wgmma_rs_m64n128k16(o, ah, dv);
          sm90::wgmma_rs_m64n128k16(o, al, dv);
        } else {
          static_assert(HD == 96, "the tensor-core build's head dims: 64 (LEAN), 96, 128, 160, 256");
          sm90::wgmma_rs_m64n96k16(o, ah, dv);
          sm90::wgmma_rs_m64n96k16(o, al, dv);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // o[4 j + 2 i + c] is row r0 + 8 i, column 8 j + cq + c
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int g = (r0 + 8 * i) % G;
    __nv_bfloat16* orow = out + (((long)b * Sq + qpos[i]) * nq + (long)kvh * G + g) * HD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
    }
    // the row's natural log-sum-exp (m and l are in base-2 units of the
    // scaled scores); the four threads of a quad hold the same row
    if constexpr (LSE) {
      if ((lane & 3) == 0)
        lse[((long)b * Sq + qpos[i]) * nq + (long)kvh * G + g] =
            l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.6931471805599453f : __int_as_float(0x7f800000);
    }
  }
}

template <int HD, bool LSE>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq, int Skv, int nq,
           int nkv, int causal, int window, float scale, void* stream) {
  const int G = nq / nkv, BQ = ROWS / G;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  // Q as (hd, G, nkv, Sq, B): a box of (64, G, 1, BQ, 1) is one block's rows
  const cuuint64_t qdims[5] = {(cuuint64_t)HD, (cuuint64_t)G, (cuuint64_t)nkv, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstr[4] = {HD * e, (cuuint64_t)G * HD * e, (cuuint64_t)nq * HD * e,
                              (cuuint64_t)Sq * nq * HD * e};
  const cuuint32_t qbox[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)BQ, 1};
  // K, V as (hd, nkv, Skv, B): a box of (64, 1, BN, 1) is one key tile's 64 columns
  const cuuint64_t kdims[4] = {(cuuint64_t)HD, (cuuint64_t)nkv, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * e, (cuuint64_t)nkv * HD * e, (cuuint64_t)Skv * nkv * HD * e};
  const cuuint32_t kbox[4] = {64, 1, BN, 1};
  CUtensorMap tq, tk, tv;
  if (!sm90::bf16_tensor_map(&tq, q, 5, qdims, qstr, qbox) || !sm90::bf16_tensor_map(&tk, k, 4, kdims, kstr, kbox) ||
      !sm90::bf16_tensor_map(&tv, v, 4, kdims, kstr, kbox))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<HD>::BYTES;
  // the opt-in above 48 KB, once a process (the port drives one card a process)
  static const cudaError_t opted = cudaFuncSetAttribute(flash_attention_tc_kernel<HD, LSE>,
                                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opted != cudaSuccess) return (int)opted;
  const int tiles = (Sq + BQ - 1) / BQ;
  const dim3 grid = LEAN<HD> ? dim3(tiles * nkv, 1, B) : dim3(tiles, nkv, B);
  flash_attention_tc_kernel<HD, LSE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, Sq, Skv, nq, nkv, BQ, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <bool LSE>
int cuda_cores(int dtype, const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq, int Skv,
               int nq, int nkv, int hd, int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || nkv <= 0 || nq % nkv != 0 || nq / nkv > MAX_ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  REPRO_DISPATCH(dtype, T, {
    constexpr bool F32 = std::is_same<T, float>::value;
    switch (hd) {
      case 16: return launch_hd<T, 16, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 32: return launch_hd<T, 32, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
      case 64:
        if constexpr (F32)
          return launch_hd<T, 64, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
        return (int)cudaErrorInvalidValue;
      case 96:
        if constexpr (F32)
          return launch_hd<T, 96, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
        return (int)cudaErrorInvalidValue;
      case 128:
        if constexpr (F32)
          return launch_hd<T, 128, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
        return (int)cudaErrorInvalidValue;
      case 160:
        if constexpr (F32)
          return launch_hd<T, 160, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
        return (int)cudaErrorInvalidValue;
      case 256:
        if constexpr (F32)
          return launch_hd<T, 256, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
        return (int)cudaErrorInvalidValue;
      default: return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}

template <bool LSE>
int tensor_cores(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq, int Skv, int nq,
                 int nkv, int hd, int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || nkv <= 0 || nq % nkv != 0 || nq / nkv > tc::ROWS || window < 0)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return tc::launch<64, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 96: return tc::launch<96, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 128: return tc::launch<128, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 160: return tc::launch<160, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    case 256: return tc::launch<256, LSE>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, nq, hd), k/v (B, Skv, nkv, hd), out (B, Sq, nq, hd), all
// contiguous; nq / nkv <= 64; f32 at hd in {16, 32, 64, 96, 128, 160, 256},
// bf16 at hd in {16, 32} (bf16 at 64, 96, 128, 160 and 256 is
// repro_flash_attention_tc's).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out, int B,
                                     int Sq, int Skv, int nq, int nkv, int hd, int causal, int window, float scale,
                                     void* stream) {
  return cuda_cores<false>(dtype, q, k, v, out, nullptr, B, Sq, Skv, nq, nkv, hd, causal, window, scale, stream);
}

// The tensor-core path: bf16 q (B, Sq, nq, hd), k/v (B, Skv, nkv, hd), out
// (B, Sq, nq, hd), all contiguous and 16-byte aligned; hd in {64, 96, 128,
// 160, 256}; nq / nkv <= 64.
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                                        int Skv, int nq, int nkv, int hd, int causal, int window, float scale,
                                        void* stream) {
  return tensor_cores<false>(q, k, v, out, nullptr, B, Sq, Skv, nq, nkv, hd, causal, window, scale, stream);
}

// The training forward: the same two builds, separate instantiations that
// also write each (query position, head) row's f32 log-sum-exp of its
// scaled scores into lse (B, Sq, nq), which the backward
// (flash_attention_bwd.cu) recomputes P from.  O is computed exactly as
// the serving entries above compute it.
extern "C" int repro_flash_attention_lse(int dtype, const void* q, const void* k, const void* v, void* out,
                                         float* lse, int B, int Sq, int Skv, int nq, int nkv, int hd, int causal,
                                         int window, float scale, void* stream) {
  return cuda_cores<true>(dtype, q, k, v, out, lse, B, Sq, Skv, nq, nkv, hd, causal, window, scale, stream);
}

extern "C" int repro_flash_attention_tc_lse(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                                            int Sq, int Skv, int nq, int nkv, int hd, int causal, int window,
                                            float scale, void* stream) {
  return tensor_cores<true>(q, k, v, out, lse, B, Sq, Skv, nq, nkv, hd, causal, window, scale, stream);
}

// Plan-steered expert SwiGLU for tiny T (the Agile decode plane).
//
// Replaces: src/repro/kernels/moe_decode/kernel.py, decode_moe_pallas
// (kernel _decode_moe_kernel), its full-precision and int8 branches.
//
// What it computes: for each assignment (t, j), expert e = ids[t*k + j]
// selects w_gate[e], w_up[e] (d, f) and w_down[e] (f, d);
//   y[t] = sum_j w[t*k + j] * (silu(x[t] @ w_gate[e]) * (x[t] @ w_up[e])) @ w_down[e]
// accumulated in f32, out (T, d) f32.  No capacity, no slot tensors.
//
// What bounds it on the card: bytes — the weights of the distinct experts
// the plan names (3 * d * f elements each, 1 byte in the int8 branch, 2 in
// bf16); every weight element is used for 2 FLOPs per assignment that
// names its expert.  At the serving shape (16 tokens, top-8 of 128, d
// 4096, f 1536: 128 assignments over ~83 experts) that is 3.13 GB in bf16,
// 0.935 ms at 3.35 TB/s, against 4.8 GFLOP, ~0.07 ms on the f32 CUDA
// cores: the work stays on the CUDA cores, and one template serves f32,
// bf16 and int8 weights with one sum order, which keeps the int8 launch
// bitwise the f32 launch on the dequantized stacks.
//
// What the design does about it (the first version read an expert's
// weights once per assignment naming it, 1.54x the bytes, one element a
// thread with nothing staged ahead: 2.23 ms bf16, 2.88 int8):
//  * Each named expert's weights are read once, grouped on the card.  The
//    grid is static, (column tiles, T*k assignments); the block of
//    assignment a scans the plan's (T*k,) ids with warp ballots: it leads a
//    group if the number of earlier assignments naming its expert is a
//    multiple of GROUP (8), and then serves the next GROUP of them in
//    ascending order; every other block exits at once.  An expert named by
//    more than GROUP assignments (the shard-sliced plan's local expert 0)
//    takes several groups, read concurrently; nothing is skipped, so 0 x a
//    non-finite row stays NaN as in the reference.  Nothing is read back to
//    the host.
//  * Weights stream through a 3-stage ring: 64 K rows of a 128-column tile
//    of each matrix a stage by TMA (zeros past K and N), and beside them the
//    group's 64-element pieces of its activation rows (x rows, or h rows
//    for the down product) by 16-byte cp.async.  Rows that are not whole
//    16-byte pieces (ragged d or f) take element copies instead.  Eight warps split each stage's K rows eight apiece; a
//    thread owns 4 neighbouring columns and accumulates them for every
//    assignment of the group (1, 2, 4 or 8 in registers, the group's size
//    rounded up), then the warps' partial sums meet in a fixed tree.  64
//    rows a stage halve the barriers of 32 (int8 0.59-0.62 -> 0.54 ms,
//    bf16 unchanged; tools/moe_decode_variants.py), and TMA tiles took
//    bf16 from ~80 % of the bound with 16-byte cp.async tiles to 91 %.
//    The f32 build's ring is 198 KB, one block an SM; bf16's 101 KB and
//    int8's 52 KB, two.
//  * Three launches, no atomics: gate/up per (f tile, group) writes h =
//    silu(x Wg) * (x Wu) to an f32 scratch; down per (d tile, group) writes
//    w_a * (h_a Wd) for each assignment to a (T*k, d) f32 scratch; a small
//    third launch sums each token's k rows in ascending j, the reference's
//    own order (moe_decode/kernel.py, the (t, j) grid), so a repeated launch
//    is bitwise equal.
//  * The int8 branch (stacks int8, per-expert f32 scales sg, su, sd; x f32
//    or bf16) converts 4 codes a 32-bit word without the int-to-float unit:
//    the codes biased by 128 are placed by __byte_perm in the low byte of
//    1.5 * 2^23 and the bias subtracted, exact for every int8; then
//    __fmul_rn(., s[e]) as each element reaches f32, before it meets x (the
//    TPU kernel's dequantize-before-dot), so the launch is bitwise the f32
//    launch on the dequantized stacks and f32 x.
//
// Measured at the serving shape (H100 80GB HBM3, 700 W; PERF.md, section
// 6): bf16 1.027 ms (device 1.005, 93 % of the byte bound), int8 0.552
// (device 0.536), against 2.228 and 2.894 for the first version in the
// same call.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SLICES = THREADS / 32;  // warps; each takes RPS of a stage's K rows
constexpr int CPT = 4;                // neighbouring output columns a thread
constexpr int BN = 32 * CPT;          // output columns a block
constexpr int BK = 64;                // K rows a stage
constexpr int RPS = BK / SLICES;      // K rows a warp takes of each stage
constexpr int GROUP = 8;              // assignments a block serves at most
constexpr int STAGES = 3;

// shared memory of one stage: NM (BK x BN) weight tiles in TW, then the
// group's (GROUP x BK) activation pieces in TA; after the K loop the ring
// holds the warps' partial sums
template <typename TW, typename TA, int NM>
struct Ring {
  static constexpr int W_BYTES = BK * BN * (int)sizeof(TW);
  static constexpr int STAGE = NM * W_BYTES + GROUP * BK * (int)sizeof(TA);
  static constexpr int RED = (SLICES / 2) * NM * GROUP * BN * (int)sizeof(float);
  static constexpr int BYTES = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static_assert(W_BYTES % 128 == 0 && STAGE % 128 == 0, "TMA destinations on 128-byte boundaries");
};

// an element's raw bits, for copies that do not convert
template <int B> struct Raw;
template <> struct Raw<1> { using T = uint8_t; };
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<4> { using T = uint32_t; };

// four neighbouring weight elements of a tile row as f32, each as the int8
// branch reads it (load_scaled's value)
__device__ __forceinline__ void four(const float* p, float, float (&v)[CPT]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void four(const __nv_bfloat16* p, float, float (&v)[CPT]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void four(const int8_t* p, float s, float (&v)[CPT]) {
  // code c ^ 0x80 is c + 128 as a byte; in the low byte of 0x4B400000
  // (1.5 * 2^23) it makes the float 12,582,912 + c + 128 exactly
  const uint32_t q = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    v[i] = __fmul_rn(__uint_as_float(__byte_perm(q, 0x4B400000u, 0x7640u + i)) - 12583040.0f, s);
}

// the dynamic shared memory, from its first 128-byte boundary (a TMA
// destination's alignment); a launch asks for Ring::BYTES + 128
__device__ __forceinline__ unsigned char* ring_base() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((128u - (sm90::smem_u32(smem_raw) & 127u)) & 127u);
}

// The block's group: writes list[0 .. n) (ascending assignment indices that
// name ids[a]) and returns n, or 0 where the block leads no group.
__device__ __forceinline__ int find_group(const int* __restrict__ ids, int TK, int a, int* list, int* n_s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int e = ids[a];
    int rank = 0, cnt = 0;  // assignments naming e before a; from a on
    for (int i0 = 0; i0 < TK; i0 += 32) {
      const int i = i0 + lane;
      const bool hit = i < TK && ids[i] == e;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      const int below = a - i0;
      const unsigned before = below >= 32 ? 0xffffffffu : below <= 0 ? 0u : (1u << below) - 1u;
      rank += __popc(bal & before);
      const unsigned from = bal & ~before;
      if (hit && i >= a) {
        const int p = cnt + __popc(from & ((1u << lane) - 1u));
        if (p < GROUP) list[p] = i;
      }
      cnt += __popc(from);
      if (cnt >= GROUP && i0 + 32 > a) break;  // warp-uniform
    }
    if (lane == 0) *n_s = rank % GROUP == 0 ? min(cnt, GROUP) : 0;
  }
  __syncthreads();
  return *n_s;
}

// One group of NA (>= its n) assignments through NM weight matrices of
// expert e: gate/up (NM 2: Wg, Wu; act x (T, K = d), row list[a] / k; out h
// (T*k, N = f)) or down (NM 1: Wd; act h (T*k, K = f), row list[a]; out the
// weighted rows (T*k, N = d)).
template <typename TA, typename TW, int NM, int NA, bool VEC>
__device__ __forceinline__ void serve_group(
    const TA* __restrict__ act, const TW* const (&wm)[NM], const CUtensorMap* const (&tm)[NM], uint32_t full,
    const float (&sc)[NM], const float* __restrict__ w, float* __restrict__ out, const int* list, const int* arow,
    int n, int e, int K, int N, int n0) {
  using R = Ring<TW, TA, NM>;
  unsigned char* smem = ring_base();
  const int tid = threadIdx.x, lane = tid & 31, sl = tid >> 5;
  const int nk = (K + BK - 1) / BK;

  // stage it % STAGES <- K rows it * BK .. of the tiles and of the group's rows
  auto load = [&](int it) {
    unsigned char* st = smem + (it % STAGES) * R::STAGE;
    const int k0 = it * BK;
    if constexpr (VEC) {  // N and K whole numbers of 16-byte pieces: a piece is all in or all out
      if (tid == 0) {  // the weight tiles by TMA, zeros past K and N
        const uint32_t bar = full + 8 * (it % STAGES);
        sm90::mbar_expect_tx(bar, NM * R::W_BYTES);
#pragma unroll
        for (int m = 0; m < NM; ++m) sm90::tma_load_3d(sm90::smem_u32(st + m * R::W_BYTES), tm[m], bar, n0, k0, e);
      }
      constexpr int CA = 16 / sizeof(TA), PA = BK / CA;
      for (int i = tid; i < NA * PA; i += THREADS) {
        const int a = i / PA, kk = (i - a * PA) * CA;
        const bool in = a < n && k0 + kk < K;
        sm90::cp_async16(sm90::smem_u32(st + NM * R::W_BYTES + (a * BK + kk) * sizeof(TA)),
                         in ? act + (long)arow[a] * K + k0 + kk : act, in ? 16 : 0);
      }
    } else {  // ragged rows: element copies, zeros past the edges
      using RW = typename Raw<sizeof(TW)>::T;
      using RA = typename Raw<sizeof(TA)>::T;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const RW* src = reinterpret_cast<const RW*>(wm[m]);
        RW* dst = reinterpret_cast<RW*>(st + m * R::W_BYTES);
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int r = i / BN, c = i - r * BN;
          dst[i] = (k0 + r < K && n0 + c < N) ? src[(long)(k0 + r) * N + n0 + c] : RW(0);
        }
      }
      const RA* src = reinterpret_cast<const RA*>(act);
      RA* dst = reinterpret_cast<RA*>(st + NM * R::W_BYTES);
      for (int i = tid; i < NA * BK; i += THREADS) {
        const int a = i / BK, kk = i - a * BK;
        dst[i] = (a < n && k0 + kk < K) ? src[(long)arow[a] * K + k0 + kk] : RA(0);
      }
    }
  };

  float acc[NM][NA][CPT];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][a][c] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    sm90::cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    sm90::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it's copies have landed for all; stage it - 1 is read by none
    if (it + STAGES - 1 < nk) load(it + STAGES - 1);
    sm90::cp_async_commit();
    if constexpr (VEC) sm90::mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);  // and its tiles
    const unsigned char* st = smem + (it % STAGES) * R::STAGE;
    const TA* as = reinterpret_cast<const TA*>(st + NM * R::W_BYTES);
#pragma unroll
    for (int r = 0; r < RPS; ++r) {
      const int kr = sl * RPS + r;  // K row k0 + kr, in ascending order within the warp's share
      float wv[NM][CPT];
#pragma unroll
      for (int m = 0; m < NM; ++m)
        four(reinterpret_cast<const TW*>(st + m * R::W_BYTES) + kr * BN + CPT * lane, sc[m], wv[m]);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float xv = to_f32(as[a * BK + kr]);
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[m][a][c] = fmaf(xv, wv[m][c], acc[m][a][c]);
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the warps' partial sums in a fixed tree: ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7))
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int half = SLICES / 2; half >= 1; half /= 2) {
    if (sl >= half && sl < 2 * half)
#pragma unroll
      for (int m = 0; m < NM; ++m)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          *reinterpret_cast<float4*>(red + (((sl - half) * NM + m) * NA + a) * BN + CPT * lane) =
              make_float4(acc[m][a][0], acc[m][a][1], acc[m][a][2], acc[m][a][3]);
    __syncthreads();
    if (sl < half)
#pragma unroll
      for (int m = 0; m < NM; ++m)
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const float4 o = *reinterpret_cast<const float4*>(red + ((sl * NM + m) * NA + a) * BN + CPT * lane);
          acc[m][a][0] += o.x, acc[m][a][1] += o.y, acc[m][a][2] += o.z, acc[m][a][3] += o.w;
        }
    __syncthreads();
  }

  if (sl == 0) {
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      if (a >= n) break;
      float v[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if constexpr (NM == 2) v[c] = silu_f32(acc[0][a][c]) * acc[1][a][c];
        else v[c] = w[list[a]] * acc[0][a][c];
      }
      float* o = out + (long)list[a] * N + n0 + CPT * lane;
      if constexpr (VEC) {  // N is a multiple of 4 here
        if (n0 + CPT * lane < N) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (n0 + CPT * lane + c < N) o[c] = v[c];
      }
    }
  }
}

// grid (ceil(N / BN), T*k): column tile blockIdx.x for the group led by
// assignment blockIdx.y
template <typename TA, typename TW, int NM, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) expert_kernel(
    const __grid_constant__ CUtensorMap ta,  // VEC: wa as (N, K, E), boxes of (BN, BK, 1)
    const __grid_constant__ CUtensorMap tb,  // VEC, gate/up: wb the same
    const TA* __restrict__ act, const int* __restrict__ ids, const float* __restrict__ w,
    const TW* __restrict__ wa, const TW* __restrict__ wb,        // gate/up: Wg, Wu; down: Wd, unused
    const float* __restrict__ sa, const float* __restrict__ sb,  // int8: their (E,) scales; otherwise unused
    float* __restrict__ out, int TK, int k, int K, int N) {
  __shared__ int list[GROUP], arow[GROUP], n_s;
  __shared__ uint64_t full_bar[STAGES];  // VEC: a stage's weight tiles have landed
  const int n = find_group(ids, TK, blockIdx.y, list, &n_s);
  if (n == 0) return;
  if (threadIdx.x < n) arow[threadIdx.x] = NM == 2 ? list[threadIdx.x] / k : list[threadIdx.x];
  const uint32_t full = sm90::smem_u32(full_bar);
  if (VEC && threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) sm90::mbar_init(full + 8 * s, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const long e = ids[blockIdx.y];
  constexpr bool Q8 = std::is_same<TW, int8_t>::value;
  const TW* wm[NM];
  const CUtensorMap* tm[NM];
  float sc[NM];
  wm[0] = wa + e * K * (long)N;
  tm[0] = &ta;
  sc[0] = Q8 ? sa[e] : 1.f;
  if constexpr (NM == 2) {
    wm[1] = wb + e * K * (long)N;
    tm[1] = &tb;
    sc[1] = Q8 ? sb[e] : 1.f;
  }
  const int n0 = blockIdx.x * BN, ei = (int)e;
#define SERVE(NA) serve_group<TA, TW, NM, NA, VEC>(act, wm, tm, full, sc, w, out, list, arow, n, ei, K, N, n0)
  if (n <= 1) SERVE(1);
  else if (n <= 2) SERVE(2);
  else if (n <= 4) SERVE(4);
  else SERVE(GROUP);
#undef SERVE
}

// out[t, c] = sum over j ascending of rows[t*k + j, c]
__global__ void __launch_bounds__(256) combine_kernel(const float* __restrict__ rows, float* __restrict__ out, int k,
                                                      int d) {
  const int t = blockIdx.y, c = blockIdx.x * 256 + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) acc += rows[((long)t * k + j) * d + c];
  out[(long)t * d + c] = acc;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <> constexpr CUtensorMapDataType tma_type<int8_t>() { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }

// the tensor map of an (E, K, N) stack as (N, K, E) with boxes of (BN, BK,
// 1) laid out as the ring's row-major tiles (no swizzle), zeros outside
template <typename TW>
bool weight_map(CUtensorMap* map, const TW* base, int E, int K, int N) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t b = sizeof(TW);
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {N * b, (cuuint64_t)K * N * b};
  const cuuint32_t box[3] = {BN, BK, 1}, unit[3] = {1, 1, 1};
  return fn(map, tma_type<TW>(), 3, const_cast<TW*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one expert_kernel launch: the 16-byte build (weight tiles by TMA, the
// group's rows by cp.async) where every row is a whole number of 16-byte
// pieces, element copies otherwise
template <typename TA, typename TW, int NM>
cudaError_t launch(const TA* act, const int* ids, const float* w, const TW* wa, const TW* wb, const float* sa,
                   const float* sb, float* out, int E, int TK, int k, int K, int N, cudaStream_t stream) {
  const bool vec = N % (16 / sizeof(TW)) == 0 && K % (16 / sizeof(TA)) == 0 && aligned16(act) && aligned16(wa) &&
                   aligned16(wb) && aligned16(out);
  CUtensorMap ta{}, tb{};
  if (vec && !(weight_map(&ta, wa, E, K, N) && weight_map(&tb, wb, E, K, N))) return cudaErrorInvalidValue;
  const size_t bytes = Ring<TW, TA, NM>::BYTES + 128;
  const dim3 grid((N + BN - 1) / BN, TK);
  auto kernel = vec ? expert_kernel<TA, TW, NM, true> : expert_kernel<TA, TW, NM, false>;
  // the opt-in above 48 KB (f32 weights), once a process for each build
  static const cudaError_t opted[2] = {
      cudaFuncSetAttribute(expert_kernel<TA, TW, NM, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes),
      cudaFuncSetAttribute(expert_kernel<TA, TW, NM, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)};
  if (opted[vec] != cudaSuccess) return opted[vec];
  kernel<<<grid, THREADS, bytes, stream>>>(ta, tb, act, ids, w, wa, wb, sa, sb, out, TK, k, K, N);
  return cudaGetLastError();
}

}  // namespace

// x_dtype / w_dtype: 0 f32, 1 bf16 (the same for both), or w_dtype 2 (int8
// stacks, then sg, su, sd (E,) f32 each; otherwise they may be null).
// scratch: f32, T*k*f elements of h rows, then, from the next multiple of 4
// elements, T*k*d of weighted down rows; out (T, d) f32, every element
// written.  Three launches: gate/up, down, the combine.
extern "C" int repro_decode_moe(int x_dtype, int w_dtype, const void* x, const void* ids, const void* w,
                                const void* wg, const void* wu, const void* wd, const void* sg, const void* su,
                                const void* sd, void* scratch, void* out, int E, int T, int k, int d, int f,
                                void* stream) {
  if (w_dtype == 2 && (sg == nullptr || su == nullptr || sd == nullptr)) return (int)cudaErrorInvalidValue;
  const int TK = T * k;
  if (T <= 0 || d <= 0) return 0;
  if (E <= 0 || k < 0 || f < 0 || TK > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* h = (float*)scratch;
  float* rows = h + (((long)TK * f + 3) & ~3L);
  REPRO_DISPATCH_PAIR(x_dtype, w_dtype, TX, TW, {
    cudaError_t e = cudaSuccess;
    if (TK > 0 && f > 0)
      e = launch<TX, TW, 2>((const TX*)x, (const int*)ids, (const float*)w, (const TW*)wg, (const TW*)wu,
                            (const float*)sg, (const float*)su, h, E, TK, k, d, f, s);
    if (e != cudaSuccess) return (int)e;
    if (TK > 0)
      e = launch<float, TW, 1>(h, (const int*)ids, (const float*)w, (const TW*)wd, (const TW*)wd, (const float*)sd,
                               (const float*)sd, rows, E, TK, k, f, d, s);
    if (e != cudaSuccess) return (int)e;
  });
  combine_kernel<<<dim3((d + 255) / 256, T), 256, 0, s>>>(rows, (float*)out, k, d);
  return (int)cudaGetLastError();
}

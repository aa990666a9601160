// Diagonal linear recurrence of the RG-LRU: h_t = a_t * h_{t-1} + b_t.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py, rglru_scan_pallas (kernel
// _rglru_kernel).  Inputs a, b (B, T, W) in f32 or bf16, h0 (B, W) f32 or
// null (zeros); the output (B, T, W) is f32, as in the TPU kernel.
//
// What bounds it on the card: bytes.  Each (b, t, w) element is read twice
// (a, b) and written once for one multiply-add: 12 bytes per 2 FLOPs in f32,
// 8 with bf16 inputs.  The recurrence is serial in t and independent across
// channels, and the serving shape has one batch row: one thread per channel
// walking all of T (the design this replaces) gives 2,560 threads, 40 of
// the card's 132 SMs, and the walk's load latency.
//
// What the design does about it: a chunked scan over T in one launch, each
// byte of a and b read once.
//  * A block takes a chunk of CHUNK = 128 steps x a tile of 32 * V channels
//    (V = 4 channels a lane: 16 bytes of f32 a and of b a step, 8 of bf16;
//    1 where W or the bases do not allow it, ops.rglru_scan_path).  Its 16
//    warps take 16 segments of SEG = 8 steps; each thread loads its 8 steps
//    of a and b into registers at once (16 loads in flight a thread, 64 KB
//    a block in f32) and keeps them there.  At (1, 4096, 2560) that is 32
//    chunks x 20 tiles = 640 blocks, one an SM at a time.
//  * Per chunk, from 0: each thread folds its segment into an aggregate
//    (A = the product of a, H = the segment's scan from 0); warp 0 folds
//    the 16 segments' aggregates in ascending order into the chunk's and
//    publishes it: its lanes store the values, __syncwarp, lane 0 stores a
//    flag with release semantics.
//  * The carry into chunk c: h0 (or 0), then the aggregates of chunks
//    0..c-1 in ascending order, h = A_j h + H_j.  The tile's first V warps
//    acquire the c flags (a lane a flag), then fold, one channel a lane,
//    FOLD_RUN aggregates' loads in flight.  Then each warp folds the
//    segments before its own into that carry and walks its segment again,
//    h = a h + b, from the registers, writing h.
//  * Determinism: every value is a fixed sequence of f32 FMAs and products
//    fixed by the shapes alone (the chunk and segment structure, never the
//    tile width, the SM count or timing), so a repeated launch is bitwise
//    equal and the 1- and 4-channel builds agree bit for bit.  Blocks take
//    (chunk, batch row, tile) from an atomic ticket, chunk slowest, so a
//    block only waits on blocks that already run: no deadlock whatever
//    order the card starts blocks in.  The ticket and the flags are zeroed
//    by a memset on the launch's stream; the scratch (flags, then the
//    aggregates) comes from the wrapper.
// Measured on an H100 80GB HBM3 at 700 W (tools/rglru_variants.py; PERF.md
// section 6): 0.063 ms device f32 and 0.051-0.053 bf16 at (1, 4096, 2560),
// against byte bounds of 0.0376 and 0.0250.  A block's life there (10.4 us
// f32) is ~2/5 loading, ~1/4 waiting for the earlier chunks' flags and ~1/5
// folding their aggregates.  In the same call chunks of 64 (two blocks an
// SM) took 0.066 and 0.056, a __threadfence beside each release and acquire
// 0.067 and 0.055, the three-launch form 0.085 and 0.061.
//
// The backward (training), repro_rglru_scan_bwd: the same kernel
// instantiated with REV, one launch after the flags' memset.  Given g =
// dL/dh it runs the reverse recurrence delta_t = g_t + a_{t+1} delta_{t+1}
// (delta_{T-1} = g_{T-1}) as the forward scan over reversed time: step r is
// time t = T-1-r, its multiplier a_{t+1} (1 at r = 0) and its input g_t, so
// the chunks and segments are the forward's, mirrored (chunk 0 holds the
// last 128 steps), and every sum is again fixed by the shapes alone.  The
// walk's epilogue writes db_t = delta_t and da_t = delta_t h_{t-1} (the
// forward's output one step earlier; h0, or 0, at t = 0) in a's type, and
// dh0 = a_0 delta_0 (f32) when h0 was given.  The ticket is the only atomic
// either direction takes: it orders the blocks, no value passes through it.
#include "common.cuh"

namespace {

constexpr int WARPS = 16;           // segments a chunk, one warp each
constexpr int SEG = 8;              // steps a thread walks
constexpr int CHUNK = WARPS * SEG;  // steps a block takes (ops.CHUNK)
constexpr int THREADS = 32 * WARPS;
constexpr int LANE_CHANNELS = 4;    // V: a lane's channels (16 bytes of f32 a step, 8 of bf16; ops.LANE_CHANNELS)
constexpr int FOLD_RUN = 16;        // earlier chunks' aggregates a lane loads ahead in the carry's fold

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// With -DREPRO_RGLRU_TRACE (tools/rglru_variants.py) thread 0 of each of the
// first TRACE_BLOCKS tickets records its SM and %globaltimer at 7 points of
// the block's life (start, ticket, segments loaded, earlier chunks' flags
// acquired, carry folded, barrier, walk issued); repro_rglru_trace_copy
// reads them back.  Off, the points compile to nothing.
#ifdef REPRO_RGLRU_TRACE
constexpr int TRACE_BLOCKS = 8192;
__device__ unsigned long long rglru_trace[TRACE_BLOCKS][8];
__device__ __forceinline__ void trace_point(int ticket, int i) {
  if (threadIdx.x == 0 && ticket < TRACE_BLOCKS) {
    unsigned long long t;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
    rglru_trace[ticket][0] = sm;
    rglru_trace[ticket][1 + i] = t;
  }
}
#else
__device__ __forceinline__ void trace_point(int, int) {}
#endif

// words of int flags before the aggregates: the ticket, one flag a (batch
// row, chunk, tile), padded to 16 bytes (ops.scratch_words)
__host__ __device__ inline long flag_words(int B, int nchunks, int ntiles) {
  return (1 + (long)B * nchunks * ntiles + 3) / 4 * 4;
}

// One thread's segment: SEG steps of V channels of a and b, loaded at once
// and kept in registers for both walks.  Step s is at element at0 + s *
// stride (stride -W in the reversed walk); with one_first step 0's
// multiplier is 1 and is not read (the reversed walk's first step, which has
// no a_{t+1}).
template <typename TA, typename TB, int V>
struct Segment {
  Pack<TA, V> a[SEG];
  Pack<TB, V> b[SEG];
  int n;  // steps inside T

  __device__ __forceinline__ void load(const TA* __restrict__ pa, const TB* __restrict__ pb, long at0, long stride,
                                       int steps, bool live, bool one_first) {
    n = live ? steps : 0;
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      if (s < n) {
        if (s == 0 && one_first) {
#pragma unroll
          for (int v = 0; v < V; ++v) a[s].v[v] = from_f32<TA>(1.0f);
        } else {
          a[s] = *reinterpret_cast<const Pack<TA, V>*>(pa + at0 + s * stride);
        }
        b[s] = *reinterpret_cast<const Pack<TB, V>*>(pb + at0 + s * stride);
      }
    }
  }

  // the aggregate from 0: A = a_0 ... a_{n-1}, H = the scan's last value
  // (1 and 0 for a segment past T)
  __device__ __forceinline__ void aggregate(float (&A)[V], float (&H)[V]) const {
#pragma unroll
    for (int v = 0; v < V; ++v) A[v] = 1.0f, H[v] = 0.0f;
    if (n > 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) A[v] = to_f32(a[0].v[v]), H[v] = to_f32(b[0].v[v]);
    }
#pragma unroll
    for (int s = 1; s < SEG; ++s) {
      if (s < n) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float av = to_f32(a[s].v[v]);
          H[v] = fmaf(av, H[v], to_f32(b[s].v[v]));
          A[v] = av * A[v];
        }
      }
    }
  }

  // the walk again from h, writing each step's h
  __device__ __forceinline__ void walk(float (&h)[V], float* __restrict__ o, int W) const {
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      if (s < n) {
        Pack<float, V> hs;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          h[v] = fmaf(to_f32(a[s].v[v]), h[v], to_f32(b[s].v[v]));
          hs.v[v] = h[v];
        }
        *reinterpret_cast<Pack<float, V>*>(o + (long)s * W) = hs;
      }
    }
  }

  // the reversed walk again from delta: step s at element at0 - s W (time
  // t0 - s), writing db = delta and da = delta h_{t-1} (hp: the segment's
  // h_{t-1}, loaded before the walk)
  __device__ __forceinline__ void walk_bwd(float (&dl)[V], const Pack<float, V> (&hp)[SEG], TA* __restrict__ db,
                                           TA* __restrict__ da, long at0, int W) const {
#pragma unroll
    for (int s = 0; s < SEG; ++s) {
      if (s < n) {
        Pack<TA, V> ds, as;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          dl[v] = fmaf(to_f32(a[s].v[v]), dl[v], to_f32(b[s].v[v]));
          ds.v[v] = from_f32<TA>(dl[v]);
          as.v[v] = from_f32<TA>(dl[v] * hp[s].v[v]);
        }
        *reinterpret_cast<Pack<TA, V>*>(db + at0 - (long)s * W) = ds;
        *reinterpret_cast<Pack<TA, V>*>(da + at0 - (long)s * W) = as;
      }
    }
  }
};

// What the reversed instantiation reads and writes beside the forward's
// operands (all null in the forward): the forward's output h, h0's gradient,
// a's and b's gradients.
template <typename TA>
struct Grads {
  const float* h;  // (B, T, W): the forward's output
  float* dh0;      // (B, W) or null
  TA* da;          // (B, T, W)
  TA* db;          // (B, T, W)
};

// A block's segment aggregates (one row a warp) and the carry into its chunk.
template <int V>
struct Shared {
  float A[WARPS][32 * V], H[WARPS][32 * V], carry[32 * V];

  // h folded with rows [0, count) in ascending order, at this lane's channels
  __device__ __forceinline__ void fold(float (&h)[V], int count, int lane) const {
    for (int w = 0; w < count; ++w) {
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(A[w][lane * V + v], h[v], H[w][lane * V + v]);
    }
  }

  // the chunk's aggregate: the WARPS rows folded in ascending order
  __device__ __forceinline__ void chunk(float (&Ac)[V], float (&Hc)[V], int lane) const {
#pragma unroll
    for (int v = 0; v < V; ++v) Ac[v] = A[0][lane * V + v], Hc[v] = H[0][lane * V + v];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float aw = A[w][lane * V + v];
        Hc[v] = fmaf(aw, Hc[v], H[w][lane * V + v]);
        Ac[v] = aw * Ac[v];
      }
    }
  }
};

// Load the block's segment and publish its aggregate to shared memory.  In
// the reversed walk step r is time Tn-1-r and its multiplier a_{t+1} is read
// one time step on (a + W).
template <bool REV, typename TA, typename TB, int V>
__device__ __forceinline__ void segment_phase(Segment<TA, TB, V>& seg, Shared<V>& sm, const TA* a, const TB* b,
                                              int bb, int c, int ch, int Tn, int W, int warp, int lane) {
  const int t0 = c * CHUNK + warp * SEG;
  const bool live = ch < W;  // V divides W, so a live lane's V channels all are
  const int steps = max(0, min(SEG, Tn - t0));
  if (REV)
    seg.load(a + W, b, ((long)bb * Tn + Tn - 1 - t0) * W + ch, -(long)W, steps, live, t0 == 0);
  else
    seg.load(a, b, ((long)bb * Tn + t0) * W + ch, W, steps, live, false);
  float A[V], H[V];
  seg.aggregate(A, H);
  if (live) {
#pragma unroll
    for (int v = 0; v < V; ++v) sm.A[warp][lane * V + v] = A[v], sm.H[warp][lane * V + v] = H[v];
  }
}

// After the chunk's carry is in shared memory: the segment's carry (the
// chunk's, then the segments before it), then the walk.
template <typename T, int V>
__device__ __forceinline__ void walk_phase(const Segment<T, T, V>& seg, const Shared<V>& sm, float* out, int bb,
                                           int c, int ch, int Tn, int W, int warp, int lane) {
  if (seg.n == 0) return;
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = sm.carry[lane * V + v];
  sm.fold(h, warp, lane);
  seg.walk(h, out + ((long)bb * Tn + c * CHUNK + warp * SEG) * W + ch, W);
}

// The reversed walk: h_{t-1} of the segment's steps loaded first, then the
// walk from the segment's carry with the gradients as its epilogue; the step
// at t = 0 also writes dh0 = a_0 delta_0.
template <typename TA, int V>
__device__ __forceinline__ void walk_phase_bwd(const Segment<TA, float, V>& seg, const Shared<V>& sm, const TA* a,
                                               const float* h0, const Grads<TA>& gr, int bb, int c, int ch, int Tn,
                                               int W, int warp, int lane) {
  if (seg.n == 0) return;
  const int t0 = Tn - 1 - (c * CHUNK + warp * SEG);
  const long at0 = ((long)bb * Tn + t0) * W + ch;
  Pack<float, V> hp[SEG];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    if (s < seg.n) {
      if (t0 - s > 0) {
        hp[s] = *reinterpret_cast<const Pack<float, V>*>(gr.h + at0 - (long)(s + 1) * W);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) hp[s].v[v] = h0 != nullptr ? h0[(long)bb * W + ch + v] : 0.0f;
      }
    }
  }
  float dl[V];
#pragma unroll
  for (int v = 0; v < V; ++v) dl[v] = sm.carry[lane * V + v];
  sm.fold(dl, warp, lane);
  seg.walk_bwd(dl, hp, gr.db, gr.da, at0, W);
  if (gr.dh0 != nullptr && t0 - (seg.n - 1) == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) gr.dh0[(long)bb * W + ch + v] = to_f32(a[(long)bb * Tn * W + ch + v]) * dl[v];
  }
}

template <bool REV, typename TA, typename TB, int V>
__global__ void __launch_bounds__(THREADS, 1) rglru_chunk_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b, const float* __restrict__ h0, float* __restrict__ out,
    int* __restrict__ flags, float* __restrict__ agg, int B, int Tn, int W, int nchunks, int ntiles,
    Grads<TA> grads) {
  __shared__ Shared<V> sm;
  __shared__ int s_ticket;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#ifdef REPRO_RGLRU_TRACE
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
#endif
  if (threadIdx.x == 0) s_ticket = atomicAdd(flags, 1);
  __syncthreads();
  const int ticket = s_ticket;
#ifdef REPRO_RGLRU_TRACE
  if (threadIdx.x == 0 && ticket < TRACE_BLOCKS) rglru_trace[ticket][1] = t0;
#endif
  trace_point(ticket, 1);
  const int tile = ticket % ntiles, row = ticket / ntiles, bb = row % B, c = row / B;
  const int ch = tile * 32 * V + lane * V;
  const bool live = ch < W;
  Segment<TA, TB, V> seg;
  segment_phase<REV>(seg, sm, a, b, bb, c, ch, Tn, W, warp, lane);
  __syncthreads();
  trace_point(ticket, 2);

  const long chunk_row = (long)bb * nchunks;
  // warp 0 publishes the chunk's aggregate (every chunk but the last, whose
  // segments are then all full)
  if (warp == 0 && c + 1 < nchunks) {
    if (live) {
      float Ac[V], Hc[V];
      sm.chunk(Ac, Hc, lane);
      float* dst = agg + (chunk_row + c) * 2 * W + ch;
#pragma unroll
      for (int v = 0; v < V; ++v) __stcg(dst + v, Ac[v]), __stcg(dst + W + v, Hc[v]);
    }
    __syncwarp();  // the warp's stores before lane 0's release (as CUTLASS's semaphore)
    if (lane == 0) st_release(flags + 1 + (chunk_row + c) * ntiles + tile, 1);
  }
  // the carry into the chunk, h0 then chunks 0..c-1's aggregates in order,
  // by the tile's first V warps, one channel a lane, FOLD_RUN aggregates'
  // loads in flight a lane
  if (warp < V) {
    const int k = warp * 32 + lane, chf = tile * 32 * V + k;
    float carry = (!REV && h0 != nullptr && chf < W) ? h0[(long)bb * W + chf] : 0.0f;
    if (c > 0) {
      const int* fl = flags + 1 + chunk_row * ntiles + tile;
      for (int j = lane; j < c; j += 32) {
        for (unsigned spins = 0; ld_acquire(fl + (long)j * ntiles) == 0; ++spins) {
          if (spins == (1u << 24)) __trap();  // over a second without the flag: a broken launch, not a slow one
          __nanosleep(64);
        }
      }
      __syncwarp();  // each lane's acquire before every lane's reads
    }
    trace_point(ticket, 3);
    if (c > 0 && chf < W) {
      const float* src = agg + chunk_row * 2 * W + chf;
#pragma unroll (FOLD_RUN)
      for (int j = 0; j < c; ++j) carry = fmaf(__ldcg(src + (long)j * 2 * W), carry, __ldcg(src + (long)j * 2 * W + W));
    }
    if (chf < W) sm.carry[k] = carry;
    trace_point(ticket, 4);
  }
  __syncthreads();
  trace_point(ticket, 5);
  if constexpr (REV)
    walk_phase_bwd(seg, sm, a, h0, grads, bb, c, ch, Tn, W, warp, lane);
  else
    walk_phase(seg, sm, out, bb, c, ch, Tn, W, warp, lane);
  trace_point(ticket, 6);
}

template <bool REV, typename TA, typename TB, int V>
int launch(const void* a, const void* b, const void* h0, void* out, void* scratch, int B, int Tn, int W,
           cudaStream_t stream, Grads<TA> grads = {}) {
  const int nchunks = (Tn + CHUNK - 1) / CHUNK, ntiles = (W + 32 * V - 1) / (32 * V);
  const long words = flag_words(B, nchunks, ntiles);
  const long blocks = (long)B * nchunks * ntiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  rglru_chunk_kernel<REV, TA, TB, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const TA*)a, (const TB*)b, (const float*)h0, (float*)out, (int*)scratch, (float*)scratch + words, B, Tn, W,
      nchunks, ntiles, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: channels a lane, 1 or 16 bytes of the input type (4 f32, 8 bf16);
// scratch: ops.scratch_words(B, T, W, vec) 4-byte words, 16-byte aligned
extern "C" int repro_rglru_scan(int dtype, const void* a, const void* b, const void* h0, void* out, void* scratch,
                                int B, int Tn, int W, int vec, void* stream) {
  if (B <= 0 || Tn <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH(dtype, T, {
    if (vec == LANE_CHANNELS && W % LANE_CHANNELS == 0) {
      return launch<false, T, T, LANE_CHANNELS>(a, b, h0, out, scratch, B, Tn, W, st);
    }
    if (vec == 1) return launch<false, T, T, 1>(a, b, h0, out, scratch, B, Tn, W, st);
    return (int)cudaErrorInvalidValue;
  });
  return (int)cudaErrorInvalidValue;
}

// The backward: a (B, T, W) in the dtype code's type, g = dL/dh and h (the
// forward's output) (B, T, W) f32, h0 (B, W) f32 or null; writes da, db (B,
// T, W) in a's type and, when both are given, dh0 (B, W) f32.  vec and
// scratch as repro_rglru_scan's; 16-byte alignment of a, g, h, da and db
// (and h0) for vec 4.
extern "C" int repro_rglru_scan_bwd(int dtype, const void* a, const void* g, const void* h, const void* h0, void* da,
                                    void* db, void* dh0, void* scratch, int B, int Tn, int W, int vec,
                                    void* stream) {
  if (B <= 0 || Tn <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH(dtype, T, {
    const Grads<T> gr{(const float*)h, h0 != nullptr ? (float*)dh0 : nullptr, (T*)da, (T*)db};
    if (vec == LANE_CHANNELS && W % LANE_CHANNELS == 0) {
      return launch<true, T, float, LANE_CHANNELS>(a, g, h0, nullptr, scratch, B, Tn, W, st, gr);
    }
    if (vec == 1) return launch<true, T, float, 1>(a, g, h0, nullptr, scratch, B, Tn, W, st, gr);
    return (int)cudaErrorInvalidValue;
  });
  return (int)cudaErrorInvalidValue;
}

#ifdef REPRO_RGLRU_TRACE
extern "C" int repro_rglru_trace_copy(void* dst, unsigned long bytes) {
  return (int)cudaMemcpyFromSymbol(dst, rglru_trace, bytes);
}
#endif

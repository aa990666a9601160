// Kernel 12 in three launches, the form the shipped one-launch scan
// (src/repro_torch/csrc/rglru_scan.cu) was timed against; built only by
// tools/rglru_variants.py.  It reuses the shipped source's segment helpers,
// so it performs the same operations in the same order and its output is
// bitwise the shipped kernel's, but reads a and b twice:
//   1. aggregate_kernel: each chunk's aggregate (every chunk but the last);
//   2. carry_kernel: one thread a (batch row, channel) folds h0 with the
//      chunks' aggregates in ascending order, writing the carry into each;
//   3. walk_kernel: each chunk loads its segments again, folds the carry
//      with the segments before each, and walks.
// Scratch: B x nchunks x 2 W floats of aggregates, then B x nchunks x W of
// carries.
#include "rglru_scan.cu"

namespace {

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 1) aggregate_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                               float* __restrict__ agg, int Tn, int W,
                                                               int nchunks) {
  __shared__ Shared<V> sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.y, bb = blockIdx.z, ch = blockIdx.x * 32 * V + lane * V;
  Segment<T, T, V> seg;
  segment_phase<false>(seg, sm, a, b, bb, c, ch, Tn, W, warp, lane);
  __syncthreads();
  if (warp == 0 && ch < W) {
    float Ac[V], Hc[V];
    sm.chunk(Ac, Hc, lane);
    float* dst = agg + ((long)bb * nchunks + c) * 2 * W + ch;
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = Ac[v], dst[W + v] = Hc[v];
  }
}

__global__ void __launch_bounds__(256) carry_kernel(const float* __restrict__ h0, const float* __restrict__ agg,
                                                    float* __restrict__ carry, int B, int W, int nchunks) {
  const long i = blockIdx.x * 256L + threadIdx.x;
  if (i >= (long)B * W) return;
  const long bb = i / W, ch = i - bb * W;
  const float* src = agg + bb * nchunks * 2 * W + ch;
  float* dst = carry + bb * nchunks * W + ch;
  float h = h0 != nullptr ? h0[i] : 0.0f;
  dst[0] = h;
#pragma unroll 16
  for (int c = 0; c + 1 < nchunks; ++c) {
    h = fmaf(src[(long)c * 2 * W], h, src[(long)c * 2 * W + W]);
    dst[(long)(c + 1) * W] = h;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 1) walk_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                          const float* __restrict__ carry, float* __restrict__ out,
                                                          int Tn, int W, int nchunks) {
  __shared__ Shared<V> sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.y, bb = blockIdx.z, ch = blockIdx.x * 32 * V + lane * V;
  Segment<T, T, V> seg;
  segment_phase<false>(seg, sm, a, b, bb, c, ch, Tn, W, warp, lane);
  if (warp == 0 && ch < W) {
#pragma unroll
    for (int v = 0; v < V; ++v) sm.carry[lane * V + v] = carry[((long)bb * nchunks + c) * W + ch + v];
  }
  __syncthreads();
  walk_phase(seg, sm, out, bb, c, ch, Tn, W, warp, lane);
}

template <typename T, int V>
int launch_three(const void* a, const void* b, const void* h0, void* out, void* scratch, int B, int Tn, int W,
                 cudaStream_t stream) {
  const int nchunks = (Tn + CHUNK - 1) / CHUNK, ntiles = (W + 32 * V - 1) / (32 * V);
  float* agg = (float*)scratch;
  float* carry = agg + (long)B * nchunks * 2 * W;
  if (nchunks > 1) {
    aggregate_kernel<T, V><<<dim3(ntiles, nchunks - 1, B), THREADS, 0, stream>>>((const T*)a, (const T*)b, agg, Tn,
                                                                                 W, nchunks);
  }
  carry_kernel<<<(unsigned)(((long)B * W + 255) / 256), 256, 0, stream>>>((const float*)h0, agg, carry, B, W,
                                                                         nchunks);
  walk_kernel<T, V><<<dim3(ntiles, nchunks, B), THREADS, 0, stream>>>((const T*)a, (const T*)b, carry, (float*)out,
                                                                      Tn, W, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_rglru_scan_three_pass(int dtype, const void* a, const void* b, const void* h0, void* out,
                                           void* scratch, int B, int Tn, int W, int vec, void* stream) {
  if (B <= 0 || Tn <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  REPRO_DISPATCH(dtype, T, {
    if (vec == LANE_CHANNELS && W % LANE_CHANNELS == 0) {
      return launch_three<T, LANE_CHANNELS>(a, b, h0, out, scratch, B, Tn, W, st);
    }
    if (vec == 1) return launch_three<T, 1>(a, b, h0, out, scratch, B, Tn, W, st);
    return (int)cudaErrorInvalidValue;
  });
  return (int)cudaErrorInvalidValue;
}

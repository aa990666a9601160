// Diagonal linear recurrence of the RG-LRU: h_t = a_t * h_{t-1} + b_t.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py, rglru_scan_pallas (kernel
// _rglru_kernel).  Inputs a, b (B, T, W) in f32 or bf16, h0 (B, W) f32; the
// output (B, T, W) is f32, as in the TPU kernel.
//
// What bounds it on the card: bytes.  Each (b, t, w) element is read twice
// (a, b) and written once for one multiply-add: 12 bytes per 2 FLOPs in f32.
// The recurrence is serial in t but independent across channels.
//
// What the design does about it:
//  * One thread per (b, channel) keeps h in a register and walks T; the TPU
//    kernel's carried VMEM scratch across sequential time blocks becomes a
//    register across loop steps (no block of the grid carries state).
//  * Neighbouring threads take neighbouring channels, so every load and
//    store of a time step is coalesced across the warp.
//  * The loads do not depend on h: each thread issues RUN loads of a and of
//    b ahead of the RUN multiply-adds, so a warp has 2*RUN loads in flight
//    instead of one load latency per step.  At B=1 there are only W threads
//    (2,560 for RecurrentGemma-2B), too few to hide latency any other way.
//  * Blocks of 64 threads spread the channels over more SMs (40 at W=2560),
//    each with its own memory pipeline.
// A split of T across blocks (a two-pass chunked scan) would give the card
// more threads; that is a later step.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int RUN = 32;

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
    float* __restrict__ out, int B, int Tn, int W) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * W) return;
  const int bb = idx / W, w = idx - bb * W;
  float h = h0[idx];
  const long base = (long)bb * Tn * W + w;
  for (int t0 = 0; t0 < Tn; t0 += RUN) {
    const int n = min(RUN, Tn - t0);
    float ra[RUN], rb[RUN];
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      if (u < n) {
        const long off = base + (long)(t0 + u) * W;
        ra[u] = to_f32(a[off]);
        rb[u] = to_f32(b[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      if (u < n) {
        h = ra[u] * h + rb[u];
        out[base + (long)(t0 + u) * W] = h;
      }
    }
  }
}

}  // namespace

extern "C" int repro_rglru_scan(int dtype, const void* a, const void* b, const void* h0, void* out, int B, int Tn,
                                int W, void* stream) {
  if (B <= 0 || Tn <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B * W + THREADS - 1) / THREADS;
  REPRO_DISPATCH(dtype, T, {
    rglru_scan_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)a, (const T*)b, (const float*)h0, (float*)out, B, Tn, W);
  });
  return (int)cudaGetLastError();
}

// Shared helpers for the port's Hopper kernels (built for sm_90a with a
// plain C interface; see src/repro_torch/kernels/__init__.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The masking constant of the reference kernels: a large finite negative,
// so exp(NEG_INF - m) underflows to 0 without producing NaN.
#define REPRO_NEG_INF (-0.7f * 3.402823466e38f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float silu_f32(float g) { return g / (1.0f + expf(-g)); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dispatch on the dtype code the Python wrappers pass: 0 = f32, 1 = bf16.
#define REPRO_DISPATCH(code, T, ...)      \
  do {                                    \
    if ((code) == 0) {                    \
      using T = float;                    \
      __VA_ARGS__;                        \
    } else if ((code) == 1) {             \
      using T = __nv_bfloat16;            \
      __VA_ARGS__;                        \
    } else {                              \
      return (int)cudaErrorInvalidValue;  \
    }                                     \
  } while (0)

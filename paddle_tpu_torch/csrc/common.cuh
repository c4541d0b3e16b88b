// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
// Each kernel library is a plain C interface loaded with ctypes: every
// entry point returns cudaGetLastError() right after its launch so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with paddle_tpu_torch/ops/kernels.py
enum PttDtype { PTT_F32 = 0, PTT_BF16 = 1, PTT_INT8 = 2, PTT_F16 = 3 };

// the JAX package's masked-logit value (jnp.finfo(float32).min), so a
// fully masked row softmaxes to the same uniform weights as the reference
#define PTT_NEG_INF (-FLT_MAX)

__device__ __forceinline__ float ptt_to_float(float v) { return v; }
__device__ __forceinline__ float ptt_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ptt_to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T ptt_from_float(float v);
template <>
__device__ __forceinline__ float ptt_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 ptt_from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch/XLA cast
}

__device__ __forceinline__ float ptt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float ptt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Raise a kernel's dynamic shared-memory cap above the 48 KB default
// (Hopper allows up to 227 KB per block after this opt-in).
template <typename Kernel>
static cudaError_t ptt_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define PTT_EXPORT extern "C" __attribute__((visibility("default")))

PTT_EXPORT const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
// Each kernel library is a plain C interface loaded with ctypes: every
// entry point returns cudaGetLastError() right after its launch so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ float ptt_to_float(__half v) {
  return __half2float(v);
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
// Conversions to and from fp16 go through the intrinsics only, never an
// implicit conversion (PyTorch's own builds define the __CUDA_NO_HALF_*
// macros that remove those). __float2half_rn rounds to nearest even and
// keeps fp16's subnormals (cvt.rn.f16.f32, which has no flush-to-zero
// form), as torch's .to(torch.float16) does; a value past 65504 becomes
// inf, never clamped.
template <>
__device__ __forceinline__ __half ptt_from_float<__half>(float v) {
  return __float2half_rn(v);
}

// The 16-bit types' raw bits (a 16-bit element kept in a 32-bit word),
// and an fp16's bits back to float.
__device__ __forceinline__ unsigned short ptt_as_ushort(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned short ptt_as_ushort(__half v) {
  return __half_as_ushort(v);
}
__device__ __forceinline__ float ptt_half_bits_to_float(
    unsigned short bits) {
  return __half2float(__ushort_as_half(bits));
}

// Packed pairs of a 16-bit type T (bf16 or fp16): PttPair<T>::type is
// __nv_bfloat162 or __half2, `pack` rounds two floats into one (to
// nearest even, subnormals kept) and ptt_to_float2 widens one.
template <typename T>
struct PttPair;
template <>
struct PttPair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type pack(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};
template <>
struct PttPair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type pack(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};
__device__ __forceinline__ float2 ptt_to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 ptt_to_float2(__half2 v) {
  return __half22float2(v);
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

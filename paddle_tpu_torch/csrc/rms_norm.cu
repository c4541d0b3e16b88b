// RMSNorm forward, y = (x * rsqrt(mean(x^2) + eps)).to(x.dtype) * w.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_rms_fwd_kernel (forward).
//
// Rounding order: this follows the model the JAX package actually runs,
// nn/functional.py:rms_norm -> ops/pallas.py:rms_norm, which normalizes
// in fp32, casts to x.dtype, and only then multiplies by the weight in
// x.dtype. The Pallas kernel multiplies by the weight before its cast;
// the two differ only in where one bf16 rounding falls.
//
// Bound on the H100: bytes. Each element is read once, squared and
// summed (a handful of flops), then written once, so the kernel can do
// no better than (2 * rows * width + width) * sizeof(T) / 3.35 TB/s.
// Design: one block of 256 threads per row; the sum of squares is a
// warp-shuffle reduction in fp32 registers, the second pass re-reads
// the row from L1/L2 (a 4096-wide bf16 row is 8 KB), so device memory
// sees each byte once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int width, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * width;
  T* yr = out + row * width;

  float ss = 0.f;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const float v = ptt_to_float(xr[i]);
    ss += v * v;
  }
  ss = ptt_warp_sum(ss);

  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0.f;
    v = ptt_warp_sum(v);
    if (threadIdx.x == 0) inv_rms = rsqrtf(v / static_cast<float>(width) + eps);
  }
  __syncthreads();

  const float inv = inv_rms;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const T normed = ptt_from_float<T>(ptt_to_float(xr[i]) * inv);
    yr[i] = ptt_from_float<T>(ptt_to_float(normed) * ptt_to_float(w[i]));
  }
}

}  // namespace

PTT_EXPORT int rms_norm_fwd(const void* x, const void* w, void* out, int rows,
                            int width, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32) {
    rms_norm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), width, eps);
  } else if (dtype == PTT_BF16) {
    rms_norm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), width, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

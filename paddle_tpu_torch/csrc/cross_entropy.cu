// Fused softmax cross-entropy over the vocab dim of contiguous logits
// [N, V] with int32 labels [N]: a forward and a backward kernel.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_ce_fwd_kernel and
// _ce_bwd_kernel (called through softmax_cross_entropy_fwd / _bwd under
// the custom VJP of softmax_cross_entropy). Same functions:
// - forward: per row, the online-softmax logsumexp over the V logits and
//   the target logit, giving lse [N] and nll = lse - x[label] [N], both
//   fp32, with the logits read from device memory once. A label outside
//   [0, V) has no target logit (nll = lse), as in the Pallas kernel;
//   callers pass 0 for ignored rows and mask the loss themselves.
// - backward: dx = (exp(x - lse) - onehot(label)) * g, computed in fp32
//   and written in the logits dtype. g is 0 on ignored rows.
// The residuals are the logits and the fp32 lse: no fp32 [N, V] buffer
// exists. The Pallas kernels' [N, 1] column vectors and the padding of N
// and V to block multiples are TPU tiling; these kernels mask their own
// ragged edge.
//
// Bound on the H100: bytes. At the training shape (N = 4094 rows of the
// shifted [2, 2048] batch, V = 32000, bf16) the forward reads 262 MB
// (78 us at 3.35 TB/s) and does ~5 flops per logit; the backward reads
// and writes 262 MB each (156 us).
// Design: one block of 256 threads per row (4094 rows fill the 132 SMs
// many times over). Each thread takes 8 consecutive logits per step, as
// one 16-byte load for bf16 (two for f32) when the rows are aligned, so
// a warp reads 256 contiguous elements. The forward keeps a running
// (max, sum of exp) per thread, rescaled once per 8 logits rather than
// once per logit, merges the 256 pairs with warp shuffles and shared
// memory, and reads the target logit directly. The backward is one
// elementwise pass with the same 8-wide loads and stores.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

// v[0..8) = p[0..8) as fp32, -inf past the n valid ones
__device__ __forceinline__ void load8(const float* p, int n, bool vec,
                                      float* v) {
  if (vec && n >= kVec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = e < n ? p[e] : -INFINITY;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n,
                                      bool vec, float* v) {
  if (vec && n >= kVec) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = __bfloat162float(h[e]);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    v[e] = e < n ? __bfloat162float(p[e]) : -INFINITY;
}

__device__ __forceinline__ void store8(float* p, int n, bool vec,
                                       const float* v) {
  if (vec && n >= kVec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    if (e < n) p[e] = v[e];
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, int n, bool vec,
                                       const float* v) {
  if (vec && n >= kVec) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) h[e] = __float2bfloat16(v[e]);
    reinterpret_cast<uint4*>(p)[0] = raw;
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    if (e < n) p[e] = __float2bfloat16(v[e]);
}

// merge the softmax partial (m2, s2) into (m, s); m == -inf is empty
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                  float* __restrict__ nll, float* __restrict__ lse, int vocab,
                  bool vec) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * vocab;
  float m = -INFINITY, s = 0.f;
  for (int base = threadIdx.x * kVec; base < vocab;
       base += kThreads * kVec) {
    float v[kVec];
    load8(xr + base, vocab - base, vec, v);
    float cm = v[0];
#pragma unroll
    for (int e = 1; e < kVec; ++e) cm = fmaxf(cm, v[e]);
    float cs = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) cs += expf(v[e] - cm);
    merge(m, s, cm, cs);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  __shared__ float ms[kThreads / 32], ss[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ms[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) merge(ms[0], ss[0], ms[w], ss[w]);
    const int lab = labels[row];
    const float target =
        (lab >= 0 && lab < vocab) ? ptt_to_float(xr[lab]) : 0.f;
    const float l = ms[0] + logf(ss[0]);
    lse[row] = l;
    nll[row] = l - target;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  T* __restrict__ dx, int vocab, bool vec) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * vocab;
  T* dr = dx + row * vocab;
  const float l = lse[row];
  const float gr = g[row];
  const int lab = labels[row];
  for (int base = threadIdx.x * kVec; base < vocab;
       base += kThreads * kVec) {
    float v[kVec];
    load8(xr + base, vocab - base, vec, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      v[e] = (expf(v[e] - l) - (base + e == lab ? 1.f : 0.f)) * gr;
    store8(dr + base, vocab - base, vec, v);
  }
}

}  // namespace

// nll [N] and lse [N] (fp32) of logits [N, V]; `vec` says every row
// starts 16-byte aligned and V % 8 == 0.
PTT_EXPORT int softmax_ce_fwd(const void* logits, const void* labels,
                              void* nll, void* lse, int n, int vocab,
                              int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* nl = static_cast<float*>(nll);
  float* ls = static_cast<float*>(lse);
  if (dtype == PTT_F32) {
    ce_fwd_kernel<float><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, nl, ls, vocab, vec != 0);
  } else if (dtype == PTT_BF16) {
    ce_fwd_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, nl, ls, vocab,
        vec != 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dlogits [N, V] in the logits dtype from the forward's lse and the
// upstream gradient g [N] (fp32).
PTT_EXPORT int softmax_ce_bwd(const void* logits, const void* labels,
                              const void* lse, const void* g, void* dx,
                              int n, int vocab, int vec, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gr = static_cast<const float*>(g);
  if (dtype == PTT_F32) {
    ce_bwd_kernel<float><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, ls, gr,
        static_cast<float*>(dx), vocab, vec != 0);
  } else if (dtype == PTT_BF16) {
    ce_bwd_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, ls, gr,
        static_cast<__nv_bfloat16*>(dx), vocab, vec != 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

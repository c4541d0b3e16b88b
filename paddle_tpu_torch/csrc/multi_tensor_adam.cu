// Multi-tensor Adam/AdamW update, and the sum of squares of a list of
// tensors (the global-norm gradient clip's norm).
//
// Replaces: no Pallas kernel. The JAX package's TrainStep traces the
// update into its one jitted, donated program
// (paddle_tpu/jit/__init__.py:269-273 -> Optimizer.apply_gradients,
// paddle_tpu/optimizer/__init__.py:114-133, Adam._rule :316-331, and the
// clip's apply_pytree, nn/clip.py:56-84), where XLA fuses it into a few
// passes over the parameters. These kernels are the port's counterpart of
// that fusion; the per-parameter plain version (ops/kernels.py) runs about
// 20 fp32 elementwise kernels per tensor.
//
// Bound on the H100: bytes. Per element the update reads p, g, m and v
// (and the fp32 master and the amsgrad max where present) and writes p, m
// and v (and those), about 15 fp32 operations: 14 bytes with bf16
// parameters, grads and moments, 7.9 ms for the 1.88 B parameters of the
// 8-layer Llama-2-7B-width training rung at 3.35 TB/s. The sum of squares
// reads each grad once more (2 bytes per bf16 element, 1.1 ms there).
//
// Design: the tensors of one (param dtype, moment dtype, master, amsgrad)
// group go in one launch, up to kAdamMaxTensors of them by value in the
// kernel's parameters (under 4 KB): per tensor its pointers, its element
// count, its decay coefficient and its first chunk. The table lives in
// the launch itself, so a step whose grads sit at new addresses rebuilds it
// on the host and copies nothing to the device and waits for nothing.
// Block b takes chunk b: it finds its tensor by a binary search of the
// first chunks (the chunk table of (tensor, chunk offset), stored as one
// prefix per tensor), then 256 threads walk its kChunk elements 8 at a
// time with 16-byte loads and stores (one for a 2-byte type, two for
// fp32), with a scalar tail at a tensor's end. The math stays in fp32
// registers: m and v are stored rounded to the moment dtype, but the step
// uses their fp32 values (and amsgrad's fp32 max). Every product, sum,
// quotient and root is an explicitly rounded intrinsic, so nvcc contracts
// nothing into an FMA and the kernel rounds each operation as the plain
// version does. A global-norm clip's scale is read from device memory
// (never by the host), and each grad is scaled and rounded to its own
// dtype before use, as the JAX clip does before the optimizer reads it.
//
// The sum of squares: one block per chunk writes its fp32 partial sum to a
// workspace; a second kernel of one block adds the partials in a fixed
// order, so the result does not depend on how the blocks were scheduled.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements per thread and step
constexpr int kChunk = 16384;           // elements per block: kernels.MT_CHUNK
constexpr int kAdamMaxTensors = 48;     // kernels.MT_ADAM_MAX_TENSORS
constexpr int kSumsqMaxTensors = 96;    // kernels.MT_SUMSQ_MAX_TENSORS
constexpr int kFinishThreads = 1024;

// kernels._DECAY_MODES
enum DecayMode { kDecayL2 = 0, kDecayL1 = 1, kDecayDecoupled = 2 };

struct AdamTable {
  void* p[kAdamMaxTensors];
  const void* g[kAdamMaxTensors];
  void* m[kAdamMaxTensors];
  void* v[kAdamMaxTensors];
  float* master[kAdamMaxTensors];
  void* vmax[kAdamMaxTensors];
  int64_t numel[kAdamMaxTensors];
  float decay[kAdamMaxTensors];
  int first_chunk[kAdamMaxTensors + 1];
  int n;
};

struct AdamScalars {
  float lr_t, b1, b2, one_minus_b1, one_minus_b2, eps;
  int mode;
  const float* clip_scale;  // null: no clip
};

struct SumsqTable {
  const void* x[kSumsqMaxTensors];
  int64_t numel[kSumsqMaxTensors];
  int dtype[kSumsqMaxTensors];
  int first_chunk[kSumsqMaxTensors + 1];
  int n;
};

// -- conversions, 16-byte vectors ------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ float bits_to_f(unsigned int bits);
template <>
__device__ __forceinline__ float bits_to_f<__nv_bfloat16>(unsigned int bits) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}
template <>
__device__ __forceinline__ float bits_to_f<__half>(unsigned int bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

template <typename T>
__device__ __forceinline__ unsigned int f_to_bits(float x);
template <>
__device__ __forceinline__ unsigned int f_to_bits<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ unsigned int f_to_bits<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

// x[0..8) as fp32; x is 16-byte aligned (32 for fp32)
template <typename T>
__device__ __forceinline__ void load8(const T* x, float (&out)[kVec]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(x)[0];
    const float4 b = reinterpret_cast<const float4*>(x)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
    const uint4 r = *reinterpret_cast<const uint4*>(x);
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[2 * k] = bits_to_f<T>(w[k] & 0xffffu);
      out[2 * k + 1] = bits_to_f<T>(w[k] >> 16);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* x, const float (&in)[kVec]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(x)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(x)[1] = make_float4(in[4], in[5], in[6], in[7]);
  } else {
    unsigned int w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = f_to_bits<T>(in[2 * k]) | (f_to_bits<T>(in[2 * k + 1]) << 16);
    *reinterpret_cast<uint4*>(x) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the launch's tensor that holds chunk c: the last with first_chunk <= c
template <int N>
__device__ __forceinline__ int tensor_of(const int (&first_chunk)[N], int n,
                                         int c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first_chunk[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// -- Adam ---------------------------------------------------------------------

// One element of Paddle's Adam step (plain version: kernels.
// multi_tensor_adam_reference): p32 in, the new fp32 parameter out; m, v
// and vmax updated in place as fp32.
template <typename G, bool kAms>
__device__ __forceinline__ float adam_elem(float p32, float g, float& m,
                                           float& v, float& vmax, float decay,
                                           float scale, const AdamScalars& s) {
  if (s.clip_scale != nullptr) g = to_f(from_f<G>(__fmul_rn(g, scale)));
  if (decay != 0.f && s.mode != kDecayDecoupled) {
    const float reg = s.mode == kDecayL1
        ? static_cast<float>((p32 > 0.f) - (p32 < 0.f)) : p32;
    g = __fadd_rn(g, __fmul_rn(reg, decay));
  }
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g),
                                               s.one_minus_b2));
  float denom_v = v;
  if (kAms) {
    vmax = (isnan(vmax) || isnan(v)) ? __int_as_float(0x7fffffff)
                                     : fmaxf(vmax, v);
    denom_v = vmax;
  }
  float out = __fsub_rn(p32, __fdiv_rn(__fmul_rn(m, s.lr_t),
                                       __fadd_rn(__fsqrt_rn(denom_v), s.eps)));
  if (decay != 0.f && s.mode == kDecayDecoupled)
    out = __fsub_rn(out, __fmul_rn(p32, decay));
  return out;
}

template <typename P, typename M, bool kMaster, bool kAms>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_adam_kernel(const AdamTable table, const AdamScalars s) {
  const int chunk = blockIdx.x;
  const int t = tensor_of(table.first_chunk, table.n, chunk);
  const int64_t n = table.numel[t];
  const int64_t start =
      static_cast<int64_t>(chunk - table.first_chunk[t]) * kChunk;
  const int64_t end = start + kChunk < n ? start + kChunk : n;
  P* p = static_cast<P*>(table.p[t]);
  const P* g = static_cast<const P*>(table.g[t]);
  M* m = static_cast<M*>(table.m[t]);
  M* v = static_cast<M*>(table.v[t]);
  float* master = table.master[t];
  M* vmax = static_cast<M*>(table.vmax[t]);
  const float decay = table.decay[t];
  const float scale = s.clip_scale != nullptr ? *s.clip_scale : 1.f;

  for (int64_t e = start + threadIdx.x * kVec; e < end;
       e += kThreads * kVec) {
    if (e + kVec <= end) {
      float pv[kVec], gv[kVec], mv[kVec], vv[kVec], xv[kVec];
      if (kMaster) load8(master + e, pv); else load8(p + e, pv);
      load8(g + e, gv);
      load8(m + e, mv);
      load8(v + e, vv);
      if (kAms) load8(vmax + e, xv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        pv[k] = adam_elem<P, kAms>(pv[k], gv[k], mv[k], vv[k], xv[k], decay,
                                   scale, s);
      store8(m + e, mv);
      store8(v + e, vv);
      if (kAms) store8(vmax + e, xv);
      if (kMaster) store8(master + e, pv);
      store8(p + e, pv);
    } else {
      for (int64_t i = e; i < end; ++i) {
        float mi = to_f(m[i]), vi = to_f(v[i]);
        float xi = kAms ? to_f(vmax[i]) : 0.f;
        const float p32 = kMaster ? master[i] : to_f(p[i]);
        const float out = adam_elem<P, kAms>(p32, to_f(g[i]), mi, vi, xi,
                                             decay, scale, s);
        m[i] = from_f<M>(mi);
        v[i] = from_f<M>(vi);
        if (kAms) vmax[i] = from_f<M>(xi);
        if (kMaster) master[i] = out;
        p[i] = from_f<P>(out);
      }
    }
  }
}

template <typename P, typename M>
cudaError_t launch_adam(bool master, bool ams, int blocks, cudaStream_t st,
                        const AdamTable& t, const AdamScalars& s) {
  if (master && ams)
    multi_tensor_adam_kernel<P, M, true, true><<<blocks, kThreads, 0, st>>>(t, s);
  else if (master)
    multi_tensor_adam_kernel<P, M, true, false><<<blocks, kThreads, 0, st>>>(t, s);
  else if (ams)
    multi_tensor_adam_kernel<P, M, false, true><<<blocks, kThreads, 0, st>>>(t, s);
  else
    multi_tensor_adam_kernel<P, M, false, false><<<blocks, kThreads, 0, st>>>(t, s);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_adam_p(int m_dtype, bool master, bool ams, int blocks,
                          cudaStream_t st, const AdamTable& t,
                          const AdamScalars& s) {
  if (m_dtype == PTT_F32)
    return launch_adam<P, float>(master, ams, blocks, st, t, s);
  if (m_dtype == PTT_BF16)
    return launch_adam<P, __nv_bfloat16>(master, ams, blocks, st, t, s);
  return cudaErrorInvalidValue;
}

// -- sum of squares -------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float chunk_sumsq(const T* x, int64_t start,
                                             int64_t end) {
  float acc = 0.f;
  for (int64_t e = start + threadIdx.x * kVec; e < end;
       e += kThreads * kVec) {
    if (e + kVec <= end) {
      float xv[kVec];
      load8(x + e, xv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc += xv[k] * xv[k];
    } else {
      for (int64_t i = e; i < end; ++i) {
        const float xi = to_f(x[i]);
        acc += xi * xi;
      }
    }
  }
  return acc;
}

// the sum of v over the block's threads, in a fixed order; valid in
// thread 0
template <int kBlock>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kBlock / 32];
  v = ptt_warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : 0.f;
    v = ptt_warp_sum(v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    multi_tensor_sumsq_kernel(const SumsqTable table, float* partial) {
  const int chunk = blockIdx.x;
  const int t = tensor_of(table.first_chunk, table.n, chunk);
  const int64_t n = table.numel[t];
  const int64_t start =
      static_cast<int64_t>(chunk - table.first_chunk[t]) * kChunk;
  const int64_t end = start + kChunk < n ? start + kChunk : n;
  float acc;
  if (table.dtype[t] == PTT_F32)
    acc = chunk_sumsq(static_cast<const float*>(table.x[t]), start, end);
  else if (table.dtype[t] == PTT_BF16)
    acc = chunk_sumsq(static_cast<const __nv_bfloat16*>(table.x[t]), start,
                      end);
  else
    acc = chunk_sumsq(static_cast<const __half*>(table.x[t]), start, end);
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partial[chunk] = acc;
}

__global__ void __launch_bounds__(kFinishThreads)
    multi_tensor_sumsq_finish_kernel(const float* __restrict__ partial, int n,
                                     float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kFinishThreads) acc += partial[i];
  acc = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace

// One launch over n <= kAdamMaxTensors tensors of one group. ptrs holds 6
// pointers per tensor (p, g, m, v, master or null, vmax or null);
// first_chunk n + 1 prefix sums of the tensors' chunk counts (the last is
// the block count).
PTT_EXPORT int multi_tensor_adam(int n, const void* const* ptrs,
                                 const long long* numel,
                                 const int* first_chunk, const float* decay,
                                 float lr_t, float b1, float b2,
                                 float one_minus_b1, float one_minus_b2,
                                 float eps, int mode, const void* clip_scale,
                                 int p_dtype, int m_dtype, int master,
                                 int amsgrad, void* stream) {
  if (n <= 0 || n > kAdamMaxTensors || first_chunk[n] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable t;
  for (int i = 0; i < n; ++i) {
    t.p[i] = const_cast<void*>(ptrs[6 * i]);
    t.g[i] = ptrs[6 * i + 1];
    t.m[i] = const_cast<void*>(ptrs[6 * i + 2]);
    t.v[i] = const_cast<void*>(ptrs[6 * i + 3]);
    t.master[i] = static_cast<float*>(const_cast<void*>(ptrs[6 * i + 4]));
    t.vmax[i] = const_cast<void*>(ptrs[6 * i + 5]);
    t.numel[i] = numel[i];
    t.decay[i] = decay[i];
    t.first_chunk[i] = first_chunk[i];
  }
  t.first_chunk[n] = first_chunk[n];
  t.n = n;
  const AdamScalars s{lr_t, b1, b2, one_minus_b1, one_minus_b2, eps, mode,
                      static_cast<const float*>(clip_scale)};
  const int blocks = first_chunk[n];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p_dtype == PTT_F32)
    err = launch_adam_p<float>(m_dtype, master, amsgrad, blocks, st, t, s);
  else if (p_dtype == PTT_BF16)
    err = launch_adam_p<__nv_bfloat16>(m_dtype, master, amsgrad, blocks, st,
                                       t, s);
  else if (p_dtype == PTT_F16)
    err = launch_adam_p<__half>(m_dtype, master, amsgrad, blocks, st, t, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The partial sums of squares of n <= kSumsqMaxTensors tensors: one per
// chunk, into partial[0 .. first_chunk[n]).
PTT_EXPORT int multi_tensor_sumsq_partial(int n, const void* const* ptrs,
                                          const long long* numel,
                                          const int* dtype,
                                          const int* first_chunk,
                                          float* partial, void* stream) {
  if (n <= 0 || n > kSumsqMaxTensors || first_chunk[n] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SumsqTable t;
  for (int i = 0; i < n; ++i) {
    if (dtype[i] != PTT_F32 && dtype[i] != PTT_BF16 && dtype[i] != PTT_F16)
      return static_cast<int>(cudaErrorInvalidValue);
    t.x[i] = ptrs[i];
    t.numel[i] = numel[i];
    t.dtype[i] = dtype[i];
    t.first_chunk[i] = first_chunk[i];
  }
  t.first_chunk[n] = first_chunk[n];
  t.n = n;
  multi_tensor_sumsq_kernel<<<first_chunk[n], kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(t, partial);
  return static_cast<int>(cudaGetLastError());
}

// out[0] = the sum of partial[0 .. n) in a fixed order (0 for n = 0).
PTT_EXPORT int multi_tensor_sumsq_finish(const float* partial, int n,
                                         float* out, void* stream) {
  multi_tensor_sumsq_finish_kernel<<<1, kFinishThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      partial, n, out);
  return static_cast<int>(cudaGetLastError());
}

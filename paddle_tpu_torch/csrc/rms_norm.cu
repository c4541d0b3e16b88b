// RMSNorm forward, y = (x * rsqrt(mean(x^2) + eps)).to(x.dtype) * w.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_rms_fwd_kernel (forward).
//
// Rounding order: this follows the model the JAX package actually runs,
// nn/functional.py:rms_norm -> ops/pallas.py:rms_norm, which normalizes
// in fp32, casts to x.dtype, and only then multiplies by the weight in
// x.dtype. The Pallas kernel multiplies by the weight before its cast;
// the two differ only in where one bf16 rounding falls. fp16 (a model
// cast with `to(dtype='float16')`) follows the same order as bf16: the
// sum of squares and the normalization in fp32, one rounding of the
// normalized row to fp16 (__float2half_rn), then the product with the
// fp16 weight in fp32 and a second rounding; the plain version
// (kernels.rms_norm_reference) does the same.
//
// Bound on the H100: bytes. Each element is read once, squared and
// summed (a handful of flops), then written once, so the kernel can do
// no better than (2 * rows * width + width) * sizeof(T) / 3.35 TB/s. At
// decode's few rows ([8, 4096]) the bound is a fraction of a
// microsecond and the call's time is its latency chain: one load round
// trip, one reduction, one store.
//
// Design (the second; the first was one 256-thread block per row with
// 2-byte loads and a second pass over the row):
// - 16-byte accesses: a thread moves 8 bf16/fp16 or 4 f32 values per
//   load and store; x is read with ld.global.nc (the read-only path).
//   An L1::no_allocate hint on those loads was measured and left out:
//   it made the [2048, 4096] bf16 call 15% slower (PERF.md).
// - The row lives in registers: a thread loads its VPT units of the
//   row, the row group sums their squares (warp shuffles, then one
//   shared-memory step when the group spans warps), and the same
//   registers are scaled and stored, so device memory sees each byte of
//   x once and nothing is re-read.
// - A group of TPR threads (a power of two) takes one row; a block of
//   max(TPR, 256) threads takes several rows, and the grid is at most
//   (SMs x resident blocks), walking the rows so that a thread keeps the
//   same columns: its VPT units of the weight are loaded once, into
//   registers, before the walk. Each thread issues the loads of its
//   next row before it reduces and stores the current one.
// - The mapping comes from the width at launch (`plan`): with many rows
//   a thread holds 2 units (width 1024 bf16: 64 threads a row; 4096
//   bf16: 256), with at most as many rows as SMs one (decode's [8, 4096]
//   bf16: 512 threads a row, one load each, one block reduction). VPT
//   is a template argument, so the row's registers are indexed at
//   compile time (1 or 2). 4 vectors a thread, a grid of one block a
//   row group, and no prefetch were each measured slower (PERF.md).
// - Any width: a width that is not a multiple of the vector, or an x, w
//   or out that is not 16-byte aligned, takes the same kernel with
//   1-element units (the wrapper passes `vec` = 0): 256 threads a row
//   sum it in one pass and scale it in a second that reads it again,
//   mostly from L1 (VPT 0). Holding 16-32 one-element units a thread
//   took 96-205 registers, and the occupancy lost made it 1.7-3x slower
//   than this form (PERF.md). A row wider than 1024 threads x 2 vectors
//   (16384 bf16 or 8192 f32 values) takes the same two-pass form in
//   16-byte units: 4 vectors a thread spill at the 64 registers that
//   1024-thread blocks leave (ptxas).
// - Programmatic dependent launch is not used: the kernel launches with
//   <<<>>> on the caller's stream, which the decode and prefill CUDA
//   graphs capture as they did the first design's.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;     // threads a row of 16-byte units
constexpr int kRowsBlock = 256;       // threads a block of small rows, and
                                      // a row's of 1-element units
constexpr int kMaxVpt = 2;            // units a thread holds (many rows)

// 16 bytes of x, w or out in four 32-bit words
struct alignas(16) Vec16 {
  uint32_t w[4];
};

// Access<T, vec>: the unit a thread loads and stores (16 bytes, or one
// element), `kElems` values of T, and element k of it as a float.
template <typename T, bool kVec>
struct Access;

template <typename T>
struct Access<T, false> {
  using Raw = T;
  static constexpr int kElems = 1;
  static __device__ __forceinline__ Raw load_stream(const Raw* p) {
    return *p;
  }
  static __device__ __forceinline__ Raw load_keep(const Raw* p) {
    return *p;
  }
  static __device__ __forceinline__ float get(const Raw& r, int) {
    return ptt_to_float(r);
  }
  static __device__ __forceinline__ void set(Raw& r, int, float v) {
    r = ptt_from_float<T>(v);
  }
};

template <typename T>
struct Access<T, true> {
  using Raw = Vec16;
  static constexpr int kElems = 16 / sizeof(T);
  static __device__ __forceinline__ Raw load_stream(const Raw* p) {
    Raw r;
    asm("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
        : "l"(p));
    return r;
  }
  static __device__ __forceinline__ Raw load_keep(const Raw* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    Raw r;
    r.w[0] = u.x;
    r.w[1] = u.y;
    r.w[2] = u.z;
    r.w[3] = u.w;
    return r;
  }
  static __device__ __forceinline__ float get(const Raw& r, int k);
  static __device__ __forceinline__ void set(Raw& r, int k, float v);
};

template <>
__device__ __forceinline__ float Access<float, true>::get(const Raw& r,
                                                          int k) {
  return __uint_as_float(r.w[k]);
}
template <>
__device__ __forceinline__ void Access<float, true>::set(Raw& r, int k,
                                                         float v) {
  r.w[k] = __float_as_uint(v);
}
template <>
__device__ __forceinline__ float Access<__nv_bfloat16, true>::get(
    const Raw& r, int k) {
  const uint32_t word = r.w[k >> 1];
  return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
}
template <>
__device__ __forceinline__ void Access<__nv_bfloat16, true>::set(
    Raw& r, int k, float v) {
  const uint32_t bits = ptt_as_ushort(__float2bfloat16(v));
  uint32_t& word = r.w[k >> 1];
  word = (k & 1) ? ((word & 0xffffu) | (bits << 16))
                 : ((word & 0xffff0000u) | bits);
}
template <>
__device__ __forceinline__ float Access<__half, true>::get(const Raw& r,
                                                           int k) {
  const uint32_t word = r.w[k >> 1];
  return ptt_half_bits_to_float(
      static_cast<unsigned short>((k & 1) ? (word >> 16) : (word & 0xffffu)));
}
template <>
__device__ __forceinline__ void Access<__half, true>::set(Raw& r, int k,
                                                          float v) {
  const uint32_t bits = ptt_as_ushort(__float2half_rn(v));
  uint32_t& word = r.w[k >> 1];
  word = (k & 1) ? ((word & 0xffffu) | (bits << 16))
                 : ((word & 0xffff0000u) | bits);
}

// x rounded to T and back (the normalized row's one rounding)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ptt_to_float(ptt_from_float<T>(v));
}

// The sum of `ss` over a row group of `tpr` threads, in every thread of
// the group. Every thread of the block calls it the same number of
// times (the row walk is uniform over the block).
__device__ __forceinline__ float group_sum(float ss, int tpr,
                                          float* partial) {
  const int lanes = tpr < 32 ? tpr : 32;
  for (int off = lanes >> 1; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = tpr >> 5, first = (warp / warps) * warps;
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    float v = lane < warps ? partial[first + lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    __syncthreads();   // partial is rewritten by the next row
    ss = v;
  }
  return ss;
}

// VPT > 0: each thread holds VPT units of its row (unit j*tpr + t) and
// of the weight in registers. VPT == 0 (1-element units, or a row wider
// than registers hold): it is summed in one pass and read again to
// scale.
template <typename T, bool kVec, int kVpt>
__global__ void __launch_bounds__(kVec ? kMaxThreads : kRowsBlock)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int rows, int width, int tpr,
                    float eps) {
  using A = Access<T, kVec>;
  using Raw = typename A::Raw;
  constexpr int E = A::kElems;
  const int units = width / E;
  const int t = threadIdx.x & (tpr - 1);
  const int rpc = blockDim.x / tpr;
  const Raw* xr = reinterpret_cast<const Raw*>(x);
  const Raw* wr = reinterpret_cast<const Raw*>(w);
  Raw* yr = reinterpret_cast<Raw*>(out);
  __shared__ float partial[kMaxThreads / 32];

  const int group_row = threadIdx.x / tpr;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rpc;
  const int64_t step = static_cast<int64_t>(gridDim.x) * rpc;
  if constexpr (kVpt > 0) {
    Raw wv[kVpt], xv[kVpt], xn[kVpt];
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      const int u = j * tpr + t;
      if (u < units) wv[j] = A::load_keep(wr + u);
    }
    // units j * tpr + t of `row`, when the row exists
    auto load_row = [&](Raw* dst, int64_t row) {
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const int u = j * tpr + t;
        if (row < rows && u < units)
          dst[j] = A::load_stream(xr + row * units + u);
      }
    };
    load_row(xv, first + group_row);
    for (int64_t base = first; base < rows; base += step) {
      const int64_t row = base + group_row;
      const bool live = row < rows;
      // the next row's loads go out before this row's reduction
      load_row(xn, row + step);
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const int u = j * tpr + t;
        if (live && u < units) {
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const float v = A::get(xv[j], k);
            ss += v * v;
          }
        }
      }
      ss = group_sum(ss, tpr, partial);
      const float inv = rsqrtf(ss / static_cast<float>(width) + eps);
      Raw* yrow = yr + row * units;
#pragma unroll
      for (int j = 0; j < kVpt; ++j) {
        const int u = j * tpr + t;
        if (live && u < units) {
          Raw o{};
#pragma unroll
          for (int k = 0; k < E; ++k)
            A::set(o, k, round_to<T>(A::get(xv[j], k) * inv) *
                             A::get(wv[j], k));
          yrow[u] = o;
        }
      }
#pragma unroll
      for (int j = 0; j < kVpt; ++j) xv[j] = xn[j];
    }
  } else {
    // a block a row (`plan`); the stride known at compile time and the
    // loops unrolled, so that a thread has several loads in flight
    constexpr int kTpr = kVec ? kMaxThreads : kRowsBlock;
    for (int64_t base = first; base < rows; base += step) {
      const int64_t row = base + group_row;
      const bool live = row < rows;
      const Raw* xrow = xr + row * units;
      Raw* yrow = yr + row * units;
      float ss = 0.f;
      if (live) {
#pragma unroll 4
        for (int u = t; u < units; u += kTpr) {
          const Raw r = A::load_keep(xrow + u);
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const float v = A::get(r, k);
            ss += v * v;
          }
        }
      }
      ss = group_sum(ss, kTpr, partial);
      const float inv = rsqrtf(ss / static_cast<float>(width) + eps);
      if (live) {
#pragma unroll 4
        for (int u = t; u < units; u += kTpr) {
          const Raw r = A::load_stream(xrow + u);
          const Raw wu = A::load_keep(wr + u);
          Raw o{};
#pragma unroll
          for (int k = 0; k < E; ++k)
            A::set(o, k, round_to<T>(A::get(r, k) * inv) * A::get(wu, k));
          yrow[u] = o;
        }
      }
    }
  }
}

struct Plan {
  int vpt;     // units a thread holds (0: the row does not fit)
  int tpr;     // threads a row
  int block;   // threads a block
};

int next_pow2(int64_t v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The row-to-thread mapping for `rows` rows of `units` units on a card
// of `sms` SMs: a thread holds kMaxVpt units when rows are many,
// one when there are at most as many rows as SMs (the decode shapes);
// rows of 1-element units take the two-pass form, kRowsBlock threads a
// row.
Plan plan(int rows, int units, int sms, bool vec) {
  if (!vec) return {0, kRowsBlock, kRowsBlock};
  if (units > kMaxThreads * kMaxVpt) return {0, kMaxThreads, kMaxThreads};
  const int target = rows <= sms ? 1 : kMaxVpt;
  int tpr = next_pow2((units + target - 1) / target);
  if (tpr > kMaxThreads) tpr = kMaxThreads;
  const int vpt = next_pow2((units + tpr - 1) / tpr);
  return {vpt, tpr, tpr > kRowsBlock ? tpr : kRowsBlock};
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return cached[dev];
}

// blocks of `block` threads one SM holds of this instantiation
template <typename T, bool kVec, int kVpt>
int resident_blocks(int block) {
  static int cached[3] = {0, 0, 0};   // 256, 512, 1024 threads
  const int slot = block <= 256 ? 0 : (block <= 512 ? 1 : 2);
  if (cached[slot] == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rms_norm_kernel<T, kVec, kVpt>, block, 0);
    cached[slot] = n > 0 ? n : 1;
  }
  return cached[slot];
}

template <typename T, bool kVec, int kVpt>
void launch(const T* x, const T* w, T* out, int rows, int width,
            const Plan& p, int sms, float eps, cudaStream_t s) {
  const int rpc = p.block / p.tpr;
  const int64_t need = (static_cast<int64_t>(rows) + rpc - 1) / rpc;
  const int64_t cap =
      static_cast<int64_t>(sms) * resident_blocks<T, kVec, kVpt>(p.block);
  const int grid = static_cast<int>(need < cap ? need : cap);
  rms_norm_kernel<T, kVec, kVpt><<<grid, p.block, 0, s>>>(
      x, w, out, rows, width, p.tpr, eps);
}

template <typename T, bool kVec>
int dispatch(const void* x, const void* w, void* out, int rows, int width,
             float eps, cudaStream_t s) {
  const int units = width / Access<T, kVec>::kElems;
  const int sms = sm_count();
  const Plan p = plan(rows, units, sms, kVec);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if constexpr (!kVec) {
    launch<T, false, 0>(xt, wt, ot, rows, width, p, sms, eps, s);
  } else {
    switch (p.vpt) {
      case 0:
        launch<T, true, 0>(xt, wt, ot, rows, width, p, sms, eps, s);
        break;
      case 1:
        launch<T, true, 1>(xt, wt, ot, rows, width, p, sms, eps, s);
        break;
      case 2:
        launch<T, true, 2>(xt, wt, ot, rows, width, p, sms, eps, s);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_access(const void* x, const void* w, void* out, int rows,
                    int width, float eps, int vec, cudaStream_t s) {
  return vec ? dispatch<T, true>(x, w, out, rows, width, eps, s)
             : dispatch<T, false>(x, w, out, rows, width, eps, s);
}

}  // namespace

// vec: 1 when width is a multiple of 16 / sizeof(T) and x, w and out are
// 16-byte aligned (the wrapper checks), else 0 (1-element accesses).
PTT_EXPORT int rms_norm_fwd(const void* x, const void* w, void* out, int rows,
                            int width, float eps, int dtype, int vec,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32)
    return dispatch_access<float>(x, w, out, rows, width, eps, vec, s);
  if (dtype == PTT_BF16)
    return dispatch_access<__nv_bfloat16>(x, w, out, rows, width, eps, vec,
                                          s);
  if (dtype == PTT_F16)
    return dispatch_access<__half>(x, w, out, rows, width, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

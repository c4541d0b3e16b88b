// Paged attention for decode: one query token per slot attends over the
// KV rows that the slot's page table scatters across the page pool.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_paged_attn_kernel (called
// through paged_attention / _paged_attention_pallas). Same function:
// q [N, H, D] (one decode query per slot), pages [num_pages, ps, HKV, D]
// in f32, bf16 or int8 (int8 dequantized by a per-(page, kv head) f32
// scale), table [N, P] int32 (page 0 is the null page), lengths [N]
// int32; GQA folds query heads as [HKV, G] (head = hkv * G + g); keys at
// or past lengths[n] are masked; pages wholly past the length are not
// read, but the slot's first page is always computed so an idle slot
// still finishes with finite values. Output is q.dtype.
//
// Bound on the H100: bytes. Each live KV row is read once and used for
// G query heads (2 * 2 * G * D flops per row against 2 * D * sizeof(KV)
// bytes), far below the ~295 flops/byte where the tensor cores would
// become the limit, so the kernels stay on fp32 FMAs. At the serving
// path's decode shape (8 slots, 32 heads, context up to 1024, bf16) the
// bound is about 18 microseconds: the time to read 60 MB of live K/V.
// Reaching it takes many bytes in flight on every SM, so the design
// splits each slot's context across blocks (the FlashDecoding / vLLM v2
// scheme). Two kernels per call:
//
// - paged_attn_split_kernel, grid (N, HKV, splits), 128 threads. Each
//   block owns a fixed run of `pps` pages (at most kSplitKeys = 64 keys:
//   4 pages at ps = 16) of one (slot, kv head); the split count comes
//   from the table width P, never from the lengths, so the host reads
//   nothing from the device. A block whose run starts past its slot's
//   last page writes an empty partial (m = -inf, l = 0) and exits; split
//   0 always holds the slot's first page. The block reads its page ids
//   from the table itself and puts every K and V row of its run in
//   flight at once: 16-byte cp.async copies (4 f32, 8 bf16 or 16 int8
//   values each) into shared memory, chunk c of row t stored at chunk
//   c ^ (t % 8), so that the 16-byte reads below are free of bank
//   conflicts. Thread (row slot r = tid / 16, 8-column group tid % 16)
//   then takes rows r, r + 8, ...: the scores q . k of the G query heads,
//   summed over each row's 16 threads by shuffles (int8 dequantized per
//   element, as it is read); the split's max and sum per head, one warp
//   per head across the block; P V into 8 x G fp32 registers, summed
//   over the 8 row slots by a shuffle and shared memory. It writes fp32
//   (acc[G][D], m, l) to the workspace [N, HKV, splits, G, D + 2].
// - paged_attn_combine_kernel, grid (N, H), one thread per output
//   column: out = sum_s acc_s exp(m_s - M) / sum_s l_s exp(m_s - M) over
//   the splits with l_s > 0 (M their largest m_s), in q's dtype. The
//   splits' weights are computed all at once and reduced across the
//   block, so the kernel waits on device memory about twice, not once
//   per split.
//
// Neither kernel syncs with the host or allocates memory: the wrapper
// takes the workspace from PyTorch's caching allocator, so a call can be
// captured by a CUDA graph.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitKeys = 64;             // K (and V) rows of a split, at most
constexpr int kRowSlots = kThreads / 16;   // 16 threads x 8 columns per row

struct PagedArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* table;
  const int* lengths;
  const float* k_scales;
  const float* v_scales;
  float* ws;       // [N, HKV, splits, G, D + 2]: acc[D], m, l per head
  void* out;
  int h, hkv, p, ps, pps, splits;
  float scale;
};

// byte offset of 16-byte chunk c of row t in a [kSplitKeys][D] tile of T
template <typename T>
__device__ __forceinline__ int chunk_at(int t, int c) {
  return t * kD * static_cast<int>(sizeof(T)) + ((c ^ (t & 7)) << 4);
}

// The 8 columns a thread of column group dg (0..15) owns: 8 dg .. 8 dg + 7,
// except in f32 tiles (4 values per chunk), where they are chunks dg and
// dg + 16, so that 8 neighbouring threads read 8 distinct bank groups.
template <typename T>
__device__ __forceinline__ int group_col(int dg, int e) {
  if (sizeof(T) == 4) return (e < 4 ? 4 * dg : 64 + 4 * dg) + (e & 3);
  return 8 * dg + e;
}

// the 8 values of row t, column group dg, of a tile, as float
__device__ __forceinline__ void row8(const float* tile, int t, int dg,
                                     float (&x)[8]) {
  const auto* base = reinterpret_cast<const uint8_t*>(tile);
  const float4 lo = *reinterpret_cast<const float4*>(
      base + chunk_at<float>(t, dg));
  const float4 hi = *reinterpret_cast<const float4*>(
      base + chunk_at<float>(t, dg + 16));
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void row8(const __nv_bfloat16* tile, int t,
                                     int dg, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(
      reinterpret_cast<const uint8_t*>(tile) + chunk_at<__nv_bfloat16>(t, dg));
  const auto* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void row8(const int8_t* tile, int t, int dg,
                                     float (&x)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(
      reinterpret_cast<const uint8_t*>(tile) + chunk_at<int8_t>(t, dg >> 1) +
      (dg & 1) * 8);
  const auto* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = static_cast<float>(bytes[e]);
}

template <typename TKV, int kG>
constexpr size_t split_smem_bytes() {
  // K and V tiles, the warps' partial P V [kWarps][kG][D], scores then
  // probabilities [kG][kSplitKeys], and the rows' k and v scales
  return 2 * kSplitKeys * kD * sizeof(TKV) +
         (kWarps * kG * kD + kG * kSplitKeys + 2 * kSplitKeys) *
             sizeof(float);
}

// kG: the group size G rounded up to 1, 2, 4 or 8 (register arrays)
template <typename TQ, typename TKV, bool kQuant, int kG>
__global__ void __launch_bounds__(kThreads)
    paged_attn_split_kernel(PagedArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kRowBytes = kD * sizeof(TKV);
  constexpr int kChunks = kRowBytes / 16;
  const TKV* k_t = reinterpret_cast<const TKV*>(smem);
  const TKV* v_t = reinterpret_cast<const TKV*>(smem + kSplitKeys * kRowBytes);
  float* red = reinterpret_cast<float*>(smem + 2 * kSplitKeys * kRowBytes);
  float* sp = red + kWarps * kG * kD;
  float* row_scale = sp + kG * kSplitKeys;     // [2][kSplitKeys]: k, v

  const int n = blockIdx.x;
  const int hk = blockIdx.y;
  const int split = blockIdx.z;
  const int g_size = a.h / a.hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = a.lengths[n];
  // the slot's pages: those holding a key below len, and at least one
  const int n_pages = min(max((len + a.ps - 1) / a.ps, 1), a.p);
  const int first_page = split * a.pps;
  float* part = a.ws + ((static_cast<int64_t>(n) * a.hkv + hk) * a.splits +
                        split) * g_size * (kD + 2);
  if (first_page >= n_pages) {                 // an empty partial
    if (tid < g_size) {
      part[tid * (kD + 2) + kD] = -INFINITY;
      part[tid * (kD + 2) + kD + 1] = 0.f;
    }
    return;
  }
  const int t_live = min(a.pps, n_pages - first_page) * a.ps;
  const int key0 = first_page * a.ps;

  // every K and V row of the run in flight at once
  const int* pages = a.table + static_cast<int64_t>(n) * a.p + first_page;
  const int64_t row_stride = static_cast<int64_t>(a.hkv) * kD;
  const uint32_t k_sm = hopper::smem_u32(k_t);
  const uint32_t v_sm = hopper::smem_u32(v_t);
  for (int i = tid; i < t_live * kChunks; i += kThreads) {
    const int t = i / kChunks, c = i % kChunks;
    const int64_t at =
        (static_cast<int64_t>(pages[t / a.ps]) * a.ps + t % a.ps) *
            row_stride + hk * kD + c * (16 / static_cast<int>(sizeof(TKV)));
    const uint32_t off = chunk_at<TKV>(t, c);
    hopper::cp_async_16(k_sm + off, static_cast<const TKV*>(a.k_pages) + at,
                        true);
    hopper::cp_async_16(v_sm + off, static_cast<const TKV*>(a.v_pages) + at,
                        true);
  }
  hopper::cp_async_commit();
  if (kQuant && tid < t_live) {
    const int64_t at = static_cast<int64_t>(pages[tid / a.ps]) * a.hkv + hk;
    row_scale[tid] = a.k_scales[at];
    row_scale[kSplitKeys + tid] = a.v_scales[at];
  }

  // this thread's 8 columns of each query head of the group, times scale
  const int dg = tid & 15, rs = tid >> 4;
  const TQ* qn = static_cast<const TQ*>(a.q) +
                 (static_cast<int64_t>(n) * a.h + hk * g_size) * kD;
  float qf[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qf[g][e] = g < g_size
                     ? ptt_to_float(qn[g * kD + group_col<TKV>(dg, e)]) *
                           a.scale
                     : 0.f;

  hopper::cp_async_wait<0>();
  __syncthreads();

  // scores of rows rs, rs + 8, ...: each row's 16 threads sum by shuffles
  // (a trip count uniform over the block, so every lane shuffles)
  const int n_iter = (t_live + kRowSlots - 1) / kRowSlots;
  for (int i = 0; i < n_iter; ++i) {
    const int t = rs + kRowSlots * i;
    const bool valid = t < t_live;
    float kf[8];
    if (valid) {
      row8(k_t, t, dg, kf);
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] *= row_scale[t];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = 0.f;
    }
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float v = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) v = fmaf(qf[g][e], kf[e], v);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      s[g] = v;
    }
    if (valid && dg == 0) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < g_size)
          sp[g * kSplitKeys + t] = key0 + t < len ? s[g] : PTT_NEG_INF;
    }
  }
  __syncthreads();

  // the split's max and sum per query head, one warp per head; the
  // probabilities replace the scores
  for (int g = warp; g < g_size; g += kWarps) {
    float* row = sp + g * kSplitKeys;
    const float s0 = lane < t_live ? row[lane] : -INFINITY;
    const float s1 = lane + 32 < t_live ? row[lane + 32] : -INFINITY;
    const float m = ptt_warp_max(fmaxf(s0, s1));
    const float p0 = expf(s0 - m), p1 = expf(s1 - m);
    row[lane] = p0;
    row[lane + 32] = p1;
    const float l = ptt_warp_sum(p0 + p1);
    if (lane == 0) {
      part[g * (kD + 2) + kD] = m;
      part[g * (kD + 2) + kD + 1] = l;
    }
  }
  __syncthreads();

  // P V over the same rows, then summed over the 8 row slots
  float acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int t = rs; t < t_live; t += kRowSlots) {
    float vf[8];
    row8(v_t, t, dg, vf);
    if (kQuant) {
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[e] *= row_scale[kSplitKeys + t];
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < g_size) {
        const float p = sp[g * kSplitKeys + t];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
  if (lane < 16) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < g_size) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[(warp * kG + g) * kD + group_col<TKV>(dg, e)] = acc[g][e];
      }
  }
  __syncthreads();
  for (int g = 0; g < g_size; ++g) {           // thread tid: column tid
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[(w * kG + g) * kD + tid];
    part[g * (kD + 2) + tid] = o;
  }
}

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    paged_attn_combine_kernel(PagedArgs a) {
  extern __shared__ float w_s[];                // [splits]: exp(m_s - M)
  __shared__ float warp_part[kWarps];
  const int n = blockIdx.x;
  const int h = blockIdx.y;                     // query head
  const int tid = threadIdx.x;                  // output column
  const int warp = tid >> 5, lane = tid & 31;
  const int g_size = a.h / a.hkv;
  const int64_t stride = static_cast<int64_t>(g_size) * (kD + 2);  // a split
  const float* head =
      a.ws + (static_cast<int64_t>(n) * a.hkv + h / g_size) * a.splits *
                 stride + (h % g_size) * (kD + 2);

  // M: the largest m_s of the splits with l_s > 0, every split at once
  float m = -INFINITY;
  for (int s = tid; s < a.splits; s += kThreads)
    if (head[s * stride + kD + 1] > 0.f) m = fmaxf(m, head[s * stride + kD]);
  m = ptt_warp_max(m);
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  m = warp_part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_part[w]);
  __syncthreads();

  // each split's weight, and L = sum_s l_s w_s
  float l = 0.f;
  for (int s = tid; s < a.splits; s += kThreads) {
    const float ls = head[s * stride + kD + 1];
    const float w = ls > 0.f ? expf(head[s * stride + kD] - m) : 0.f;
    w_s[s] = w;
    l = fmaf(ls, w, l);
  }
  l = ptt_warp_sum(l);
  if (lane == 0) warp_part[warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += warp_part[w];

  float o = 0.f;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
    const float w = w_s[s];
    if (w > 0.f) o = fmaf(head[s * stride + tid], w, o);
  }
  static_cast<TQ*>(a.out)[(static_cast<int64_t>(n) * a.h + h) * kD + tid] =
      ptt_from_float<TQ>(o / l);
}

template <typename TQ, typename TKV, bool kQuant, int kG>
int launch_split(const PagedArgs& a, int n, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<TKV, kG>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        ptt_allow_smem(paged_attn_split_kernel<TQ, TKV, kQuant, kG>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  paged_attn_split_kernel<TQ, TKV, kQuant, kG>
      <<<dim3(n, a.hkv, a.splits), kThreads, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_attn_combine_kernel<TQ>
      <<<dim3(n, a.h), kThreads, a.splits * sizeof(float), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool kQuant>
int launch(const PagedArgs& a, int n, cudaStream_t stream) {
  const int g = a.h / a.hkv;
  if (g == 1) return launch_split<TQ, TKV, kQuant, 1>(a, n, stream);
  if (g == 2) return launch_split<TQ, TKV, kQuant, 2>(a, n, stream);
  if (g <= 4) return launch_split<TQ, TKV, kQuant, 4>(a, n, stream);
  if (g <= 8) return launch_split<TQ, TKV, kQuant, 8>(a, n, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `pps` pages per split (pps * ps <= 64) and `splits` = ceil(p / pps)
// blocks per (slot, kv head); `ws` is the fp32 workspace
// [n, hkv, splits, h / hkv, 130].
PTT_EXPORT int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, const void* k_scales,
                                   const void* v_scales, void* ws, void* out,
                                   int n, int h, int hkv, int p, int ps,
                                   int pps, int splits, float scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  if (pps < 1 || pps * ps > kSplitKeys || splits != (p + pps - 1) / pps)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a{q,
              k_pages,
              v_pages,
              static_cast<const int*>(table),
              static_cast<const int*>(lengths),
              static_cast<const float*>(k_scales),
              static_cast<const float*>(v_scales),
              static_cast<float*>(ws),
              out,
              h,
              hkv,
              p,
              ps,
              pps,
              splits,
              scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_F32)
    return launch<float, float, false>(a, n, s);
  if (q_dtype == PTT_BF16 && kv_dtype == PTT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(a, n, s);
  if (q_dtype == PTT_F32 && kv_dtype == PTT_INT8)
    return launch<float, int8_t, true>(a, n, s);
  if (q_dtype == PTT_BF16 && kv_dtype == PTT_INT8)
    return launch<__nv_bfloat16, int8_t, true>(a, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

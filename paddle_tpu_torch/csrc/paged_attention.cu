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
// - paged_attn_split_kernel (paged_attn_int8_split_kernel for int8
//   pages), grid (N, HKV, splits), 128 threads. Each
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
// The float window (int8 pages in a decode round, kv_quant='int8'): the
// JAX round gathers every slot's pages into a float view, writes the
// round's new rows there and requantizes only the touched pages at the
// round's end (paddle_tpu/serving/engine.py:698-741). The port's round
// keeps the pages the round can touch, W per slot (2 at decode_block 8,
// ps 16), dequantized in a window [N, W, ps, HKV, D] in q's dtype, and
// its sub-steps write their rows there. Logical page i of slot n with
// win_first[n] <= i < win_first[n] + W is then read from the window,
// unscaled. So that every split reads one dtype (one tile layout, one
// cp.async width), the int8 splits skip the window's pages (their rows
// are neither copied nor scored; a split whose live pages all lie in the
// window writes an empty partial), and one more split per (slot, kv
// head), paged_attn_window_kernel, runs the same split in q's dtype over
// the window's W * ps <= 64 rows, into the workspace's last partial
// [N, HKV, splits + 1, G, D + 2]. The combine merges every partial by
// exp(m_s - M) as before. Three launches, one call.
//
// No kernel syncs with the host or allocates memory: the wrapper takes
// the workspace from PyTorch's caching allocator, so a call can be
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
  const void* k_win;     // [N, W, ps, HKV, D] in q's dtype, or null (W = 0)
  const void* v_win;
  const int* win_first;  // [N]: the window's first logical page
  float* ws;       // [N, HKV, parts, G, D + 2]: acc[D], m, l per head
  void* out;
  int h, hkv, p, ps, pps, splits, w;   // parts = splits + (w > 0)
  float scale;
};

__host__ __device__ __forceinline__ int n_parts(const PagedArgs& a) {
  return a.splits + (a.w > 0 ? 1 : 0);
}

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

// One split of one (slot, kv head): the body of the three split kernels
// below. kG: the group size G rounded up to 1, 2, 4 or 8 (register
// arrays); kWindow: this block is the window's split (TKV = TQ, the
// window's rows).
template <typename TQ, typename TKV, bool kQuant, int kG, bool kWindow>
__device__ __forceinline__ void split_body(const PagedArgs& a) {
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
  const int split = kWindow ? a.splits : blockIdx.z;
  const int g_size = a.h / a.hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = a.lengths[n];
  // the slot's pages: those holding a key below len, and at least one
  const int n_pages = min(max((len + a.ps - 1) / a.ps, 1), a.p);
  // an int8 split skips the window's pages; a split over pages in q's
  // dtype knows of no window (its code is the one without a window)
  constexpr bool kSkips = kQuant && !kWindow;
  // the window's logical pages [win0, win0 + w) (none without a window)
  const int win0 = (kSkips || kWindow) && a.w > 0 ? a.win_first[n] : 0;
  // this block's run of logical pages; the window's split runs over the
  // window (computed even when len is 0, as split 0 is without one)
  const int first_page = kWindow ? win0 : split * a.pps;
  const int run = kWindow ? a.w : min(a.pps, n_pages - first_page);
  const bool empty =
      kWindow ? win0 * a.ps >= max(len, 1)
              : first_page >= n_pages ||
                    (kSkips && first_page >= win0 &&
                     first_page + run <= win0 + a.w);
  const int parts = kSkips || kWindow ? n_parts(a) : a.splits;
  float* part = a.ws + ((static_cast<int64_t>(n) * a.hkv + hk) * parts +
                        split) * g_size * (kD + 2);
  if (empty) {                                 // an empty partial
    if (tid < g_size) {
      part[tid * (kD + 2) + kD] = -INFINITY;
      part[tid * (kD + 2) + kD + 1] = 0.f;
    }
    return;
  }
  const int t_live = run * a.ps;
  const int key0 = first_page * a.ps;
  // row t of the run lies in the window (an int8 split skips it)
  auto in_window = [&](int t) {
    if constexpr (kSkips) {
      const int page = first_page + t / a.ps;
      return page >= win0 && page < win0 + a.w;
    } else {
      return false;
    }
  };

  // every K and V row of the run in flight at once: from the slot's
  // pages through its table, or from the slot's window
  const int* pages = a.table + static_cast<int64_t>(n) * a.p + first_page;
  const int64_t row_stride = static_cast<int64_t>(a.hkv) * kD;
  const TKV* k_src = static_cast<const TKV*>(kWindow ? a.k_win : a.k_pages);
  const TKV* v_src = static_cast<const TKV*>(kWindow ? a.v_win : a.v_pages);
  const uint32_t k_sm = hopper::smem_u32(k_t);
  const uint32_t v_sm = hopper::smem_u32(v_t);
  for (int i = tid; i < t_live * kChunks; i += kThreads) {
    const int t = i / kChunks, c = i % kChunks;
    const int64_t page = kWindow ? static_cast<int64_t>(n) * a.w + t / a.ps
                                 : static_cast<int64_t>(pages[t / a.ps]);
    const int64_t at = (page * a.ps + t % a.ps) * row_stride + hk * kD +
                       c * (16 / static_cast<int>(sizeof(TKV)));
    const uint32_t off = chunk_at<TKV>(t, c);
    const bool load = !in_window(t);         // skipped rows are zero-filled
    hopper::cp_async_16(k_sm + off, k_src + at, load);
    hopper::cp_async_16(v_sm + off, v_src + at, load);
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
          sp[g * kSplitKeys + t] =
              key0 + t < len && !in_window(t) ? s[g] : PTT_NEG_INF;
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

// pages in q's dtype
template <typename TQ, typename TKV, int kG>
__global__ void __launch_bounds__(kThreads)
    paged_attn_split_kernel(PagedArgs a) {
  split_body<TQ, TKV, false, kG, false>(a);
}

// int8 pages (the window's pages skipped)
template <typename TQ, int kG>
__global__ void __launch_bounds__(kThreads)
    paged_attn_int8_split_kernel(PagedArgs a) {
  split_body<TQ, int8_t, true, kG, false>(a);
}

// the decode round's float window, one split per (slot, kv head)
template <typename TQ, int kG>
__global__ void __launch_bounds__(kThreads)
    paged_attn_window_kernel(PagedArgs a) {
  split_body<TQ, TQ, false, kG, true>(a);
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
  const int parts = n_parts(a);
  const int64_t stride = static_cast<int64_t>(g_size) * (kD + 2);  // a split
  const float* head =
      a.ws + (static_cast<int64_t>(n) * a.hkv + h / g_size) * parts *
                 stride + (h % g_size) * (kD + 2);

  // M: the largest m_s of the splits with l_s > 0, every split at once
  float m = -INFINITY;
  for (int s = tid; s < parts; s += kThreads)
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
  for (int s = tid; s < parts; s += kThreads) {
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
  for (int s = 0; s < parts; ++s) {
    const float w = w_s[s];
    if (w > 0.f) o = fmaf(head[s * stride + tid], w, o);
  }
  static_cast<TQ*>(a.out)[(static_cast<int64_t>(n) * a.h + h) * kD + tid] =
      ptt_from_float<TQ>(o / l);
}

enum class Split { kFloat, kInt8, kWindow };

// one split kernel over `blocks` splits of every (slot, kv head)
template <Split kS, typename TQ, typename TKV, int kG>
cudaError_t launch_splits(const PagedArgs& a, int n, int blocks,
                          cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<TKV, kG>();
  void (*kernel)(PagedArgs);
  if constexpr (kS == Split::kInt8)
    kernel = paged_attn_int8_split_kernel<TQ, kG>;
  else if constexpr (kS == Split::kWindow)
    kernel = paged_attn_window_kernel<TQ, kG>;
  else
    kernel = paged_attn_split_kernel<TQ, TKV, kG>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = ptt_allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  kernel<<<dim3(n, a.hkv, blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool kQuant, int kG>
int launch_split(const PagedArgs& a, int n, cudaStream_t stream) {
  cudaError_t e =
      launch_splits<kQuant ? Split::kInt8 : Split::kFloat, TQ, TKV, kG>(
          a, n, a.splits, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kQuant) {           // the window's split, in q's dtype
    if (a.w > 0) {
      e = launch_splits<Split::kWindow, TQ, TQ, kG>(a, n, 1, stream);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  paged_attn_combine_kernel<TQ>
      <<<dim3(n, a.h), kThreads, n_parts(a) * sizeof(float), stream>>>(a);
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
// blocks per (slot, kv head); `w` window pages (0: no window; int8 pages
// only, w * ps <= 64); `ws` is the fp32 workspace
// [n, hkv, splits + (w > 0), h / hkv, 130].
PTT_EXPORT int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, const void* k_scales,
                                   const void* v_scales, const void* k_win,
                                   const void* v_win, const void* win_first,
                                   void* ws, void* out, int n, int h, int hkv,
                                   int p, int ps, int pps, int splits, int w,
                                   float scale, int q_dtype, int kv_dtype,
                                   void* stream) {
  if (pps < 1 || pps * ps > kSplitKeys || splits != (p + pps - 1) / pps ||
      w < 0 || w * ps > kSplitKeys || (w > 0 && kv_dtype != PTT_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a{q,
              k_pages,
              v_pages,
              static_cast<const int*>(table),
              static_cast<const int*>(lengths),
              static_cast<const float*>(k_scales),
              static_cast<const float*>(v_scales),
              k_win,
              v_win,
              static_cast<const int*>(win_first),
              static_cast<float*>(ws),
              out,
              h,
              hkv,
              p,
              ps,
              pps,
              splits,
              w,
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

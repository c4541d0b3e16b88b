// Paged attention for decode: T query tokens per slot (T = 1 for a decode
// sub-step, k + 1 for a speculative verify) attend over the KV rows that
// the slot's page table scatters across the page pool.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_paged_attn_kernel (called
// through paged_attention / _paged_attention_pallas). Same function:
// q [N, T, H, D] (T decode queries per slot), pages [num_pages, ps, HKV, D]
// in f32, bf16, fp16 or int8 (int8 dequantized by a per-(page, kv head) f32
// scale), table [N, P] int32 (page 0 is the null page), lengths [N]
// int32; GQA folds query heads as [HKV, G] (head = hkv * G + g); query
// row t of slot n sees the keys below lengths[n] + t (the JAX verify's
// slot-causal mask, paddle_tpu/serving/engine.py:832-833; T = 1 is the
// decode kernel's mask); pages wholly past the last row's count are not
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
//   pages), grid (N, HKV, splits), 128 threads. The T x G query rows
//   of a (slot, kv head) are folded into one block, so each K and V row
//   is read once for all of them (a verify of T = 5 rows reads the bytes
//   of a decode call). Each
//   block owns a fixed run of `pps` pages (at most kSplitKeys = 64 keys:
//   4 pages at ps = 16) of one (slot, kv head); the split count comes
//   from the table width P, never from the lengths, so the host reads
//   nothing from the device. A block whose run starts past its slot's
//   last page writes an empty partial (m = -inf, l = 0) and exits; split
//   0 always holds the slot's first page. The block reads its page ids
//   from the table itself and puts every K and V row of its run in
//   flight at once: 16-byte cp.async copies (4 f32, 8 bf16 or 16 int8
//   values each) into shared memory, chunk c of row t stored at chunk
//   c ^ (t % 8) of its row (`chunk_at`; rows of 4 chunks below), so
//   that the 16-byte reads below are free of bank conflicts. Thread (row
//   slot r = tid / 16, 8-column group tid % 16)
//   then takes rows r, r + 8, ...: the scores q . k of up to 8 query
//   rows at a time (a pass: T x G <= 8 rows are one pass, as in decode;
//   up to 32 rows take 2 to 4 passes of equal width, and a pass holds
//   just its rows in registers), each summed over a key row's 16
//   threads by shuffles (int8 dequantized per element, as it is read),
//   under each query row's own mask; the split's max and sum per query
//   row, one warp per row across the block; P V, a pass at a time, into
//   8 fp32 registers per row, summed over the 8 row slots by a shuffle
//   and shared memory. It writes fp32 (acc[D], m, l) per query row to the
//   workspace [N, HKV, splits, T x G, D + 2].
// - paged_attn_combine_kernel, grid (N, H, T), one thread per output
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
// Nine libraries share this header, so that the compiler builds them in
// parallel. Three, one for each dtype of q (paged_attention_f32.cu,
// paged_attention_bf16.cu and paged_attention_fp16.cu), hold the
// instantiations for pages in q's dtype and for int8 pages with the
// window in q's dtype, at D = 64 and 128. Six, one for each pair of a q
// dtype and another float dtype P (paged_attention_<q>_kv<P>.cu), hold
// those for pages in P and for int8 pages with the window in P: a KV pool
// kept in another dtype than the model's (`InferenceEngine(dtype=)`, the
// JAX engine's argument), whose int8 window is in the pool's compute
// dtype. Every split reads its tile in the pages' (or the window's) type
// and q in its own, widened to fp32 as it is loaded; the output is in q's
// dtype. Each library exports `paged_attention_fwd`
// (`PTT_PAGED_ATTENTION_KV_FWD`); ops/kernels.py picks the library by q's
// dtype and the float dtype of the pages or of the window.
//
// No kernel syncs with the host or allocates memory: the wrapper takes
// the workspace from PyTorch's caching allocator, so a call can be
// captured by a CUDA graph.
//
// Head widths and dtypes: every kernel is a template over D, built for
// D = 128 and D = 64 (GPT-2, BERT, ERNIE), over pages in q's dtype (f32,
// bf16 or fp16) and over int8 pages with their window in q's dtype. An
// fp16 instantiation reads as the bf16 one: a 2-byte element, so the
// same tile layout and cp.async width, its packed pairs widened by
// __half22float2 (row8), scores, partials and LSE in fp32, int8 pages
// dequantized as scale x int8 in fp32, and one rounding of the output to
// fp16 (__float2half_rn) in the combine. A key row is spread over D / 8
// threads of 8 columns each (16 at D = 128, 8 at D = 64), so a block of
// 128 threads holds 128 / (D / 8) key rows at a time, the score
// reduce-scatter runs over D / 8 lanes and the combine has one thread
// per column.
//
// The tile layout of a 64-byte row (int8 at D = 64: 4 chunks). Every
// other row is 128 bytes or more (8 chunks and up: bf16 at D = 64 and
// int8 at D = 128 are 128 bytes, f32 at D = 64 256), and chunk c of row
// t sits at c ^ (t & 7) inside its own row. XOR with t & 7 over 4 chunks
// would reach chunks 4..7, which are the next row's bytes, so a 64-byte
// row XORs with t & 3 and stays inside its 64 bytes: the tile is then
// two rows per 128-byte line, each row's 4 chunks permuted within it.
// Its reads stay free of bank conflicts. row8<D>(const int8_t*) gives a
// thread 8 bytes, at chunk dg >> 1, offset (dg & 1) * 8, of one row; an
// 8-byte shared load is served a half-warp (16 lanes) at a time, and
// with 8 lanes a row the 16 lanes of a half-warp read rows t and t + 1
// (t even, so a 128-byte-aligned line) whole: 16 distinct 8-byte words
// of 128 contiguous bytes, all 32 banks once. The cp.async staging moves
// 4 chunks a row (2 x 64 keys x 64 B = 8 KB of K and V a split), and 8
// neighbouring threads store one whole line, permuted: conflict-free too.
#pragma once

#include <cmath>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitKeys = 64;             // K (and V) rows of a split, at most

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
  int t, h, hkv, p, ps, pps, splits, w;   // parts = splits + (w > 0)
  float scale;
};

__host__ __device__ __forceinline__ int n_parts(const PagedArgs& a) {
  return a.splits + (a.w > 0 ? 1 : 0);
}

// byte offset of 16-byte chunk c of row t in a [kSplitKeys][D] tile of T:
// swizzled inside the row, over 8 chunks, or over 4 in a 64-byte row (the
// note above; tests/test_torch_smoke.py mirrors it)
template <int D, typename T>
__device__ __forceinline__ int chunk_at(int t, int c) {
  constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static_assert(kRowBytes == 64 || kRowBytes % 128 == 0,
                "tile rows of 64 bytes or whole 128-byte lines");
  constexpr int kMask = kRowBytes == 64 ? 3 : 7;
  return t * kRowBytes + ((c ^ (t & kMask)) << 4);
}

// True when an f32 tile is read under an f32 q: its columns interleave
// (below). Under a 16-bit q an f32 tile (a pool kept in f32) keeps the
// 16-bit tiles' columns, so that the q . k and P V sums run in the same
// order over f32 pages as over the model's own 16-bit pages: a bf16 model
// served from an f32 pool reads the same bits, as on the CPU, where both
// read pages in f32. Its reads then take two wavefronts a quarter-warp.
template <typename TQ, typename TKV>
__host__ __device__ constexpr bool interleaved() {
  return sizeof(TKV) == 4 && sizeof(TQ) == 4;
}

// The 8 columns a thread of column group dg (0 .. D/8 - 1) owns: 8 dg ..
// 8 dg + 7, except in f32 tiles under an f32 q (4 values per chunk),
// where they are chunks dg and dg + D/8, so that 8 neighbouring threads
// read 8 distinct bank groups.
template <int D, typename TQ, typename TKV>
__device__ __forceinline__ int group_col(int dg, int e) {
  if (interleaved<TQ, TKV>())
    return (e < 4 ? 4 * dg : D / 2 + 4 * dg) + (e & 3);
  return 8 * dg + e;
}

// the 8 values of row t, column group dg, of a tile, as float (kInter:
// an f32 tile's interleaved columns, `group_col`)
template <int D, bool kInter>
__device__ __forceinline__ void row8(const float* tile, int t, int dg,
                                     float (&x)[8]) {
  const auto* base = reinterpret_cast<const uint8_t*>(tile);
  const float4 lo = *reinterpret_cast<const float4*>(
      base + chunk_at<D, float>(t, kInter ? dg : 2 * dg));
  const float4 hi = *reinterpret_cast<const float4*>(
      base + chunk_at<D, float>(t, kInter ? dg + D / 8 : 2 * dg + 1));
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

// bf16 or fp16 (T): one 16-byte chunk, four packed pairs
template <int D, typename T>
__device__ __forceinline__ void row8_16(const T* tile, int t, int dg,
                                        float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(
      reinterpret_cast<const uint8_t*>(tile) + chunk_at<D, T>(t, dg));
  const auto* pairs = reinterpret_cast<const typename PttPair<T>::type*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = ptt_to_float2(pairs[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <int D, bool kInter>
__device__ __forceinline__ void row8(const __nv_bfloat16* tile, int t,
                                     int dg, float (&x)[8]) {
  row8_16<D>(tile, t, dg, x);
}

template <int D, bool kInter>
__device__ __forceinline__ void row8(const __half* tile, int t, int dg,
                                     float (&x)[8]) {
  row8_16<D>(tile, t, dg, x);
}

template <int D, bool kInter>
__device__ __forceinline__ void row8(const int8_t* tile, int t, int dg,
                                     float (&x)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(
      reinterpret_cast<const uint8_t*>(tile) + chunk_at<D, int8_t>(t, dg >> 1) +
      (dg & 1) * 8);
  const auto* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = static_cast<float>(bytes[e]);
}

template <int D, typename TKV, int kG, int kRows>
constexpr size_t split_smem_bytes() {
  // K and V tiles (2 x 64 rows of D x sizeof(TKV) bytes: 8 KB for int8
  // at D = 64, 64 KB for f32 at D = 128), the warps' partial P V
  // [kWarps][kG][D] of a pass, scores then probabilities
  // [kRows][kSplitKeys], and the rows' k and v scales
  return 2 * kSplitKeys * D * sizeof(TKV) +
         (kWarps * kG * D + kRows * kSplitKeys + 2 * kSplitKeys) *
             sizeof(float);
}

// v rounded through T and back (float: v itself)
template <typename T>
__device__ __forceinline__ float round_through(float v) {
  return ptt_to_float(ptt_from_float<T>(v));
}

// One split of one (slot, kv head): the body of the three split kernels
// below. kG: query rows per pass (register arrays), T x G in one pass, or
// ceil(T x G / passes) in 2 to 4 passes; kRows: the rows T x G, at most
// (kG in one pass, else 32); kWindow: this block is the window's split
// (TKV the window's type). TR: over int8 pages, the type each
// dequantized value (one fp32 product scale x int8) is rounded through,
// as the JAX gather dequantizes into the pool's compute dtype: float (no
// rounding) where the window is in q's dtype, else the window's type.
template <int D, typename TQ, typename TKV, bool kQuant, int kG, int kRows,
          bool kWindow, typename TR = float>
__device__ __forceinline__ void split_body(const PagedArgs& a) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kD = D;
  constexpr int kLanes = D / 8;              // threads of a key row
  constexpr int kRowSlots = kThreads / kLanes;
  constexpr int kRowBytes = kD * sizeof(TKV);
  constexpr int kChunks = kRowBytes / 16;
  const TKV* k_t = reinterpret_cast<const TKV*>(smem);
  const TKV* v_t = reinterpret_cast<const TKV*>(smem + kSplitKeys * kRowBytes);
  float* red = reinterpret_cast<float*>(smem + 2 * kSplitKeys * kRowBytes);
  float* sp = red + kWarps * kG * kD;
  float* row_scale = sp + kRows * kSplitKeys;  // [2][kSplitKeys]: k, v

  const int n = blockIdx.x;
  const int hk = blockIdx.y;
  const int split = kWindow ? a.splits : blockIdx.z;
  const int g_size = a.h / a.hkv;
  // query row r: t = r / G; one pass holds exactly kG rows (`launch`)
  const int rows = kRows == kG ? kG : a.t * g_size;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = a.lengths[n];                // keys of query row t = 0
  const int len_last = len + a.t - 1;          // ... and of row T - 1
  // no row sees past the table (a window page past it, at a slot's end)
  const int keys = a.p * a.ps;
  // the slot's pages: those holding a key below len_last, and at least one
  const int n_pages = min(max((len_last + a.ps - 1) / a.ps, 1), a.p);
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
      kWindow ? win0 * a.ps >= max(len_last, 1)
              : first_page >= n_pages ||
                    (kSkips && first_page >= win0 &&
                     first_page + run <= win0 + a.w);
  const int parts = kSkips || kWindow ? n_parts(a) : a.splits;
  float* part = a.ws + ((static_cast<int64_t>(n) * a.hkv + hk) * parts +
                        split) * rows * (kD + 2);
  if (empty) {                                 // an empty partial
    if (tid < rows) {
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
    const uint32_t off = chunk_at<D, TKV>(t, c);
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

  // this thread's 8 columns of query rows r0 .. r0 + kG - 1 (row r: query
  // t = r / G, head hk * G + r % G), times scale
  const int dg = tid % kLanes, rs = tid / kLanes;
  // the pass's rows padded to a power of two for the reduce-scatter
  // below, and the row of the pass whose score this lane ends with
  constexpr int kP = kG == 1 ? 1 : kG == 2 ? 2 : kG <= 4 ? 4 : 8;
  constexpr int kSteps = kLanes == 16 ? 4 : 3;   // log2(kLanes)
  static_assert(kP <= kLanes, "a key row's lanes hold the pass's rows");
  int lane_g = 0;
#pragma unroll
  for (int st = 0; st < kSteps; ++st)
    if ((kP >> st) >= 2 && (dg & ((kLanes / 2) >> st)))
      lane_g += (kP >> st) / 2;
  const bool writer = (dg & (kLanes / kP - 1)) == 0 && lane_g < kG;
  float qf[kG][8];
  auto load_q = [&](int r0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int r = r0 + g;
      const TQ* qr = static_cast<const TQ*>(a.q) +
                     ((static_cast<int64_t>(n) * a.t + r / g_size) * a.h +
                      hk * g_size + r % g_size) * kD;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qf[g][e] = r < rows
                       ? ptt_to_float(qr[group_col<D, TQ, TKV>(dg, e)]) *
                             a.scale
                       : 0.f;
    }
  };
  load_q(0);

  hopper::cp_async_wait<0>();
  __syncthreads();

  // scores of rows rs, rs + 8, ...: each row's 16 threads sum by shuffles
  // (a trip count uniform over the block, so every lane shuffles), one
  // pass of kG query rows at a time, each row under its own mask
  const int n_iter = (t_live + kRowSlots - 1) / kRowSlots;
  for (int r0 = 0; r0 < rows; r0 += kG) {
    if (r0 > 0) load_q(r0);
    // this lane's query row and its key count (none past the table)
    const int r = r0 + lane_g;
    const bool writes = writer && r < rows;
    const int count = writes ? min(len + r / g_size, keys) : 0;
    for (int i = 0; i < n_iter; ++i) {
      const int t = rs + kRowSlots * i;
      const bool valid = t < t_live;
      float kf[8];
      if (valid) {
        row8<D, interleaved<TQ, TKV>()>(k_t, t, dg, kf);
        if (kQuant) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            kf[e] = round_through<TR>(kf[e] * row_scale[t]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
      // this thread's part of each row's dot product, padded to kP rows
      float v[kP];
#pragma unroll
      for (int g = 0; g < kP; ++g) {
        float x = 0.f;
        if (g < kG) {
#pragma unroll
          for (int e = 0; e < 8; ++e) x = fmaf(qf[g][e], kf[e], x);
        }
        v[g] = x;
      }
      // reduce-scatter over the key row's kLanes lanes: at each step of
      // the butterfly a lane keeps half of its rows and adds its
      // partner's half of them, so the sums are those of a plain
      // kLanes-lane reduction, bit for bit, in kP - 1 + log2(kLanes /
      // kP) shuffles, not kP log2(kLanes); lane dg ends with the whole
      // score of query row r
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int o = (kLanes / 2) >> st, m = kP >> st;   // m: rows held
        if (m >= 2) {
          const bool hi = (dg & o) != 0;
#pragma unroll
          for (int i = 0; i < m / 2; ++i) {
            const float send = hi ? v[i] : v[i + m / 2];
            const float keep = hi ? v[i + m / 2] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        } else {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
        }
      }
      if (valid && writes)
        sp[r * kSplitKeys + t] =
            key0 + t < count && !in_window(t) ? v[0] : PTT_NEG_INF;
    }
  }
  __syncthreads();

  // the split's max and sum per query row, one warp per row; the
  // probabilities replace the scores
  for (int g = warp; g < rows; g += kWarps) {
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

  // P V over the same rows, a pass of kG query rows at a time, then
  // summed over the 8 row slots
  for (int r0 = 0; r0 < rows; r0 += kG) {
    float acc[kG][8];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    for (int t = rs; t < t_live; t += kRowSlots) {
      float vf[8];
      row8<D, interleaved<TQ, TKV>()>(v_t, t, dg, vf);
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vf[e] = round_through<TR>(vf[e] * row_scale[kSplitKeys + t]);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (r0 + g < rows) {
          const float p = sp[(r0 + g) * kSplitKeys + t];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    // the warp's row slots (lanes kLanes apart) summed by shuffles
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    if (lane < kLanes) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (r0 + g < rows) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            red[(warp * kG + g) * kD + group_col<D, TQ, TKV>(dg, e)] =
                acc[g][e];
        }
    }
    __syncthreads();
    // thread tid: column tid
    for (int g = 0; g < kG && r0 + g < rows && tid < kD; ++g) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += red[(w * kG + g) * kD + tid];
      part[(r0 + g) * (kD + 2) + tid] = o;
    }
    if (r0 + kG < rows) __syncthreads();         // red is the next pass's
  }
}

// pages in q's dtype
template <int D, typename TQ, typename TKV, int kG, int kRows>
__global__ void __launch_bounds__(kThreads)
    paged_attn_split_kernel(PagedArgs a) {
  split_body<D, TQ, TKV, false, kG, kRows, false>(a);
}

// int8 pages (the window's pages skipped), dequantized through TR
template <int D, typename TQ, typename TR, int kG, int kRows>
__global__ void __launch_bounds__(kThreads)
    paged_attn_int8_split_kernel(PagedArgs a) {
  split_body<D, TQ, int8_t, true, kG, kRows, false, TR>(a);
}

// the decode round's float window (in TW: q's dtype, or the pool's
// compute dtype), one split per (slot, kv head)
template <int D, typename TQ, typename TW, int kG, int kRows>
__global__ void __launch_bounds__(kThreads)
    paged_attn_window_kernel(PagedArgs a) {
  split_body<D, TQ, TW, false, kG, kRows, true>(a);
}

// D threads, one per output column
template <int D, typename TQ>
__global__ void __launch_bounds__(D)
    paged_attn_combine_kernel(PagedArgs a) {
  constexpr int kD = D, kThreads = D, kWarps = D / 32;
  extern __shared__ float w_s[];                // [splits]: exp(m_s - M)
  __shared__ float warp_part[kWarps];
  const int n = blockIdx.x;
  const int h = blockIdx.y;                     // query head
  const int qt = blockIdx.z;                    // query row of the slot
  const int tid = threadIdx.x;                  // output column
  const int warp = tid >> 5, lane = tid & 31;
  const int g_size = a.h / a.hkv;
  const int parts = n_parts(a);
  // a split's partials: T x G rows of D + 2
  const int64_t stride = static_cast<int64_t>(a.t) * g_size * (kD + 2);
  const float* head =
      a.ws + (static_cast<int64_t>(n) * a.hkv + h / g_size) * parts *
                 stride + (qt * g_size + h % g_size) * (kD + 2);

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
  static_cast<TQ*>(a.out)[((static_cast<int64_t>(n) * a.t + qt) * a.h + h) *
                               kD + tid] = ptt_from_float<TQ>(o / l);
}

enum class Split { kFloat, kInt8, kWindow };

// one split kernel over `blocks` splits of every (slot, kv head); TKV is
// the tile's type (the window's for Split::kWindow); TR as in split_body
template <int D, Split kS, typename TQ, typename TKV, int kG, int kRows,
          typename TR = float>
cudaError_t launch_splits(const PagedArgs& a, int n, int blocks,
                          cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<D, TKV, kG, kRows>();
  void (*kernel)(PagedArgs);
  if constexpr (kS == Split::kInt8)
    kernel = paged_attn_int8_split_kernel<D, TQ, TR, kG, kRows>;
  else if constexpr (kS == Split::kWindow)
    kernel = paged_attn_window_kernel<D, TQ, TKV, kG, kRows>;
  else
    kernel = paged_attn_split_kernel<D, TQ, TKV, kG, kRows>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = ptt_allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  kernel<<<dim3(n, a.hkv, blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// TW: the window's dtype over int8 pages
template <int D, typename TQ, typename TKV, bool kQuant, typename TW, int kG,
          int kRows>
int launch_split(const PagedArgs& a, int n, cudaStream_t stream) {
  // int8 pages dequantize through the window's type when it is not q's
  using TR = std::conditional_t<std::is_same_v<TW, TQ>, float, TW>;
  cudaError_t e = launch_splits<D, kQuant ? Split::kInt8 : Split::kFloat,
                                TQ, TKV, kG, kRows, TR>(a, n, a.splits,
                                                        stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (kQuant) {           // the window's split, in TW
    if (a.w > 0) {
      e = launch_splits<D, Split::kWindow, TQ, TW, kG, kRows>(a, n, 1,
                                                              stream);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  paged_attn_combine_kernel<D, TQ>
      <<<dim3(n, a.h, a.t), D, n_parts(a) * sizeof(float), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// by the query rows R = T x G of a (slot, kv head): R <= 8 in one pass
// of R rows; up to 32 in ceil(R / 8) passes of ceil(R / passes) rows
template <int D, typename TQ, typename TKV, bool kQuant, typename TW>
int launch(const PagedArgs& a, int n, cudaStream_t stream) {
  const int r = a.t * (a.h / a.hkv);
  switch (r) {
    case 1: return launch_split<D, TQ, TKV, kQuant, TW, 1, 1>(a, n, stream);
    case 2: return launch_split<D, TQ, TKV, kQuant, TW, 2, 2>(a, n, stream);
    case 3: return launch_split<D, TQ, TKV, kQuant, TW, 3, 3>(a, n, stream);
    case 4: return launch_split<D, TQ, TKV, kQuant, TW, 4, 4>(a, n, stream);
    case 5: return launch_split<D, TQ, TKV, kQuant, TW, 5, 5>(a, n, stream);
    case 6: return launch_split<D, TQ, TKV, kQuant, TW, 6, 6>(a, n, stream);
    case 7: return launch_split<D, TQ, TKV, kQuant, TW, 7, 7>(a, n, stream);
    case 8: return launch_split<D, TQ, TKV, kQuant, TW, 8, 8>(a, n, stream);
    default: break;
  }
  if (r > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int passes = (r + 7) / 8;
  switch ((r + passes - 1) / passes) {   // 5 .. 8
    case 5: return launch_split<D, TQ, TKV, kQuant, TW, 5, 32>(a, n, stream);
    case 6: return launch_split<D, TQ, TKV, kQuant, TW, 6, 32>(a, n, stream);
    case 7: return launch_split<D, TQ, TKV, kQuant, TW, 7, 32>(a, n, stream);
    default: return launch_split<D, TQ, TKV, kQuant, TW, 8, 32>(a, n, stream);
  }
}

// `paged_attention_fwd` of the library for q of type TQ (dtype code
// kCode) over float pages of type TP (code kPageCode): `t` query rows per
// slot (t x h / hkv <= 32); `pps` pages per split (pps * ps <= 64) and
// `splits` = ceil(p / pps) blocks per (slot, kv head); `w` window pages
// (0: no window; int8 pages only, w * ps <= 64); `ws` is the fp32
// workspace [n, hkv, splits + (w > 0), t x h / hkv, d + 2]; `d` is 128 or
// 64. Pages are in TP, or int8 (the window then in TP); any other dtype is
// cudaErrorInvalidValue. A library of TP = TQ serves pages in q's dtype;
// one of TP != TQ (paged_attention_<q>_kv<p>.cu) pages, or an int8 pool's
// window, in another float dtype.
template <typename TQ, int kCode, typename TP, int kPageCode>
int paged_attention_entry(const void* q, const void* k_pages,
                          const void* v_pages, const void* table,
                          const void* lengths, const void* k_scales,
                          const void* v_scales, const void* k_win,
                          const void* v_win, const void* win_first, void* ws,
                          void* out, int n, int t, int h, int hkv, int p,
                          int ps, int pps, int splits, int w, float scale,
                          int q_dtype, int kv_dtype, int d, void* stream) {
  if (t < 1 || pps < 1 || pps * ps > kSplitKeys ||
      splits != (p + pps - 1) / pps || w < 0 || w * ps > kSplitKeys ||
      (w > 0 && kv_dtype != PTT_INT8) || (d != 128 && d != 64) ||
      q_dtype != kCode || (kv_dtype != kPageCode && kv_dtype != PTT_INT8))
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
              t,
              h,
              hkv,
              p,
              ps,
              pps,
              splits,
              w,
              scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == PTT_INT8)
    return d == 64 ? launch<64, TQ, int8_t, true, TP>(a, n, s)
                   : launch<128, TQ, int8_t, true, TP>(a, n, s);
  return d == 64 ? launch<64, TQ, TP, false, TP>(a, n, s)
                 : launch<128, TQ, TP, false, TP>(a, n, s);
}

}  // namespace

// the library's exported entry, for q of type TQ (dtype code CODE) over
// float pages, or an int8 pool's window, of type TP (code PCODE)
#define PTT_PAGED_ATTENTION_KV_FWD(TQ, CODE, TP, PCODE)                     \
  PTT_EXPORT int paged_attention_fwd(                                       \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* table, const void* lengths, const void* k_scales,         \
      const void* v_scales, const void* k_win, const void* v_win,           \
      const void* win_first, void* ws, void* out, int n, int t, int h,      \
      int hkv, int p, int ps, int pps, int splits, int w, float scale,      \
      int q_dtype, int kv_dtype, int d, void* stream) {                     \
    return paged_attention_entry<TQ, CODE, TP, PCODE>(                      \
        q, k_pages, v_pages, table, lengths, k_scales, v_scales, k_win,     \
        v_win, win_first, ws, out, n, t, h, hkv, p, ps, pps, splits, w,     \
        scale, q_dtype, kv_dtype, d, stream);                               \
  }

// the entry for pages (or an int8 pool's window) in q's dtype
#define PTT_PAGED_ATTENTION_FWD(TQ, CODE) \
  PTT_PAGED_ATTENTION_KV_FWD(TQ, CODE, TQ, CODE)

// Segmented LoRA delta over a packed adapter bank, per batch row b:
//   delta[b, t, :] = (scale[s] * ((x[b, t, :] . A[s]) . B[s])).to(x.dtype),
//   s = rows[b],  x [B, T, H],  A = a_bank [C, H, R],  B = b_bank [C, R, O],
// and, with y given, out = y + delta in y's dtype (= x.dtype), the
// projection's output and its delta in one pass.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_adapter_matmul_kernel
// (pallas_call at :878), the per-row adapter delta of multi-tenant LoRA
// serving, and the add the JAX hook does after it
// (paddle_tpu/serving/adapters/apply.py: y + Tensor(delta)). Every adapted
// projection of every prefill and decode forward calls it once.
//
// Rounding order: the JAX reference's (pallas_kernels.py:842-848). x and
// the factors go to fp32, h1 = x . A is summed in fp32, then h1 . B in
// fp32, times the slot's fp32 scale, and one cast to x.dtype; the fused
// add then adds that rounded delta to y in fp32 and rounds once more to
// y's dtype, which is what torch and XLA do for y + delta.
//
// Bound on the H100: bytes, and at the serving path's shapes the launch
// itself. The work is 2 * T * R * (H + O) flops per row: 134 MFLOP for a
// prefill call (T = 1024, H = O = 4096, rank 8), about 2 us at the 67
// TFLOP/s fp32 FMA rate, so no tensor cores (TF32 wgmma would also break
// the reference's fp32 sums for an f32 bank). A decode call (8 rows, T = 1,
// three adapted slots and slot 0, f32 bank) moves about 1 MB (each
// adapted slot's 256 KB of factors once, x, y and the output): ~0.3 us at
// 3.35 TB/s, below what a launch costs, so what counts is how many SMs
// share the factor reads and how many memory round trips the call waits
// on in a row. A prefill call moves ~24 MB of x, y and output (~7 us); what
// holds it back is the fixed cost of each 16-token round of a cluster
// (issuing its copies, the cluster barrier, the expand), not the bytes.
//
// Design (Punica's SGMV, split over a thread-block cluster):
//  - Rows grouped by slot, on the device. The grid is one cluster of
//    kCluster = 8 blocks per (row b, tile of TT tokens). Every block
//    reads `rows` itself (the host never does: no sync, so the call can be
//    captured by a CUDA graph) and finds the rows on slot s = rows[b]. The
//    cluster of the first such row serves the whole group; every other
//    cluster exits at once. So each distinct slot's factors are read from
//    memory once per call, by 8 SMs. A group holds at most the whole
//    batch, kMaxBatch = 1024 rows (a larger batch raises in the wrapper);
//    its (row, token) entries are processed in rounds of MTOT (16 at rank
//    8), never cut. TT is MTOT, or a multiple of it when the call would
//    otherwise launch more clusters than the card holds at once (a
//    prefill call at T = 1024: a few rounds per cluster instead of 64
//    clusters of one), so that the clusters run in one wave.
//  - Slot 0 (the zero base adapter) reads no factors: its rows get an
//    exact zero delta (y unchanged with the add). A slot outside [0, C)
//    reads nothing and writes NaN, so a bad row table shows in the output.
//  - Block k of the cluster owns the k-th eighth of H (rounded to 8) for
//    the shrink and of O for the expand. The lanes of warp 0 stage the
//    block's slices with bulk copies (TMA, one per row, 16-byte granules,
//    counted on an mbarrier): the live rows' x slice and the A slice
//    [H/8][R], and the B slice [R][O/8], all in flight together, into
//    dynamic shared memory (80 KB: x and A, B, and a second x buffer; x
//    and A, and B, go in pieces when a large rank does not fit; a slice
//    that fits stays for every round). When A stays and there is more
//    than one round, round r + 1's x lands in the other x buffer while
//    round r computes. Shapes whose rows are not 16-byte multiples, or
//    unaligned pointers, are copied element by element instead; the
//    instantiation for shapes and pointers that allow 16-byte access
//    everywhere (VEC, the serve path) holds no element-by-element code.
//  - Shrink: the 256 threads are 4 row groups of 64; a group takes a tile
//    of MT rows of the round (MT * RT = 32 or 64 fp32 partial sums, RT the
//    rank padded to 8, 16, 32 or 64) and every 64th row of H, from shared
//    memory, with fp32 FMAs. When the round's live rows fit one tile
//    (decode), all 4 groups share it, each taking every 256th row of H. A
//    warp reduce-scatter (62 shuffles for 64 sums) and one pass through
//    shared memory give the block's partial h1 of each tile.
//  - Each block pushes its partial h1 [MTOT][RT] into every block of the
//    cluster (distributed shared memory, map_shared_rank), then one cluster
//    barrier; each block sums the 8 partials in rank order, so all hold the
//    same h1. The receive area is double-buffered by round, so a block one
//    round ahead never overwrites a partial still being read, and nothing
//    needs a second barrier. The first push waits for a barrier armed at
//    the start, so that every block of the cluster runs.
//  - Expand: thread (group q, lane c) takes 8-wide chunks c, c + 64, ... of
//    the block's O slice for its rows (a lone tile's rows dealt across the
//    groups): B from shared memory, fp32 FMAs, scale, one rounding, and,
//    for the add, y (16-byte loads, issued at the round's start so that
//    they land during the shrink); 16-byte stores.
//  - One launch, no global scratch, no atomics, nothing to reset between
//    calls. Ragged H, O and rank are masked; a padded rank entry is exactly
//    0 in h1 and is not summed into the output.
#include <algorithm>
#include <climits>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                   // blocks per cluster
constexpr int kGroups = 4;                    // row groups per block
constexpr int kLanes = kThreads / kGroups;    // threads per row group
constexpr int kVec = 8;                       // elements per 16-byte chunk
constexpr int kMaxBatch = 1024;
// dynamic shared memory: x and A of a piece of the block's H slice, and B
// of a piece of its O slice (one piece each at the serve path's shapes)
constexpr int kStageXA = 32768;
constexpr int kStageB = 32768;
// a second x buffer, for the next round's x while this round computes
constexpr int kStageX2 = 16384;
constexpr int kStageBytes = kStageXA + kStageB + kStageX2;
enum { kVecX = 1, kVecA = 2, kVecB = 4, kVecOut = 8, kVecAll = 15 };

// rows of a round per row group: MT * RT partial sums per thread
template <int RT>
struct Tile {
  static constexpr int MT = RT >= 32 ? 1 : 32 / RT;
  static constexpr int N = MT * RT;             // 32 or 64
  static constexpr int MTOT = kGroups * MT;     // entries per round
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// 8 elements of T kept as the raw 16-byte words they were loaded as, so
// that a batch of loads issues back to back: nothing waits for a load's
// data until an element is read as fp32 (operator[], j known at compile
// time once the loops are unrolled).
template <typename T>
struct Raw8 {
  static constexpr int kWords = sizeof(T) / 2;   // 1 (bf16) or 2 (f32)
  uint4 w[kWords];

  __device__ __forceinline__ static unsigned& part(uint4& u, int k) {
    return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  }
  __device__ __forceinline__ static unsigned part(const uint4& u, int k) {
    return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  }
  __device__ __forceinline__ float operator[](int j) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(part(w[j / 4], j % 4));
    } else {   // bf16 2k in the low half of word k, 2k + 1 in the high half
      const unsigned b = part(w[0], j / 2);
      return __uint_as_float(j % 2 ? b & 0xffff0000u : b << 16);
    }
  }
};

// r = p[i .. i + 8), 0 past n, from global or shared memory: one or two
// 16-byte loads when `vec` (p 16-byte aligned, i a multiple of 8) and the
// chunk is whole, else masked scalar loads packed into the same words
template <typename T>
__device__ __forceinline__ void load8(const T* p, int64_t i, int64_t n,
                                      bool vec, Raw8<T>& r) {
  if (vec && i + kVec <= n) {
#pragma unroll
    for (int k = 0; k < Raw8<T>::kWords; ++k)
      r.w[k] = reinterpret_cast<const uint4*>(p + i)[k];
    return;
  }
#pragma unroll
  for (int k = 0; k < Raw8<T>::kWords; ++k) r.w[k] = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (i + j >= n) continue;
    if constexpr (sizeof(T) == 4) {
      Raw8<T>::part(r.w[j / 4], j % 4) = __float_as_uint(p[i + j]);
    } else {
      const unsigned bits = __bfloat16_as_ushort(p[i + j]);
      Raw8<T>::part(r.w[0], j / 2) |= j % 2 ? bits << 16 : bits;
    }
  }
}

// p[i + j] = v[j] (rounded to T) for i + j < n
template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, int64_t i,
                                       int64_t n, bool vec, const float* v) {
  if (vec && i + kVec <= n) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + i + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(p + i) = u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (i + j < n) p[i + j] = ptt_from_float<T>(v[j]);
  }
}

// One step of a warp reduce-scatter: lanes with bit O keep the upper half
// of their N sums, the others the lower half, each adding its partner's.
template <int N, int O>
__device__ __forceinline__ void rs_step(float* v, int lane) {
  constexpr int kHalf = N / 2;
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// After it, v[j] (j < N / 32) holds the warp's total of sum index
// lane * (N / 32) + j.
template <int N>
__device__ __forceinline__ void warp_reduce_scatter(float* v, int lane) {
  rs_step<N, 16>(v, lane);
  rs_step<N / 2, 8>(v, lane);
  rs_step<N / 4, 4>(v, lane);
  rs_step<N / 8, 2>(v, lane);
  rs_step<N / 16, 1>(v, lane);
}

// the cluster barrier in two halves: a block arrives when it starts and
// waits just before it first writes another block's shared memory
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an mbarrier that one thread arms with the bytes of the bulk copies
// (TMA) it then issues; every thread waits for the phase to complete
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  // order this block's earlier reads of the staging buffers before the
  // copies' writes (generic then async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// dst[k * n + j] = src(k)[j] for k < rows, j < n (raw elements): with
// `bulk` (every row's start 16-byte aligned, n * sizeof(T) a multiple of
// 16), one bulk copy per row, issued by the lanes of warp 0 in turn (a
// copy takes a thread hundreds of cycles to issue) and counted on `bar`
// (armed with the bytes by thread 0, before or after the copies land);
// else element by element by every thread, complete at the next
// __syncthreads()
template <typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int n, bool bulk,
                                           Src src, uint64_t* bar) {
  if (bulk) {
    if (threadIdx.x < 32) {
      // this block's earlier reads of dst before the copies' writes
      // (generic then async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int k = threadIdx.x; k < rows; k += 32)
        bulk_copy(dst + k * n, src(k), n * sizeof(T), bar);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += kThreads)
      dst[i] = src(i / n)[i % n];
  }
}

// the RT (padded) entries of a staged A row as fp32; 0 past R
template <typename TW, int RT>
__device__ __forceinline__ void smem_row(const TW* row, int R, bool vec,
                                         float* v) {
  if (vec) {   // R a multiple of 8: 16-byte shared loads
#pragma unroll
    for (int r = 0; r < RT; r += kVec) {
      Raw8<TW> w;
#pragma unroll
      for (int k = 0; k < Raw8<TW>::kWords; ++k)
        w.w[k] = r < R ? reinterpret_cast<const uint4*>(row + r)[k]
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[r + j] = w[j];
    }
  } else {
#pragma unroll
    for (int r = 0; r < RT; ++r) v[r] = r < R ? ptt_to_float(row[r]) : 0.f;
  }
}

// VEC: every flag of kVecAll holds, known at compile time, so that the
// serve path's instantiation holds no element-by-element code
template <typename TX, typename TW, int RT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    adapter_sgmv_kernel(const TX* __restrict__ x,
                        const TW* __restrict__ a_bank,
                        const TW* __restrict__ b_bank,
                        const int* __restrict__ rows,
                        const float* __restrict__ scale,
                        const TX* __restrict__ y, TX* __restrict__ out,
                        int B, int T, int H, int R, int O, int C, int TT,
                        int flags) {
  using Sh = Tile<RT>;
  constexpr int MT = Sh::MT, N = Sh::N, MTOT = Sh::MTOT, NW = N / 32;
  __shared__ int members[kMaxBatch];
  __shared__ int n_members;
  __shared__ float red[kWarps][N];
  // every block's partial h1, pushed here by its owner; two rounds' worth,
  // so that a block one round ahead never overwrites what is still read
  __shared__ float recv[2][kCluster][MTOT * RT];
  __shared__ float h1[MTOT * RT];   // the cluster's h1
  // staging of x (and A) into xs, into xs2; of B
  __shared__ __align__(8) uint64_t bars[3];
  extern __shared__ __align__(16) unsigned char stage[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cid = blockIdx.x / kCluster;
  const int tiles = ceil_div(T, TT);
  const int b = cid / tiles;
  const int t0 = (cid % tiles) * TT;
  const int nt = min(TT, T - t0);
  const int hs = ceil_div(ceil_div(H, kCluster), kVec) * kVec;
  const int hb = min(H, rank * hs), he = min(H, hb + hs);
  const int os = ceil_div(ceil_div(O, kCluster), kVec) * kVec;
  const int ob = min(O, rank * os), oe = min(O, ob + os);
  const int s = rows[b];
  const bool adapted = s > 0 && s < C;
  const TW* a = a_bank + static_cast<int64_t>(adapted ? s : 0) * H * R;
  const TW* bm = b_bank + static_cast<int64_t>(adapted ? s : 0) * R * O;

  if (tid == 0) {   // ready before the scan's __syncthreads()
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
  }

  // the rows on slot s, in order (the same in every block of the cluster)
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < B; base += 32) {
      const int i = base + lane;
      const bool hit = i < B && rows[i] == s;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) members[cnt + __popc(m & ((1u << lane) - 1u))] = i;
      cnt += __popc(m);
    }
    if (lane == 0) n_members = cnt;
  }
  __syncthreads();
  if (members[0] != b) return;   // the group's first row's cluster serves it

  const int ne = n_members * nt;   // entries: (row of the group, token)
  const int o_chunks = ceil_div(oe - ob, kVec);
  const bool vx = VEC || (flags & kVecX), va = VEC || (flags & kVecA),
             vb = VEC || (flags & kVecB), vo = VEC || (flags & kVecOut);
  auto token = [&](int e) {   // flat token index of entry e
    return static_cast<int64_t>(members[e / nt]) * T + t0 + e % nt;
  };

  if (!adapted) {   // slot 0: a zero delta; outside [0, C): NaN
    const float d = s == 0 ? 0.f : __int_as_float(0x7fc00000);
    for (int i = tid; i < ne * o_chunks; i += kThreads) {
      const int64_t tok = token(i / o_chunks);
      const int o = ob + (i % o_chunks) * kVec;
      Raw8<TX> yr;
      if (y != nullptr) load8(y + tok * O, o, oe, vo, yr);
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = (y != nullptr ? yr[j] : 0.f) + d;
      store8(out + tok * O, o, oe, vo, v);
    }
    return;   // uniform over the cluster: no block waits on a cluster barrier
  }

  const float sc = scale[s];
  const int q = tid / kLanes, c0 = tid % kLanes;
  // staged in shared memory, raw: xs [MTOT][P] and as [P][R] for a piece
  // of P rows of this block's H slice, bs [R][PO] for a piece of PO
  // columns of its O slice. A single piece stays for every round.
  const int piece = min(hs, kStageXA / (MTOT * static_cast<int>(sizeof(TX)) +
                                        R * static_cast<int>(sizeof(TW))) /
                                kVec * kVec);
  const int n_o = oe - ob;
  const int o_piece = min(os, kStageB / (R * static_cast<int>(sizeof(TW))) /
                                  kVec * kVec);
  TX* const xs = reinterpret_cast<TX*>(stage);
  TW* const as = reinterpret_cast<TW*>(stage + MTOT * piece * sizeof(TX));
  TW* const bs = reinterpret_cast<TW*>(stage + kStageXA);
  TX* const xs2 = reinterpret_cast<TX*>(stage + kStageXA + kStageB);
  const bool a_resident = piece >= he - hb, b_resident = o_piece >= n_o;
  const bool row_vec = R % kVec == 0;
  // more than one round, and the A slice stays: round r's x is staged into
  // xs or xs2 by parity (bars[r & 1]) while round r - 1 computes
  const bool pipelined =
      ne > MTOT && a_resident && vx &&
      MTOT * (he - hb) * static_cast<int>(sizeof(TX)) <= kStageX2;
  unsigned phases = 0;   // bit i: the phase bars[i] waits for next
  auto wait_bar = [&](int i) {
    mbar_wait(&bars[i], (phases >> i) & 1u);
    phases ^= 1u << i;
  };
  // the live rows of the round from entry e0 (a dead row's sums are never
  // stored), columns [p0, p0 + np) of x into dst, with the A rows
  // [p0, p0 + np) when with_a; true when bulk copies count on bars[bar]
  auto stage_x = [&](int e0, TX* dst, int p0, int np, bool with_a,
                     int bar) {
    const int rows_x = min(MTOT, ne - e0);
    const unsigned bytes = (vx ? rows_x * np * sizeof(TX) : 0) +
                           (with_a && va ? np * R * sizeof(TW) : 0);
    if (tid == 0 && bytes > 0) mbar_arm(&bars[bar], bytes);
    stage_rows(
        dst, rows_x, np, vx,
        [&](int m) { return x + token(e0 + m) * H + p0; }, &bars[bar]);
    if (with_a)
      stage_rows(
          as, 1, np * R, va,
          [&](int) { return a + static_cast<int64_t>(p0) * R; }, &bars[bar]);
    return bytes > 0;
  };
  bool b_pending = false;
  auto stage_b = [&](int p, int n) {   // B columns [ob + p, ob + p + n)
    if (vb) {
      if (tid == 0) mbar_arm(&bars[2], R * n * sizeof(TW));
      b_pending = true;
    }
    stage_rows(
        bs, R, n, vb,
        [&](int r) { return bm + static_cast<int64_t>(r) * O + ob + p; },
        &bars[2]);
  };
  auto wait_b = [&]() {
    if (b_pending) {
      wait_bar(2);
      b_pending = false;
    }
  };
  // a block may write another's shared memory only once that block runs:
  // this arrival is waited for before the first push
  cluster_arrive_relaxed();

  for (int e0 = 0, round = 0; e0 < ne; e0 += MTOT, ++round) {
    // row tiles of MT entries with live rows, and how many row groups
    // share each tile's H (all 4 when a decode group fits one tile)
    const int live_tiles = ceil_div(min(MTOT, ne - e0), MT);
    const int gm = live_tiles <= 1 ? 1 : live_tiles <= 2 ? 2 : kGroups;
    const int tile = q % gm, split = q / gm, splits = kGroups / gm;

    // row group q expands tile q; a lone live tile's rows are dealt to
    // the row groups in turn instead (row m to group m % kGroups)
    const bool deal = gm == 1;
    const int et = deal ? e0 : e0 + q * MT;   // the tile's first entry
    int64_t tok[MT];
    bool live[MT], busy = false;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      live[m] = et + m < ne && (!deal || m % kGroups == q);
      tok[m] = token(et + m < ne ? et + m : e0);
      busy |= live[m];
    }
    Raw8<TX> yr[MT];   // y of the first O chunk: in flight from here on
    if (y != nullptr) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (live[m]) load8(y + tok[m] * O, ob + c0 * kVec, oe, vo, yr[m]);
    }

    // 1. shrink over this block's slice of H, a staged piece at a time
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    if (round == 0 && b_resident) stage_b(0, n_o);   // in flight with x, A
    const int buf = pipelined ? round & 1 : 0;
    TX* const xr = buf ? xs2 : xs;
    for (int p0 = hb; p0 < he; p0 += piece) {
      const int np = min(piece, he - p0);
      bool pending = true;   // a pipelined round's x was staged earlier
      if (!pipelined || round == 0)
        pending = stage_x(e0, xr, p0, np, round == 0 || !a_resident, buf);
      if (pipelined && round == 0)   // round 1's x, in flight from here on
        stage_x(e0 + MTOT, xs2, p0, np, false, 1);
      if (pending) wait_bar(buf);
      __syncthreads();
      for (int h = c0 + kLanes * split; h < np; h += kLanes * splits) {
        float av[RT];
        smem_row<TW, RT>(as + h * R, R, row_vec, av);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = ptt_to_float(xr[(tile * MT + m) * np + h]);
#pragma unroll
          for (int r = 0; r < RT; ++r)
            acc[m * RT + r] = fmaf(xv, av[r], acc[m * RT + r]);
        }
      }
      __syncthreads();   // before the next piece overwrites the stage
      if (pipelined && e0 + 2 * MTOT < ne)   // the round after next's x
        stage_x(e0 + 2 * MTOT, xr, p0, np, false, buf);
    }
    warp_reduce_scatter<N>(acc, lane);
#pragma unroll
    for (int j = 0; j < NW; ++j) red[warp][lane * NW + j] = acc[j];
    __syncthreads();

    // 2. push this block's partial of each tile (the sum over the row
    // groups that share it; group g is warps 2g and 2g + 1) into every
    // block of the cluster, then one cluster barrier
    if (round == 0) cluster_wait();
    float* const mine = &recv[round & 1][rank][0];
    for (int i = tid; i < MTOT * RT; i += kThreads) {
      const int t = i / N;
      float v = 0.f;
      if (t < gm) {
        for (int g = t; g < kGroups; g += gm)
          v += red[2 * g][i % N] + red[2 * g + 1][i % N];
      }
#pragma unroll
      for (int k = 0; k < kCluster; ++k)
        cluster.map_shared_rank(mine, k)[i] = v;
    }
    cluster.sync();   // every block's partial has landed
    for (int i = tid; i < MTOT * RT; i += kThreads) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kCluster; ++k) v += recv[round & 1][k][i];
      h1[i] = v;
    }
    wait_b();   // B, when it was staged with x and A
    __syncthreads();

    // 3. expand over this block's slice of O, a staged piece of B at a
    // time (h1 is exactly 0 at a padded rank entry, not summed)
    const float* hq = h1 + (deal ? 0 : q) * MT * RT;
    for (int p = 0; p < n_o; p += o_piece) {
      const int npo = min(o_piece, n_o - p);
      if (!b_resident) {
        __syncthreads();   // the previous piece is used up
        stage_b(p, npo);
        wait_b();
        __syncthreads();
      }
      if (!busy) continue;
      for (int c = c0; c * kVec < npo; c += kLanes) {
        const int ol = c * kVec, o = ob + p + ol;
        if (p + ol != c0 * kVec && y != nullptr) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (live[m]) load8(y + tok[m] * O, o, oe, vo, yr[m]);
        }
        float ov[MT][kVec];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < kVec; ++j) ov[m][j] = 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < R) {
            Raw8<TW> br;
            load8(bs + r * npo, ol, npo, vb, br);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (!live[m]) continue;
              const float hv = hq[m * RT + r];
#pragma unroll
              for (int j = 0; j < kVec; ++j)
                ov[m][j] = fmaf(hv, br[j], ov[m][j]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (!live[m]) continue;
          float v[kVec];
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            v[j] = ptt_to_float(ptt_from_float<TX>(sc * ov[m][j]));
            if (y != nullptr) v[j] += yr[m][j];
          }
          store8(out + tok[m] * O, o, oe, vo, v);
        }
      }
    }
  }
}

struct Args {
  const void* x;
  const void* a_bank;
  const void* b_bank;
  const int* rows;
  const float* scale;
  const void* y;
  void* out;
  int batch, tokens, hidden, rank, out_features, slots, flags;
  cudaStream_t stream;
};

template <typename TX, typename TW, int RT, bool VEC>
cudaError_t launch(const Args& p) {
  constexpr int kMtot = Tile<RT>::MTOT;
  const auto kernel = adapter_sgmv_kernel<TX, TW, RT, VEC>;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kStageBytes;
  cfg.stream = p.stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // once per instantiation: the shared memory attribute, and how many
  // clusters the card holds at once
  static int resident = 0;
  static const cudaError_t attr_err = [&] {
    cudaError_t err = ptt_allow_smem(kernel, kStageBytes);
    if (err == cudaSuccess) {
      cfg.gridDim = dim3(kCluster);
      err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    }
    return err;
  }();
  if (attr_err != cudaSuccess) return attr_err;
  // tokens per cluster: kMtot (one round), or a multiple of it so that the
  // clusters of a call, counting every row as its group's first, fit on
  // the card at once; a cluster's rounds then overlap x's staging
  const int64_t tiles_min = ceil_div(p.tokens, kMtot);
  const int64_t k =
      resident > 0 ? (p.batch * tiles_min + resident - 1) / resident : 1;
  const int tt = static_cast<int>(std::min(tiles_min, k) * kMtot);
  const int64_t blocks = static_cast<int64_t>(p.batch) *
                         ceil_div(p.tokens, tt) * kCluster;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TX*>(p.x),
      static_cast<const TW*>(p.a_bank), static_cast<const TW*>(p.b_bank),
      p.rows, p.scale, static_cast<const TX*>(p.y), static_cast<TX*>(p.out),
      p.batch, p.tokens, p.hidden, p.rank, p.out_features, p.slots, tt,
      p.flags);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX, typename TW, int RT>
cudaError_t launch_vec(const Args& p) {
  return p.flags == kVecAll ? launch<TX, TW, RT, true>(p)
                            : launch<TX, TW, RT, false>(p);
}

template <typename TX, typename TW>
cudaError_t launch_rank(const Args& p) {
  if (p.rank <= 8) return launch_vec<TX, TW, 8>(p);
  if (p.rank <= 16) return launch_vec<TX, TW, 16>(p);
  if (p.rank <= 32) return launch_vec<TX, TW, 32>(p);
  if (p.rank <= 64) return launch_vec<TX, TW, 64>(p);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_bank(const Args& p, int w_dtype) {
  if (w_dtype == PTT_F32) return launch_rank<TX, float>(p);
  if (w_dtype == PTT_BF16) return launch_rank<TX, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// delta (y == nullptr) or y + delta into out [batch, tokens, out_features]
PTT_EXPORT int adapter_matmul_fwd(const void* x, const void* a_bank,
                                  const void* b_bank, const void* rows,
                                  const void* scale, const void* y, void* out,
                                  int batch, int tokens, int hidden, int rank,
                                  int out_features, int slots, int x_dtype,
                                  int w_dtype, void* stream) {
  if (batch <= 0 || batch > kMaxBatch || tokens <= 0 || hidden < 0 ||
      out_features <= 0 || rank < 1 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int flags = 0;
  if (aligned16(x) && hidden % kVec == 0) flags |= kVecX;
  if (aligned16(a_bank) && hidden % kVec == 0) flags |= kVecA;
  if (aligned16(b_bank) && out_features % kVec == 0) flags |= kVecB;
  if (aligned16(out) && (y == nullptr || aligned16(y)) &&
      out_features % kVec == 0)
    flags |= kVecOut;
  const Args p{x, a_bank, b_bank, static_cast<const int*>(rows),
               static_cast<const float*>(scale), y, out, batch, tokens,
               hidden, rank, out_features, slots, flags,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (x_dtype == PTT_F32) {
    err = launch_bank<float>(p, w_dtype);
  } else if (x_dtype == PTT_BF16) {
    err = launch_bank<__nv_bfloat16>(p, w_dtype);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

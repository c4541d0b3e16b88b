// Segmented LoRA delta over a packed adapter bank, per batch row b:
//   out[b, t, :] = (scale[s] * ((x[b, t, :] . A[s]) . B[s])).to(x.dtype),
//   s = rows[b],  x [B, T, H],  A = a_bank [C, H, R],  B = b_bank [C, R, O].
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_adapter_matmul_kernel
// (pallas_call at :878), the per-row adapter delta of multi-tenant LoRA
// serving. Every adapted projection of every prefill and decode forward
// calls it once.
//
// Rounding order: the JAX reference's (pallas_kernels.py:842-848). x and
// the gathered factors go to fp32, h1 = x . A is summed in fp32, then
// h1 . B in fp32, times the slot's fp32 scale, and one cast to x.dtype.
// The caller adds the delta to the projection's output in x.dtype.
//
// Bound on the H100: bytes, and at the serving path's shapes the launch
// itself. A decode call (8 rows, T = 1, H = O = 4096, rank 8, f32 bank,
// four distinct slots) moves about 1.2 MB (the distinct slots' factors,
// x and the output): ~0.35 us at 3.35 TB/s, below what a launch costs. A
// prefill call (T = 1024) moves ~16 MB, ~5 us. The 2 * T * R * (H + O)
// flops per row are negligible.
//
// Design: one block of 256 threads per (row b, tile of TOK tokens of b).
// The block reads rows[b] itself (the TPU kernel gets it by scalar
// prefetch into its BlockSpec index maps) and reads that slot's factors
// straight out of the bank: no per-request copy of a factor exists.
//  1. shrink: each thread walks H with a stride of 256 and keeps TOK x RT
//     fp32 partial sums of x[t, h] * A[s, h, r], RT being the rank padded
//     to 8, 16, 32 or 64 and TOK * RT = 64 (registers). Warp shuffles and
//     one pass through shared memory reduce them to h1[TOK][RT], which
//     stays in shared memory.
//  2. expand: each thread owns output columns o (stride 256, so loads of
//     B and stores of the output are coalesced), holds B[s, :, o] in RT
//     registers and writes scale[s] * sum_r h1[t][r] * B[s, r, o] in
//     x.dtype for each token of the tile.
// Ragged H, O, T and rank tails are masked; a padded rank entry is never
// summed into the output. A row on slot 0 (zero factors, scale 0) gets an
// exact zero. A slot outside [0, C) reads nothing and writes NaN, so a
// bad row table shows in the output. Grouping rows by slot (Punica's
// SGMV) and splitting H across blocks are later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 64;  // TOK * RT partial sums per thread

struct Args {
  const void* x;
  const void* a_bank;
  const void* b_bank;
  const int* rows;
  const float* scale;
  void* out;
  int batch, tokens, hidden, rank, out_features, slots;
  cudaStream_t stream;
};

template <typename TX, typename TW, int RT>
__global__ void __launch_bounds__(kThreads)
    adapter_matmul_kernel(const TX* __restrict__ x,
                          const TW* __restrict__ a_bank,
                          const TW* __restrict__ b_bank,
                          const int* __restrict__ rows,
                          const float* __restrict__ scale,
                          TX* __restrict__ out, int T, int H, int R, int O,
                          int C) {
  constexpr int TOK = kAcc / RT;
  __shared__ float red[kWarps][kAcc];
  __shared__ float h1[kAcc];  // [TOK][RT]

  const int tiles = (T + TOK - 1) / TOK;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * TOK;
  const int nt = min(TOK, T - t0);  // tokens of this tile, >= 1
  const int s = rows[b];
  const int64_t x_off = (static_cast<int64_t>(b) * T + t0) * H;
  const int64_t o_off = (static_cast<int64_t>(b) * T + t0) * O;

  if (s < 0 || s >= C) {  // uniform over the block
    const TX nan = ptt_from_float<TX>(__int_as_float(0x7fc00000));
    for (int i = threadIdx.x; i < nt * O; i += kThreads) out[o_off + i] = nan;
    return;
  }
  const TW* a = a_bank + static_cast<int64_t>(s) * H * R;
  const TW* bm = b_bank + static_cast<int64_t>(s) * R * O;
  const float sc = scale[s];

  // 1. shrink: h1[t][r] = sum_h x[t][h] * A[h][r]
  float acc[TOK][RT];
#pragma unroll
  for (int t = 0; t < TOK; ++t)
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[t][r] = 0.f;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float av[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      av[r] = r < R ? ptt_to_float(a[static_cast<int64_t>(h) * R + r]) : 0.f;
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      if (t < nt) {
        const float xv =
            ptt_to_float(x[x_off + static_cast<int64_t>(t) * H + h]);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[t][r] = fmaf(xv, av[r], acc[t][r]);
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < TOK; ++t) {
    if (t < nt) {  // uniform over the block: every lane shuffles
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float v = ptt_warp_sum(acc[t][r]);
        if (lane == 0) red[warp][t * RT + r] = v;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < nt * RT) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    h1[threadIdx.x] = v;
  }
  __syncthreads();

  // 2. expand: out[t][o] = scale * sum_r h1[t][r] * B[r][o]
  for (int o = threadIdx.x; o < O; o += kThreads) {
    float bv[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      bv[r] = r < R ? ptt_to_float(bm[static_cast<int64_t>(r) * O + o]) : 0.f;
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      if (t < nt) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r)
          if (r < R) v = fmaf(h1[t * RT + r], bv[r], v);
        out[o_off + static_cast<int64_t>(t) * O + o] =
            ptt_from_float<TX>(v * sc);
      }
    }
  }
}

template <typename TX, typename TW, int RT>
cudaError_t launch(const Args& p) {
  constexpr int TOK = kAcc / RT;
  const int64_t blocks =
      static_cast<int64_t>(p.batch) * ((p.tokens + TOK - 1) / TOK);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  adapter_matmul_kernel<TX, TW, RT>
      <<<static_cast<int>(blocks), kThreads, 0, p.stream>>>(
          static_cast<const TX*>(p.x), static_cast<const TW*>(p.a_bank),
          static_cast<const TW*>(p.b_bank), p.rows, p.scale,
          static_cast<TX*>(p.out), p.tokens, p.hidden, p.rank,
          p.out_features, p.slots);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_rank(const Args& p) {
  if (p.rank <= 8) return launch<TX, TW, 8>(p);
  if (p.rank <= 16) return launch<TX, TW, 16>(p);
  if (p.rank <= 32) return launch<TX, TW, 32>(p);
  if (p.rank <= 64) return launch<TX, TW, 64>(p);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_bank(const Args& p, int w_dtype) {
  if (w_dtype == PTT_F32) return launch_rank<TX, float>(p);
  if (w_dtype == PTT_BF16) return launch_rank<TX, __nv_bfloat16>(p);
  return cudaErrorInvalidValue;
}

}  // namespace

PTT_EXPORT int adapter_matmul_fwd(const void* x, const void* a_bank,
                                  const void* b_bank, const void* rows,
                                  const void* scale, void* out, int batch,
                                  int tokens, int hidden, int rank,
                                  int out_features, int slots, int x_dtype,
                                  int w_dtype, void* stream) {
  if (batch <= 0 || tokens <= 0 || out_features <= 0 || rank < 1 ||
      slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{x, a_bank, b_bank, static_cast<const int*>(rows),
               static_cast<const float*>(scale), out, batch, tokens, hidden,
               rank, out_features, slots, static_cast<cudaStream_t>(stream)};
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

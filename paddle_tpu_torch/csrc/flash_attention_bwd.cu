// Flash attention backward over contiguous [B, S, H, D] tensors, D = 128:
// two kernels, the FlashAttention-2 scheme.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (called through flash_attention_bwd, under the
// custom VJP of flash_attention_own). Same function: with P recomputed
// from the forward's logsumexp, P = exp(S * scale - lse),
// dS = P * (dO V^T - delta) * scale with delta = rowsum(dO * O), the
// kernels compute dQ = dS K, dV = P^T dO and dK = dS^T Q, in fp32, and
// write each gradient once in the input dtype. The causal mask is aligned
// bottom-right (query i sees keys <= i + Sk - Sq), as in the port's
// forward kernel; the Pallas kernels align top-left, which agrees when
// Sq == Sk (training). GQA: query head h reads kv head h / G, and the
// dk/dv kernel sums the G query heads of a kv head itself, with no
// repeated K/V copy and no atomics (the Pallas path repeats K/V and sums
// over [HKV, G] afterwards). Ragged tails (any Sq, Sk >= 1) are masked in
// the kernels; there is no padding to block multiples.
//
// Bound on the H100: operations. Each product costs 2 * D flops per
// live (query, key) pair; at the training shape (B = 2, S = 2048,
// H = 32, causal) that is 34 GFLOP per product. The dq kernel does three
// (dP, S, dQ: 103 GFLOP, 0.10 ms at 989 TFLOP/s bf16), the dk/dv kernel
// four (S, dP, dV, dK: 137 GFLOP, 0.14 ms), against about 0.06 ms each to
// move their tensors once.
//
// - dq kernel, bf16: flash_bwd_dq_wgmma_kernel, on the tensor cores. One
//   block of two warpgroups per (128 query rows, head, batch); each
//   warpgroup owns 64 rows and keeps its dQ accumulator (64 x 128 fp32)
//   in registers across the whole loop. The Q and dO tiles are staged
//   once into hopper.cuh's 128-byte-swizzled layout; the 64-key K and V
//   tiles run through a two-stage cp.async ring (the next pair flies
//   while the current one computes). The prologue computes delta =
//   rowsum(dO * O) for the block's rows from 16-byte loads while the
//   tiles fly, and stores it for the dk/dv kernel. Per k tile: S = Q K^T
//   and dP = dO V^T by wgmma m64n64k16, both operands K-major from
//   shared memory; P = exp(S scale - lse) and dS = P (dP - delta) scale
//   in fp32 registers (exp2f with lse * log2 e; masked only on tiles that
//   the diagonal or a tail cuts); then dQ += dS K by wgmma m64n128k16
//   with dS rounded to bf16 as the register A operand and K read in the
//   transposed-B (MN-major) mode from the same tile. Heavy causal tiles
//   are scheduled first. About 130 KB of shared memory. Rounding dS to
//   bf16 before dS K departs from the fp32 plain version as SDPA and
//   FlashAttention-2/3 do (tests/test_torch_smoke.py checks that order).
// - dq kernel, f32: flash_bwd_dq_kernel, fp32 FMAs on the CUDA cores
//   (the f32 checks' relative 1e-5 is beyond TF32). One block of 256
//   threads per (64-row q tile, head, batch), fp32 tiles in shared
//   memory (row stride D + 1, conflict-free column reads), 4 x 4
//   (scores) and 4 x 8 (gradients) micro-tiles per thread in registers;
//   delta in its prologue; per k tile V into the K/V tile, dP = dO V^T;
//   K into the same tile, S = Q K^T, dS into shared memory; dQ += dS K.
//   About 116 KB of shared memory.
// - dk/dv kernel, bf16: flash_bwd_dkv_wgmma_kernel, on the tensor cores
//   (the FlashAttention-2/3 scheme). One block of two warpgroups per
//   (128 keys, kv head, batch); each warpgroup owns 64 keys and keeps
//   its dK and dV accumulators (64 x 128 fp32 each) in registers across
//   the whole loop. K and V sit in shared memory in hopper.cuh's
//   128-byte-swizzled layout; the loop runs over the G query heads of
//   the kv head and, for each, over the 64-row q tiles from the first
//   one that sees the block's keys to the end, with the Q and dO tiles
//   and the tile's lse and delta rows double-buffered by cp.async (the
//   next pair of tiles is in flight while the current one computes).
//   Per q tile: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16, both
//   operands from shared memory; P^T = exp(S^T scale - lse) and
//   dS^T = P^T (dP^T - delta) scale in fp32 registers (masked only on
//   tiles that the diagonal or a tail cuts); then dV += P^T dO and
//   dK += dS^T Q by wgmma m64n128k16 with P^T and dS^T rounded to bf16
//   as the register A operand and dO and Q read in the transposed-B
//   (MN-major) mode from the same tiles. The GQA sum stays inside the
//   block: no atomics, no repeated K/V. About 130 KB of shared memory.
//   Rounding P^T and dS^T to bf16 before the second products departs
//   from the fp32 plain version as FlashAttention-2/3 and SDPA do; it
//   stays within chip_smoke.py's bf16 limits (tests/test_torch_smoke.py
//   checks that order on the CPU).
// - dk/dv kernel, f32: flash_bwd_dkv_kernel, fp32 FMAs as in the dq
//   kernel (the f32 consistency checks hold it to a relative 1e-5,
//   which TF32 tensor-core products cannot meet). One block per (64-row
//   k tile, kv head, batch); K and V stay in shared memory; per q tile
//   S^T = K Q^T and dP^T = V dO^T together, P^T and dS^T into shared
//   memory, then dV += P^T dO and dK += dS^T Q in registers. About
//   166 KB of shared memory, one block per SM.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 128;
constexpr int kB = 64;            // rows of a q or k tile
constexpr int kThreads = 256;
constexpr int kRS = kD + 1;       // row stride of a [64][D] fp32 tile
constexpr int kPS = kB + 1;       // row stride of a [64][64] fp32 tile
constexpr size_t kDqSmemBytes =
    (3 * kB * kRS + kB * kPS + 2 * kB) * sizeof(float);
constexpr size_t kDkvSmemBytes =
    (4 * kB * kRS + 2 * kB * kPS + 2 * kB) * sizeof(float);

struct BwdArgs {
  const void* q;        // [B, Sq, H, D]
  const void* k;        // [B, Sk, HKV, D]
  const void* v;        // [B, Sk, HKV, D]
  const void* o;        // [B, Sq, H, D]
  const void* dout;     // [B, Sq, H, D]
  const float* lse;     // [B, H, Sq]
  float* delta;         // [B, H, Sq]: written by dq, read by dk/dv
  void* dq;             // [B, Sq, H, D]
  void* dk;             // [B, Sk, HKV, D]
  void* dv;             // [B, Sk, HKV, D]
  int sq, sk, h, hkv;
  float scale;
  int causal;
};

// dst[r][c] = src[r * row_stride + c] for the 64 x D tile, zero past the
// last valid row
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride,
                                          int nrows_valid) {
  for (int i = threadIdx.x; i < kB * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    float val = 0.f;
    if (r < nrows_valid)
      val = ptt_to_float(src[static_cast<int64_t>(r) * row_stride + c]);
    dst[r * kRS + c] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [64][D+1] Q
  float* dos = qs + kB * kRS;         // [64][D+1] dO
  float* kv = dos + kB * kRS;         // [64][D+1] V, then K
  float* ds = kv + kB * kRS;          // [64][65] dS
  float* lse_s = ds + kB * kPS;       // [64]
  float* delta_s = lse_s + kB;        // [64]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qt * kB;
  const int offset = a.sk - a.sq;
  const int64_t q_row = static_cast<int64_t>(a.h) * kD;
  const int64_t kv_row = static_cast<int64_t>(a.hkv) * kD;
  const int64_t q_base = (static_cast<int64_t>(b) * a.sq + q0) * q_row +
                         static_cast<int64_t>(h) * kD;
  const int64_t kv_base = static_cast<int64_t>(b) * a.sk * kv_row +
                          static_cast<int64_t>(hk) * kD;
  const int64_t row_base = (static_cast<int64_t>(b) * a.h + h) * a.sq + q0;
  const T* qb = static_cast<const T*>(a.q) + q_base;
  const T* ob = static_cast<const T*>(a.o) + q_base;
  const T* dob = static_cast<const T*>(a.dout) + q_base;
  const T* kb = static_cast<const T*>(a.k) + kv_base;
  const T* vb = static_cast<const T*>(a.v) + kv_base;
  const int q_valid = a.sq - q0;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  load_tile(qs, qb, q_row, q_valid);
  load_tile(dos, dob, q_row, q_valid);
  __syncthreads();

  // delta = rowsum(dO * O) in fp32, one warp per 8 rows
  for (int r = warp * (kB / 8); r < (warp + 1) * (kB / 8); ++r) {
    float part = 0.f;
    if (r < q_valid) {
      const T* orow = ob + static_cast<int64_t>(r) * q_row;
      for (int c = lane; c < kD; c += 32)
        part += dos[r * kRS + c] * ptt_to_float(orow[c]);
    }
    part = ptt_warp_sum(part);
    if (lane == 0) {
      delta_s[r] = part;
      lse_s[r] = r < q_valid ? a.lse[row_base + r] : 0.f;
      if (r < q_valid) a.delta[row_base + r] = part;
    }
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int n_kt = (a.sk + kB - 1) / kB;
  if (a.causal) {
    const int need = (q0 + kB - 1 + offset) / kB + 1;
    if (need < n_kt) n_kt = need;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    const int k_valid = a.sk - k0;
    __syncthreads();  // the previous dQ update is done with kv and ds
    load_tile(kv, vb + static_cast<int64_t>(k0) * kv_row, kv_row, k_valid);
    __syncthreads();

    // dP = dO V^T on a 4x4 micro-tile: rows ty + 16i, cols tx + 16j
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = dos[(ty + 16 * i) * kRS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = kv[(tx + 16 * j) * kRS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(x[i], y[j], dp[i][j]);
    }
    __syncthreads();  // done with V
    load_tile(kv, kb + static_cast<int64_t>(k0) * kv_row, kv_row, k_valid);
    __syncthreads();

    // S = Q K^T on the same micro-tile, then dS = P (dP - delta) scale
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = qs[(ty + 16 * i) * kRS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = kv[(tx + 16 * j) * kRS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool live = r < q_valid && c < k_valid &&
                          !(a.causal && kpos > qpos + offset);
        const float p = live ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        ds[r * kPS + c] = p * (dp[i][j] - delta_s[r]) * a.scale;
      }
    }
    __syncthreads();

    // dQ += dS K on a 4x8 micro-tile: rows ty + 16i, cols tx + 16j
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float x[4], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = ds[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = kv[c * kRS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

  T* dqb = static_cast<T*>(a.dq) + q_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_valid) continue;
    T* row = dqb + static_cast<int64_t>(r) * q_row;
#pragma unroll
    for (int j = 0; j < 8; ++j) row[tx + 16 * j] = ptt_from_float<T>(acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [64][D+1] K (whole block)
  float* vs = ks + kB * kRS;          // [64][D+1] V (whole block)
  float* qs = vs + kB * kRS;          // [64][D+1] Q of the current q tile
  float* dos = qs + kB * kRS;         // [64][D+1] dO of the current q tile
  float* pt = dos + kB * kRS;         // [64 keys][65] P^T
  float* dst = pt + kB * kPS;         // [64 keys][65] dS^T
  float* lse_s = dst + kB * kPS;      // [64]
  float* delta_s = lse_s + kB;        // [64]

  const int kt = blockIdx.x;          // low k tiles carry the most causal work
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.h / a.hkv;
  const int k0 = kt * kB;
  const int k_valid = a.sk - k0;
  const int offset = a.sk - a.sq;
  const int64_t q_row = static_cast<int64_t>(a.h) * kD;
  const int64_t kv_row = static_cast<int64_t>(a.hkv) * kD;
  const int64_t kv_base = (static_cast<int64_t>(b) * a.sk + k0) * kv_row +
                          static_cast<int64_t>(hk) * kD;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  load_tile(ks, static_cast<const T*>(a.k) + kv_base, kv_row, k_valid);
  load_tile(vs, static_cast<const T*>(a.v) + kv_base, kv_row, k_valid);

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }

  const int n_qt = (a.sq + kB - 1) / kB;
  int first_qt = 0;
  if (a.causal) {
    // the first query that sees key k0 is k0 - offset
    const int first_q = k0 - offset;
    first_qt = first_q > 0 ? first_q / kB : 0;
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      const int q_valid = a.sq - q0;
      const int64_t q_base = (static_cast<int64_t>(b) * a.sq + q0) * q_row +
                             static_cast<int64_t>(h) * kD;
      const int64_t row_base =
          (static_cast<int64_t>(b) * a.h + h) * a.sq + q0;
      __syncthreads();  // the previous q tile's updates are done
      load_tile(qs, static_cast<const T*>(a.q) + q_base, q_row, q_valid);
      load_tile(dos, static_cast<const T*>(a.dout) + q_base, q_row, q_valid);
      if (tid < kB) {
        lse_s[tid] = tid < q_valid ? a.lse[row_base + tid] : 0.f;
        delta_s[tid] = tid < q_valid ? a.delta[row_base + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows (keys) ty + 16i,
      // cols (queries) tx + 16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 2
      for (int d = 0; d < kD; ++d) {
        float kx[4], vx[4], qy[4], oy[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kx[i] = ks[(ty + 16 * i) * kRS + d];
          vx[i] = vs[(ty + 16 * i) * kRS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qy[j] = qs[(tx + 16 * j) * kRS + d];
          oy[j] = dos[(tx + 16 * j) * kRS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kx[i], qy[j], s[i][j]);
            dp[i][j] = fmaf(vx[i], oy[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int kpos = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int qpos = q0 + c;
          const bool live = r < k_valid && c < q_valid &&
                            !(a.causal && kpos > qpos + offset);
          const float p = live ? expf(s[i][j] * a.scale - lse_s[c]) : 0.f;
          pt[r * kPS + c] = p;
          dst[r * kPS + c] = p * (dp[i][j] - delta_s[c]) * a.scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: rows ty + 16i, cols tx + 16j
#pragma unroll 2
      for (int c = 0; c < kB; ++c) {
        float px[4], sx[4], oy[8], qy[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          px[i] = pt[(ty + 16 * i) * kPS + c];
          sx[i] = dst[(ty + 16 * i) * kPS + c];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          oy[j] = dos[c * kRS + tx + 16 * j];
          qy[j] = qs[c * kRS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dv[i][j] = fmaf(px[i], oy[j], dv[i][j]);
            dk[i][j] = fmaf(sx[i], qy[j], dk[i][j]);
          }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + kv_base;
  T* dvb = static_cast<T*>(a.dv) + kv_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= k_valid) continue;
    T* krow = dkb + static_cast<int64_t>(r) * kv_row;
    T* vrow = dvb + static_cast<int64_t>(r) * kv_row;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      krow[tx + 16 * j] = ptt_from_float<T>(dk[i][j]);
      vrow[tx + 16 * j] = ptt_from_float<T>(dv[i][j]);
    }
  }
}

constexpr int kWThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// dq in bf16 on the tensor cores (see the note at the top)
constexpr int kWDqRows = 128;         // queries per block: two warpgroups x 64
constexpr int kWDqKeys = 64;          // keys per K / V tile
constexpr uint32_t kWDqTileBytes = kWDqRows * kD * 2;
constexpr uint32_t kWDqKVBytes = kWDqKeys * kD * 2;
// Q, dO, then the two K/V stages (each tile 1024-byte aligned, as the
// swizzle needs), then lse[128] and delta[128]
constexpr size_t kWDqSmemBytes =
    2 * kWDqTileBytes + 4 * kWDqKVBytes + 2 * kWDqRows * 4 + 1024;

// sum of the eight products of two rows of 8 bf16 values, in fp32
__device__ __forceinline__ float dot8_bf16(uint4 x, uint4 y) {
  const auto* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const auto* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(xs[i]);
    const float2 yf = __bfloat1622float2(ys[i]);
    sum = fmaf(xf.x, yf.x, sum);
    sum = fmaf(xf.y, yf.y, sum);
  }
  return sum;
}

__global__ void __launch_bounds__(kWThreads, 1)
    flash_bwd_dq_wgmma_kernel(BwdArgs a) {
  using namespace hopper;
  extern __shared__ __align__(16) uint8_t smem_w[];
  const uint32_t q_s = aligned_smem_base(smem_w);
  const uint32_t do_s = q_s + kWDqTileBytes;
  const uint32_t kv_s = do_s + kWDqTileBytes;   // stage s: K, then V
  float* lse_s = reinterpret_cast<float*>(
      smem_w + (kv_s + 4 * kWDqKVBytes - smem_u32(smem_w)));
  float* delta_s = lse_s + kWDqRows;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qt * kWDqRows;
  const int offset = a.sk - a.sq;
  const int64_t q_row = static_cast<int64_t>(a.h) * kD;
  const int64_t kv_row = static_cast<int64_t>(a.hkv) * kD;
  const int64_t q_base = static_cast<int64_t>(b) * a.sq * q_row +
                         static_cast<int64_t>(h) * kD;
  const int64_t kv_base = static_cast<int64_t>(b) * a.sk * kv_row +
                          static_cast<int64_t>(hk) * kD;
  const int64_t row_base = (static_cast<int64_t>(b) * a.h + h) * a.sq + q0;
  const auto* qg = static_cast<const __nv_bfloat16*>(a.q) + q_base;
  const auto* og = static_cast<const __nv_bfloat16*>(a.o) + q_base;
  const auto* dog = static_cast<const __nv_bfloat16*>(a.dout) + q_base;
  const auto* kg = static_cast<const __nv_bfloat16*>(a.k) + kv_base;
  const auto* vg = static_cast<const __nv_bfloat16*>(a.v) + kv_base;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qw = q0 + wg * 64;                    // first row of the warpgroup
  const int row0 = qw + warp * 16 + (lane >> 2);  // this thread: row0, +8
  const int col = 2 * (lane & 3);

  int n_kt = (a.sk + kWDqKeys - 1) / kWDqKeys;
  if (a.causal) n_kt = min(n_kt, (q0 + kWDqRows - 1 + offset) / kWDqKeys + 1);
  const int wg_last_key = a.causal ? qw + 63 + offset : a.sk - 1;

  load_tile_async<kWDqRows, kWThreads>(q_s, qg, q_row, q0, a.sq);
  load_tile_async<kWDqRows, kWThreads>(do_s, dog, q_row, q0, a.sq);
  load_tile_async<kWDqKeys, kWThreads>(kv_s, kg, kv_row, 0, a.sk);
  load_tile_async<kWDqKeys, kWThreads>(kv_s + kWDqKVBytes, vg, kv_row, 0,
                                       a.sk);
  cp_async_commit();

  // delta = rowsum(dO * O) in fp32 while the tiles fly: two threads per
  // row, 64 columns each, by 16-byte loads
  {
    const int r = tid >> 1, half = tid & 1;
    const bool valid = q0 + r < a.sq;
    float part = 0.f;
    if (valid) {
      const int64_t at = static_cast<int64_t>(q0 + r) * q_row + half * 64;
      const uint4* o16 = reinterpret_cast<const uint4*>(og + at);
      const uint4* do16 = reinterpret_cast<const uint4*>(dog + at);
#pragma unroll
      for (int i = 0; i < 8; ++i) part += dot8_bf16(do16[i], o16[i]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      delta_s[r] = part;
      lse_s[r] = valid ? a.lse[row_base + r] : 0.f;
      if (valid) a.delta[row_base + r] = part;
    }
  }
  __syncthreads();
  const float nlse0 = -lse_s[row0 - q0] * kLog2e;
  const float nlse1 = -lse_s[row0 + 8 - q0] * kLog2e;
  const float delta0 = delta_s[row0 - q0];
  const float delta1 = delta_s[row0 + 8 - q0];

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  const float scale_log2 = a.scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kWDqKeys;
    const uint32_t k_s = kv_s + (kt & 1) * 2 * kWDqKVBytes;
    const uint32_t v_s = k_s + kWDqKVBytes;
    if (kt + 1 < n_kt) {   // the next tile flies while this one computes
      const uint32_t nk = kv_s + ((kt + 1) & 1) * 2 * kWDqKVBytes;
      load_tile_async<kWDqKeys, kWThreads>(nk, kg, kv_row, k0 + kWDqKeys,
                                           a.sk);
      load_tile_async<kWDqKeys, kWThreads>(nk + kWDqKVBytes, vg, kv_row,
                                           k0 + kWDqKeys, a.sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();

    if (k0 <= wg_last_key) {   // uniform over the warpgroup
      // S = Q K^T and dP = dO V^T: rows = this warpgroup's 64 queries,
      // columns = the tile's 64 keys
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        wgmma_m64n64k16_ss(s, desc_kmajor(q_s, kWDqRows, wg * 64, k),
                           desc_kmajor(k_s, kWDqKeys, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        wgmma_m64n64k16_ss(dp, desc_kmajor(do_s, kWDqRows, wg * 64, k),
                           desc_kmajor(v_s, kWDqKeys, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P = exp(S scale - lse), dS = P (dP - delta) scale, into s
      const bool edge = qw + 64 > a.sq || k0 + kWDqKeys > a.sk ||
                        (a.causal && k0 + kWDqKeys - 1 > qw + offset);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          float p = exp2f(fmaf(s[4 * j + e], scale_log2, hi ? nlse1 : nlse0));
          if (edge) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int row = hi ? row0 + 8 : row0;
            if (row >= a.sq || key >= a.sk ||
                (a.causal && key > row + offset))
              p = 0.f;
          }
          s[4 * j + e] =
              p * (dp[4 * j + e] - (hi ? delta1 : delta0)) * a.scale;
        }
      uint32_t da[4][4];
      acc_to_a(s, da);

      // dQ += dS K, K read MN-major
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWDqKeys / 16; ++k)
        wgmma_m64n128k16_rs(dq, da[k], desc_mnmajor(k_s, kWDqKeys, k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    __syncthreads();   // every warpgroup is done with this stage
  }

  auto* dqb = static_cast<__nv_bfloat16*>(a.dq) + q_base;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + col;
    if (row0 < a.sq)
      *reinterpret_cast<uint32_t*>(dqb + row0 * q_row + c) =
          pack_bf16(dq[4 * j], dq[4 * j + 1]);
    if (row0 + 8 < a.sq)
      *reinterpret_cast<uint32_t*>(dqb + (row0 + 8) * q_row + c) =
          pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
  }
}

// dk/dv in bf16 on the tensor cores (see the note at the top)
constexpr int kWBKV = 128;            // keys per block: two warpgroups x 64
constexpr int kWBQ = 64;              // queries per Q / dO tile
constexpr uint32_t kWKVBytes = kWBKV * kD * 2;
constexpr uint32_t kWQBytes = kWBQ * kD * 2;
// a stage holds the Q and dO tiles (each 1024-byte aligned, as the
// swizzle needs); the stages' lse[64] and delta[64] rows follow them
constexpr uint32_t kWStageBytes = 2 * kWQBytes;
constexpr uint32_t kWStatBytes = 2 * kWBQ * 4;
constexpr size_t kWDkvSmemBytes =
    2 * kWKVBytes + 2 * (kWStageBytes + kWStatBytes) + 1024;

__global__ void __launch_bounds__(kWThreads, 1)
    flash_bwd_dkv_wgmma_kernel(BwdArgs a) {
  using namespace hopper;
  extern __shared__ __align__(16) uint8_t smem_w[];
  const uint32_t k_s = aligned_smem_base(smem_w);
  const uint32_t v_s = k_s + kWKVBytes;
  const uint32_t st_s = v_s + kWKVBytes;
  const uint32_t stat_s = st_s + 2 * kWStageBytes;
  const uint8_t* k_at = smem_w + (k_s - smem_u32(smem_w));  // generic k_s

  const int kt = blockIdx.x;        // low key tiles carry the most causal work
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.h / a.hkv;
  const int k0 = kt * kWBKV;
  const int offset = a.sk - a.sq;
  const int64_t q_row = static_cast<int64_t>(a.h) * kD;
  const int64_t kv_row = static_cast<int64_t>(a.hkv) * kD;
  const int64_t kv_base = static_cast<int64_t>(b) * a.sk * kv_row +
                          static_cast<int64_t>(hk) * kD;
  const auto* qg = static_cast<const __nv_bfloat16*>(a.q);
  const auto* dog = static_cast<const __nv_bfloat16*>(a.dout);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kw = k0 + wg * 64;                     // first key of the warpgroup
  const int key0 = kw + warp * 16 + (lane >> 2);   // this thread: key0, +8
  const int col = 2 * (lane & 3);

  load_tile_async<kWBKV, kWThreads>(
      k_s, static_cast<const __nv_bfloat16*>(a.k) + kv_base, kv_row, k0, a.sk);
  load_tile_async<kWBKV, kWThreads>(
      v_s, static_cast<const __nv_bfloat16*>(a.v) + kv_base, kv_row, k0, a.sk);

  // the (query head of the group, q tile) pairs this block visits: for
  // each head, the q tiles from the first one that sees key k0
  const int n_qt = (a.sq + kWBQ - 1) / kWBQ;
  const int first_qt = a.causal ? max(0, k0 - offset) / kWBQ : 0;
  const int per_head = n_qt - first_qt;
  const int n_it = group * per_head;

  auto load_stage = [&](int it, int stage) {
    const int h = hk * group + it / per_head;
    const int q0 = (first_qt + it % per_head) * kWBQ;
    const int64_t q_base = static_cast<int64_t>(b) * a.sq * q_row +
                           static_cast<int64_t>(h) * kD;
    const uint32_t st = st_s + stage * kWStageBytes;
    load_tile_async<kWBQ, kWThreads>(st, qg + q_base, q_row, q0, a.sq);
    load_tile_async<kWBQ, kWThreads>(st + kWQBytes, dog + q_base, q_row, q0,
                                     a.sq);
    if (tid < 2 * kWBQ) {   // lse (threads 0..63) and delta (64..127)
      const int r = tid & (kWBQ - 1);
      const bool valid = q0 + r < a.sq;
      const float* src = (tid < kWBQ ? a.lse : a.delta) +
                         (static_cast<int64_t>(b) * a.h + h) * a.sq +
                         (valid ? q0 + r : 0);
      cp_async_4(stat_s + stage * kWStatBytes + tid * 4, src, valid);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  const float scale_log2 = a.scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_stage(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();

    const int q0 = (first_qt + it % per_head) * kWBQ;
    const uint32_t q_t = st_s + stage * kWStageBytes;
    const uint32_t do_t = q_t + kWQBytes;
    const float* lse_t = reinterpret_cast<const float*>(
        k_at + (stat_s - k_s) + stage * kWStatBytes);
    const float* delta_t = lse_t + kWBQ;

    // skip when no key of this warpgroup is visible to any query here
    if (!(a.causal && kw > q0 + kWBQ - 1 + offset)) {
      // S^T = K Q^T and dP^T = V dO^T: rows = this warpgroup's 64 keys,
      // columns = the tile's 64 queries
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        wgmma_m64n64k16_ss(s, desc_kmajor(k_s, kWBKV, wg * 64, k),
                           desc_kmajor(q_t, kWBQ, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        wgmma_m64n64k16_ss(dp, desc_kmajor(v_s, kWBKV, wg * 64, k),
                           desc_kmajor(do_t, kWBQ, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale
      const bool edge = q0 + kWBQ > a.sq || kw + 64 > a.sk ||
                        (a.causal && kw + 63 > q0 + offset);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + col + (e & 1);
          float p = exp2f(fmaf(s[4 * j + e], scale_log2,
                               -lse_t[qi] * kLog2e));
          if (edge) {
            const int key = e < 2 ? key0 : key0 + 8;
            const int qpos = q0 + qi;
            if (qpos >= a.sq || key >= a.sk ||
                (a.causal && key > qpos + offset))
              p = 0.f;
          }
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - delta_t[qi]) * a.scale;
        }
      uint32_t pa[4][4], da[4][4];
      acc_to_a(s, pa);
      acc_to_a(dp, da);

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWBQ / 16; ++k)
        wgmma_m64n128k16_rs(dv, pa[k], desc_mnmajor(do_t, kWBQ, k));
#pragma unroll
      for (int k = 0; k < kWBQ / 16; ++k)
        wgmma_m64n128k16_rs(dk, da[k], desc_mnmajor(q_t, kWBQ, k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    __syncthreads();   // every warpgroup is done with this stage
  }

  auto* dkb = static_cast<__nv_bfloat16*>(a.dk) + kv_base;
  auto* dvb = static_cast<__nv_bfloat16*>(a.dv) + kv_base;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + col;
    if (key0 < a.sk) {
      const int64_t at = key0 * kv_row + c;
      *reinterpret_cast<uint32_t*>(dkb + at) =
          pack_bf16(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dvb + at) =
          pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (key0 + 8 < a.sk) {
      const int64_t at = (key0 + 8) * kv_row + c;
      *reinterpret_cast<uint32_t*>(dkb + at) =
          pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dvb + at) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

int launch_dq(const BwdArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        ptt_allow_smem(flash_bwd_dq_kernel<float>, kDqSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sq + kB - 1) / kB, a.h, batch);
  flash_bwd_dq_kernel<float><<<grid, kThreads, kDqSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_wgmma(const BwdArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        ptt_allow_smem(flash_bwd_dq_wgmma_kernel, kWDqSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sq + kWDqRows - 1) / kWDqRows, a.h, batch);
  flash_bwd_dq_wgmma_kernel<<<grid, kWThreads, kWDqSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv(const BwdArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        ptt_allow_smem(flash_bwd_dkv_kernel<float>, kDkvSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sk + kB - 1) / kB, a.hkv, batch);
  flash_bwd_dkv_kernel<float><<<grid, kThreads, kDkvSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_wgmma(const BwdArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        ptt_allow_smem(flash_bwd_dkv_wgmma_kernel, kWDkvSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sk + kWBKV - 1) / kWBKV, a.hkv, batch);
  flash_bwd_dkv_wgmma_kernel<<<grid, kWThreads, kWDkvSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta, void* dq,
                  void* dk, void* dv, int sq, int sk, int h, int hkv,
                  float scale, int causal) {
  return BwdArgs{q,  k,  v,  o,  dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv, sq, sk, h, hkv,
                 scale, causal};
}

}  // namespace

// dq and delta (= rowsum(dO * O), [B, H, Sq] fp32) for one backward.
PTT_EXPORT int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int batch,
                                      int sq, int sk, int h, int hkv,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  const BwdArgs a = make_args(q, k, v, o, dout, lse, delta, dq, nullptr,
                              nullptr, sq, sk, h, hkv, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32) return launch_dq(a, batch, s);
  if (dtype == PTT_BF16) return launch_dq_wgmma(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk and dv, summed over each kv head's query group; reads the delta that
// flash_attention_bwd_dq wrote.
PTT_EXPORT int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int batch, int sq,
                                       int sk, int h, int hkv, float scale,
                                       int causal, int dtype, void* stream) {
  const BwdArgs a = make_args(q, k, v, nullptr, dout, lse,
                              const_cast<void*>(delta), nullptr, dk, dv, sq,
                              sk, h, hkv, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32) return launch_dkv(a, batch, s);
  if (dtype == PTT_BF16) return launch_dkv_wgmma(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// move their tensors once. This first version runs every product as
// fp32 FMAs on the CUDA cores (67 TFLOP/s peak), like the port's forward
// kernel; wgmma and TMA are later work.
// Design: 256 threads per block, 64-row tiles staged in shared memory as
// fp32 (row stride D + 1, conflict-free column reads), 4 x 4 (scores)
// and 4 x 8 (gradients) micro-tiles per thread in registers.
// - dq kernel: one block per (64-row q tile, head, batch). Its prologue
//   computes delta for its rows (dO is staged anyway; O is read once) and
//   stores it for the dk/dv kernel. It loops over the k tiles up to the
//   diagonal: V into the K/V tile, dP = dO V^T; K into the same tile,
//   S = Q K^T, dS into shared memory; dQ += dS K in registers. Heavy
//   causal tiles are scheduled first. About 116 KB of shared memory.
// - dk/dv kernel: one block per (64-row k tile, kv head, batch); K and V
//   stay in shared memory. It loops over the G query heads of the kv
//   head and, for each, over the q tiles from the diagonal to the end:
//   S^T = K Q^T and dP^T = V dO^T together, P^T and dS^T into shared
//   memory, then dV += P^T dO and dK += dS^T Q in registers. About
//   166 KB of shared memory, one block per SM.
#include "common.cuh"

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

template <typename T>
int launch_dq(const BwdArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = ptt_allow_smem(flash_bwd_dq_kernel<T>, kDqSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sq + kB - 1) / kB, a.h, batch);
  flash_bwd_dq_kernel<T><<<grid, kThreads, kDqSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const BwdArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        ptt_allow_smem(flash_bwd_dkv_kernel<T>, kDkvSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sk + kB - 1) / kB, a.hkv, batch);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, kDkvSmemBytes, stream>>>(a);
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
  if (dtype == PTT_F32) return launch_dq<float>(a, batch, s);
  if (dtype == PTT_BF16) return launch_dq<__nv_bfloat16>(a, batch, s);
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
  if (dtype == PTT_F32) return launch_dkv<float>(a, batch, s);
  if (dtype == PTT_BF16) return launch_dkv<__nv_bfloat16>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

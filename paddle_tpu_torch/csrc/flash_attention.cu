// Flash attention forward over [B, S, H, D] strided tensors, D = 128.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_flash_fwd_kernel (called
// through flash_attention_fwd). It computes the same function: blockwise
// online-softmax attention, scale 1/sqrt(D), an optional causal mask
// aligned bottom-right (query i sees keys <= i + Sk - Sq, which is the
// JAX package's _attention_xla convention and equals the Pallas kernel's
// top-left one when Sq == Sk), GQA by reading kv head h / G directly
// (no repeat copy), fp32 statistics and accumulators, output in the
// input dtype. With a non-null `lse` it also writes each row's fp32
// logsumexp of the scaled logits, m + log(l), as [B, H, Sq] contiguous
// (the training path's residual; the Pallas kernel's [B, H, Sq, 128]
// lane-replicated layout is TPU tiling and is not carried over).
//
// Bound on the H100: at the serving path's prefill shapes (S <= 1024,
// 32 heads) the causal work is 2 * 2 * D * S(S+1)/2 flops per head,
// about 8.6 GFLOP at S = 1024; against 989 TFLOP/s (bf16 tensor cores)
// that is operations-bound, while the bytes (q, k, v, o once each,
// 32 MB at S = 1024) take ~10 us. This first kernel runs the two
// products as fp32 FMAs on the CUDA cores, not on the tensor cores
// (wgmma comes in a later change), so it sits well above that bound.
// Design: one block of 256 threads per (q tile of 64 rows, head,
// batch). The block loops over 64-row k tiles, skips tiles wholly above
// the diagonal, and keeps the running max / denominator / output
// accumulator on chip: S = QK^T as a 4x4 micro-tile per thread, the
// row softmax one warp per 8 rows, O += PV as a 4x8 micro-tile per
// thread in registers. K and V share one shared-memory tile (V is
// loaded while the softmax runs), which keeps the block at ~82 KB so
// two blocks fit on an SM. Ragged tails (any Sq, Sk >= 1) are masked
// in the kernel; heavy causal q tiles are scheduled first.
#include "common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kQStride = kD + 1;   // +1 float: conflict-free column reads
constexpr int kKVStride = kD + 1;
constexpr int kPStride = kBK + 1;
constexpr size_t kSmemFloats =
    kBQ * kQStride + kBK * kKVStride + kBQ * kPStride + 3 * kBQ;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] or null
  int sq, sk, h, hkv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const T* src, int64_t row_stride,
                                          int row0, int nrows_valid) {
  // dst[r][c] = src[(row0 + r) * row_stride + c], zero past the tail
  for (int i = threadIdx.x; i < kBK * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    float val = 0.f;
    if (row0 + r < nrows_valid)
      val = ptt_to_float(src[static_cast<int64_t>(row0 + r) * row_stride + c]);
    dst[r * dst_stride + c] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                         // [BQ][D+1]
  float* kv = qs + kBQ * kQStride;          // [BK][D+1], K then V
  float* ps = kv + kBK * kKVStride;         // [BQ][BK+1]
  float* m_s = ps + kBQ * kPStride;         // running max   [BQ]
  float* l_s = m_s + kBQ;                   // running denom [BQ]
  float* a_s = l_s + kBQ;                   // rescale alpha [BQ]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;     // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qt * kBQ;
  const int offset = a.sk - a.sq;           // bottom-right causal alignment

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  load_tile(qs, kQStride, qb + static_cast<int64_t>(q0) * a.q_ss, a.q_ss, 0,
            a.sq - q0);
  if (tid < kBQ) {
    m_s[tid] = PTT_NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int n_kt = (a.sk + kBK - 1) / kBK;
  if (a.causal) {
    // last key any row of this tile may see: q0 + BQ - 1 + offset
    const int last_key = q0 + kBQ - 1 + offset;
    const int need = last_key / kBK + 1;
    if (need < n_kt) n_kt = need;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous PV done with kv and ps
    load_tile(kv, kKVStride, kb + static_cast<int64_t>(k0) * a.k_ss, a.k_ss,
              0, a.sk - k0);
    __syncthreads();

    // S = Q K^T on a 4x4 micro-tile: rows ty + 16i, cols tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float qv[4], kvv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kQStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kvv[j] = kv[(tx + 16 * j) * kKVStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float val = s[i][j] * a.scale;
        if (kpos >= a.sk || (a.causal && kpos > qpos + offset))
          val = PTT_NEG_INF;
        ps[r * kPStride + c] = val;
      }
    }
    __syncthreads();  // S complete; K no longer needed

    // V into the shared K/V tile while each warp runs the row softmax
    load_tile(kv, kKVStride, vb + static_cast<int64_t>(k0) * a.v_ss, a.v_ss,
              0, a.sk - k0);
    for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
      const float s0 = ps[r * kPStride + lane];
      const float s1 = ps[r * kPStride + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, ptt_warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      ps[r * kPStride + lane] = p0;
      ps[r * kPStride + lane + 32] = p1;
      const float sum = ptt_warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V on a 4x8 micro-tile: rows ty + 16i, cols tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = kv[c * kKVStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    if (qpos >= a.sq) continue;
    const float inv_l = 1.f / l_s[r];
    T* orow = ob + static_cast<int64_t>(qpos) * a.o_ss;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      orow[tx + 16 * j] = ptt_from_float<T>(acc[i][j] * inv_l);
  }
  if (a.lse != nullptr && tid < kBQ && q0 + tid < a.sq) {
    a.lse[(static_cast<int64_t>(b) * a.h + h) * a.sq + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
  }
}

template <typename T>
int launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = ptt_allow_smem(flash_fwd_kernel<T>, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, batch);
  flash_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PTT_EXPORT int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int sq,
    int sk, int h, int hkv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int dtype, void* stream) {
  FlashArgs a{q,    k,    v,    o,    static_cast<float*>(lse),
              sq,   sk,   h,    hkv,  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
              v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32) return launch<float>(a, batch, s);
  if (dtype == PTT_BF16) return launch<__nv_bfloat16>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

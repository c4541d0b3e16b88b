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
// natural-log logsumexp of the scaled logits as [B, H, Sq] contiguous
// (the training path's residual; the Pallas kernel's [B, H, Sq, 128]
// lane-replicated layout is TPU tiling and is not carried over).
//
// Bound on the H100: the causal work is 2 * 2 * D * S(S+1)/2 flops per
// head. At the serving path's S = 1024 (32 heads) that is 8.6 GFLOP,
// 8.7 us at 989 TFLOP/s on the bf16 tensor cores, against 10 us to move
// q, k, v and o once (bytes bound it, barely); at the training shape
// (B = 2, S = 2048, H = 32) 68.7 GFLOP take 69 us against 40 us of
// bytes (operations bound it).
//
// Two kernels, chosen by dtype (the wrapper never mixes them):
//
// bf16: flash_fwd_wgmma_kernel, on the tensor cores. One block of two
// warpgroups per (128 query rows, head, batch); each warpgroup owns 64
// rows. The Q tile and a two-stage ring of 64-key K and V tiles sit in
// shared memory in the 128-byte-swizzled layout of hopper.cuh (~97 KB),
// loaded by 16-byte cp.async copies that zero-fill the ragged S tail:
// cp.async, not TMA, because one copy per thread takes any row stride
// the wrapper passes (a strided [B, H, S, D] view as well), needs no
// tensor map per call and no libcuda entry point, and the next tile
// is in flight while the current one is computed either way. Per key
// tile: S = Q K^T by wgmma m64n64k16 (both operands from shared memory,
// K read K-major), the online softmax on the accumulator fragment in
// registers (each row spread over a quad: two shuffles; the log2(e)
// factor folded into the scale, exp2f), the mask applied only on tiles
// that the diagonal or the tail cuts, P rounded to bf16 in registers
// as wgmma's A operand and O += P V by wgmma m64n128k16 with V read in
// the transposed-B (MN-major) mode, no transpose in shared memory. The
// 64 x 128 fp32 O accumulator stays in registers; the epilogue writes
// O / l in bf16 and m * ln 2 + ln l as the natural-log LSE that the
// backward kernels read. Heavy causal tiles are scheduled first.
// Rounding P to bf16 before P V is what FlashAttention-2/3 and SDPA do;
// the plain version rounds the normalised probabilities instead, and
// the two stay within chip_smoke.py's bf16 limits
// (tests/test_torch_smoke.py checks that order on the CPU).
//
// f32: flash_fwd_kernel, fp32 FMAs on the CUDA cores (the port's first
// design, kept for f32 only): the f32 consistency checks hold it to a
// relative 1e-5, which TF32 tensor-core products (10-bit mantissa)
// cannot meet. 256 threads per (64 query rows, head, batch), fp32 tiles
// in shared memory, S = QK^T as 4x4 and O += PV as 4x8 register
// micro-tiles, ~82 KB of shared memory.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWBQ = 128;                 // two warpgroups x 64 query rows
constexpr int kWBK = 64;                  // keys per K/V tile
constexpr int kWThreads = 256;
constexpr uint32_t kWQBytes = kWBQ * kD * 2;
constexpr uint32_t kWKVBytes = kWBK * kD * 2;
constexpr size_t kWSmemBytes = kWQBytes + 4 * kWKVBytes + 1024;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kWThreads, 1)
    flash_fwd_wgmma_kernel(FlashArgs a) {
  using namespace hopper;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t q_s = aligned_smem_base(smem);
  const uint32_t kv_s = q_s + kWQBytes;   // stage s: K, then V

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qt * kWBQ;
  const int offset = a.sk - a.sq;              // bottom-right causal alignment
  const auto* qb = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb +
                   h * a.q_sh;
  const auto* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb +
                   hk * a.k_sh;
  const auto* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb +
                   hk * a.v_sh;
  auto* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qw = q0 + wg * 64;                  // first row of the warpgroup
  const int row0 = qw + warp * 16 + (lane >> 2);  // this thread: row0, +8
  const int col = 2 * (lane & 3);

  int n_kt = (a.sk + kWBK - 1) / kWBK;
  if (a.causal) n_kt = min(n_kt, (q0 + kWBQ - 1 + offset) / kWBK + 1);
  const int wg_last_key = a.causal ? qw + 63 + offset : a.sk - 1;

  load_tile_async<kWBQ, kWThreads>(q_s, qb, a.q_ss, q0, a.sq);
  load_tile_async<kWBK, kWThreads>(kv_s, kb, a.k_ss, 0, a.sk);
  load_tile_async<kWBK, kWThreads>(kv_s + kWKVBytes, vb, a.v_ss, 0, a.sk);
  cp_async_commit();

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = PTT_NEG_INF, m1 = PTT_NEG_INF;   // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;                   // this thread's partial sums
  const float scale_log2 = a.scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kWBK;
    const uint32_t k_s = kv_s + (kt & 1) * 2 * kWKVBytes;
    const uint32_t v_s = k_s + kWKVBytes;
    if (kt + 1 < n_kt) {   // the next tile flies while this one computes
      const uint32_t nk = kv_s + ((kt + 1) & 1) * 2 * kWKVBytes;
      load_tile_async<kWBK, kWThreads>(nk, kb, a.k_ss, k0 + kWBK, a.sk);
      load_tile_async<kWBK, kWThreads>(nk + kWKVBytes, vb, a.v_ss,
                                       k0 + kWBK, a.sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();

    if (k0 <= wg_last_key) {   // uniform over the warpgroup
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        wgmma_m64n64k16_ss(s, desc_kmajor(q_s, kWBQ, wg * 64, k),
                           desc_kmajor(k_s, kWBK, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const bool edge = k0 + kWBK > a.sk ||
                        (a.causal && k0 + kWBK - 1 > qw + offset);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int row = e < 2 ? row0 : row0 + 8;
            if (key >= a.sk || (a.causal && key > row + offset))
              x = PTT_NEG_INF;
          }
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j + 0] = exp2f(s[4 * j + 0] - m0);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - m0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - m1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - m1);
        ps0 += s[4 * j + 0] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j + 0] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
      uint32_t p[4][4];
      acc_to_a(s, p);

      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWBK / 16; ++k)
        wgmma_m64n128k16_rs(o, p[k], desc_mnmajor(v_s, kWBK, k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();   // every warpgroup is done with this stage
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + col;
    if (row0 < a.sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * a.o_ss + c) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row0 + 8 < a.sq)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * a.o_ss + c) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (a.lse != nullptr && (lane & 3) == 0) {
    float* lb = a.lse + (static_cast<int64_t>(b) * a.h + h) * a.sq;
    if (row0 < a.sq) lb[row0] = m0 * kLn2 + logf(l0);
    if (row0 + 8 < a.sq) lb[row0 + 8] = m1 * kLn2 + logf(l1);
  }
}

int launch_wgmma(const FlashArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = ptt_allow_smem(flash_fwd_wgmma_kernel, kWSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sq + kWBQ - 1) / kWBQ, a.h, batch);
  flash_fwd_wgmma_kernel<<<grid, kWThreads, kWSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kQStride = kD + 1;   // +1 float: conflict-free column reads
constexpr int kKVStride = kD + 1;
constexpr int kPStride = kBK + 1;
constexpr size_t kSmemFloats =
    kBQ * kQStride + kBK * kKVStride + kBQ * kPStride + 3 * kBQ;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const float* src,
                                          int64_t row_stride, int row0,
                                          int nrows_valid) {
  // dst[r][c] = src[(row0 + r) * row_stride + c], zero past the tail
  for (int i = threadIdx.x; i < kBK * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    float val = 0.f;
    if (row0 + r < nrows_valid)
      val = src[static_cast<int64_t>(row0 + r) * row_stride + c];
    dst[r * dst_stride + c] = val;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(FlashArgs a) {
  extern __shared__ float smem_f[];
  float* qs = smem_f;                       // [BQ][D+1]
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

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* ob = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

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
    float* orow = ob + static_cast<int64_t>(qpos) * a.o_ss;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[tx + 16 * j] = acc[i][j] * inv_l;
  }
  if (a.lse != nullptr && tid < kBQ && q0 + tid < a.sq) {
    a.lse[(static_cast<int64_t>(b) * a.h + h) * a.sq + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
  }
}

int launch_fma(const FlashArgs& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = ptt_allow_smem(flash_fwd_kernel, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, batch);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, stream>>>(a);
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
  if (dtype == PTT_F32) return launch_fma(a, batch, s);
  if (dtype == PTT_BF16) return launch_wgmma(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Paged attention for decode: one query token per slot attends over the
// KV rows that the slot's page table scatters across the page pool.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_paged_attn_kernel (called
// through paged_attention / _paged_attention_pallas). Same function:
// q [N, H, D] (one decode query per slot), pages [num_pages, ps, HKV, D]
// in f32, bf16 or int8 (int8 dequantized by a per-(page, kv head) f32
// scale), table [N, P] int32 (page 0 is the null page), lengths [N]
// int32; GQA folds query heads as [HKV, G] (head = hkv * G + g); keys at
// or past lengths[n] are masked; pages wholly past the length are
// skipped, but the slot's first page is always computed so an idle slot
// still finishes with finite values. Output is q.dtype.
//
// Bound on the H100: bytes. Each live KV row is read once and used for
// G query heads (2 * 2 * G * D flops per row against 2 * D * sizeof(KV)
// bytes), far below the ~295 flops/byte where the tensor cores would
// become the limit. At the serving path's decode shape (8 slots, 32
// heads, context up to 1024, bf16) the bound is a few tens of
// microseconds.
// Design: one block of D = 128 threads per (slot, kv head). The block
// reads its slot's page ids from the table itself (the CUDA counterpart
// of scalar prefetch), stages one [ps, D] K tile and one V tile per page
// in shared memory as fp32 (dequantized on load), computes the G x ps
// scores one warp per (head, row) with a shuffle reduction, runs the
// online softmax for the G heads of the group, and accumulates P V with
// thread t owning output dimension t for every head of the group, in
// registers. Loads are coalesced rows of D contiguous elements. This
// first kernel walks a slot's pages in order within one block; splitting
// a long context across blocks is later work.
#include "common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = kD;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;

struct PagedArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* table;
  const int* lengths;
  const float* k_scales;
  const float* v_scales;
  void* out;
  int h, hkv, p, ps;
  float scale;
};

template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(PagedArgs a) {
  extern __shared__ float smem[];
  const int g_size = a.h / a.hkv;
  float* qs = smem;                        // [G][D], pre-scaled by sm_scale
  float* kt = qs + g_size * kD;            // [ps][D]
  float* vt = kt + a.ps * kD;              // [ps][D]
  float* sc = vt + a.ps * kD;              // [G][ps] scores, then probs
  float* m_s = sc + g_size * a.ps;         // [G]
  float* l_s = m_s + g_size;               // [G]
  float* al_s = l_s + g_size;              // [G]

  const int n = blockIdx.x;
  const int hk = blockIdx.y;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int len = a.lengths[n];

  const TQ* qn = static_cast<const TQ*>(a.q) +
                 (static_cast<int64_t>(n) * a.h + hk * g_size) * kD;
  for (int g = 0; g < g_size; ++g)
    qs[g * kD + t] = ptt_to_float(qn[g * kD + t]) * a.scale;
  if (t < g_size) {
    m_s[t] = PTT_NEG_INF;
    l_s[t] = 0.f;
  }

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  int n_pages = (len + a.ps - 1) / a.ps;
  if (n_pages < 1) n_pages = 1;            // the first page always computes
  if (n_pages > a.p) n_pages = a.p;

  const TKV* kp = static_cast<const TKV*>(a.k_pages);
  const TKV* vp = static_cast<const TKV*>(a.v_pages);
  const int64_t row_stride = static_cast<int64_t>(a.hkv) * kD;

  for (int ip = 0; ip < n_pages; ++ip) {
    const int pid = a.table[static_cast<int64_t>(n) * a.p + ip];
    float k_scale = 1.f, v_scale = 1.f;
    if (kQuant) {
      k_scale = a.k_scales[static_cast<int64_t>(pid) * a.hkv + hk];
      v_scale = a.v_scales[static_cast<int64_t>(pid) * a.hkv + hk];
    }
    const int64_t base = static_cast<int64_t>(pid) * a.ps * row_stride +
                         static_cast<int64_t>(hk) * kD + t;
    __syncthreads();  // previous page's PV is done with kt / vt / sc
    for (int j = 0; j < a.ps; ++j) {
      kt[j * kD + t] = ptt_to_float(kp[base + j * row_stride]) * k_scale;
      vt[j * kD + t] = ptt_to_float(vp[base + j * row_stride]) * v_scale;
    }
    __syncthreads();

    for (int idx = warp; idx < g_size * a.ps; idx += kWarps) {
      const int g = idx / a.ps, j = idx % a.ps;
      float part = 0.f;
#pragma unroll
      for (int c = lane; c < kD; c += 32) part += qs[g * kD + c] * kt[j * kD + c];
      part = ptt_warp_sum(part);
      if (lane == 0)
        sc[g * a.ps + j] = (ip * a.ps + j < len) ? part : PTT_NEG_INF;
    }
    __syncthreads();

    if (t < g_size) {
      float* row = sc + t * a.ps;
      const float m_old = m_s[t];
      float m_new = m_old;
      for (int j = 0; j < a.ps; ++j) m_new = fmaxf(m_new, row[j]);
      float sum = 0.f;
      for (int j = 0; j < a.ps; ++j) {
        const float pj = expf(row[j] - m_new);
        row[j] = pj;
        sum += pj;
      }
      const float alpha = expf(m_old - m_new);
      al_s[t] = alpha;
      l_s[t] = l_s[t] * alpha + sum;
      m_s[t] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < g_size) {
        float v_acc = acc[g] * al_s[g];
        for (int j = 0; j < a.ps; ++j) v_acc = fmaf(sc[g * a.ps + j], vt[j * kD + t], v_acc);
        acc[g] = v_acc;
      }
    }
  }

  TQ* on = static_cast<TQ*>(a.out) +
           (static_cast<int64_t>(n) * a.h + hk * g_size) * kD;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < g_size) on[g * kD + t] = ptt_from_float<TQ>(acc[g] / l_s[g]);
}

template <typename TQ, typename TKV, bool kQuant>
int launch(const PagedArgs& a, int n, cudaStream_t stream) {
  const int g_size = a.h / a.hkv;
  const size_t smem =
      (static_cast<size_t>(g_size) * kD + 2 * static_cast<size_t>(a.ps) * kD +
       static_cast<size_t>(g_size) * a.ps + 3 * g_size) *
      sizeof(float);
  const cudaError_t e =
      ptt_allow_smem(paged_attn_kernel<TQ, TKV, kQuant>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n, a.hkv);
  paged_attn_kernel<TQ, TKV, kQuant><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PTT_EXPORT int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, const void* k_scales,
                                   const void* v_scales, void* out, int n,
                                   int h, int hkv, int p, int ps, float scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  PagedArgs a{q,
              k_pages,
              v_pages,
              static_cast<const int*>(table),
              static_cast<const int*>(lengths),
              static_cast<const float*>(k_scales),
              static_cast<const float*>(v_scales),
              out,
              h,
              hkv,
              p,
              ps,
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

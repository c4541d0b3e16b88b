// Paged attention for decode, f32 q over fp16 pages (or int8 pages with
// the decode round's window in fp16): the instantiations of
// paged_attention.cuh for a KV pool kept in another float dtype than the
// model's (the kernels, their design and their bound are described
// there).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_paged_attn_kernel.
#include "paged_attention.cuh"

PTT_PAGED_ATTENTION_KV_FWD(float, PTT_F32, __half, PTT_F16)

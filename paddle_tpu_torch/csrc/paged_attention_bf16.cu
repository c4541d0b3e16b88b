// Paged attention for decode, bf16 q: the instantiations of
// paged_attention.cuh (the kernels, their design and their bound are
// described there).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_paged_attn_kernel.
#include "paged_attention.cuh"

PTT_PAGED_ATTENTION_FWD(__nv_bfloat16, PTT_BF16)

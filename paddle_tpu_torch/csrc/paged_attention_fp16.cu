// Paged attention for decode, fp16 q: the instantiations of
// paged_attention.cuh (the kernels, their design and their bound are
// described there). An fp16 element is 2 bytes, as bf16's: the same tile
// layout and cp.async width, pairs widened by __half22float2, fp32
// inside, one __float2half_rn rounding of the output in the combine.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_paged_attn_kernel.
#include "paged_attention.cuh"

PTT_PAGED_ATTENTION_FWD(__half, PTT_F16)

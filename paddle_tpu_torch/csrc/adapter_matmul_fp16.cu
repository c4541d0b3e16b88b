// Segmented LoRA delta over a packed adapter bank, fp16 x: the
// instantiations of adapter_matmul.cuh (the kernel, its design and its
// bound are described there) under an f32 bank (the JAX bank's
// default) or an fp16 one.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_adapter_matmul_kernel.
#include "adapter_matmul.cuh"

PTT_ADAPTER_MATMUL_FWD(__half, PTT_F16)

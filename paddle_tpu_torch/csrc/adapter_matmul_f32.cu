// Segmented LoRA delta over a packed adapter bank, f32 x: the
// instantiations of adapter_matmul.cuh (the kernel, its design and its
// bound are described there) under an f32 or a bf16 bank.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_adapter_matmul_kernel.
#include "adapter_matmul.cuh"

PTT_ADAPTER_MATMUL_FWD(float, PTT_F32)

"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX reference (`paddle_tpu`), with the same
Paddle-style names. It imports torch and never jax, nor anything of
`paddle_tpu`. Its entry points run on `cuda` unless the caller passes
`device='cpu'`; every kernel the JAX package wrote in Pallas for the TPU
is, on this package's path, a kernel written by hand for Hopper
(`ops/kernels.py`, sources under `csrc/`).

It serves Llama through the paged continuous-batching engine
(`nlp.LlamaForCausalLM` + `serving.InferenceEngine`) and trains it
(`jit.TrainStep` + the optimizers of `optimizer`, LR schedules from
`optimizer.lr` and gradient clips from `nn`, with `F.cross_entropy` and
`use_recompute`; Adam/AdamW update through one multi-tensor kernel).
`save`/`load` write and read the JAX package's npz container, and
`utils.CheckpointManager` and `serving.WeightStore` its checkpoint and
weight-version layouts.
"""
from . import (dtype, flags, framework, jit, nlp, nn, ops, optimizer,
               regularizer, resilience, serving, utils, weights)
from .flags import get_flags, set_flags
from .framework import generator, resolve_device, seed
from .serialization import load, save

__all__ = ['dtype', 'flags', 'framework', 'jit', 'nlp', 'nn', 'ops',
           'optimizer', 'regularizer', 'resilience', 'serving', 'utils',
           'weights', 'generator', 'get_flags', 'load', 'resolve_device',
           'save', 'seed', 'set_flags']

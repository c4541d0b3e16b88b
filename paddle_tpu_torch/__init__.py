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
"""
from . import (dtype, framework, jit, nlp, nn, ops, optimizer, regularizer,
               serving, weights)
from .framework import generator, resolve_device, seed

__all__ = ['dtype', 'framework', 'jit', 'nlp', 'nn', 'ops', 'optimizer',
           'regularizer', 'serving', 'weights', 'generator', 'resolve_device',
           'seed']

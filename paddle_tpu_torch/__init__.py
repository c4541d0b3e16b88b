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
weight-version layouts. `serving.Router` serves replicas in one process
or in replica processes under a `serving.Supervisor` (tenancy, failover,
the autoscaler, the rolling weight swap), `loadgen` replays seeded
traffic through it, and `loop.RolloutLoop` closes training onto serving
(serve, score, train, publish, swap). `observability` reports
what the serving and training paths do (metrics, events, spans, the
goodput and request ledgers, the program catalog and roofline, the SLO
engine, the flight recorder, an HTTP endpoint, and the fleet plane
that merges them across processes) under the JAX package's names.

Training runs the JAX bench's rungs: selective recompute
(`use_recompute='dots'|'dots_no_batch'`), tied word embeddings, Adam's
slots offloaded to pinned host memory (`offload='host'`), the fault-
tolerant step and its watchdog (`resilience`), and `Model.fit` (`hapi`)
over `io.DataLoader` with `metric`s, callbacks, checkpoints and resume.
"""
from . import (analysis, debug, dtype, flags, framework, io, jit, loadgen,
               loop, metric, nlp, nn, observability, ops, optimizer,
               regularizer, resilience, serving, utils, weights)
from . import hapi
from .flags import get_flags, set_flags
from .framework import generator, resolve_device, seed
from .hapi import Model
from .hapi import callbacks_mod as callbacks
from .serialization import load, save

__all__ = ['analysis', 'callbacks', 'debug', 'dtype', 'flags', 'framework',
           'hapi', 'io', 'jit', 'loadgen', 'loop', 'metric', 'nlp', 'nn',
           'observability', 'ops', 'optimizer', 'regularizer', 'resilience',
           'serving', 'utils', 'weights', 'Model', 'generator', 'get_flags',
           'load', 'resolve_device', 'save', 'seed', 'set_flags']

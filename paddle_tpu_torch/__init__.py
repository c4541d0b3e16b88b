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

The eager Paddle API (slice 18): `Tensor` (a wrapper of a torch tensor)
and `Parameter`, `to_tensor` and the op library of `ops` (creation,
math, reduction, manipulation, search, linalg; every op through
`tensor.apply_op`), torch's autograd behind `backward`, `grad`,
`no_grad`, `PyLayer`, `jacobian` and `hessian` (`autograd`), places and
`set_device`, and mixed precision (`amp.auto_cast`, `amp.decorate`,
`amp.GradScaler`) with fp16 flash-attention kernels.

The GPT family (slice 19): the rest of `nn` that it builds on (Paddle's
constructors, `ParamAttr` and `nn.initializer`, the functional library,
the norm, loss, container and transformer layers),
`nlp.GPTForCausalLM` served by the paged engine and trained,
`generate()` / `speculative_generate()` on every causal LM (`nlp.
GenerationMixin`), BERT and ERNIE, and head_dim-64 flash and paged
kernels.

The vision slice: convolution, pooling, resampling, padding
and RNN layers with their functional entries, `nn.utils`, and `vision`
(the model zoo from LeNet to InceptionV3, the detection ops,
transforms, datasets), ResNet-50 trained through `Model.fit` with its
loss on the CE kernels.

The row engine and the host pieces: `serving.InferenceEngine` builds the
JAX package's default layout, one KV row per slot, unless a page
argument asks for pages; `serialization.save_sharded` / `load_sharded`,
`utils.CheckpointManager(backend='native')` and the `DataLoader`'s
native collator over the port's copies of the host C++; `flops`,
`summary`, `LazyGuard` and `utils`' `unique_name`, `try_import` and
`deprecated`.

The public packages that compute on the card: `device`, `profiler`
(host regions and a torch.profiler device trace), `static` (programs
recorded at `tensor.apply_op` and replayed by `Executor`), `incubate`
(the fused entries over the port's kernels), `geometric`,
`quantization` (PTQ, QAT and the observers), `fft`, `signal`, `sparse`,
`version`, `sysconfig` and the top-level CUDA checks. A KV pool may be
kept in another float dtype than the model's (`InferenceEngine(
dtype=)`), read by the paged kernel's (q, pages) pair.

The long tail: `audio` (windows, mel filterbanks and the feature layers
over `signal.stft`), `text` (Viterbi decoding and the synthetic
datasets), `distribution` (the families, transforms and KL pairs,
sampled from `torch.Generator`s), `hub` (local hubconf.py) and `onnx`
(the `torch.export` graph mapped to ONNX nodes, the kernels' export ops
lowered to their plain versions' subgraphs).
"""
# the op surface first: the modules imported below keep their names
from .ops import *  # noqa: F401,F403
from . import (analysis, autograd, debug, dtype, flags, framework, io, jit,
               loadgen, loop, metric, nlp, nn, observability, ops, optimizer,
               regularizer, resilience, serving, tensor, utils, vision,
               weights)
from . import amp
from . import hapi
from . import (device, fft, geometric, incubate, profiler, quantization,
               signal, sparse, static, sysconfig, version)
from . import audio, distribution, hub, onnx, text
from .autograd import (PyLayer, PyLayerContext, enable_grad, grad,
                       is_grad_enabled, no_grad, set_grad_enabled)
from .dtype import (bfloat16, bool_, complex64, complex128, finfo, float16,
                    float32, float64, iinfo, int8, int16, int32, int64, uint8)
from .flags import get_flags, set_flags
from .framework import (CPUPlace, CUDAPlace, Generator, Place, TPUPlace,
                        XLAPlace, device_guard, generator,
                        get_default_dtype, get_device, get_place,
                        is_compiled_with_cuda, resolve_device, seed,
                        set_default_dtype, set_device, synchronize)
from .hapi import Model
from .nn.layer import LazyGuard, ParamAttr
from .regularizer import L1Decay, L2Decay
from .hapi import callbacks_mod as callbacks
from .ops import linalg
from .serialization import load, save
from .tensor import Parameter, Tensor, set_printoptions
from .utils.flops import flops, summary

bool = bool_  # paddle.bool

__version__ = version.full_version

disable_static = static.disable_static
enable_static = static.enable_static


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_custom_device(device_type: str = '') -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int (e.g. 90100), None without cuDNN."""
    import torch
    return (torch.backends.cudnn.version()
            if torch.backends.cudnn.is_available() else None)


def in_dynamic_mode() -> bool:
    return not static.in_static_mode()

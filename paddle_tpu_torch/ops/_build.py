"""Build and load the port's CUDA kernels.

Each `paddle_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into its own shared library with a plain C interface, which
`ctypes` loads. The build happens at first use, into
`<repo>/build/paddle_tpu_torch/<key>/`, where `<key>` hashes the
sources, the flags and the compiler path, so an edited kernel is rebuilt
and an unchanged one is reused. All sources compile in parallel, one
`nvcc` process each. `COMPILES` counts the sources this process compiled:
a process that finds every library built (a replica process started by
a parent that built them) compiles nothing, and reports 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'paddle_tpu_torch'
SOURCES = ('rms_norm', 'flash_attention', 'flash_attention_bwd',
           'paged_attention_f32', 'paged_attention_bf16',
           'paged_attention_fp16', 'paged_attention_f32_kvbf16',
           'paged_attention_f32_kvfp16', 'paged_attention_bf16_kvf32',
           'paged_attention_bf16_kvfp16', 'paged_attention_fp16_kvf32',
           'paged_attention_fp16_kvbf16', 'cross_entropy', 'adapter_matmul_f32',
           'adapter_matmul_bf16', 'adapter_matmul_fp16', 'multi_tensor_adam')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_libs: Dict[str, ctypes.CDLL] = {}
# sources this process has handed to nvcc (a replica's warm-start gate)
COMPILES = 0


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        'nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the '
        'port\'s CUDA kernels are compiled on the machine with the card')


def _build_dir(nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update(' '.join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in ('.cu', '.cuh'):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, str]:
    """Compile every kernel source that is not built yet, all at once.

    Returns {source name: nvcc's output} for the sources compiled by this
    call (`-Xptxas=-v` makes that the registers, shared memory and spills
    of each kernel), each ending with the seconds from the start of the
    build to that source's end (`compiled in ... s`); the output is also
    kept beside each library as `lib<name>.log` (see `build_log`).
    Raises RuntimeError with the compiler's output if a source fails to
    build.
    """
    global COMPILES
    nvcc = _nvcc()
    out_dir = _build_dir(nvcc)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        lib = out_dir / f'lib{name}.so'
        if lib.exists():
            continue
        tmp = out_dir / f'lib{name}.so.tmp{os.getpid()}'
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        # nvcc's output goes to a file, not a pipe: pipes are read one
        # process at a time, and one that ptxas -v fills (over 64 KB for
        # a source of many kernels) would stall its compile until then
        out = tempfile.TemporaryFile(mode='w+', dir=out_dir)
        procs[name] = (subprocess.Popen(cmd, stdout=out,
                                        stderr=subprocess.STDOUT, text=True),
                       out, tmp, lib)
    COMPILES += len(procs)
    logs, failed = {}, []
    pending = dict(procs)
    while pending:
        for name, (proc, out, tmp, lib) in list(pending.items()):
            if proc.poll() is None:
                continue
            del pending[name]
            out.seek(0)
            logs[name] = (out.read() + f'compiled in '
                          f'{time.perf_counter() - t0:.1f} s\n')
            out.close()
            if proc.returncode != 0:
                failed.append(name)
                continue
            lib.with_suffix('.log').write_text(logs[name])
            os.replace(tmp, lib)
        if pending:
            time.sleep(0.1)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + ':\n'
                           + '\n'.join(logs[n] for n in failed))
    return logs


def build_log(name: str) -> str:
    """nvcc's output from the build of kernel source `name` ('' if it is
    not built)."""
    path = _build_dir(_nvcc()) / f'lib{name}.log'
    return path.read_text() if path.exists() else ''


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, building it first if
    needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_build_dir(_nvcc()) / f'lib{name}.so'))
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.ptt_error_string(rc).decode()
        raise RuntimeError(f'{what}: CUDA error {rc} ({msg})')

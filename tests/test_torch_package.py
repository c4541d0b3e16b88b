"""Package rules of the PyTorch/CUDA port (`paddle_tpu_torch`): it imports
neither jax nor anything of `paddle_tpu`, and its entry points run on the
card unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN_IMPORT = re.compile(
    r'^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)(\.|\s|$)', re.M)


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = ('import sys, paddle_tpu_torch\n'
            'bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib") '
            'or m.startswith(("jax.", "jaxlib.")) or m == "paddle_tpu" '
            'or m.startswith("paddle_tpu."))\n'
            'print(bad)\n'
            'sys.exit(1 if bad else 0)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_and_no_reference_package():
    files = sorted((ROOT / 'paddle_tpu_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py']
    bad = [f'{p.relative_to(ROOT)}: {m.group(0).strip()}'
           for p in files
           for m in _FORBIDDEN_IMPORT.finditer(p.read_text())]
    assert not bad, bad


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert ptt.resolve_device().type == 'cuda'
    assert ptt.resolve_device('cpu').type == 'cpu'


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError):
        ptt.generator(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu')
    assert model.device.type == 'cpu'


def test_seeded_generator_makes_identical_weights():
    a = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu',
                         generator=ptt.generator(5, 'cpu'))
    b = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu',
                         generator=ptt.generator(5, 'cpu'))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_kernel_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    """The build directory hashes the sources: an edited kernel gets a
    new directory, so a stale library is never loaded."""
    src = tmp_path / 'csrc'
    src.mkdir()
    for name in ('a.cu', 'common.cuh'):
        (src / name).write_text('// ' + name)
    monkeypatch.setattr(_build, 'CSRC', src)
    first = _build._build_dir('/usr/local/cuda/bin/nvcc')
    assert first == _build._build_dir('/usr/local/cuda/bin/nvcc')
    (src / 'common.cuh').write_text('// edited')
    assert _build._build_dir('/usr/local/cuda/bin/nvcc') != first


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.os.path, 'isfile', lambda path: False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build_all()


def test_training_modules_import_no_jax():
    """The training slice's modules (optimizer, TrainStep, the loss layer,
    the backward kernels' sources) are held to the same rule: imported
    alone, they pull in no jax and nothing of `paddle_tpu`."""
    mods = ('paddle_tpu_torch.optimizer', 'paddle_tpu_torch.jit',
            'paddle_tpu_torch.nn.loss_layers')
    code = ('import sys\n'
            + ''.join(f'import {m}\n' for m in mods)
            + 'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
              '("jax", "jaxlib", "paddle_tpu"))\n'
              'sys.exit(1 if bad else 0)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    sources = {p.stem for p in (ROOT / 'paddle_tpu_torch' / 'csrc')
               .glob('*.cu')}
    assert set(_build.SOURCES) == sources


def test_training_entry_points_run_where_the_model_is(monkeypatch):
    """TrainStep and the optimizers follow the model's device: `cuda`
    unless the model was made with device='cpu'."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny(use_recompute=True))
    model = LlamaForCausalLM(LlamaConfig.tiny(), device='cpu')
    step = TrainStep(model, lambda logits, labels: logits.mean(),
                     AdamW(parameters=model.parameters()))
    assert step.device.type == 'cpu'
    step(torch.zeros((1, 4), dtype=torch.int64), None)
    assert step.optimizer._slots and all(
        s['moment1'].device.type == 'cpu'
        for s in step.optimizer._slots.values())

"""Places, the default dtype, seeds and generators (counterpart of
`paddle_tpu/framework.py`).

The port runs on the card: every entry point resolves `device=None` to
`cuda` and raises when there is no card, so a run never moves to the
CPU unless the caller asks for it with `device='cpu'` (as the CPU tests
do). The eager API's current place (`set_device`, `get_place`) starts
at `gpu:0`; creation ops make their tensors there. Randomness comes from
explicit `torch.Generator`s: `seed` reseeds torch's default generators
and the port's own one per device (`default_generator`), from which the
random creation ops draw.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from . import dtype as _dtype_mod

DEFAULT_DEVICE = 'cuda'


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `cuda`. Raises when a CUDA
    device is asked for and there is none."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {dev} requested but no CUDA device is available; pass '
            f"device='cpu' to run on the CPU")
    return dev


# --------------------------------------------------------------------------
# Places
# --------------------------------------------------------------------------


class Place:
    device_type = 'unknown'

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f'Place({self.device_type}:{self.device_id})'

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    device_type = 'cpu'

    def torch_device(self) -> torch.device:
        return torch.device('cpu')


class CUDAPlace(Place):
    device_type = 'gpu'

    def torch_device(self) -> torch.device:
        return resolve_device(f'cuda:{self.device_id}')


def _no_tpu(*_a, **_k):
    raise ValueError("the port has no TPU: its places are CUDAPlace "
                     "('gpu', 'gpu:N') and CPUPlace ('cpu')")


class TPUPlace(Place):
    device_type = 'tpu'
    __init__ = _no_tpu


XLAPlace = TPUPlace


def place_of(device: torch.device) -> Place:
    """The Place of a torch device."""
    if device.type == 'cuda':
        return CUDAPlace(device.index or 0)
    return CPUPlace(0)


class _State(threading.local):
    def __init__(self):
        self.default_dtype = _dtype_mod.float32
        self.place = CUDAPlace(0)


_state = _State()


def set_device(device: str) -> Place:
    """set_device('gpu') / 'gpu:N' / 'cpu' (Paddle's
    paddle.device.set_device; 'cuda' is taken for 'gpu')."""
    name, _, idx = str(device).partition(':')
    idx = int(idx) if idx else 0
    if name in ('gpu', 'cuda'):
        _state.place = CUDAPlace(idx)
    elif name == 'cpu':
        _state.place = CPUPlace(idx)
    elif name in ('tpu', 'xla', 'xpu'):
        _no_tpu()
    else:
        raise ValueError(f'unknown device {device!r}')
    return _state.place


def get_device() -> str:
    p = _state.place
    return f'{p.device_type}:{p.device_id}'


def get_place() -> Place:
    return _state.place


def current_device() -> torch.device:
    """The torch device of the current place (raises for `gpu` without a
    card)."""
    return _state.place.torch_device()


@contextlib.contextmanager
def device_guard(device: str):
    old = _state.place
    set_device(device)
    try:
        yield
    finally:
        _state.place = old


def synchronize(device=None) -> None:
    """Block until all queued work on the card is done (the CPU place
    has none)."""
    if _state.place.device_type == 'gpu':
        torch.cuda.synchronize(device)


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


# --------------------------------------------------------------------------
# Device memory statistics (Paddle's paddle.device.cuda family), from the
# caching allocator
# --------------------------------------------------------------------------

def memory_allocated(device_id: Optional[int] = None) -> int:
    return int(torch.cuda.memory_allocated(device_id))


def max_memory_allocated(device_id: Optional[int] = None) -> int:
    return int(torch.cuda.max_memory_allocated(device_id))


def memory_reserved(device_id: Optional[int] = None) -> int:
    return int(torch.cuda.memory_reserved(device_id))


def max_memory_reserved(device_id: Optional[int] = None) -> int:
    return int(torch.cuda.max_memory_reserved(device_id))


def device_memory_limit(device_id: Optional[int] = None) -> int:
    """Total device memory in bytes."""
    return int(torch.cuda.get_device_properties(device_id or 0)
               .total_memory)


# --------------------------------------------------------------------------
# Default dtype
# --------------------------------------------------------------------------

def set_default_dtype(d) -> None:
    _state.default_dtype = _dtype_mod.convert_dtype(d)


def get_default_dtype():
    return _state.default_dtype


# --------------------------------------------------------------------------
# Seeds and generators
# --------------------------------------------------------------------------

class Generator:
    """A random stream over a `torch.Generator` (the JAX package's
    `Generator`, a threefry (seed, counter) stream): `manual_seed`, and
    its state as {'seed', 'state'} (`state()`, `set_state()`), the torch
    generator's own state bytes. `generator` is the torch generator to
    draw from; `device` defaults to the CPU's."""

    def __init__(self, seed: int = 0, device=None):
        self.generator = torch.Generator(
            device='cpu' if device is None else resolve_device(device))
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> 'Generator':
        self._seed = int(seed)
        self.generator.manual_seed(self._seed)
        return self

    def state(self) -> dict:
        return {'seed': self._seed, 'state': self.generator.get_state()}

    def set_state(self, st: dict) -> None:
        self._seed = int(st['seed'])
        self.generator.set_state(st['state'])


def get_cuda_rng_state() -> list:
    """Each CUDA device's RNG state (upstream's per-device list; empty
    without a card)."""
    return torch.cuda.get_rng_state_all() if torch.cuda.is_available() \
        else []


def set_cuda_rng_state(state) -> None:
    if state:
        torch.cuda.set_rng_state_all(state)


_seed = {'value': None}
_generators: dict = {}


def seed(value: int) -> None:
    """Seed torch's default generators on every device (`paddle.seed`)
    and the port's generators that random creation ops draw from."""
    torch.manual_seed(int(value))
    _seed['value'] = int(value)
    _generators.clear()


def generator(seed_value: Optional[int] = None,
              device=None) -> torch.Generator:
    """A torch.Generator on `device` (default `cuda`), seeded when
    `seed_value` is given (else from torch's default seed sequence)."""
    g = torch.Generator(device=resolve_device(device))
    if seed_value is not None:
        g.manual_seed(int(seed_value))
    else:
        g.seed()
    return g


def default_generator(device: torch.device) -> torch.Generator:
    """The generator random creation ops draw from on `device`: seeded
    from the last `seed()` (else from torch's seed sequence), made on
    first use."""
    key = str(device)
    g = _generators.get(key)
    if g is None:
        g = _generators[key] = generator(_seed['value'], device)
    return g

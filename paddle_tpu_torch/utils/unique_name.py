"""paddle.utils.unique_name (a copy of `paddle_tpu/utils/unique_name.py`;
upstream: python/paddle/utils/unique_name.py):
process-wide unique name generation for layers/ops, with guard() scoping
so name sequences are reproducible across program builds."""
from __future__ import annotations

import contextlib
from typing import Dict, Optional


class UniqueNameGenerator:
    def __init__(self, prefix: str = ''):
        self.prefix = prefix
        self._ids: Dict[str, int] = {}

    def __call__(self, key: str) -> str:
        i = self._ids.get(key, 0)
        self._ids[key] = i + 1
        return f'{self.prefix}{key}_{i}'


_generator = UniqueNameGenerator()


def generate(key: str) -> str:
    """Next unique name for `key`: 'fc_0', 'fc_1', ..."""
    return _generator(key)


def switch(new_generator: Optional[UniqueNameGenerator] = None):
    """Swap the active generator; returns the previous one."""
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None \
        else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """Scope with a fresh (or given) name sequence; restores the previous
    generator on exit. A str/bytes argument becomes the prefix."""
    if isinstance(new_generator, (str, bytes)):
        new_generator = UniqueNameGenerator(
            new_generator.decode() if isinstance(new_generator, bytes)
            else new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)

"""paddle.hub (a copy of `paddle_tpu/hub.py`; upstream:
python/paddle/hub.py): load models from a hubconf.py entry-point file.

The 'local' source is fully supported (a directory containing
hubconf.py, whose entry points build port models). Remote
'github'/'gitee' sources need network access, which this build does
not use: they raise with a pointer to the local workflow instead of
downloading."""
from __future__ import annotations

import importlib.util
import os
import sys
from typing import List

__all__ = ['list', 'help', 'load']

_HUBCONF = 'hubconf.py'


def _load_hubconf(repo_dir: str):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.isfile(path):
        raise FileNotFoundError(f'no {_HUBCONF} in {repo_dir!r}')
    spec = importlib.util.spec_from_file_location('paddle_tpu_torch_hubconf',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(repo_dir)
    return mod


def _check_source(source: str):
    if source != 'local':
        raise RuntimeError(
            f'hub source {source!r} needs network access; this build '
            "supports source='local' (a directory with hubconf.py)")


def list(repo_dir: str, source: str = 'local', force_reload: bool = False,
         **kwargs) -> List[str]:
    """Entry-point names exposed by the repo's hubconf.py."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith('_')]


def help(repo_dir: str, model: str, source: str = 'local',
         force_reload: bool = False, **kwargs) -> str:
    """Docstring of one entry point."""
    _check_source(source)
    fn = getattr(_load_hubconf(repo_dir), model, None)
    if fn is None or not callable(fn):
        raise ValueError(f'no callable entry point {model!r} in {repo_dir!r}')
    return fn.__doc__ or ''


def load(repo_dir: str, model: str, source: str = 'local',
         force_reload: bool = False, **kwargs):
    """Call the entry point and return the constructed model."""
    _check_source(source)
    fn = getattr(_load_hubconf(repo_dir), model, None)
    if fn is None or not callable(fn):
        raise ValueError(f'no callable entry point {model!r} in {repo_dir!r}')
    return fn(**kwargs)

"""paddle.sysconfig (counterpart of `paddle_tpu/sysconfig.py`; upstream:
python/paddle/sysconfig.py)."""
from __future__ import annotations

import os


def get_include() -> str:
    """Directory of the package's kernel and host sources (`csrc/`: the
    CUDA kernels' headers and sources, and the host C++)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')


def get_lib() -> str:
    """Directory the kernels are built into at first use
    (`build/paddle_tpu_torch/` beside the package, one subdirectory per
    hash of the sources and flags)."""
    from .ops import _build
    return str(_build.BUILD_ROOT)

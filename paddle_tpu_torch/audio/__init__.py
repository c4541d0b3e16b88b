"""paddle.audio (counterpart of `paddle_tpu/audio/`; upstream:
python/paddle/audio/)."""
from . import backends, datasets, features, functional
from .backends import load, save

__all__ = ['backends', 'datasets', 'features', 'functional', 'load', 'save']

from . import functional
from .functional import memory_efficient_attention

__all__ = ['functional', 'memory_efficient_attention']

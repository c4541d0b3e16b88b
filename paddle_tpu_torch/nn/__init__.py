from . import functional
from .common_layers import Embedding, Linear
from .layer import Layer
from .norm import RMSNorm

__all__ = ['functional', 'Embedding', 'Layer', 'Linear', 'RMSNorm']

from . import functional
from .common_layers import Embedding, Linear
from .layer import Layer
from .loss_layers import CrossEntropyLoss
from .norm import RMSNorm

__all__ = ['functional', 'CrossEntropyLoss', 'Embedding', 'Layer', 'Linear',
           'RMSNorm']

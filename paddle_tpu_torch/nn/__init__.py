from . import functional
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, clip_grad_norm_)
from .common_layers import Embedding, Linear
from .layer import Layer
from .loss_layers import CrossEntropyLoss
from .norm import RMSNorm

__all__ = ['functional', 'ClipGradBase', 'ClipGradByGlobalNorm',
           'ClipGradByNorm', 'ClipGradByValue', 'clip_grad_norm_',
           'CrossEntropyLoss', 'Embedding', 'Layer', 'Linear', 'RMSNorm']

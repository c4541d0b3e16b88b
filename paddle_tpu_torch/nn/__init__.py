"""paddle.nn for the port (counterpart of `paddle_tpu/nn`): layers,
functional ops, initializers, clips. The convolution, pooling, RNN,
resampling and padding layers, `SyncBatchNorm` and `nn.utils` wait for
later slices (ROADMAP, Queue 1)."""
from . import functional
from . import initializer
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, clip_grad_norm_)
from .common_layers import (GLU, AlphaDropout, Bilinear, CELU,
                            CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                            ELU, Embedding, Flatten, GELU, Hardshrink,
                            Hardsigmoid, Hardswish, Hardtanh, Identity,
                            LayerDict, LayerList, LeakyReLU, Linear,
                            LogSigmoid, LogSoftmax, Maxout, Mish,
                            ParameterList, PReLU, ReLU, ReLU6, RReLU, SELU,
                            Sequential, Sigmoid, Silu, Softmax, Softplus,
                            Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                            ThresholdedReLU)
from .layer import Layer, ParamAttr
from .loss_layers import (AdaptiveLogSoftmaxWithLoss, BCELoss,
                          BCEWithLogitsLoss, CosineEmbeddingLoss,
                          CrossEntropyLoss, CTCLoss, GaussianNLLLoss,
                          HSigmoidLoss, HingeEmbeddingLoss, KLDivLoss, L1Loss,
                          MarginRankingLoss, MSELoss,
                          MultiLabelSoftMarginLoss, MultiMarginLoss, NLLLoss,
                          PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
                          TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, RMSNorm)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ['functional', 'initializer', 'ClipGradBase',
           'ClipGradByGlobalNorm', 'ClipGradByNorm', 'ClipGradByValue',
           'clip_grad_norm_', 'GLU', 'AlphaDropout', 'Bilinear', 'CELU',
           'CosineSimilarity', 'Dropout', 'Dropout2D', 'Dropout3D', 'ELU',
           'Embedding', 'Flatten', 'GELU', 'Hardshrink', 'Hardsigmoid',
           'Hardswish', 'Hardtanh', 'Identity', 'LayerDict', 'LayerList',
           'LeakyReLU', 'Linear', 'LogSigmoid', 'LogSoftmax', 'Maxout',
           'Mish', 'ParameterList', 'PReLU', 'ReLU', 'ReLU6', 'RReLU',
           'SELU', 'Sequential', 'Sigmoid', 'Silu', 'Softmax', 'Softplus',
           'Softshrink', 'Softsign', 'Swish', 'Tanh', 'Tanhshrink',
           'ThresholdedReLU', 'Layer', 'ParamAttr',
           'AdaptiveLogSoftmaxWithLoss', 'BCELoss', 'BCEWithLogitsLoss',
           'CosineEmbeddingLoss', 'CrossEntropyLoss', 'CTCLoss',
           'GaussianNLLLoss', 'HSigmoidLoss', 'HingeEmbeddingLoss',
           'KLDivLoss', 'L1Loss', 'MarginRankingLoss', 'MSELoss',
           'MultiLabelSoftMarginLoss', 'MultiMarginLoss', 'NLLLoss',
           'PoissonNLLLoss', 'SmoothL1Loss', 'SoftMarginLoss',
           'TripletMarginLoss', 'BatchNorm', 'BatchNorm1D', 'BatchNorm2D',
           'BatchNorm3D', 'GroupNorm', 'InstanceNorm1D', 'InstanceNorm2D',
           'InstanceNorm3D', 'LayerNorm', 'LocalResponseNorm', 'RMSNorm',
           'MultiHeadAttention', 'Transformer', 'TransformerDecoder',
           'TransformerDecoderLayer', 'TransformerEncoder',
           'TransformerEncoderLayer']

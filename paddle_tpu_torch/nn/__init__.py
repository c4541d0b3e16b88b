"""paddle.nn for the port (counterpart of `paddle_tpu/nn`): layers,
functional ops, initializers, clips, `nn.utils`. `SyncBatchNorm` waits
for `distributed/` (ROADMAP, Queue 1)."""
from . import functional
from . import initializer
from . import utils
from .utils import SpectralNorm
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, clip_grad_norm_)
from .common_layers import (GLU, AlphaDropout, Bilinear, CELU,
                            ChannelShuffle, CosineSimilarity, Dropout,
                            Dropout2D, Dropout3D, ELU, Embedding, Flatten,
                            Fold, GELU, Hardshrink, Hardsigmoid, Hardswish,
                            Hardtanh, Identity, LayerDict, LayerList,
                            LeakyReLU, Linear, LogSigmoid, LogSoftmax,
                            Maxout, Mish, Pad1D, Pad2D, Pad3D, ParameterList,
                            PixelShuffle, PixelUnshuffle, PReLU, ReLU, ReLU6,
                            RReLU, SELU, Sequential, Sigmoid, Silu, Softmax,
                            Softplus, Softshrink, Softsign, Swish, Tanh,
                            Tanhshrink, ThresholdedReLU, Unfold, Upsample,
                            UpsamplingBilinear2D, UpsamplingNearest2D,
                            ZeroPad2D)
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose,
                   Conv3D, Conv3DTranspose)
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
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
                      MaxUnPool2D)
from .rnn import (GRU, GRUCell, LSTM, LSTMCell, RNN, BiRNN, SimpleRNN,
                  SimpleRNNCell, RNNCellBase)
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
           'TransformerEncoderLayer', 'utils', 'SpectralNorm',
           'ChannelShuffle', 'Fold', 'Pad1D', 'Pad2D', 'Pad3D',
           'PixelShuffle', 'PixelUnshuffle', 'Unfold', 'Upsample',
           'UpsamplingBilinear2D', 'UpsamplingNearest2D', 'ZeroPad2D',
           'Conv1D', 'Conv1DTranspose', 'Conv2D', 'Conv2DTranspose',
           'Conv3D', 'Conv3DTranspose', 'AdaptiveAvgPool1D',
           'AdaptiveAvgPool2D', 'AdaptiveAvgPool3D', 'AdaptiveMaxPool1D',
           'AdaptiveMaxPool2D', 'AvgPool1D', 'AvgPool2D', 'AvgPool3D',
           'MaxPool1D', 'MaxPool2D', 'MaxPool3D', 'MaxUnPool2D', 'GRU',
           'GRUCell', 'LSTM', 'LSTMCell', 'RNN', 'BiRNN', 'SimpleRNN',
           'SimpleRNNCell', 'RNNCellBase']

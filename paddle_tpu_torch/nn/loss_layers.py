"""Loss layers (counterpart of `paddle_tpu/nn/loss_layers.py`), each over
its `nn.functional` entry."""
from __future__ import annotations

import torch

from ..tensor import apply_op
from . import functional as F
from .layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction='mean'):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, reduction=self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction='mean', name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction='mean', name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, weight=self.weight,
                                      reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction='mean', pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction='mean',
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class KLDivLoss(Layer):
    def __init__(self, reduction='mean', log_target=False):
        super().__init__()
        self.reduction, self.log_target = reduction, log_target

    def forward(self, input, label):
        return F.kl_div(input, label, reduction=self.reduction,
                        log_target=self.log_target)


class SmoothL1Loss(Layer):
    def __init__(self, reduction='mean', delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, reduction=self.reduction,
                                delta=self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, margin=self.margin,
                                     reduction=self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction='mean', name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, margin=self.margin,
                                      reduction=self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction='mean', name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, reduction=self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction='mean', name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label,
                                              weight=self.weight,
                                              reduction=self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction='mean', name=None):
        super().__init__()
        self.margin, self.p = margin, p
        self.epsilon, self.swap = epsilon, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative,
                                     margin=self.margin, p=self.p,
                                     epsilon=self.epsilon, swap=self.swap,
                                     reduction=self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction='mean', name=None):
        super().__init__()
        self.log_input, self.full = log_input, full
        self.epsilon, self.reduction = epsilon, reduction

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, log_input=self.log_input,
                                  full=self.full, epsilon=self.epsilon,
                                  reduction=self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction='mean',
                 name=None):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, full=self.full,
                                   epsilon=self.epsilon,
                                   reduction=self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction='mean', name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction='mean', name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label,
                                       margin=self.margin,
                                       reduction=self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction='mean',
                 name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, p=self.p,
                                   margin=self.margin, weight=self.weight,
                                   reduction=self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid (upstream paddle.nn.HSigmoidLoss): holds the
    [num_classes - 1, feature_size] internal-node weights for the
    default complete binary tree (or the custom-tree variant via
    path_table/path_code at call time)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        init = dict(dtype=dtype, device=device, generator=generator)
        if not is_custom and num_classes < 2:
            raise ValueError('num_classes must be >= 2')
        self.feature_size, self.num_classes = feature_size, num_classes
        n_nodes = num_classes - 1
        self.weight = self.create_parameter((n_nodes, feature_size),
                                            attr=weight_attr, **init)
        self.bias = self.create_parameter((n_nodes,), attr=bias_attr,
                                          is_bias=True, **init)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax head (upstream paddle.nn.AdaptiveLogSoftmaxWithLoss;
    Grave et al. 2017). Head covers the cutoffs[0] frequent classes plus
    one slot per tail cluster; tail cluster c factors through a
    in_features/div_value^(c+1) bottleneck."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        init = dict(dtype=dtype, device=device, generator=generator)
        cutoffs = list(cutoffs)
        if (not cutoffs or cutoffs != sorted(set(cutoffs))
                or cutoffs[-1] >= n_classes):
            raise ValueError('cutoffs must be unique, increasing, and '
                             '< n_classes')
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs
        self.div_value = div_value
        n_clusters = len(cutoffs)
        self.head_weight = self.create_parameter(
            (in_features, cutoffs[0] + n_clusters), **init)
        self.head_bias = self.create_parameter(
            (cutoffs[0] + n_clusters,), is_bias=True, **init) if head_bias \
            else None
        bounds = cutoffs + [n_classes]
        self.tail_weights = []
        for c in range(n_clusters):
            hsz = max(1, int(in_features / (div_value ** (c + 1))))
            csz = bounds[c + 1] - bounds[c]
            w1 = self.create_parameter((in_features, hsz), **init)
            w2 = self.create_parameter((hsz, csz), **init)
            self.add_parameter(f'tail_{c}_proj', w1)
            self.add_parameter(f'tail_{c}_cls', w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights,
            self.cutoffs, head_bias=self.head_bias)

    def log_prob(self, input):
        """Full [N, n_classes] log-probability table — one pass per
        cluster, concatenated."""
        head = F.linear(input, self.head_weight, self.head_bias)
        head_lp = F.log_softmax(head, axis=-1)
        cols = [head_lp[:, :self.cutoffs[0]]]
        for c, (w1, w2) in enumerate(self.tail_weights):
            tl = F.log_softmax(F.linear(F.linear(input, w1), w2), axis=-1)
            cluster_lp = head_lp[:, self.cutoffs[0] + c].unsqueeze(-1)
            cols.append(cluster_lp + tl)
        return apply_op(lambda *t: torch.cat(t, dim=-1), *cols,
                        _name='concat')

    def predict(self, input):
        return apply_op(lambda t: t.argmax(dim=-1), self.log_prob(input),
                        _name='argmax')

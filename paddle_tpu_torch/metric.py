"""paddle.metric: streaming metrics (counterpart of `paddle_tpu/metric.py`;
upstream: python/paddle/metric/).

The JAX module's arithmetic on the host in numpy: predictions and labels
arrive as torch tensors (on the card or the CPU; bf16 read as fp32) or
arrays, and the counts and the AUC histograms are numpy's, so both
packages report the same numbers on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Per-batch preprocessing; result is fed to update()."""
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy (upstream: paddle.metric.Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        super().__init__(name or 'acc')
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        maxk = max(self.topk)
        top = np.argsort(-pred_np, axis=-1)[..., :maxk]
        return (top == label_np[..., None]).astype(np.float32)

    def update(self, correct):
        correct = _np(correct)
        n = correct[..., 0].size
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].any(-1).sum()
            self.count[i] += n
        acc = self.total / np.maximum(self.count, 1)
        return acc[0] if len(self.topk) == 1 else acc

    def accumulate(self):
        acc = self.total / np.maximum(self.count, 1)
        return float(acc[0]) if len(self.topk) == 1 else acc.tolist()

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f'{self._name}_top{k}' for k in self.topk]


class Precision(Metric):
    """Binary precision over probability/score predictions."""

    def __init__(self, name=None, threshold=0.5):
        super().__init__(name or 'precision')
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > self.threshold).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None, threshold=0.5):
        super().__init__(name or 'recall')
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > self.threshold).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


def accuracy(input, label, k=1):
    """Functional top-k accuracy for a single batch."""
    m = Accuracy(topk=(k,))
    return float(np.asarray(m.update(m.compute(input, label))))


class Auc(Metric):
    """Streaming ROC-AUC via thresholded TP/FP histograms (upstream:
    paddle.metric.Auc, python/paddle/metric/metrics.py — same
    num_thresholds binning scheme)."""

    def __init__(self, curve='ROC', num_thresholds=4095, name=None):
        if curve != 'ROC':
            raise NotImplementedError('only ROC curve is supported')
        super().__init__(name or 'auc')
        self.num_thresholds = int(num_thresholds)
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        """preds: [N, 2] class probabilities (or [N] prob-of-positive);
        labels: [N] or [N, 1] in {0, 1}."""
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        p = p.reshape(-1)
        l = _np(labels).reshape(-1).astype(np.int64)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        np.add.at(self._stat_pos, bins[l == 1], 1)
        np.add.at(self._stat_neg, bins[l == 0], 1)

    def accumulate(self):
        # sweep thresholds high->low accumulating TP/FP; trapezoid area
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.concatenate([[0.0], tp / tot_pos])
        fpr = np.concatenate([[0.0], fp / tot_neg])
        return float(np.trapezoid(tpr, fpr))


__all__ = ['Accuracy', 'Auc', 'Metric', 'Precision', 'Recall', 'accuracy']

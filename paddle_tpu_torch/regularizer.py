"""Weight-decay regularizers (counterpart of `paddle_tpu/regularizer.py`).

An optimizer's `weight_decay` takes a number (L2) or one of these:
`L2Decay(coeff)` adds coeff * p to each gradient, `L1Decay(coeff)` adds
coeff * sign(p). `AdamW` decouples its decay from the gradient either
way (p -= lr * coeff * p).
"""


class L2Decay:

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L1Decay:

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


__all__ = ['L1Decay', 'L2Decay']

"""paddle_tpu_torch.loop: the post-training loop that closes the
trainer → serving circle (counterpart of `paddle_tpu.loop`).

The serving fleet generates rollouts, a reward function scores them,
the trainer (`jit.TrainStep`) consumes the best of them, and the
trained weights stream back into the replicas that generated them
through the weight store and the rolling swap (`serving.hotswap`).

    from paddle_tpu_torch.loop import RolloutLoop, response_lm_loss
"""
from __future__ import annotations

from .rollout import (Rollout, RolloutBatch, RolloutLoop,
                      response_lm_loss)

__all__ = ['Rollout', 'RolloutBatch', 'RolloutLoop', 'response_lm_loss']

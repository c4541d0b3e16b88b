"""RLHF-shaped rollout loop: serve → score → train → publish → swap (a
copy of `paddle_tpu/loop/rollout.py`).

The loop implements best-of-n (rejection-sampling) fine-tuning, the
simplest member of the RLHF family with the full production shape: each
iteration the SERVING fleet samples `rollouts_per_iter` continuations
for fresh prompts, a scalar `reward_fn` scores each, the top
`keep_best` become the training batch (response tokens supervised,
prompt tokens masked), the TRAINER takes `train_passes` optimizer steps
on them, the `WeightPublisher` snapshots every `interval_steps`, and
the `ReplicaUpdater` swaps the new version across the replicas, so the
NEXT iteration's rollouts come from the weights this iteration learned:

    trainer (TrainStep)  --publish-->  WeightStore  --swap-->  Router
        ^                                                        |
        +------------- scored rollouts (reward_fn) <-------------+

The replicas may be in-process engines or `RemoteReplica`s (replica
processes that load each version from the store themselves).

Shapes are static: every training batch is exactly `keep_best` rows of
`seq_len` tokens (right-padded, masked), and every rollout asks for the
same `max_new_tokens`, so after the first iteration no serving graph is
captured again (a swap copies into the live parameters).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import observability as _obs
from ..serving.api import SAMPLING, SamplingParams

# label value cross_entropy ignores: prompt + pad positions contribute
# zero loss, so only the RESPONSE tokens are supervised
IGNORE_INDEX = -100


def response_lm_loss(vocab_size: int):
    """Loss factory for `jit.TrainStep`: next-token cross-entropy over
    the response span only. Labels carry `IGNORE_INDEX` at prompt and
    pad positions (the loop builds them that way), which
    `F.cross_entropy(ignore_index=...)` masks out of the mean (the
    fused CE kernels on the card)."""
    from ..nn import functional as F

    def loss_fn(logits, labels):
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, int(vocab_size)),
            labels[:, 1:].reshape(-1), ignore_index=IGNORE_INDEX)
    return loss_fn


class Rollout:
    """One scored generation: `prompt` + `response` token lists and the
    scalar `reward` the reward function assigned."""

    __slots__ = ('prompt', 'response', 'reward', 'weight_version')

    def __init__(self, prompt: List[int], response: List[int],
                 reward: float, weight_version: Optional[int] = None):
        self.prompt = list(prompt)
        self.response = list(response)
        self.reward = float(reward)
        self.weight_version = weight_version

    def __repr__(self):
        return (f'Rollout(prompt={len(self.prompt)}t, '
                f'response={len(self.response)}t, '
                f'reward={self.reward:.4f}, v={self.weight_version})')


class RolloutBatch:
    """A reward-ranked set of rollouts plus the fixed-shape training
    arrays built from the best of them."""

    def __init__(self, rollouts: Sequence[Rollout], keep_best: int,
                 seq_len: int, pad_token_id: int = 0):
        self.rollouts = sorted(rollouts, key=lambda r: -r.reward)
        self.selected = self.rollouts[:int(keep_best)]
        self.seq_len = int(seq_len)
        self.pad_token_id = int(pad_token_id)
        self.inputs, self.labels = self._build()

    def _build(self):
        """[keep_best, seq_len] int32 arrays (the JAX package's): inputs
        are prompt + response right-padded; labels mask prompt and pad
        positions with IGNORE_INDEX so only response tokens are
        supervised. The shape is identical every iteration."""
        n, t = len(self.selected), self.seq_len
        inputs = np.full((n, t), self.pad_token_id, np.int32)
        labels = np.full((n, t), IGNORE_INDEX, np.int32)
        for i, r in enumerate(self.selected):
            seq = (r.prompt + r.response)[:t]
            inputs[i, :len(seq)] = seq
            lo = min(len(r.prompt), t)
            hi = min(len(seq), t)
            labels[i, lo:hi] = seq[lo:hi]
        return inputs, labels

    @property
    def mean_reward(self) -> float:
        rs = [r.reward for r in self.rollouts]
        return float(np.mean(rs)) if rs else 0.0

    @property
    def best_reward(self) -> float:
        return self.rollouts[0].reward if self.rollouts else 0.0

    @property
    def selected_mean_reward(self) -> float:
        rs = [r.reward for r in self.selected]
        return float(np.mean(rs)) if rs else 0.0


class RolloutLoop:
    """The composed post-training driver (see module docstring).

    Args:
        train_step: a `jit.TrainStep`-shaped callable
            `(inputs, labels) -> loss` over the TRAINER's model (build
            it with `response_lm_loss(vocab)`); the publisher's source
            should snapshot the same model.
        router: the live serving `Router` the rollouts come from (its
            replicas are also the swap targets).
        publisher: `serving.WeightPublisher` over the trainer's model.
        updater: `serving.ReplicaUpdater` over `router` + the
            publisher's store.
        prompt_fn: `iteration_index -> list of prompt token lists`
            (`rollouts_per_iter` of them; fewer is allowed).
        reward_fn: `(prompt_tokens, response_tokens) -> float`.
        rollouts_per_iter / keep_best: generation fan-out and the
            best-of-n selection width (the training batch size —
            constant).
        max_new_tokens: response budget per rollout (constant).
        temperature / top_p / top_k: rollout sampling knobs; rollouts
            SAMPLE (seeded per request for reproducibility) because
            best-of-n needs diversity to select from.
        train_passes: optimizer steps per iteration on the selected
            batch.
        seq_len: training window (default: longest prompt the fn may
            yield + max_new_tokens, probed from iteration 0).
        pad_token_id: fill for the right-padding.
        swap_every_iters: poll the updater every this many iterations
            (1 = swap as soon as a version lands).
    """

    def __init__(self, *, train_step, router, publisher, updater,
                 prompt_fn: Callable[[int], Sequence[Sequence[int]]],
                 reward_fn: Callable[[List[int], List[int]], float],
                 rollouts_per_iter: int = 8, keep_best: int = 4,
                 max_new_tokens: int = 8, temperature: float = 1.0,
                 top_p: float = 1.0, top_k: int = 0,
                 train_passes: int = 1,
                 seq_len: Optional[int] = None, pad_token_id: int = 0,
                 swap_every_iters: int = 1):
        if keep_best < 1 or rollouts_per_iter < keep_best:
            raise ValueError('need rollouts_per_iter >= keep_best >= 1')
        self.train_step = train_step
        self.router = router
        self.publisher = publisher
        self.updater = updater
        self.prompt_fn = prompt_fn
        self.reward_fn = reward_fn
        self.rollouts_per_iter = int(rollouts_per_iter)
        self.keep_best = int(keep_best)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.train_passes = int(train_passes)
        self.seq_len = None if seq_len is None else int(seq_len)
        self.pad_token_id = int(pad_token_id)
        self.swap_every_iters = max(int(swap_every_iters), 1)
        self.global_step = 0
        self.iterations = 0
        self._req_seq = 0
        self.history: List[Dict[str, Any]] = []

    # -- phases -------------------------------------------------------------
    def generate(self, iteration: int) -> List[Rollout]:
        """Fan the iteration's prompts out over the serving fleet and
        score every finished continuation. Requests are seeded by a
        loop-owned sequence number, so a re-run reproduces the same
        rollouts from the same weights."""
        prompts = [list(map(int, p)) for p in self.prompt_fn(iteration)]
        handles = []
        for p in prompts:
            self._req_seq += 1
            handles.append(self.router.submit(p, SamplingParams(
                max_new_tokens=self.max_new_tokens, strategy=SAMPLING,
                temperature=self.temperature, top_p=self.top_p,
                top_k=self.top_k, eos_token_id=-1,
                seed=self._req_seq)))
        self.router.run()
        out = []
        for p, h in zip(prompts, handles):
            if h.status != 'FINISHED':
                continue    # a failed rollout is skipped, not fatal
            toks = list(h.tokens)
            out.append(Rollout(p, toks, self.reward_fn(p, toks),
                               h.weight_version))
        return out

    def _ensure_seq_len(self, rollouts: Sequence[Rollout]):
        if self.seq_len is None:
            longest = max((len(r.prompt) for r in rollouts), default=8)
            self.seq_len = longest + self.max_new_tokens

    def train(self, batch: RolloutBatch) -> float:
        """`train_passes` optimizer steps on the selected rollouts;
        returns the last loss. Publishes on the publisher's step
        interval as the step counter advances."""
        loss = None
        for _ in range(self.train_passes):
            loss = self.train_step(batch.inputs, batch.labels)
            self.global_step += 1
            self.publisher.maybe_publish(self.global_step)
        return float(loss)   # one scalar read per iteration

    # -- the loop -----------------------------------------------------------
    def iteration(self) -> Dict[str, Any]:
        """One full serve→score→train→publish→swap turn; returns (and
        records) the iteration's stats."""
        i = self.iterations
        rollouts = self.generate(i)
        if not rollouts:
            raise RuntimeError(
                f'iteration {i}: every rollout failed — the serving '
                f'fleet is not producing continuations')
        self._ensure_seq_len(rollouts)
        batch = RolloutBatch(rollouts, self.keep_best, self.seq_len,
                             self.pad_token_id)
        loss = self.train(batch)
        swap = None
        if (i + 1) % self.swap_every_iters == 0:
            swap = self.updater.poll()
        self.iterations += 1
        stats = {
            'iteration': i,
            'rollouts': len(rollouts),
            'mean_reward': batch.mean_reward,
            'best_reward': batch.best_reward,
            'selected_mean_reward': batch.selected_mean_reward,
            'loss': loss,
            'global_step': self.global_step,
            'published_version': self.publisher.last_published_version,
            'swap': None if swap is None else
                    {'version': swap['version'],
                     'outcome': swap['outcome']},
            'fleet_version': self.updater.fleet_version,
        }
        self.history.append(stats)
        _obs.emit('rollout_iteration', **{
            k: v for k, v in stats.items()
            if isinstance(v, (int, float)) and v is not None})
        return stats

    def run(self, iterations: int) -> List[Dict[str, Any]]:
        for _ in range(int(iterations)):
            self.iteration()
        return self.history

    def stats(self) -> Dict[str, Any]:
        return {
            'iterations': self.iterations,
            'global_step': self.global_step,
            'fleet_version': self.updater.fleet_version,
            'store': self.publisher.store.stats(),
            'history': list(self.history),
        }

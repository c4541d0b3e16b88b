"""Llama (RMSNorm + SwiGLU + RoPE + GQA), counterpart of
`paddle_tpu/nlp/llama.py`, with the same `state_dict` keys and shapes.

Three forward modes:
- without pages, the whole sequence attends causally to itself through
  the flash-attention kernel (`scaled_dot_product_attention`); this is
  also the serving engine's whole prefill, which takes each layer's new
  K/V rows (`LlamaModel.forward` returns them) and scatters them into
  pages;
- with `kv_pages`, `table` and a [N] `position_offset`, each batch row is
  one decode slot whose S tokens (1 in a decode sub-step, k + 1 in a
  speculative verify) sit at positions position_offset[n] + i: their K/V
  rows are written into the slot's pages and token i attends through the
  paged-attention kernel to positions [0, position_offset[n] + i];
- with `kv_pages`, a [1, P] `table` and a scalar `position_offset`
  `start` (an int or a 0-d tensor), the S tokens are one prompt chunk of
  one slot at positions [start, start + S) (the engine's suffix and
  chunked prefill): their K/V rows are written into the slot's pages
  (below `floor`, which guards the shared prefix pages, to the null
  page) and they attend through the causal flash kernel over the slot's
  whole gathered row, their own rows written at [start, start + S), with
  the key count start + S read from device memory (`seqused_k`), bottom-
  right aligned, so token i sees positions <= start + i. No host value
  depends on `start`, so the chunk replays from a CUDA graph at any
  start (`serving/prefill_graph.py`).

A fourth mode is `GenerationMixin`'s static dense cache: with `cache`
(per-layer (K, V) [B, L, HKV, D] from `init_cache`) and `cache_offset`
(the slot of the first token; `position_offset` is its logical position,
which differs for a left-padded prompt) each layer writes its rows at
their slots in place (`generation.update_static_cache`) and attends
through the slot-causal `decode_mask` (or the caller's
`attention_mask`), which takes the plain attention, as the JAX package
sends masked attention to XLA; `use_cache=True` returns (logits,
caches). `attention_mask` without a cache (a [B, S] pad mask or a
[B, 1, Sq, Sk] boolean one) masks the causal forward the same way.

A layer's `kv_pages` entry is a `generation.LayerKV` (or a plain (k, v)
pair). Over int8 pages it carries their scales: the chunk's gather
dequantizes and its touched pages are requantized whole; the decode
forward writes its rows into the round's float window, which the paged
kernel reads in place of the window's int8 pages.

Training: `LlamaForCausalLM.forward(input_ids, labels=...)` returns
(loss, logits) with the loss from `F.cross_entropy` (the fused CE
kernels). `config.use_recompute` recomputes each decoder layer in the
backward (`torch.utils.checkpoint`, non-reentrant), as the JAX model's
`jax.checkpoint` does:
- `True` keeps only the layer inputs and reruns the whole layer;
- `'dots_no_batch'` (`jax.checkpoint_policies.
  dots_with_no_batch_dims_saveable`) keeps the outputs of the weight
  matmuls (`aten.mm`/`aten.addmm`, which a [B, S, H] @ [H, O] product
  reaches through a view) and reruns attention and the elementwise ops;
- `'dots'` (`dots_saveable`) also keeps the batched dots
  (`aten.bmm`/`aten.baddbmm`).
The policies are torch's selective checkpoint contexts, which see the
ops below autograd. On the card attention is the flash kernels'
`autograd.Function`, whose kernels are no aten op: both policies rerun
it, as the JAX program on a TPU reruns the Pallas call, which is no
`dot_general`. On the CPU the plain attention's two bmm are what
`'dots'` keeps. The kernels rerun in the recompute count their launches
again.

The projections are bias-free `Linear`s (`bias_attr=False`) and random
weights are normal(0, 0.02) draws from `generator` (`INIT_STD`).

`tie_word_embeddings=True` has no `lm_head`: the logits are
`h @ embed_tokens.weight.T` (`_logits`), so the embedding's gradient sums
the gather's and the head's, and every forward mode (training, the
engine's prefill, chunk and decode, their captured graphs) reads it.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import amp as _amp
from ..dtype import to_torch_dtype
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.common_layers import Embedding, Linear
from ..nn.layer import Layer, init_kwargs
from ..nn.norm import RMSNorm
from .generation import (GenerationMixin, as_offset, attend_static,
                         offset_grid, pad_mask, paged_attend, round_kv)

INIT_STD = 0.02   # normal init of random weights (the usual Llama range)


def _linear(in_f: int, out_f: int, init: dict) -> Linear:
    """A bias-free projection, normal(0, INIT_STD) from the generator."""
    return Linear(in_f, out_f, weight_attr=I.Normal(0.0, INIT_STD),
                  bias_attr=False, **init)


class LlamaConfig:
    model_type = 'llama'

    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 pad_token_id=0, bos_token_id=1, eos_token_id=2,
                 use_recompute=False, **kwargs):
        if isinstance(use_recompute, str) \
                and use_recompute not in SAVED_OPS:
            raise ValueError(f'use_recompute={use_recompute!r}: take True, '
                             f'False or one of {sorted(SAVED_OPS)}')
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.use_recompute = use_recompute if isinstance(
            use_recompute, str) else bool(use_recompute)
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls, **kw):
        """Llama-2-7B; keyword arguments override (e.g. a cut depth)."""
        return cls(**{**dict(vocab_size=32000, hidden_size=4096,
                             intermediate_size=11008, num_hidden_layers=32,
                             num_attention_heads=32, num_key_value_heads=32,
                             max_position_embeddings=4096), **kw})

    @classmethod
    def tiny(cls, **kw):
        """Test-sized config (the JAX package's `LlamaConfig.tiny`)."""
        kw.setdefault('vocab_size', 128)
        kw.setdefault('hidden_size', 64)
        kw.setdefault('intermediate_size', 128)
        kw.setdefault('num_hidden_layers', 2)
        kw.setdefault('num_attention_heads', 4)
        kw.setdefault('num_key_value_heads', 2)
        kw.setdefault('max_position_embeddings', 256)
        return cls(**kw)


_aten = torch.ops.aten
# the ops whose outputs a selective recompute policy keeps: the weight
# matmuls, and under 'dots' the batched dots as well
SAVED_OPS = {
    'dots_no_batch': frozenset({_aten.mm.default, _aten.addmm.default}),
    'dots': frozenset({_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default}),
}


def recompute_context(policy: str):
    """The `context_fn` of `torch.utils.checkpoint` for a selective
    recompute policy of `SAVED_OPS`: its ops' outputs are saved, every
    other op is rerun in the backward."""
    saved = SAVED_OPS[policy]

    def keep(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, keep)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention, in fp32. x [B, S, H, D];
    positions [S] or [B, S]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = positions.float()[..., None] * inv          # [..., S, D/2]
    while freqs.dim() < 3:
        freqs = freqs[None]
    cos = torch.cos(freqs)[:, :, None, :]                # [B, S, 1, D/2]
    sin = torch.sin(freqs)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class LlamaAttention(Layer):

    def __init__(self, config: LlamaConfig, **init):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.num_heads = config.num_attention_heads
        self.num_key_value_heads = config.num_key_value_heads
        self.head_dim = hd
        self.q_proj = _linear(h, self.num_heads * hd, init)
        self.k_proj = _linear(h, self.num_key_value_heads * hd, init)
        self.v_proj = _linear(h, self.num_key_value_heads * hd, init)
        self.o_proj = _linear(self.num_heads * hd, h, init)

    def forward(self, hidden, position_offset=None, kv_pages=None,
                table=None, floor=None, attn_mask=None, cache=None,
                cache_offset=None, kv_dtype=None):
        """Returns (output, (k, v)): k/v are this call's new rows after
        RoPE, [B, S, HKV, D], or with `cache` the updated (K, V) cache.
        `kv_dtype` is the dtype of the KV pool that a serving prefill
        writes into: the rows it attends are rounded through it first
        (`round_kv`), as the JAX forward attends the rows it wrote."""
        b, s, _ = hidden.shape
        nh, nkv, hd = self.num_heads, self.num_key_value_heads, self.head_dim
        offset = as_offset(position_offset, hidden.device)
        pos = offset_grid(offset, s)
        q = _rope(self.q_proj(hidden).view(b, s, nh, hd), pos,
                  self.config.rope_theta)
        k = _rope(self.k_proj(hidden).view(b, s, nkv, hd), pos,
                  self.config.rope_theta)
        v = self.v_proj(hidden).view(b, s, nkv, hd)
        if cache is not None:
            out, kv = attend_static(q, k, v, cache, offset, cache_offset,
                                    attn_mask)
            return self.o_proj(out.reshape(b, s, nh * hd)), kv
        if kv_pages is None:
            k, v = round_kv(k, kv_dtype), round_kv(v, kv_dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                 is_causal=True)
            return self.o_proj(out.reshape(b, s, nh * hd)), (k, v)
        out = paged_attend(q, k, v, kv_pages, table, offset, floor, kv_dtype)
        return self.o_proj(out.reshape(b, s, nh * hd)), (k, v)


class LlamaMLP(Layer):

    def __init__(self, config: LlamaConfig, **init):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, i, init)
        self.up_proj = _linear(h, i, init)
        self.down_proj = _linear(i, h, init)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(Layer):

    def __init__(self, config: LlamaConfig, **init):
        super().__init__()
        norm_init = {k: init[k] for k in ('device', 'dtype')}
        self.self_attn = LlamaAttention(config, **init)
        self.mlp = LlamaMLP(config, **init)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps,
                                       **norm_init)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **norm_init)

    def forward(self, hidden, position_offset=None, kv_pages=None,
                table=None, floor=None, attn_mask=None, cache=None,
                cache_offset=None, kv_dtype=None):
        attn_out, kv = self.self_attn(
            self.input_layernorm(hidden), position_offset=position_offset,
            kv_pages=kv_pages, table=table, floor=floor, attn_mask=attn_mask,
            cache=cache, cache_offset=cache_offset, kv_dtype=kv_dtype)
        h = hidden + attn_out
        h = h + self.mlp(self.post_attention_layernorm(h))
        return h, kv


class LlamaModel(Layer):
    """Embedding -> decoder layers -> final RMSNorm.

    Runs on `device` (default `cuda`; raises when there is no card), with
    random weights drawn on the device from `generator`."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = init_kwargs(device, dtype, generator)
        self.config = config
        self.embed_tokens = Embedding(
            config.vocab_size, config.hidden_size,
            weight_attr=I.Normal(0.0, INIT_STD), **init)
        self.layers = torch.nn.ModuleList(
            LlamaDecoderLayer(config, **init)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=init['device'], dtype=init['dtype'])

    def forward(self, input_ids, position_offset=None, kv_pages=None,
                table=None, floor=None, attention_mask=None, cache=None,
                cache_offset=None,
                kv_dtype=None) -> Tuple[torch.Tensor, List[tuple]]:
        """Returns (final hidden states, per-layer (k, v) new rows, or
        with `cache` the updated caches).

        With `config.use_recompute` and grad enabled (training, no pages)
        each layer runs under `torch.utils.checkpoint`: its activations
        (all of them, or those a policy does not keep) are dropped after
        the forward and recomputed in the backward, under the AMP policy
        the forward ran under (a backward outside `auto_cast` recomputes
        the same casts)."""
        h = self.embed_tokens(input_ids)
        mask = pad_mask(attention_mask)
        policy = self.config.use_recompute
        remat = (policy and kv_pages is None and cache is None
                 and mask is None and torch.is_grad_enabled())
        extra = ({'context_fn': recompute_context(policy)}
                 if isinstance(policy, str) else {})
        kvs = []
        for i, layer in enumerate(self.layers):
            if remat:
                h, kv = checkpoint(_amp.keep_policy(layer), h,
                                   position_offset, use_reentrant=False,
                                   **extra)
            else:
                h, kv = layer(h, position_offset=position_offset,
                              kv_pages=None if kv_pages is None
                              else kv_pages[i], table=table, floor=floor,
                              attn_mask=mask,
                              cache=None if cache is None else cache[i],
                              cache_offset=cache_offset, kv_dtype=kv_dtype)
            kvs.append(kv)
        return self.norm(h), kvs


class LlamaForCausalLM(Layer, GenerationMixin):

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.llama = LlamaModel(config, device=device, dtype=dtype,
                                generator=generator)
        self.lm_head = None if config.tie_word_embeddings else _linear(
            config.hidden_size, config.vocab_size,
            init_kwargs(device, dtype, generator))

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.llama.embed_tokens.weight.dtype

    def _logits(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        return torch.matmul(h, self.llama.embed_tokens.weight.t())

    def forward(self, input_ids, position_offset=None, kv_pages=None,
                table=None, labels=None, floor=None, attention_mask=None,
                cache=None, use_cache=False, cache_offset=None):
        """Logits [B, S, V]; see the module docstring for the modes.
        With `labels` [B, S] returns (loss, logits), the loss being the
        mean cross-entropy of every position against its label (no
        shift, as in the JAX package); with `use_cache` the updated
        caches come last ((logits, caches) or (loss, logits, caches))."""
        h, kvs = self.llama(input_ids, position_offset=position_offset,
                            kv_pages=kv_pages, table=table, floor=floor,
                            attention_mask=attention_mask, cache=cache,
                            cache_offset=cache_offset)
        logits = self._logits(h)
        out = (logits,) if labels is None else (F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size), labels.reshape(-1)),
            logits)
        if use_cache:
            out = out + (kvs,)
        return out[0] if len(out) == 1 else out

    def prefill_kv(self, input_ids, start=None, kv_pages=None, table=None,
                   floor=None, kv_dtype=None) -> List[tuple]:
        """The serving engine's prefill, without logits: the causal
        no-cache forward of a prompt from position 0, returning each
        layer's (k, v) rows [B, S, HKV, D] (after RoPE) for the page pool;
        or, with `kv_pages`, `table` [1, P] and a scalar `start` (an int or
        a 0-d tensor), the chunk forward of the module docstring, which
        writes its rows into the pages itself. `kv_dtype`: the pool's
        (compute) dtype, when it is not the model's; every row attended
        is rounded through it."""
        return self.llama(input_ids, position_offset=start,
                          kv_pages=kv_pages, table=table, floor=floor,
                          kv_dtype=kv_dtype)[1]

    def init_cache(self, batch_size: int, max_length: int, dtype=None):
        """Per-layer (K, V) zeros [batch_size, max_length, HKV, D] on the
        model's device, in `dtype`, by default the model's (the paged pool
        calls this with (num_pages, page_size)). The JAX package's default
        is float32 whatever the model's dtype; the port keeps the model's
        (ROADMAP, faults in the reference that the port does not
        share)."""
        cfg = self.config
        dt = self.dtype if dtype is None else to_torch_dtype(dtype)
        shape = (batch_size, int(max_length), cfg.num_key_value_heads,
                 cfg.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(cfg.num_hidden_layers)]

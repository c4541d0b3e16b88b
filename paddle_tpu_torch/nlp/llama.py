"""Llama (RMSNorm + SwiGLU + RoPE + GQA), counterpart of
`paddle_tpu/nlp/llama.py`, with the same `state_dict` keys and shapes.

Three forward modes:
- without pages, the whole sequence attends causally to itself through
  the flash-attention kernel (`scaled_dot_product_attention`); this is
  also the serving engine's whole prefill, which takes each layer's new
  K/V rows (`LlamaModel.forward` returns them) and scatters them into
  pages;
- with `kv_pages`, `table` and a [N] `position_offset`, each batch row is
  one decode slot whose pending token sits at `position_offset[n]`: its
  K/V rows are written into the slot's pages and it attends through the
  paged-attention kernel to positions [0, position_offset[n]];
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

A layer's `kv_pages` entry is a `generation.LayerKV` (or a plain (k, v)
pair). Over int8 pages it carries their scales: the chunk's gather
dequantizes and its touched pages are requantized whole; the decode
forward writes its row into the round's float window, which the paged
kernel reads in place of the window's int8 pages.

Training: `LlamaForCausalLM.forward(input_ids, labels=...)` returns
(loss, logits) with the loss from `F.cross_entropy` (the fused CE
kernels), and `config.use_recompute=True` recomputes each decoder layer
in the backward (`torch.utils.checkpoint`), trading one more forward of
each layer for holding only the layer inputs.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import dtype as _dtype
from ..framework import resolve_device
from ..nn import functional as F
from ..nn.common_layers import Embedding, Linear
from ..nn.layer import Layer
from ..nn.norm import RMSNorm
from ..ops import kernels
from .generation import (LayerKV, as_offset, chunk_rows, offset_grid,
                         update_kv_cache)


class LlamaConfig:
    model_type = 'llama'

    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 pad_token_id=0, bos_token_id=1, eos_token_id=2,
                 use_recompute=False, **kwargs):
        if isinstance(use_recompute, str):
            raise NotImplementedError(
                f'use_recompute={use_recompute!r}: selective recompute '
                f'policies are not ported yet (ROADMAP.md, Queue 1); use '
                f'True (whole decoder layers) or False')
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
        self.use_recompute = bool(use_recompute)
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
        self.q_proj = Linear(h, self.num_heads * hd, **init)
        self.k_proj = Linear(h, self.num_key_value_heads * hd, **init)
        self.v_proj = Linear(h, self.num_key_value_heads * hd, **init)
        self.o_proj = Linear(self.num_heads * hd, h, **init)

    def forward(self, hidden, position_offset=None, kv_pages=None,
                table=None, floor=None):
        """Returns (output, (k, v)): k/v are this call's new rows after
        RoPE, [B, S, HKV, D]."""
        b, s, _ = hidden.shape
        nh, nkv, hd = self.num_heads, self.num_key_value_heads, self.head_dim
        offset = as_offset(position_offset, hidden.device)
        pos = offset_grid(offset, s)
        q = _rope(self.q_proj(hidden).view(b, s, nh, hd), pos,
                  self.config.rope_theta)
        k = _rope(self.k_proj(hidden).view(b, s, nkv, hd), pos,
                  self.config.rope_theta)
        v = self.v_proj(hidden).view(b, s, nkv, hd)
        if kv_pages is None:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.o_proj(out.reshape(b, s, nh * hd)), (k, v)
        kv = LayerKV(*kv_pages)
        scales = None if kv.k_scales is None else (kv.k_scales, kv.v_scales)
        if offset.dim() == 0:
            if b != 1:
                raise ValueError('a paged chunk forward takes one slot')
            k_all, v_all = chunk_rows(kv.k, kv.v, k, v, table, offset, floor,
                                      scales)
            used = (offset + s).to(torch.int32).reshape(1)
            out = kernels.flash_attention_fwd(q, k_all, v_all, causal=True,
                                              seqused_k=used)
        else:
            if s != 1 or offset.dim() != 1:
                raise ValueError('the paged decode forward takes one token '
                                 'per slot and a [N] position offset')
            lengths = (offset + 1).to(torch.int32)
            if scales is None:
                update_kv_cache(kv.k, kv.v, k, v, table, offset)
                out = kernels.paged_attention(q[:, 0], kv.k, kv.v, table,
                                              lengths)
            else:
                if kv.k_win is None:
                    raise ValueError('a decode forward over int8 pages '
                                     'writes into the round\'s float window '
                                     '(serving/decode_graph.py)')
                # the new row goes into the window, never into an int8
                # page: the round's end requantizes the touched pages
                ps = kv.k.shape[1]
                n = torch.arange(b, device=offset.device)
                w = torch.div(offset, ps, rounding_mode='floor') - \
                    kv.win_first
                kv.k_win[n, w, offset % ps] = k[:, 0].to(kv.k_win.dtype)
                kv.v_win[n, w, offset % ps] = v[:, 0].to(kv.v_win.dtype)
                out = kernels.paged_attention(
                    q[:, 0], kv.k, kv.v, table, lengths,
                    k_scales=kv.k_scales, v_scales=kv.v_scales,
                    k_win=kv.k_win, v_win=kv.v_win, win_first=kv.win_first)
            out = out[:, None]
        return self.o_proj(out.reshape(b, s, nh * hd)), (k, v)


class LlamaMLP(Layer):

    def __init__(self, config: LlamaConfig, **init):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, **init)
        self.up_proj = Linear(h, i, **init)
        self.down_proj = Linear(i, h, **init)

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
                table=None, floor=None):
        attn_out, kv = self.self_attn(
            self.input_layernorm(hidden), position_offset=position_offset,
            kv_pages=kv_pages, table=table, floor=floor)
        h = hidden + attn_out
        h = h + self.mlp(self.post_attention_layernorm(h))
        return h, kv


def _init_kwargs(device, dtype, generator):
    return {'device': resolve_device(device),
            'dtype': _dtype.to_torch_dtype(dtype), 'generator': generator}


class LlamaModel(Layer):
    """Embedding -> decoder layers -> final RMSNorm.

    Runs on `device` (default `cuda`; raises when there is no card), with
    random weights drawn on the device from `generator`."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = _init_kwargs(device, dtype, generator)
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **init)
        self.layers = torch.nn.ModuleList(
            LlamaDecoderLayer(config, **init)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            device=init['device'], dtype=init['dtype'])

    def forward(self, input_ids, position_offset=None, kv_pages=None,
                table=None, floor=None) -> Tuple[torch.Tensor, List[tuple]]:
        """Returns (final hidden states, per-layer (k, v) new rows).

        With `config.use_recompute` and grad enabled (training, no pages)
        each layer runs under `torch.utils.checkpoint`: its activations
        are dropped after the forward and recomputed in the backward."""
        h = self.embed_tokens(input_ids)
        remat = (self.config.use_recompute and kv_pages is None
                 and torch.is_grad_enabled())
        kvs = []
        for i, layer in enumerate(self.layers):
            if remat:
                h, kv = checkpoint(layer, h, position_offset,
                                   use_reentrant=False)
            else:
                h, kv = layer(h, position_offset=position_offset,
                              kv_pages=None if kv_pages is None
                              else kv_pages[i], table=table, floor=floor)
            kvs.append(kv)
        return self.norm(h), kvs


class LlamaForCausalLM(Layer):

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype='float32',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.tie_word_embeddings:
            raise ValueError('tied word embeddings are not ported yet')
        self.config = config
        self.llama = LlamaModel(config, device=device, dtype=dtype,
                                generator=generator)
        emb = self.llama.embed_tokens.weight
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              device=emb.device, dtype=emb.dtype,
                              generator=generator)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.llama.embed_tokens.weight.dtype

    def forward(self, input_ids, position_offset=None, kv_pages=None,
                table=None, labels=None, floor=None):
        """Logits [B, S, V]; see the module docstring for the three modes.
        With `labels` [B, S] returns (loss, logits), the loss being the
        mean cross-entropy of every position against its label (no
        shift, as in the JAX package)."""
        h, _ = self.llama(input_ids, position_offset=position_offset,
                          kv_pages=kv_pages, table=table, floor=floor)
        logits = self.lm_head(h)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))
        return loss, logits

    def prefill_kv(self, input_ids, start=None, kv_pages=None, table=None,
                   floor=None) -> List[tuple]:
        """The serving engine's prefill, without logits: the causal
        no-cache forward of a prompt from position 0, returning each
        layer's (k, v) rows [B, S, HKV, D] (after RoPE) for the page pool;
        or, with `kv_pages`, `table` [1, P] and a scalar `start` (an int or
        a 0-d tensor), the chunk forward of the module docstring, which
        writes its rows into the pages itself."""
        return self.llama(input_ids, position_offset=start,
                          kv_pages=kv_pages, table=table, floor=floor)[1]

    def init_cache(self, batch_size: int, max_length: int):
        """Per-layer (K, V) zeros [batch_size, max_length, HKV, D] on the
        model's device and in its dtype (the paged pool calls this with
        (num_pages, page_size))."""
        cfg = self.config
        shape = (batch_size, int(max_length), cfg.num_key_value_heads,
                 cfg.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in range(cfg.num_hidden_layers)]

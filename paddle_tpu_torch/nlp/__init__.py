from .generation import (as_offset, cached_forward, decode_mask,
                         offset_grid, update_kv_cache)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)

__all__ = ['as_offset', 'cached_forward', 'decode_mask', 'offset_grid',
           'update_kv_cache', 'LlamaAttention', 'LlamaConfig',
           'LlamaDecoderLayer', 'LlamaForCausalLM', 'LlamaMLP', 'LlamaModel']

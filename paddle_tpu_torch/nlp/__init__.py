from .generation import (as_offset, cached_forward, chunk_forward,
                         chunk_rows, decode_mask, gather_rows, offset_grid,
                         update_kv_cache)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)

__all__ = ['as_offset', 'cached_forward', 'chunk_forward', 'chunk_rows',
           'decode_mask', 'gather_rows', 'offset_grid', 'update_kv_cache',
           'LlamaAttention', 'LlamaConfig', 'LlamaDecoderLayer',
           'LlamaForCausalLM', 'LlamaMLP', 'LlamaModel']

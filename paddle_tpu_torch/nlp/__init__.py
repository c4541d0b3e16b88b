"""The port's model zoo and generation (counterpart of
`paddle_tpu/nlp`): Llama, GPT, BERT and ERNIE, `GenerationMixin`, and
the decode helpers the serving engine shares. The `transformers`
submodule mirrors the reference's import path
(`from paddlenlp.transformers import GPTForCausalLM`). T5 with
`Seq2SeqGenerationMixin` and the tokenizers are not ported yet (ROADMAP,
Queue 1)."""
from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel)
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel)
from .generation import (GenerationMixin, as_offset, cached_forward,
                         chunk_forward, chunk_rows, decode_mask, gather_rows,
                         offset_grid, padded_decode_mask, update_kv_cache,
                         update_static_cache)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)

from . import transformers  # noqa: E402  (the import-path alias module)

__all__ = ['as_offset', 'cached_forward', 'chunk_forward', 'chunk_rows',
           'decode_mask', 'gather_rows', 'offset_grid', 'padded_decode_mask',
           'update_kv_cache', 'update_static_cache',
           'BertConfig', 'BertForMaskedLM', 'BertForSequenceClassification',
           'BertModel', 'ErnieConfig', 'ErnieForMaskedLM',
           'ErnieForSequenceClassification', 'ErnieModel', 'GenerationMixin',
           'GPTConfig', 'GPTForCausalLM', 'GPTModel',
           'LlamaAttention', 'LlamaConfig', 'LlamaDecoderLayer',
           'LlamaForCausalLM', 'LlamaMLP', 'LlamaModel', 'transformers']

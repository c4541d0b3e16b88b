"""The port's model zoo, generation and tokenizers (counterpart of
`paddle_tpu/nlp`): Llama, GPT, BERT, ERNIE and T5, `GenerationMixin`
and `Seq2SeqGenerationMixin`, the decode helpers the serving engine
shares, and the offline tokenizers (`BPETokenizer`,
`WhitespaceTokenizer`, and `fast_tokenizer.FastBPETokenizer` over host
C++). The `transformers` submodule mirrors the reference's import path
(`from paddlenlp.transformers import T5ForConditionalGeneration`)."""
from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification, BertModel)
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel)
from .generation import (GenerationMixin, Seq2SeqGenerationMixin, as_offset,
                         cached_forward, chunk_forward, chunk_rows,
                         decode_mask, gather_rows, offset_grid,
                         padded_decode_mask, update_kv_cache,
                         update_static_cache)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)
from .t5 import T5Config, T5ForConditionalGeneration, T5Model
from .tokenizer import BPETokenizer, PretrainedTokenizer, WhitespaceTokenizer

from . import transformers  # noqa: E402  (the import-path alias module)

__all__ = ['as_offset', 'cached_forward', 'chunk_forward', 'chunk_rows',
           'decode_mask', 'gather_rows', 'offset_grid', 'padded_decode_mask',
           'update_kv_cache', 'update_static_cache',
           'BertConfig', 'BertForMaskedLM', 'BertForSequenceClassification',
           'BertModel', 'BPETokenizer', 'ErnieConfig', 'ErnieForMaskedLM',
           'ErnieForSequenceClassification', 'ErnieModel', 'GenerationMixin',
           'GPTConfig', 'GPTForCausalLM', 'GPTModel',
           'LlamaAttention', 'LlamaConfig', 'LlamaDecoderLayer',
           'LlamaForCausalLM', 'LlamaMLP', 'LlamaModel', 'PretrainedTokenizer',
           'Seq2SeqGenerationMixin', 'T5Config', 'T5ForConditionalGeneration',
           'T5Model', 'WhitespaceTokenizer', 'transformers']

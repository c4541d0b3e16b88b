"""The prefill over static device buffers, replayed from one captured
CUDA graph per (kind, bucket) on the card (the port's counterpart of the
JAX engine's compiled `paged_prefill_<b>` and `paged_chunk_prefill_<b>`
programs, `paddle_tpu/serving/engine.py:394-402` and `_paged_prefill_fn`
/ `_paged_chunk_prefill_fn` at :743-790, and of the row engine's
`prefill_<b>` and `chunk_prefill_<b>`, `_prefill_fn` /
`_chunk_prefill_fn` at :570-608, each traced once per bucket). A row
pool is read and written through its identity page table
(`kv_pool.SlotPool`), so the bodies serve both layouts.

`PrefillStep` keeps every input of one prefill in a buffer allocated
once per (kind, bucket): the right-padded prompt ids [1, bucket], the
slot's page table row [1, P], for a chunk its start and floor (0-d), and
with an adapter bank the slot's bank row [1]. A call refills them with
`copy_` from pinned host staging, then `run_once()` replays the graph
(or, uncaptured, runs the body).

The bodies:
- `whole`: the causal no-cache forward of the bucket (`prefill_kv`), its
  per-layer K/V slab scattered into the slot's pages from row 0 (pad
  rows past the reservation land on the null page); over int8 pages
  each page the bucket touches is quantized whole from the slab's rows
  and zeros past the bucket, as the JAX prefill writes it from a zero
  slab, so rows an earlier occupant left in the page never reach its
  scale;
- `draft`: a speculating engine's draft prefill (the JAX
  `_draft_prefill_fn`): the draft model's causal no-cache forward of the
  bucket, its K/V rows followed by zeros up to the slot's length written
  through the slot's identity table row into the draft's row pool
  (`kv_pool.SlotPool`), a whole-row replace;
- `chunk`: the chunk forward of `nlp.generation.chunk_rows`: per layer,
  the slot's whole table row gathered into a fixed-shape buffer, the
  chunk's fresh rows written into it at [start, start + bucket) and
  into the pages above `floor`, and the causal flash kernel over the
  buffer with the key count start + bucket read from device memory. No
  host value depends on the start, so one graph serves every start.
  Over int8 pages the gather dequantizes and the touched pages above
  the floor are requantized whole from the gathered row.

Capture, on a CUDA device, is `GraphStep.capture`: a warm-up over zeroed
buffers (every write lands on the null page 0) on a side stream, then
`torch.cuda.graph` on that stream under `torch.inference_mode()` and,
with a bank, inside `adapter_scope` over the bank's packed tensors and
the static row. Every prefill graph of an engine allocates from one
memory pool: their only outputs are in-place page writes, and they
replay in turn on one stream, so what one graph leaves in the pool no
other reads. A failed capture or replay raises; nothing falls back to
the uncaptured body on the card. On the CPU nothing is captured and the
same body runs directly.
"""
from __future__ import annotations

import torch

from .adapters.apply import adapter_scope
from .decode_graph import GraphStep
from .kv_pool import pad_rows, scatter_pages

KINDS = ('whole', 'chunk', 'draft')


class PrefillStep(GraphStep):
    """One engine's prefill of `kind` ('whole', 'chunk' or 'draft') at
    `bucket` tokens over static buffers on `device`.

    Args:
        model: the engine's model (`prefill_kv`), or for 'draft' its
            draft model.
        pages: the pool's per-layer (k_pages, v_pages), updated in place
            (for 'draft' the draft's `SlotPool.pages`).
        table_width: P, the page table's width.
        adapter_arrays: `AdapterBank.device_arrays()`, or None without a
            bank.
        scales: the int8 pool's per-layer (k_scales, v_scales), or None.
        paged: False for a row engine's pool (`kv_pool.SlotPool`, read
            through its identity table): the bodies are the same, only
            the names are the JAX row engine's (`prefill_<b>`,
            `chunk_prefill_<b>`).
        kv_dtype: the pool's compute dtype (`compute_dtype`), which may
            differ from the model's: the forward attends its rows
            rounded through it (`prefill_kv(kv_dtype=)`).
    """

    def __init__(self, kind: str, bucket: int, model, pages,
                 table_width: int, device: torch.device,
                 adapter_arrays=None, scales=None, paged: bool = True,
                 kv_dtype=None):
        if kind not in KINDS:
            raise ValueError(f'prefill kind {kind!r} is not one of {KINDS}')
        self.kind, self.bucket = kind, int(bucket)
        self.what = f'{kind} prefill at bucket {self.bucket}'
        # the JAX engine's trace names (engine.py:581, 600, 613, 751, 776)
        self.name = ('paged_' if paged and kind != 'draft' else '') + {
            'whole': 'prefill', 'chunk': 'chunk_prefill',
            'draft': 'draft_prefill'}[kind] + f'_{self.bucket}'
        self._rows = table_width * pages[0][0].shape[1]
        self._model = model
        self._pages = pages
        self._scales = scales
        self._kv_dtype = kv_dtype
        self._arrays = adapter_arrays
        spec = {'ids': ((1, self.bucket), torch.int64),
                'table': ((1, table_width), torch.int32)}
        if kind == 'chunk':
            spec['start'] = ((), torch.int64)
            spec['floor'] = ((), torch.int64)
        if adapter_arrays is not None:
            spec['rows'] = ((1,), torch.int32)
        super().__init__(spec, device)
        self._zero = torch.zeros(1, dtype=torch.int64, device=device)

    def _body(self) -> None:
        b = self.buf
        with adapter_scope(self._arrays, b.get('rows')):
            if self.kind == 'chunk':
                layers = (self._pages if self._scales is None else
                          [kv + sc for kv, sc in zip(self._pages,
                                                     self._scales)])
                self._model.prefill_kv(b['ids'], start=b['start'],
                                       kv_pages=layers,
                                       table=b['table'], floor=b['floor'],
                                       kv_dtype=self._kv_dtype)
            elif self.kind == 'draft':
                scatter_pages(self._pages, b['table'], pad_rows(
                    self._model.prefill_kv(b['ids'], kv_dtype=self._kv_dtype),
                    self._rows), self._zero)
            else:
                scatter_pages(self._pages, b['table'],
                              self._model.prefill_kv(
                                  b['ids'], kv_dtype=self._kv_dtype),
                              self._zero, scales=self._scales)

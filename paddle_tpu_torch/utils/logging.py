"""Metric logging (counterpart of `paddle_tpu/utils/logging.py`; upstream
analogue: VisualDL's LogWriter, here a JSONL metric log plus a
VisualDL-compatible surface), copied: `hapi.callbacks.VisualDL` writes
through it the records the JAX callback writes.

`SummaryWriter.add_scalar(tag, value, step)` appends one JSON line per
record; `read_jsonl` loads a log back for tooling/tests. Deliberately
plain-file so multi-host pods can write per-host logs with no daemon.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional


class SummaryWriter:
    def __init__(self, logdir: str, filename_suffix: str = ''):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(
            logdir, f'metrics{filename_suffix}.jsonl')
        self._fh = open(self._path, 'a', buffering=1)

    def add_scalar(self, tag: str, value, step: Optional[int] = None,
                   walltime: Optional[float] = None):
        rec = {'tag': tag, 'value': float(value), 'step': step,
               'time': walltime if walltime is not None else time.time()}
        self._fh.write(json.dumps(rec) + '\n')

    def add_scalars(self, main_tag: str, tag_value_dict: Dict[str, Any],
                    step: Optional[int] = None):
        for k, v in tag_value_dict.items():
            self.add_scalar(f'{main_tag}/{k}', v, step)

    def add_text(self, tag: str, text: str, step: Optional[int] = None):
        rec = {'tag': tag, 'text': str(text), 'step': step,
               'time': time.time()}
        self._fh.write(json.dumps(rec) + '\n')

    def add_hparams(self, hparams: Dict[str, Any],
                    metrics: Optional[Dict[str, Any]] = None):
        self.add_text('hparams', json.dumps(
            {'hparams': hparams, 'metrics': metrics or {}}))

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


LogWriter = SummaryWriter  # VisualDL parity alias


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def scalars(path_or_dir: str, tag: str) -> Iterator[Dict[str, Any]]:
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, 'metrics.jsonl')
    for rec in read_jsonl(path):
        if rec.get('tag') == tag:
            yield rec


__all__ = ['LogWriter', 'SummaryWriter', 'read_jsonl', 'scalars']

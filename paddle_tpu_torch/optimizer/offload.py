"""Host-offloaded optimizer state (counterpart of
`paddle_tpu/optimizer/offload.py`, `OffloadEngine`; upstream: fleet
sharding's `offload=True`).

Adam's slots (m, v, amsgrad's running max, fp32 masters) live in pinned
host memory, allocated once at the first update: one flat pinned buffer
per slot name, each parameter's slot a view of it, 64 elements aligned.
Each update streams the slots through a ring of two device buffers of
`chunk` elements per slot name:

- the copy stream `h2d` copies a group's host range into a ring slot
  once the `d2h` copy of that ring slot's previous group has finished
  (which also orders this step's read of a host range after last step's
  write of it);
- the caller's stream waits for that copy, then runs the port's
  `multi_tensor_adam` kernel over the group's pieces (each parameter is
  cut into pieces of at most `chunk` elements; small ones share a
  group), in place on the parameters and the ring;
- the copy stream `d2h` waits for the kernel and copies the ring slot
  back into the host range.

Streams are ordered by events only; nothing waits on the host. The group
of leaf i + 1 is copied in while leaf i updates, as the JAX engine's
prefetch does. Adam is elementwise, so pieces and groups give the bits
of the in-HBM update (the same kernel on the same values). HBM holds the
parameters, the grads and the ring: for Llama-2-7B width at 16 layers
and bf16 moments, 13.9 GB of slots stay on the host.

`settle()` waits on the host for the last copies back; the optimizer's
`state_dict`, `set_state_dict` and a snapshot call it before they touch
the host slots. The global-norm clip's scale is computed by the caller
over all grads (`multi_tensor_sumsq`) before the first group.

`paddle_offload_h2d_bytes_total` and `paddle_offload_d2h_bytes_total`
count the slot bytes of every parameter with a grad, per update, as the
JAX engine's `_note_transfer` does (the ring copies also move the
alignment gaps, which are not counted).

On the CPU the same code runs with host tensors for the ring: the copies
are host-to-host and the kernel's plain version updates, as the JAX
engine degrades to a host-to-host stream there. On the card pinning
never falls back: a failed pinned allocation raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .. import observability as _obs
from ..ops import kernels as K

ALIGN = 64                  # elements: 128 bytes for bf16, 256 for fp32
CHUNK = 1 << 25             # elements per ring slot and slot name


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _note_transfer(direction: str, nbytes: int) -> None:
    """H2D/D2H ledger of the streamed slots (no-op while observability
    is off)."""
    if not _obs.enabled() or not nbytes:
        return
    _obs.get_registry().counter(
        f'paddle_offload_{direction}_bytes_total',
        f'optimizer-slot {direction.upper()} transfer bytes').inc(nbytes)


class OffloadEngine:
    """Streams Adam/AdamW's update through HBM while its slots persist in
    pinned host memory. Built by `Adam(offload='host')`; `update` is
    called from the optimizer's `update`."""

    def __init__(self, optimizer, chunk: int = CHUNK):
        if chunk % ALIGN:
            raise ValueError(f'chunk must be a multiple of {ALIGN}')
        self.opt = optimizer
        self.chunk = int(chunk)
        self.device: Optional[torch.device] = None
        self._offsets: Dict[torch.Tensor, int] = {}
        self._host: Dict[str, torch.Tensor] = {}
        self._ring: List[Dict[str, torch.Tensor]] = []
        self._streams: Optional[Tuple] = None
        self._done: List[Optional[object]] = [None, None]

    # -- state ------------------------------------------------------------
    @property
    def initialized(self) -> bool:
        return bool(self._host)

    def _slot_dtypes(self, params) -> Dict[str, torch.dtype]:
        """{slot name: dtype} of the optimizer's slots for `params`."""
        opt = self.opt
        names = {'moment1': opt._moment_dtype, 'moment2': opt._moment_dtype}
        if opt._amsgrad:
            names['moment2_max'] = opt._moment_dtype
        if opt._multi_precision and any(p.dtype in (torch.bfloat16,
                                                    torch.float16)
                                        for p in params):
            names['master'] = torch.float32
        return names

    def init(self, params: List[torch.Tensor]) -> None:
        """Allocate every slot of `params` once: pinned host buffers (CPU
        ones on the CPU), moments zero, masters a copy of the fp32
        parameters; and the device ring. Fills `opt._slots`."""
        devices = {p.device for p in params}
        if len(devices) != 1:
            raise ValueError(f'offload: parameters on several devices '
                             f'{sorted(map(str, devices))}')
        self.device = devices.pop()
        on_card = self.device.type == 'cuda'
        total = 0
        for p in params:
            self._offsets[p] = total
            total += _round_up(p.numel(), ALIGN)
        dtypes = self._slot_dtypes(params)
        for name, dt in dtypes.items():
            self._host[name] = torch.zeros(total, dtype=dt,
                                           pin_memory=on_card)
        low = (torch.bfloat16, torch.float16)
        for p in params:
            off, n = self._offsets[p], p.numel()
            slots = {name: buf[off:off + n].view(p.shape)
                     for name, buf in self._host.items()
                     if name != 'master'}
            if 'master' in self._host and p.dtype in low:
                slots['master'] = self._host['master'][off:off + n] \
                    .view(p.shape)
                slots['master'].copy_(p.detach().float())
            self.opt._slots[p] = slots
        width = min(self.chunk, _round_up(max(total, 1), ALIGN))
        self._ring = [{name: torch.empty(width, dtype=dt, device=self.device)
                       for name, dt in dtypes.items()} for _ in range(2)]
        if on_card:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
            for ring in self._ring:
                for buf in ring.values():
                    for s in self._streams:
                        buf.record_stream(s)

    def reset(self) -> None:
        """Back to the state before the first update, in the same
        buffers: moments zero, masters the parameters' values."""
        self.settle()
        for name, buf in self._host.items():
            if name != 'master':
                buf.zero_()
        for p, slots in self.opt._slots.items():
            if 'master' in slots:
                slots['master'].copy_(p.detach().float())

    def settle(self) -> None:
        """Wait on the host until the last update's slots are back on
        the host."""
        for ev in self._done:
            if ev is not None:
                ev.synchronize()

    # -- the plan ---------------------------------------------------------
    def _groups(self, params) -> List[Tuple[int, int, list]]:
        """[(flat start, flat end, [(param index, piece start, piece
        end)])]: each parameter cut into pieces of at most `chunk`
        elements at ALIGN boundaries, consecutive pieces grouped while
        their flat span fits one ring slot."""
        groups, cur, start = [], [], None
        for i in sorted(range(len(params)),
                        key=lambda j: self._offsets[params[j]]):
            off, n = self._offsets[params[i]], params[i].numel()
            for a in range(0, n, self.chunk):
                b = min(a + self.chunk, n)
                lo, hi = off + a, off + b
                if cur and hi - start > self.chunk:
                    groups.append((start, self._end(cur, params), cur))
                    cur = []
                if not cur:
                    start = lo
                cur.append((i, a, b))
        if cur:
            groups.append((start, self._end(cur, params), cur))
        return groups

    def _end(self, pieces, params) -> int:
        i, _, b = pieces[-1]
        return self._offsets[params[i]] + b

    # -- the update -------------------------------------------------------
    @torch.no_grad()
    def update(self, params, grads, decay, *, lr_t, decay_mode,
               clip_scale=None) -> None:
        """One Adam/AdamW step of `params` (with their `grads` and fp32
        `decay` coefficients, as `multi_tensor_adam` takes them), the
        slots streamed from the host and back."""
        if not self.initialized:
            self.init(list(params))
        missing = [i for i, p in enumerate(params) if p not in self._offsets]
        if missing:
            raise ValueError(f'offload: parameter {missing[0]} was not '
                             f'given at the first update')
        opt = self.opt
        names = list(self._host)
        on_card = self._streams is not None
        if on_card:
            h2d, d2h = self._streams
            compute = torch.cuda.current_stream(self.device)
        moved = sum(p.numel() * self._host[k].element_size()
                    for p in params for k in names
                    if k in opt._slots[p])
        for g_idx, (s, e, pieces) in enumerate(self._groups(params)):
            ring = self._ring[g_idx % 2]
            if on_card:
                ready = self._done[g_idx % 2]
                if ready is not None:
                    h2d.wait_event(ready)
                with torch.cuda.stream(h2d):
                    for k in names:
                        ring[k][:e - s].copy_(self._host[k][s:e],
                                              non_blocking=True)
                compute.wait_stream(h2d)
            else:
                for k in names:
                    ring[k][:e - s].copy_(self._host[k][s:e])
            ps, gs, ms, vs, masters, vmax, coeffs = [], [], [], [], [], [], []
            for i, a, b in pieces:
                p = params[i]
                at = self._offsets[p] + a - s
                ps.append(p.view(-1)[a:b])
                gs.append(grads[i].reshape(-1)[a:b])
                ms.append(ring['moment1'][at:at + b - a])
                vs.append(ring['moment2'][at:at + b - a])
                vmax.append(ring['moment2_max'][at:at + b - a]
                            if opt._amsgrad else None)
                masters.append(ring['master'][at:at + b - a]
                               if 'master' in opt._slots[p] else None)
                coeffs.append(decay[i])
            K.multi_tensor_adam(
                ps, gs, ms, vs, masters, vmax if opt._amsgrad else None,
                lr_t=lr_t, beta1=opt._beta1, beta2=opt._beta2,
                epsilon=opt._epsilon, decay=coeffs, decay_mode=decay_mode,
                clip_scale=clip_scale)
            if on_card:
                d2h.wait_stream(compute)
                with torch.cuda.stream(d2h):
                    for k in names:
                        self._host[k][s:e].copy_(ring[k][:e - s],
                                                 non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(d2h)
                self._done[g_idx % 2] = done
            else:
                for k in names:
                    self._host[k][s:e].copy_(ring[k][:e - s])
        _note_transfer('h2d', moved)
        _note_transfer('d2h', moved)


__all__ = ['OffloadEngine']

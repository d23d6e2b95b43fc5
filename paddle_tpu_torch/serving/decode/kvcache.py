"""Paged KV cache: bucketed per-slot pages over preallocated device pools
(counterpart of paddle_tpu/serving/decode/kvcache.py).

Why pages: continuous batching admits and evicts sequences of wildly
different lengths between decode steps. A dense ``[max_slots, max_len]``
cache wastes HBM on short sequences; reallocating per-sequence buffers
recompiles (new shapes) and fragments. Instead each layer owns ONE device
array ``[num_pages, page_len, num_kv_heads, head_dim]`` allocated once,
and a sequence's KV lives in whichever pages the host-side allocator
handed it. Admit/evict is pure host bookkeeping — the device arrays never
change shape, so slot churn never creates a new step signature.

The step sees pages through a ``[B, P]`` int32 page table (physical
page ids per slot, P a bucketed width from ``bucketing.page_buckets``):
reads gather ``pool[page_table]`` into a ``[B, P*page_len, ...]`` view,
writes scatter this step's K/V rows at ``(page, offset)`` computed from
each slot's position. One step signature exists per (batch bucket,
page bucket) pair — the bound the scheduler's bucket sets enforce.

paddle_tpu's step returns new pools and donates the old ones back on
the TPU so the cache updates in place. The port's counterpart of that
donation is a plain in-place ``index_put_`` on the pools, run under
``torch.inference_mode()`` by the engine: no pool is ever copied.

Page 0 is a reserved scratch page: inactive batch rows and padded table
entries point at it, so their (masked, never-read) writes can't corrupt a
live sequence. Inactive rows all write to that one page, so its indices
repeat within a write; which duplicate lands is unspecified and does not
matter, because those rows are never read unmasked.
"""
from __future__ import annotations

import math
from collections import deque
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..batcher import ServingError

__all__ = ["PagesExhausted", "PageAllocator", "init_paged_cache",
           "pages_for", "PagedKV", "page_table_array", "SCRATCH_PAGE"]

SCRATCH_PAGE = 0


class PagesExhausted(ServingError):
    """The page pool has no free page. The scheduler catches this and
    preempts (or refuses admission) instead of corrupting the pool."""


def pages_for(tokens: int, page_len: int) -> int:
    """Pages needed to hold ``tokens`` cache rows."""
    return max(1, math.ceil(tokens / page_len))


class PageAllocator:
    """Host-side free list over the physical pages of one pool.

    Not thread-safe by itself — the engine's single scheduler thread is
    the only caller (admission, growth, and eviction all happen between
    decode steps on that thread)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page {SCRATCH_PAGE} is the "
                f"reserved scratch page), got {num_pages}")
        self.num_pages = int(num_pages)
        self._free = deque(range(1, self.num_pages))

    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages or raise PagesExhausted taking none."""
        if n > len(self._free):
            raise PagesExhausted(
                f"need {n} KV pages, {len(self._free)} free "
                f"(pool: {self.num_pages - 1} usable)")
        return [self._free.popleft() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"freeing invalid page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


def init_paged_cache(num_layers: int, num_pages: int, page_len: int,
                     num_kv_heads: int, head_dim: int,
                     dtype: torch.dtype = torch.float32, device=None
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer (pool_k, pool_v) tensors
    ``[num_pages, page_len, Hkv, D]`` on ``device`` (default ``cuda``),
    allocated once at server start."""
    dev = resolve_device(device)
    shape = (num_pages, page_len, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(num_layers)]


class PagedKV:
    """kv_ops implementation over page pools (models/decode.py protocol).

    Built once per step around that step's ``[B, P]`` page table, so one
    instance serves every layer of the step. ``update`` writes this
    step's K/V rows into the pools in place and returns the gathered
    ``[B, P*page_len, Hkv, D]`` view to attend over; the caller masks by
    position, so stale rows in owned pages and the scratch page's
    garbage are never visible."""

    def __init__(self, page_rows, page_len: int, device=None):
        if device is None and isinstance(page_rows, torch.Tensor):
            device = page_rows.device
        self.page_rows = torch.as_tensor(
            page_rows, device=resolve_device(device)).long()
        self.page_len = int(page_len)

    def update(self, layer_idx, cache, k_new, v_new, positions):
        del layer_idx
        pk, pv = cache
        rows = self.page_rows
        b, s = k_new.shape[0], k_new.shape[1]
        tp = positions.long()[:, None] + torch.arange(
            s, device=rows.device)                                  # [B,S]
        phys = torch.gather(rows, 1, tp // self.page_len)           # [B,S]
        off = tp % self.page_len
        pk.index_put_((phys, off), k_new.to(pk.dtype))
        pv.index_put_((phys, off), v_new.to(pv.dtype))
        gk = pk[rows].reshape(b, -1, pk.shape[2], pk.shape[3])
        gv = pv[rows].reshape(b, -1, pv.shape[2], pv.shape[3])
        return gk, gv, (pk, pv)


def page_table_array(page_lists: Sequence[Sequence[int]], width: int
                     ) -> np.ndarray:
    """Host-side [B, width] int32 page table: each slot's pages padded
    with the scratch page. A slot's real positions never index into the
    padding (its pages cover its length), so scratch rows are read only
    under the position mask."""
    out = np.full((len(page_lists), width), SCRATCH_PAGE, dtype=np.int32)
    for i, pages in enumerate(page_lists):
        if len(pages) > width:
            raise ValueError(
                f"slot {i} holds {len(pages)} pages > table width {width}")
        out[i, :len(pages)] = pages
    return out

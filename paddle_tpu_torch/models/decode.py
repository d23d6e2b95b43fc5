"""Shared autoregressive-decode helpers (counterpart of
paddle_tpu/models/decode.py).

The models' ``decode_step`` is written against a one-method cache
protocol, so the same model code serves two cache layouts::

    kv_ops.update(layer_idx, cache_layer, k_new, v_new, positions)
        -> (k_all, v_all, new_cache_layer)

``k_new``/``v_new`` are this step's ``[B, S, Hkv, D]`` entries,
``positions`` the ``[B]`` write start of each slot, and ``k_all``/
``v_all`` ``[B, T, Hkv, D]`` views covering every written position.
Entries past a slot's length may be garbage: ``decode_attention`` masks
by position, never by buffer extent.

- ``ContiguousKV`` (here): one dense ``[B, T, Hkv, D]`` pair per layer;
  the plain ``use_cache`` path and the parity oracle.
- ``serving.decode.kvcache.PagedKV``: pages gathered through a page
  table, the continuous-batching server's layout.

paddle_tpu's arrays are immutable, so its caches come back as new
arrays (donated on the TPU). Here the caches are written in place and
the same tensors are returned.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device

__all__ = ["ContiguousKV", "init_contiguous_cache", "decode_attention",
           "apply_rope_at"]


def init_contiguous_cache(num_layers: int, batch: int, max_len: int,
                          num_kv_heads: int, head_dim: int,
                          dtype: torch.dtype = torch.float32, device=None):
    """Per-layer ``(k, v)`` zero caches ``[B, T, Hkv, D]``."""
    dev = resolve_device(device)
    shape = (batch, max_len, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(num_layers)]


def _slot_positions(positions: torch.Tensor, s: int) -> torch.Tensor:
    """[B, S] absolute positions ``positions[b] + i``."""
    return positions.long()[:, None] + torch.arange(
        s, device=positions.device)


class ContiguousKV:
    """Dense per-layer cache; each slot writes its ``S`` new rows at its
    own position (one indexed write for the whole batch)."""

    def update(self, layer_idx, cache, k_new, v_new, positions):
        del layer_idx
        ck, cv = cache
        b, s = k_new.shape[0], k_new.shape[1]
        rows = torch.arange(b, device=ck.device)[:, None].expand(b, s)
        cols = _slot_positions(positions, s)
        ck[rows, cols] = k_new.to(ck.dtype)
        cv[rows, cols] = v_new.to(cv.dtype)
        return ck, cv, (ck, cv)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Length-masked attention of ``S`` query tokens over a ``T``-long
    cached prefix.

    ``q``: [B, S, H, D]; ``k``/``v``: [B, T, Hkv, D] (GQA when
    ``Hkv < H``: each kv head repeats ``H // Hkv`` times, adjacent);
    ``positions``: [B] absolute position of each slot's first query.
    Query ``i`` attends keys ``j <= positions + i``, which hides
    right-padded prefill rows and stale cache contents. Returns
    [B, S, H, D]."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        rep = h // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(d)
    qpos = _slot_positions(positions, s)                          # [B,S]
    mask = torch.arange(t, device=q.device)[None, None, :] \
        <= qpos[:, :, None]                                       # [B,S,T]
    scores = scores.masked_fill(~mask[:, None, :, :],
                                torch.finfo(scores.dtype).min)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v)


def apply_rope_at(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, positions: torch.Tensor):
    """RoPE at per-slot absolute positions, rotating interleaved pairs
    ``(x[..., 0::2], x[..., 1::2])``. ``q``/``k``: [B, S, H(kv), D];
    ``cos``/``sin``: [max_len, D/2]; ``positions``: [B]."""
    idx = _slot_positions(positions, q.shape[1])                  # [B,S]
    c = cos[idx][:, :, None, :]                                   # [B,S,1,D/2]
    sn = sin[idx][:, :, None, :]

    def rot(x):
        x1, x2 = x[..., 0::2], x[..., 1::2]
        o1 = x1 * c - x2 * sn
        o2 = x2 * c + x1 * sn
        return torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return rot(q), rot(k)

"""Attention functionals (counterpart of
paddle_tpu/nn/functional/flash_attention.py).

q/k/v are ``[batch, seq, heads, head_dim]`` (the reference's flash-attn
contract); GQA (fewer kv heads than q heads) is native. CUDA tensors go
to the hand-written flash-attention kernels, CPU tensors to their plain
versions (``ops/kernels/flash_attention.py``); both are differentiable.
``is_causal`` / ``causal`` uses the reference's bottom-right diagonal
(key ``j`` visible to query ``i`` iff ``j <= i + Sk - Sq``).

Dropout seeds are int32 values drawn from the caller's
``torch.Generator`` on the tensors' device (a draw with no generator
raises). An additive ``attn_mask`` rides into the kernels as their bias
(a broadcast view, never materialised), and ``flash_attn_unpadded``'s
packed sequences as segment words masked inside the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.kernels.flash_attention import flash_attention_ext

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention"]


def _draw_seed(generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """One int32 dropout seed on ``device``, drawn from ``generator``."""
    if generator is None:
        raise ValueError("attention dropout needs an explicit "
                         "torch.Generator")
    return torch.randint(-2 ** 31, 2 ** 31, (1,), generator=generator,
                         dtype=torch.int32, device=device)


def _attention(q, k, v, causal: bool, rate: float,
               generator: Optional[torch.Generator], bias=None,
               q_seg=None, k_seg=None, scale=None) -> torch.Tensor:
    seed = _draw_seed(generator, q.device) if rate > 0.0 else None
    return flash_attention_ext(q, k, v, bias=bias, seed=seed, q_seg=q_seg,
                               k_seg=k_seg, causal=causal, scale=scale,
                               dropout_rate=rate)


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    training: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Returns ``(out [B,Sq,Hq,D], None)`` like the reference (the
    softmax is not materialised)."""
    if return_softmax:
        raise NotImplementedError("flash_attention: return_softmax is not "
                                  "supported")
    rate = float(dropout) if training else 0.0
    return _attention(query, key, value, bool(causal), rate, generator), None


def _segments_from_cu(cu_seqlens, total: int,
                      device: torch.device) -> torch.Tensor:
    """``cu_seqlens`` [n+1] -> per-position segment ids [1, total];
    positions past ``cu_seqlens[-1]`` take the one-past-the-end id, so
    they only see each other (packing don't-cares)."""
    cu = torch.as_tensor(cu_seqlens, device=device).to(torch.int32)
    cu = cu.reshape(-1).contiguous()
    pos = torch.arange(total, dtype=torch.int32, device=device)
    return torch.searchsorted(cu[1:], pos, right=True).to(torch.int32)[None]


def flash_attn_unpadded(query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q: int, max_seqlen_k: int, scale: float,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, training: bool = True,
                        generator: Optional[torch.Generator] = None):
    """Varlen attention over packed ``[total, H, D]`` q/k/v, the
    sequences delimited by ``cu_seqlens_*``: segment ids from the offsets
    are masked inside the kernels, so attention never crosses a sequence,
    and ``causal`` applies each sequence's own diagonal. Returns
    ``(out [total_q, H, D], None)``."""
    del max_seqlen_q, max_seqlen_k      # the shapes carry them
    if return_softmax:
        raise NotImplementedError("flash_attn_unpadded: return_softmax is "
                                  "not supported")
    rate = float(dropout) if training else 0.0
    seg_q = _segments_from_cu(cu_seqlens_q, query.shape[0], query.device)
    seg_k = _segments_from_cu(cu_seqlens_k, key.shape[0], query.device)
    out = _attention(query[None], key[None], value[None], bool(causal), rate,
                     generator, q_seg=seg_q, k_seg=seg_k, scale=float(scale))
    return out[0], None


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Softmax attention of ``[B,S,H,D]`` tensors with scale
    ``1/sqrt(head_dim)``; ``attn_mask`` is an additive float mask
    broadcastable to ``[B, H, Sq, Sk]`` (differentiable)."""
    if attn_mask is not None and not attn_mask.is_floating_point():
        raise TypeError("scaled_dot_product_attention: attn_mask must be an "
                        "additive float mask (MultiHeadAttention converts a "
                        "bool mask)")
    rate = float(dropout_p) if training else 0.0
    return _attention(query, key, value, bool(is_causal), rate, generator,
                      bias=attn_mask)

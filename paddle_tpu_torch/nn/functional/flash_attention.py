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
raises). An additive ``attn_mask`` belongs to a later slice of the port
and raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.kernels.flash_attention import flash_attention_ext

__all__ = ["flash_attention", "scaled_dot_product_attention"]


def _draw_seed(generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """One int32 dropout seed on ``device``, drawn from ``generator``."""
    if generator is None:
        raise ValueError("attention dropout needs an explicit "
                         "torch.Generator")
    return torch.randint(-2 ** 31, 2 ** 31, (1,), generator=generator,
                         dtype=torch.int32, device=device)


def _attention(q, k, v, causal: bool, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    seed = _draw_seed(generator, q.device) if rate > 0.0 else None
    return flash_attention_ext(q, k, v, seed=seed, causal=causal,
                               scale=1.0 / math.sqrt(q.shape[-1]),
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


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Softmax attention of ``[B,S,H,D]`` tensors with scale
    ``1/sqrt(head_dim)``."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: an additive attn_mask (flash "
            "bias) is not ported yet (ROADMAP Queue 2); use is_causal")
    rate = float(dropout_p) if training else 0.0
    return _attention(query, key, value, bool(is_causal), rate, generator)

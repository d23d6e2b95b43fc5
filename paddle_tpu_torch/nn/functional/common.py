"""Common functions (counterpart of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

from typing import Optional

import torch

from ...core import flags as _flags

__all__ = ["linear", "embedding", "dropout"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W (+ b)`` with ``W`` shaped ``[in_features, out_features]``
    (Paddle's fc layout, kept so weights carry across unchanged)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` [vocab, dim] at the integer ids ``x``.

    Ids outside ``[0, vocab)`` clamp to the nearest row, as the
    reference's ``jnp.take(..., mode="clip")`` does: never Python's
    negative indexing, never an out-of-bounds read on the card. With
    ``FLAGS_check_index_bounds`` such ids raise ``ValueError`` first
    (one host sync per call; under a CUDA-graph capture the flag raises
    ``RuntimeError``)."""
    ids = x.long()
    n = weight.shape[0]
    if _flags.get_flag("check_index_bounds") and ids.numel():
        from ...jit import is_capturing
        if is_capturing():
            raise RuntimeError(
                "FLAGS_check_index_bounds reads the embedding ids on the "
                "host, which a CUDA-graph capture cannot do: turn the flag "
                "off for a captured step")
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= n:
            raise ValueError(f"embedding ids out of range [0, {n}): "
                             f"min={lo}, max={hi}")
    return weight[ids.clamp(0, n - 1)]


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Upscale-in-train dropout: each element is kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)``. The mask is drawn from
    ``generator``, which must lie on ``x``'s device; a draw with none
    raises rather than touch a global stream."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout with p > 0 in training needs an explicit "
                         "torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device)
                       ).to(x.dtype)

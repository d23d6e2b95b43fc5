"""Common functions (counterpart of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["linear", "embedding"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W (+ b)`` with ``W`` shaped ``[in_features, out_features]``
    (Paddle's fc layout, kept so weights carry across unchanged)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` [vocab, dim] at the integer ids ``x``."""
    return weight[x.long()]

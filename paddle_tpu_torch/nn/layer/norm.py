"""Normalisation layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant
from .common import create_parameter

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """RMS normalisation over the last axis with a learned scale
    (the Llama-family norm; on the card, the hand-written kernel)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = create_parameter([hidden_size], Constant(1.0),
                                       device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, self._epsilon)

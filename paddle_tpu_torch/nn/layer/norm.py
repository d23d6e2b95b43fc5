"""Normalisation layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant
from .common import create_parameter

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """Layer normalisation over the trailing ``normalized_shape`` dims
    with a learned scale (ones) and shift (zeros); ``weight_attr=False``
    or ``bias_attr=False`` drops one. On the card the forward is the
    hand-written kernel."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None, *,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else create_parameter(
            self._normalized_shape, weight_attr or Constant(1.0),
            device=device)
        self.bias = None if bias_attr is False else create_parameter(
            self._normalized_shape, bias_attr or Constant(0.0), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


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

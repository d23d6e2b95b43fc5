"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch

__all__ = ["gelu", "relu", "silu", "tanh"]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU; exact ``x * (1 + erf(x / sqrt 2)) / 2`` unless
    ``approximate`` (the tanh form)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``."""
    return torch.nn.functional.silu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)

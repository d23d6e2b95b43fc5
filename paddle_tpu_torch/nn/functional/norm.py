"""Normalisation functions (counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.kernels.norms import rms_norm as _rms_norm_kernel

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * weight``,
    accumulated in fp32 and returned in ``x.dtype``. On the card this is
    the hand-written kernel (``ops/kernels/csrc/rms_norm.cu``)."""
    return _rms_norm_kernel(x, weight, float(epsilon))[0]

"""Normalisation functions (counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from ...ops.kernels.norms import LayerNormFunction, RMSNormFunction

__all__ = ["layer_norm", "rms_norm"]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * weight``,
    accumulated in fp32 and returned in ``x.dtype``; differentiable. On
    the card the forward is the hand-written kernel
    (``ops/kernels/csrc/rms_norm.cu``) and the backward plain PyTorch
    from its saved statistic."""
    return RMSNormFunction.apply(x, weight, float(epsilon))


def layer_norm(x: torch.Tensor,
               normalized_shape: Union[int, Sequence[int]],
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` dims, accumulated
    in fp32 and returned in ``x.dtype``; differentiable. On the card the
    forward is the hand-written kernel (``ops/kernels/csrc/layer_norm.cu``)
    and the backward plain PyTorch from its saved statistics."""
    ns = [normalized_shape] if isinstance(normalized_shape, int) \
        else list(normalized_shape)
    if list(x.shape[x.dim() - len(ns):]) != ns:
        raise ValueError(f"layer_norm: normalized_shape {ns} does not match "
                         f"the trailing dims of {tuple(x.shape)}")
    n = math.prod(ns)
    x2 = x.reshape(*x.shape[:x.dim() - len(ns)], n)
    w = weight.reshape(n) if weight is not None else None
    b = bias.reshape(n) if bias is not None else None
    return LayerNormFunction.apply(x2, w, b, float(epsilon)).reshape(x.shape)

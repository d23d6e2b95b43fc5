"""Weight initialisers (counterpart of paddle_tpu/nn/initializer).

paddle_tpu's initialisers return a new array for ``(shape, dtype)``.
Here an initialiser fills a tensor that is already allocated on its
device, in place and from an explicit ``torch.Generator`` on that
device, so a large model is drawn on the card and never passes through
host memory.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["Initializer", "Constant", "Normal", "XavierUniform"]


class Initializer:
    def __call__(self, tensor: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.normal_(self.mean, self.std, generator=generator)


class XavierUniform(Initializer):
    """Uniform in ``±sqrt(6 / (fan_in + fan_out))`` for a 2-D
    ``[in, out]`` weight (Paddle's fc layout; the default of ``Linear``
    and ``Embedding``)."""

    def __call__(self, tensor, generator=None):
        fan_in, fan_out = (tensor.shape[0], tensor.shape[1]) \
            if tensor.dim() >= 2 else (tensor.shape[0], tensor.shape[0])
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            return tensor.uniform_(-limit, limit, generator=generator)

"""Common layers (counterpart of paddle_tpu/nn/layer/common.py).

Parameters are allocated on the requested device at construction and
filled there by their initialiser from an explicit generator on the same
device: a 7B model is drawn on the card, never built on the host first.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from ..initializer import Constant, Initializer, XavierUniform

__all__ = ["create_parameter", "Linear", "Embedding", "Dropout"]


def create_parameter(shape: Sequence[int], initializer: Initializer, *,
                     device=None, dtype: torch.dtype = torch.float32,
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Parameter:
    """An ``nn.Parameter`` of ``shape`` on ``device`` (default ``cuda``),
    filled in place by ``initializer``."""
    t = torch.empty(tuple(shape), dtype=dtype, device=resolve_device(device))
    initializer(t, generator)
    return nn.Parameter(t)


class Linear(nn.Module):
    """``y = x W + b`` with ``W`` shaped ``[in_features, out_features]``
    (Paddle's fc layout). ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr: Optional[Initializer] = None,
                 bias_attr=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter(
            [in_features, out_features], weight_attr or XavierUniform(), **kw)
        if bias_attr is not False:
            self.bias = create_parameter([out_features],
                                         bias_attr or Constant(0.0), **kw)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(nn.Module):
    """Lookup table ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr: Optional[Initializer] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], weight_attr or XavierUniform(),
            device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight)

    def extra_repr(self) -> str:
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(nn.Module):
    """Upscale-in-train dropout whose masks come from ``generator`` (on
    the device of the tensors it drops; required once ``p > 0`` is used
    in training)."""

    def __init__(self, p: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self._generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, self.training, self._generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"

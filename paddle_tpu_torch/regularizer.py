"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py).

``L1Decay``/``L2Decay`` carry a coefficient; handed to an optimizer as
``weight_decay``, their ``coeff`` is its weight-decay coefficient
(``Optimizer._wd_coeff``), and the optimizer adds their penalty's
gradient to each gradient: ``coeff * sign(p)`` and ``coeff * p``. Called
on a parameter, each returns its penalty: ``coeff * sum(|p|)`` and
``coeff / 2 * sum(p * p)``.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff
        self._regularization_coeff = coeff

    def __call__(self, param: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(param)) * self.coeff


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff
        self._regularization_coeff = coeff

    def __call__(self, param: torch.Tensor) -> torch.Tensor:
        return torch.sum(param * param) * (0.5 * self.coeff)

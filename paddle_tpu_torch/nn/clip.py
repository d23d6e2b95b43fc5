"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

Each clip object maps a list of ``(param, grad)`` pairs to a new list;
the optimizers apply theirs in the eager ``step()``. A pair whose grad
is None, or whose parameter has ``need_clip`` False, passes through.
Norms are summed and gradients scaled in fp32, then cast back to the
gradient's dtype, as in the reference: a bf16 gradient is read through
an fp32 copy.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]

Pairs = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _skip(p, g) -> bool:
    return g is None or not getattr(p, "need_clip", True)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads: Pairs) -> Pairs:
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Each gradient entry clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _dygraph_clip(self, params_grads):
        return [(p, g) if _skip(p, g) else
                (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(
                self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by ``min(clip_norm / global_norm,
    1)``, the global norm taken over the gradients that clip."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def _global_norm_sq(self, params_grads) -> torch.Tensor:
        total = None
        for p, g in params_grads:
            if _skip(p, g):
                continue
            sq = torch.sum(torch.square(g.float()))
            total = sq if total is None else total + sq
        if total is None:
            return torch.zeros((), dtype=torch.float32)
        return total

    def _dygraph_clip(self, params_grads):
        global_norm = torch.sqrt(self._global_norm_sq(params_grads))
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm, min=1e-12), max=1.0)
        return [(p, g) if _skip(p, g) else (p, _scaled(g, scale))
                for p, g in params_grads]


def _param_list(parameters) -> list:
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


def clip_grad_norm_(parameters: Union[torch.Tensor, Iterable[torch.Tensor]],
                    max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False) -> torch.Tensor:
    """Scale every ``p.grad`` in place so that their joint ``norm_type``
    norm (2, any p, or inf: the largest magnitude) is at most
    ``max_norm``; returns that norm before scaling. With
    ``error_if_nonfinite`` a norm that is nan or inf raises
    ``RuntimeError`` (one host read)."""
    params = _param_list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g))
                                       for g in grads]))
    else:
        total = torch.pow(
            sum(torch.sum(torch.pow(torch.abs(g.float()), norm_type))
                for g in grads), 1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(f"clip_grad_norm_: the total norm of order "
                           f"{norm_type} is not finite")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad = _scaled(p.grad, scale)
    return total


def clip_grad_value_(parameters: Union[torch.Tensor,
                                       Iterable[torch.Tensor]],
                     clip_value: float) -> None:
    """Clamp every ``p.grad`` in place to ``[-clip_value, clip_value]``."""
    with torch.no_grad():
        for p in _param_list(parameters):
            if p.grad is not None:
                p.grad = torch.clamp(p.grad, -clip_value, clip_value)

"""Adam and AdamW (counterpart of paddle_tpu/optimizer/optimizer.py).

``torch.optim.Optimizer`` subclasses running paddle_tpu's update rule
(``Adam._update``), not ``torch.optim.AdamW``'s:

- the update runs in fp32 and is cast back to each parameter's dtype (a
  bf16 parameter is updated in fp32 and rounded once per step);
- the moments are stored in ``moment_dtype`` (default fp32), the beta
  powers as fp32 scalars in the state;
- ``eps`` is added to ``sqrt(v_hat)``;
- AdamW decays decoupled, ``p * (1 - lr * wd)`` before the step; Adam
  adds ``wd * p`` to the gradient (L2).

``step(lr=..., wd_mask=...)`` takes the learning rate of this step and a
per-parameter mask (``{id(param): bool}``; False skips weight decay),
the counterpart of ``apply_gradients(..., lr, wd_mask=)``. Parameters
are updated in place.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

__all__ = ["Adam", "AdamW"]


class Adam(torch.optim.Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: Optional[float] = None, *,
                 moment_dtype: Optional[torch.dtype] = None):
        if parameters is None:
            raise ValueError("Adam: parameters are required")
        defaults = dict(lr=float(learning_rate), beta1=float(beta1),
                        beta2=float(beta2), eps=float(epsilon),
                        weight_decay=float(weight_decay or 0.0))
        super().__init__(parameters, defaults)
        self._moment_dtype = moment_dtype or torch.float32

    def _decoupled_weight_decay(self) -> bool:
        return False

    def _init_state(self, p: torch.Tensor) -> dict:
        return {"moment1": torch.zeros_like(p, dtype=self._moment_dtype),
                "moment2": torch.zeros_like(p, dtype=self._moment_dtype),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device),
                "beta2_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[float] = None,
             wd_mask: Optional[Mapping[int, bool]] = None):
        """One update of every parameter that has a gradient. ``lr``
        overrides the groups' rate for this step; ``wd_mask[id(p)]``
        False skips weight decay for ``p``."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            step_lr = group["lr"] if lr is None else float(lr)
            for p in group["params"]:
                if p.grad is None:
                    continue
                decay = group["weight_decay"]
                if wd_mask is not None and not wd_mask.get(id(p), True):
                    decay = 0.0
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                self._update(p, p.grad, state, step_lr, decay, group)
        return loss

    def _update(self, p, grad, state, lr, decay, group):
        b1, b2 = group["beta1"], group["beta2"]
        decoupled = self._decoupled_weight_decay()
        g = grad.float()
        p32 = p.float()
        if decay and not decoupled:
            g = g + decay * p32
        m1 = b1 * state["moment1"].float() + (1 - b1) * g
        m2 = b2 * state["moment2"].float() + (1 - b2) * (g * g)
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        mhat = m1 / (1 - b1p)
        vhat = m2 / (1 - b2p)
        if decay and decoupled:
            p32 = p32 * (1.0 - lr * decay)
        p32 = p32 - lr * mhat / (torch.sqrt(vhat) + group["eps"])
        p.copy_(p32)
        state["moment1"] = m1.to(self._moment_dtype)
        state["moment2"] = m2.to(self._moment_dtype)
        state["beta1_pow"] = b1p
        state["beta2_pow"] = b2p


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = 0.01, *,
                 moment_dtype: Optional[torch.dtype] = None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, moment_dtype=moment_dtype)

    def _decoupled_weight_decay(self) -> bool:
        return True

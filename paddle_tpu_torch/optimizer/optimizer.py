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

With the flag ``use_fused_optimizer`` (default on, as the reference's)
the step is multi-tensor, the counterpart of the reference's fused step
(``_try_fused_step``/``_fused_step_group``: one jitted program over
every parameter): parameters sharing a device, dtypes, weight decay and
step count form a group (cut into runs of ``FUSED_CHUNK_ELEMENTS``), and
each operation of ``_update`` runs once per run as a ``torch._foreach_*``
call, in the same order and dtypes, so the result equals the
per-parameter loop's bit for bit. Off, the loop runs.
"""
from __future__ import annotations

from typing import List, Mapping, Optional

import torch

from ..core.flags import get_flag

__all__ = ["Adam", "AdamW"]

# elements updated by one multi-tensor call: its fp32 temporaries (the
# parameters', gradients' and moments' fp32 copies and the update's
# intermediates, about seven per element) stay near 3.5 GB
FUSED_CHUNK_ELEMENTS = 1 << 27


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
                                        device=p.device),
                "step": 0}

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
        fused = get_flag("use_fused_optimizer")
        for group in self.param_groups:
            step_lr = group["lr"] if lr is None else float(lr)
            batches = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                decay = group["weight_decay"]
                if wd_mask is not None and not wd_mask.get(id(p), True):
                    decay = 0.0
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                if fused:
                    key = (p.device, p.dtype, p.grad.dtype, decay,
                           state["step"])
                    batches.setdefault(key, []).append(p)
                else:
                    self._update(p, p.grad, state, step_lr, decay, group)
            for (*_, decay, _), params in batches.items():
                for chunk in _chunks(params, FUSED_CHUNK_ELEMENTS):
                    self._fused_update(chunk, step_lr, decay, group)
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
        state["step"] += 1

    def _fused_update(self, params: List[torch.Tensor], lr: float,
                      decay: float, group: dict) -> None:
        """``_update`` of every parameter in ``params`` (one device,
        dtypes, decay and step count, hence one pair of beta powers), each
        operation one ``torch._foreach_*`` call over the group."""
        b1, b2 = group["beta1"], group["beta2"]
        decoupled = self._decoupled_weight_decay()
        states = [self.state[p] for p in params]
        g = _fp32([p.grad for p in params])
        p32 = _fp32(params)
        if decay and not decoupled:
            g = torch._foreach_add(g, torch._foreach_mul(p32, decay))
        m1 = torch._foreach_mul(_fp32([s["moment1"] for s in states]), b1)
        torch._foreach_add_(m1, torch._foreach_mul(g, 1 - b1))
        m2 = torch._foreach_mul(_fp32([s["moment2"] for s in states]), b2)
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - b2)
        torch._foreach_add_(m2, gg)
        del g, gg
        b1p = states[0]["beta1_pow"] * b1
        b2p = states[0]["beta2_pow"] * b2
        step = torch._foreach_div(m1, 1 - b1p)               # mhat
        den = torch._foreach_div(m2, 1 - b2p)                # vhat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_mul_(step, lr)
        torch._foreach_div_(step, den)
        del den
        if decay and decoupled:
            p32 = torch._foreach_mul(p32, 1.0 - lr * decay)
        torch._foreach_sub_(p32, step)
        if p32[0] is not params[0]:     # else fp32 p32 is the parameters
            torch._foreach_copy_(params, p32)
        for key, new in (("moment1", m1), ("moment2", m2)):
            olds = [s[key] for s in states]
            if olds[0].dtype == torch.float32:
                for s, t in zip(states, new):
                    s[key] = t
            else:
                torch._foreach_copy_(olds, new)
        for s in states:
            s["beta1_pow"] = b1p
            s["beta2_pow"] = b2p
            s["step"] += 1


def _chunks(params: List[torch.Tensor], cap: int):
    """``params`` in order, cut into runs of at most ``cap`` elements (a
    larger tensor alone): the fp32 temporaries of one multi-tensor update
    stay a few times ``cap`` x 4 bytes."""
    run, n = [], 0
    for p in params:
        if run and n + p.numel() > cap:
            yield run
            run, n = [], 0
        run.append(p)
        n += p.numel()
    if run:
        yield run


def _fp32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """``[t.float() for t in ts]`` of one dtype: the tensors themselves
    when fp32, else fp32 copies made by one ``_foreach_copy_``."""
    if ts[0].dtype == torch.float32:
        return list(ts)
    out = [torch.empty_like(t, dtype=torch.float32) for t in ts]
    torch._foreach_copy_(out, ts)
    return out


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

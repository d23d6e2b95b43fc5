"""Training-step factory (counterpart of paddle_tpu/models/trainer.py).

paddle_tpu stages forward, backward and the optimizer sweep into one
jitted XLA program over functional parameter trees. PyTorch runs
eagerly, so the port's step works on the module in place: it runs the
forward, the backward (the flash-attention backward kernels on the
card) and one optimizer step that updates the parameters and moments in
place, the counterpart of the reference's buffer donation. The weight
decay mask is the reference's ``_wd_mask``.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn

__all__ = ["create_train_step", "write_back"]


def _wd_mask(names: Iterable[str]) -> Dict[str, bool]:
    """No weight decay on biases and norm parameters."""
    return {n: ("bias" not in n and "norm" not in n.lower()
                and "ln_" not in n) for n in names}


def create_train_step(model: nn.Module, optimizer,
                      loss_fn: Optional[Callable] = None):
    """``train_step(ids, labels, lr) -> loss``: one forward, backward and
    ``optimizer`` step over ``model``'s trainable parameters, in place.
    ``model.loss(ids, labels)`` is the loss unless ``loss_fn(model, ids,
    labels)`` is given. ``ids``/``labels`` are moved to the model's
    device; the returned loss is a detached 0-d tensor there (reading it
    synchronises). The gradients of the step stay on the parameters
    until the next step."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    mask = _wd_mask(n for n, _ in named)
    wd_mask = {id(p): mask[n] for n, p in named}
    device = named[0][1].device

    def train_step(ids, labels, lr: float) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=device)
        labels = torch.as_tensor(labels, device=device)
        optimizer.zero_grad(set_to_none=True)
        loss = (loss_fn(model, ids, labels) if loss_fn is not None
                else model.loss(ids, labels))
        loss.backward()
        optimizer.step(lr=lr, wd_mask=wd_mask)
        return loss.detach()

    return train_step


def write_back(model: nn.Module, params: Mapping[str, torch.Tensor],
               strict: bool = False) -> None:
    """Replace the named parameters' data with ``params`` (dtype and
    device included: casting a model's weights to bf16 is
    ``write_back(model, {k: v.bfloat16() ...})``). Names not on the model
    warn, or raise ``KeyError`` with ``strict=True``."""
    entries = dict(model.named_parameters())
    unknown = sorted(k for k in params if k not in entries)
    if unknown:
        msg = (f"write_back: {len(unknown)} param(s) not on the model, "
               f"dropped: {unknown[:5]}{'...' if len(unknown) > 5 else ''}")
        if strict:
            raise KeyError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    with torch.no_grad():
        for k, v in params.items():
            if k in entries:
                entries[k].data = v

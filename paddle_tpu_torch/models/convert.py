"""Carry weights into the port by name.

The port keeps paddle_tpu's parameter names and its ``[in, out]`` linear
layout, so a paddle_tpu ``state_dict()`` turned into numpy arrays loads
as a name-checked copy: nothing is transposed or renamed. A tied weight
has one entry: GPT's LM head reads ``gpt.wte.weight``, as in paddle_tpu.

An optimizer's state carries across the same way: paddle_tpu's
``Optimizer.state_dict()`` (``step``, ``LR_Scheduler`` and
``"{name or index}.{state}"`` entries) with its tensors as numpy arrays
loads into the port's optimizer of the same class over the same
parameters in the same order, so a run can stop in paddle_tpu and go
on in the port.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_numpy", "optimizer_state_from_numpy"]


def state_dict_from_numpy(model: nn.Module,
                          arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``arrays`` ({name: ndarray}) into ``model``'s state_dict
    entries, cast to each entry's dtype, on its device. Raises
    ``KeyError`` on missing or unexpected names and ``ValueError`` on a
    shape mismatch; nothing is copied unless every entry matches."""
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    bad = [f"{k}: {tuple(np.shape(arrays[k]))} vs {tuple(t.shape)}"
           for k, t in own.items()
           if tuple(np.shape(arrays[k])) != tuple(t.shape)]
    if bad:
        raise ValueError("state_dict shape mismatch: " + "; ".join(bad))
    with torch.no_grad():
        for k, t in own.items():
            a = np.ascontiguousarray(arrays[k])
            if not a.flags.writeable:     # torch wraps only writable arrays
                a = a.copy()
            t.copy_(torch.from_numpy(a))
    return model


def optimizer_state_from_numpy(optimizer, state: Mapping) -> None:
    """Load a paddle_tpu optimizer's ``state_dict()`` (arrays as numpy,
    scalars as numbers) into the port's ``optimizer`` with
    ``set_state_dict``. Raises ``KeyError`` on an entry the port's
    optimizer has no state for and ``ValueError`` on a shape mismatch;
    nothing is loaded unless every entry matches."""
    own = optimizer._expected_state()
    entries = {k: v for k, v in state.items()
               if k not in ("step", "LR_Scheduler")}
    unexpected = sorted(set(entries) - set(own))
    if unexpected:
        raise KeyError(f"optimizer state: unexpected {unexpected}")
    bad = [f"{k}: {tuple(np.shape(v))} vs {own[k]}"
           for k, v in entries.items() if tuple(np.shape(v)) != own[k]]
    if bad:
        raise ValueError("optimizer state shape mismatch: " + "; ".join(bad))
    optimizer.set_state_dict(dict(state))

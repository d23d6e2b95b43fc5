"""Mixed precision (counterpart of paddle_tpu/amp; only ``decorate`` is
ported so far).

``decorate(..., level="O2")`` casts every floating parameter of the
models to ``dtype`` and turns on the optimizers' ``multi_precision``
(fp32 master weights) unless ``master_weight`` is False. ``auto_cast``
and ``GradScaler`` act through the reference's op-dispatch funnel and
wait for its port.
"""
from __future__ import annotations

import torch

__all__ = ["decorate", "amp_decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: the models' floating parameters cast to ``dtype`` in place (the
    optimizers keep the same parameter objects), the optimizers' master
    weights on. Returns ``models``, or ``(models, optimizers)`` when
    optimizers are given. ``save_dtype`` is accepted, as in the
    reference, and not used."""
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
        if optimizers is not None:
            opts = optimizers if isinstance(optimizers, (list, tuple)) \
                else [optimizers]
            for o in opts:
                o._multi_precision = master_weight is not False
    if optimizers is None:
        return models
    return models, optimizers


amp_decorate = decorate

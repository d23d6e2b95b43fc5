"""Loss functions (counterpart of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` keeps the reference's hard-label fast path: a per-row
softmax cross-entropy in fp32 (logsumexp minus the label's logit; a
label outside ``[0, V)``, ``ignore_index`` included, gives 0 loss and 0
gradient) and, for ``reduction="mean"``, the sum over the valid labels
divided by their count. The per-row core is
``ops/kernels/cross_entropy.py`` ``softmax_xent``: the hand-written CUDA
forward and backward kernels on the card, their plain versions on the
CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.kernels.cross_entropy import softmax_xent

__all__ = ["cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: Optional[int] = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Softmax cross-entropy of ``input`` [..., V] against integer
    ``label`` [...] (or [..., 1])."""
    if (weight is not None or soft_label or axis not in (-1, input.dim() - 1)
            or not use_softmax or label_smoothing != 0.0
            or label.dim() not in (input.dim() - 1, input.dim())):
        raise NotImplementedError(
            "cross_entropy: only the hard-label, unweighted, last-axis "
            "softmax path is ported")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    li = label.long()
    if li.dim() == input.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    v = input.shape[-1]
    flat_labels = li.reshape(-1)
    if ignore_index is not None:
        flat_labels = torch.where(flat_labels == ignore_index,
                                  torch.full_like(flat_labels, -1),
                                  flat_labels)
    per = softmax_xent(input.reshape(-1, v), flat_labels).reshape(li.shape)
    if reduction == "mean" and ignore_index is not None:
        denom = torch.clamp((li != ignore_index).float().sum(), min=1.0)
        return per.sum() / denom
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per

"""Fused hard-label softmax cross-entropy: the CUDA kernels
``csrc/cross_entropy.cu`` (forward and backward) and their plain PyTorch
versions.

Counterpart of ``paddle_tpu/ops/pallas/cross_entropy.py``
``softmax_xent_pallas`` (kernels ``_fwd_kernel`` and ``_bwd_kernel``).
For logits [R, V] and integer labels [R]:

- ``softmax_xent_fwd``: per row, ``lse = m + log sum exp(x - m)`` and
  ``loss = lse - x[label]``, both fp32; a label outside ``[0, V)``
  (``ignore_index`` arrives as -1) gives loss 0.
- ``softmax_xent_bwd``: ``dx = (exp(x - lse) - onehot) * g * valid`` in
  the logits' dtype.

Each picks by where the tensor lies: a CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises. ``softmax_xent``
(``SoftmaxXentFunction``) makes the forward differentiable through the
backward, and is what ``nn/functional/loss.py`` ``cross_entropy`` calls.

The reference chooses among the plain form, the forward kernel with a
plain backward, and both kernels, by flags whose default (the plain
form) came from a TPU measurement. On the H100 both kernels together are
the fastest of the three at GPT-2's training logits (PERF.md), so the
port has no such choice: the card always runs both kernels. The reference also sends a vocabulary that is not a
multiple of 128 to XLA; that is a Mosaic tiling rule of the TPU, and the
CUDA kernels take any V and any contiguous logits, a view at a storage
offset included (the forward reads a row that does not start on a
16-byte boundary as a scalar head, a body of 16-byte vectors and a
scalar tail).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["softmax_xent_fwd", "softmax_xent_fwd_plain", "softmax_xent_bwd",
           "softmax_xent_bwd_plain", "SoftmaxXentFunction",
           "softmax_xent"]

_DTYPE_CODES = _build.DTYPE_CODES


def softmax_xent_fwd_plain(logits: torch.Tensor, labels: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward in the kernel's fp32 order: ``(loss, lse)``,
    fp32 [R]. A row of -inf only has lse -inf, as in the kernel."""
    x = logits.float()
    v = x.shape[-1]
    m = torch.amax(x, dim=-1)
    shift = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    lse = shift + torch.log(torch.exp(x - shift[:, None]).sum(dim=-1))
    li = labels.long()
    valid = (li >= 0) & (li < v)
    safe = torch.where(valid, li, torch.zeros_like(li))
    picked = torch.gather(x, 1, safe[:, None])[:, 0]
    return torch.where(valid, lse - picked, torch.zeros_like(lse)), lse


def softmax_xent_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                           lse: torch.Tensor, g: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch backward in the kernel's fp32 order:
    ``(exp(x - lse) - onehot) * (g * valid)`` cast to the logits' dtype.
    The one-hot is subtracted in place at each valid label (an invalid
    row subtracts 0), so no [R, V] one-hot is built."""
    v = logits.shape[-1]
    p = torch.exp(logits.float() - lse.float()[:, None])
    li = labels.long()
    valid = ((li >= 0) & (li < v)).float()
    safe = torch.where(valid > 0, li, torch.zeros_like(li))
    p.scatter_add_(1, safe[:, None], -valid[:, None])
    return (p * (g.float() * valid)[:, None]).to(logits.dtype)


def _check(name: str, logits: torch.Tensor, *rows_args: torch.Tensor
           ) -> Tuple[int, int]:
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous [R, V] logits, got "
                         f"{tuple(logits.shape)}")
    r, v = logits.shape
    if v < 1 or v > 2**31 - 1 or r > 2**31 - 1:
        raise ValueError(f"{name}: [R, V] = [{r}, {v}] out of range")
    for a in rows_args:
        if a.device != logits.device or tuple(a.shape) != (r,):
            raise ValueError(f"{name}: a per-row operand is {tuple(a.shape)} "
                             f"on {a.device}, expected [{r}] on "
                             f"{logits.device}")
    return r, v


def _fwd_launch(logits: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    r, v = _check("softmax_xent_fwd", logits, labels)
    lab = labels.to(torch.int64).contiguous()
    loss = torch.empty((r,), dtype=torch.float32, device=logits.device)
    lse = torch.empty((r,), dtype=torch.float32, device=logits.device)
    lib = _build.load("cross_entropy")
    softmax_xent_fwd.launches += 1
    ptr = _build.ptr
    rc = lib.softmax_xent_fwd(ptr(logits), ptr(lab), ptr(loss), ptr(lse), r,
                              v, _DTYPE_CODES[logits.dtype],
                              _build.stream(logits))
    _build.check(lib, rc, "softmax_xent_fwd")
    return loss, lse


def softmax_xent_fwd(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(loss, lse)``, fp32 [R], of logits [R, V] and labels [R].

    CUDA tensors run the hand-written kernel (``softmax_xent_fwd.launches``
    counts each launch); CPU tensors run ``softmax_xent_fwd_plain``."""
    return _build.dispatch(softmax_xent_fwd_plain, _fwd_launch, logits,
                           labels)


softmax_xent_fwd.launches = 0


def _bwd_launch(logits: torch.Tensor, labels: torch.Tensor,
                lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    r, v = _check("softmax_xent_bwd", logits, labels, lse, g)
    lab = labels.to(torch.int64).contiguous()
    lse32 = lse.to(torch.float32).contiguous()
    g32 = g.to(torch.float32).contiguous()
    dx = torch.empty_like(logits)
    lib = _build.load("cross_entropy")
    softmax_xent_bwd.launches += 1
    ptr = _build.ptr
    rc = lib.softmax_xent_bwd(ptr(logits), ptr(lab), ptr(lse32), ptr(g32),
                              ptr(dx), r, v, _DTYPE_CODES[logits.dtype],
                              _build.stream(logits))
    _build.check(lib, rc, "softmax_xent_bwd")
    return dx


def softmax_xent_bwd(logits: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dx`` [R, V] in the logits' dtype from the saved ``lse`` and the
    per-row cotangent ``g``.

    CUDA tensors run the hand-written kernel (``softmax_xent_bwd.launches``
    counts each launch); CPU tensors run ``softmax_xent_bwd_plain``."""
    return _build.dispatch(softmax_xent_bwd_plain, _bwd_launch, logits,
                           labels, lse, g)


softmax_xent_bwd.launches = 0

class SoftmaxXentFunction(torch.autograd.Function):
    """Differentiable per-row CE: the forward is ``softmax_xent_fwd``, the
    backward ``softmax_xent_bwd`` from the saved lse. Labels get no
    gradient."""

    @staticmethod
    def forward(ctx, logits, labels):
        logits = logits.contiguous()
        loss, lse = softmax_xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return softmax_xent_bwd(logits, labels, lse, g), None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(logits [R, V], labels [R] int) -> per-row loss [R] fp32; invalid
    labels give loss 0 and zero gradient. On CUDA tensors both directions
    are the kernels; on CPU tensors both are the plain versions."""
    return SoftmaxXentFunction.apply(logits, labels)

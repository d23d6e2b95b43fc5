"""Fused RMSNorm forward: the CUDA kernel ``csrc/rms_norm.cu`` and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/norms.py`` ``rms_norm_pallas``
(kernel ``_rms_fwd_kernel``). The serving path is forward-only, so the
port always takes the kernel on the card; the TPU package's
per-direction choice (``FLAGS_pallas_prefer_norms``) has no counterpart
here yet. Unlike the TPU dispatch, which keeps its kernel to widths that
are multiples of 128 with a weight, the CUDA kernel takes any width and
``w=None``, so no CUDA call ever needs the plain version.

``rms_norm`` picks by where the tensor lies: a CPU tensor goes to
``rms_norm_plain``; a CUDA tensor launches the kernel or raises. There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_plain(x: torch.Tensor, w: Optional[torch.Tensor], eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch RMSNorm in the kernel's fp32 order: returns
    ``(y in x.dtype, inv fp32 [rows])`` for x viewed as ``[rows, N]``."""
    n = x.shape[-1]
    x32 = x.reshape(-1, n).float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=1) + eps)
    y = x32 * inv[:, None]
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype).reshape(x.shape), inv


def _launch(x: torch.Tensor, w: Optional[torch.Tensor], eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rms_norm kernel needs a contiguous x")
    n = x.shape[-1]
    if n < 1:
        raise ValueError("rms_norm needs a last dimension of at least 1")
    rows = x.numel() // n
    if w is not None:
        if w.device != x.device:
            raise ValueError(f"rms_norm: w on {w.device}, x on {x.device}")
        if w.dtype not in _DTYPE_CODES:
            raise TypeError(f"rms_norm kernel takes float32 or bfloat16 w, "
                            f"got {w.dtype}")
        if tuple(w.shape) != (n,) or not w.is_contiguous():
            raise ValueError(f"rms_norm: w must be contiguous [{n}], got "
                             f"{tuple(w.shape)}")
    y = torch.empty_like(x)
    inv = torch.empty((rows,), dtype=torch.float32, device=x.device)
    lib = _build.load("rms_norm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rms_norm.launches += 1
    rc = lib.rms_norm_fwd(
        ctypes.c_void_p(x.data_ptr()),
        None if w is None else ctypes.c_void_p(w.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(inv.data_ptr()),
        rows, n, float(eps), _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[w.dtype] if w is not None else 0,
        ctypes.c_void_p(stream))
    _build.check(lib, rc, "rms_norm_fwd")
    return y, inv


def rms_norm(x: torch.Tensor, w: Optional[torch.Tensor], eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm over the last axis: ``(y, inv)`` with ``y`` like ``x`` and
    ``inv = rsqrt(mean(x^2) + eps)`` as fp32 ``[rows]``.

    CUDA tensors run the hand-written kernel (``rms_norm.launches``
    counts each launch); CPU tensors run ``rms_norm_plain``."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm has no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(x, w, eps)
    return _launch(x, w, eps)


rms_norm.launches = 0

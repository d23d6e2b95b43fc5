"""Fused RMSNorm and LayerNorm forwards: the CUDA kernels
``csrc/rms_norm.cu`` and ``csrc/layer_norm.cu`` and their plain PyTorch
versions.

Counterpart of ``paddle_tpu/ops/pallas/norms.py`` ``rms_norm_pallas``
(kernel ``_rms_fwd_kernel``) and ``layer_norm_pallas`` (kernel
``_ln_fwd_kernel``). The port always takes the kernel on the card; the
TPU package's per-direction choice (``FLAGS_pallas_prefer_norms``) has
no counterpart here yet. Unlike the TPU dispatch, which keeps its
kernels to widths that are multiples of 128 with a weight (and a bias),
the CUDA kernels take any width and ``w=None`` (``b=None``), so no CUDA
call ever needs the plain version.

``rms_norm`` and ``layer_norm`` pick by where the tensor lies: a CPU
tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other. The RMSNorm kernel
has two routes, which its C entry picks from rows and N and which give
the same bits: up to 132 rows that fit its register cache (decode's
batch) take a kernel built for latency, launched with programmatic
dependent launch; more rows take the many-row kernel.

The backwards are plain PyTorch from the saved statistics, as the
reference's ``_rms_bwd`` and ``_ln_bwd`` are plain XLA:
``RMSNormFunction`` and ``LayerNormFunction``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_plain", "layer_norm", "layer_norm_plain",
           "RMSNormFunction", "LayerNormFunction"]

_DTYPE_CODES = _build.DTYPE_CODES


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


def _check_x(name: str, x: torch.Tensor) -> Tuple[int, int]:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous x")
    n = x.shape[-1]
    if n < 1:
        raise ValueError(f"{name} needs a last dimension of at least 1")
    return x.numel() // n, n


def _check_param(name: str, what: str, p: Optional[torch.Tensor],
                 x: torch.Tensor, n: int) -> None:
    if p is None:
        return
    if p.device != x.device:
        raise ValueError(f"{name}: {what} on {p.device}, x on {x.device}")
    if p.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 {what}, "
                        f"got {p.dtype}")
    if tuple(p.shape) != (n,) or not p.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous [{n}], got "
                         f"{tuple(p.shape)}")


def _launch(x: torch.Tensor, w: Optional[torch.Tensor], eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, n = _check_x("rms_norm", x)
    _check_param("rms_norm", "w", w, x, n)
    y = torch.empty_like(x)
    inv = torch.empty((rows,), dtype=torch.float32, device=x.device)
    lib = _build.load("rms_norm")
    rms_norm.launches += 1
    ptr = _build.ptr
    rc = lib.rms_norm_fwd(
        ptr(x), ptr(w), ptr(y), ptr(inv), rows, n, float(eps),
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype] if w is not None else 0,
        _build.stream(x))
    _build.check(lib, rc, "rms_norm_fwd")
    return y, inv


def rms_norm(x: torch.Tensor, w: Optional[torch.Tensor], eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm over the last axis: ``(y, inv)`` with ``y`` like ``x`` and
    ``inv = rsqrt(mean(x^2) + eps)`` as fp32 ``[rows]``.

    CUDA tensors run the hand-written kernel (``rms_norm.launches``
    counts each launch); CPU tensors run ``rms_norm_plain``."""
    return _build.dispatch(rms_norm_plain, _launch, x, w, eps)


rms_norm.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """Differentiable RMSNorm over the last axis: the forward is
    ``rms_norm`` (the kernel on the card); the backward is plain PyTorch
    from the saved ``inv`` by the reference ``_rms_bwd``'s formulas
    (dx = inv g - x inv^3 mean(g x) with g = dy w, in x's dtype; dw
    summed in fp32 and cast to w's dtype)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        x = x.contiguous()
        y, inv = rms_norm(x, w, float(eps))
        ctx.save_for_backward(x, w, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, inv = ctx.saved_tensors
        n = x.shape[-1]
        dy2 = dy.reshape(-1, n).float()
        x32 = x.reshape(-1, n).float()
        inv = inv[:, None]
        g = dy2 * w.float()[None, :] if w is not None else dy2
        m = torch.mean(g * x32, dim=1, keepdim=True)
        dx = inv * g - x32 * inv ** 3 * m
        dw = torch.sum(dy2 * x32 * inv, dim=0).to(w.dtype) \
            if w is not None and ctx.needs_input_grad[1] else None
        return dx.reshape(x.shape).to(x.dtype), dw, None


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def layer_norm_plain(x: torch.Tensor, w: Optional[torch.Tensor],
                     b: Optional[torch.Tensor], eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch LayerNorm in the kernel's fp32 order: returns
    ``(y in x.dtype, mu fp32 [rows], rstd fp32 [rows])`` for x viewed as
    ``[rows, N]``."""
    n = x.shape[-1]
    x32 = x.reshape(-1, n).float()
    mu = torch.mean(x32, dim=1)
    xc = x32 - mu[:, None]
    rstd = torch.rsqrt(torch.mean(xc * xc, dim=1) + eps)
    y = xc * rstd[:, None]
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype).reshape(x.shape), mu, rstd


def _ln_launch(x: torch.Tensor, w: Optional[torch.Tensor],
               b: Optional[torch.Tensor], eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    rows, n = _check_x("layer_norm", x)
    _check_param("layer_norm", "w", w, x, n)
    _check_param("layer_norm", "b", b, x, n)
    if w is not None and b is not None and w.dtype != b.dtype:
        raise TypeError(f"layer_norm kernel takes w and b of one dtype, got "
                        f"{w.dtype} and {b.dtype}")
    p = w if w is not None else b
    y = torch.empty_like(x)
    mu = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
    lib = _build.load("layer_norm")
    layer_norm.launches += 1
    ptr = _build.ptr
    rc = lib.layer_norm_fwd(
        ptr(x), ptr(w), ptr(b), ptr(y), ptr(mu), ptr(rstd), rows, n,
        float(eps), _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[p.dtype] if p is not None else 0, _build.stream(x))
    _build.check(lib, rc, "layer_norm_fwd")
    return y, mu, rstd


def layer_norm(x: torch.Tensor, w: Optional[torch.Tensor],
               b: Optional[torch.Tensor], eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm forward over the last axis: ``(y, mu, rstd)`` with ``y``
    like ``x`` and the fp32 ``[rows]`` statistics the backward reuses.

    CUDA tensors run the hand-written kernel (``layer_norm.launches``
    counts each launch); CPU tensors run ``layer_norm_plain``."""
    return _build.dispatch(layer_norm_plain, _ln_launch, x, w, b, eps)


layer_norm.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """Differentiable LayerNorm over the last axis: the forward is
    ``layer_norm`` (the kernel on the card); the backward is plain
    PyTorch from the saved ``mu``/``rstd`` by the reference ``_ln_bwd``'s
    formulas (dx in x's dtype; dw, db summed in fp32 and cast to the
    parameters' dtype)."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, mu, rstd = layer_norm(x.contiguous(), w, b, float(eps))
        ctx.save_for_backward(x, w, b, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, mu, rstd = ctx.saved_tensors
        n = x.shape[-1]
        dy2 = dy.reshape(-1, n).float()
        xhat = (x.reshape(-1, n).float() - mu[:, None]) * rstd[:, None]
        g = dy2 * w.float()[None, :] if w is not None else dy2
        mg = torch.mean(g, dim=1, keepdim=True)
        mgx = torch.mean(g * xhat, dim=1, keepdim=True)
        dx = rstd[:, None] * (g - mg - xhat * mgx)
        dw = torch.sum(dy2 * xhat, dim=0).to(w.dtype) \
            if w is not None and ctx.needs_input_grad[1] else None
        db = torch.sum(dy2, dim=0).to(b.dtype) \
            if b is not None and ctx.needs_input_grad[2] else None
        return dx.reshape(x.shape).to(x.dtype), dw, db, None

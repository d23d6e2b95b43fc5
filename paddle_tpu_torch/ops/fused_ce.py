"""LM-head matmul fused with softmax cross-entropy (counterpart of
paddle_tpu/ops/fused_ce.py).

Both functions take the hidden states ``h`` [tokens, hidden], the head's
weight ``w`` [vocab, hidden] (a transposed view of an untied [hidden,
vocab] head does as well) and integer ``labels`` [tokens], and return
the token-mean loss. Neither keeps the [tokens, vocab] logits for the
backward: the backward recomputes them from ``h`` and ``w``, as the
reference's ``custom_vjp`` does.

- ``fused_linear_cross_entropy``: the logits in one matmul.
- ``blockwise_linear_cross_entropy``: the vocabulary in ``num_blocks``
  chunks, carrying an online (max, sumexp) pair per row through the
  forward; the backward re-scans the chunks, adds each chunk's
  ``dlogits @ w_c`` into an fp32 dh and writes that chunk's dw. The
  largest CE temporary is [tokens, vocab / num_blocks].

Every LM-head product (the logits, the backward's recomputed logits,
dh's and dw's products) takes its operands in the storage dtype and
gives an fp32 result, unrounded, as the reference's
``preferred_element_type=jnp.float32`` does (``_mm32``): on the card
``torch.mm(..., out_dtype=torch.float32)``, bf16 operands at the tensor
cores' rate; on the CPU, where that overload does not exist, the product
of the operands upcast to fp32. Softmax arithmetic is fp32. The
reference computes these outside Pallas (XLA matmuls and a
``lax.scan``), so this is plain PyTorch on both devices: cuBLAS on the
card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fused_linear_cross_entropy", "blockwise_linear_cross_entropy"]


def _valid_and_denom(labels: torch.Tensor, ignore_index: Optional[int]):
    """(valid mask or None, denominator): the count of valid labels (at
    least 1) with ``ignore_index``, else the token count."""
    if ignore_index is None:
        return None, labels.shape[0]
    valid = labels != ignore_index
    return valid, torch.clamp(valid.sum(), min=1)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) in fp32, never rounded to the operands' dtype
    first: on the card bf16 or fp16 operands by ``out_dtype`` (an fp32
    GEMM would run at a fifteenth of the rate); else the operands in fp32
    (a no-op for fp32 ones)."""
    if a.dtype != torch.float32 and _on_card(a):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _logits(h: torch.Tensor, w_c: torch.Tensor) -> torch.Tensor:
    return _mm32(h, w_c.t())


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, ignore_index):
        safe = torch.clamp(labels, 0, w.shape[0] - 1)
        valid, denom = _valid_and_denom(labels, ignore_index)
        logits = _logits(h, w)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(1, safe[:, None])[:, 0]
        per_tok = lse - tgt
        if valid is not None:
            per_tok = torch.where(valid, per_tok, 0.0)
        ctx.save_for_backward(h, w, lse, safe)
        ctx.valid, ctx.denom = valid, denom
        return per_tok.sum() / denom

    @staticmethod
    def backward(ctx, g):
        h, w, lse, safe = ctx.saved_tensors
        p = torch.exp(_logits(h, w) - lse[:, None])
        dlogits = p.scatter_add(1, safe[:, None],
                                torch.full_like(lse[:, None], -1.0))
        if ctx.valid is not None:
            dlogits = dlogits * ctx.valid[:, None]
        dlogits = (dlogits * (g / ctx.denom)).to(h.dtype)
        dh = _mm32(dlogits, w).to(h.dtype)
        dw = _mm32(dlogits.t(), h).to(w.dtype)
        return dh, dw, None, None


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor,
                               ignore_index: Optional[int] = None
                               ) -> torch.Tensor:
    """Mean CE of softmax(h @ w.T) against ``labels``; with
    ``ignore_index``, rows with that label add nothing and the mean is
    over the others. Labels outside [0, vocab) otherwise read the
    nearest column, as the reference's clipping does."""
    return _FusedCE.apply(h, w, labels.long(), ignore_index)


class _BlockwiseCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, num_blocks, ignore_index):
        v = w.shape[0]
        vb = v // num_blocks
        n = h.shape[0]
        safe = torch.clamp(labels, 0, v - 1)
        valid, denom = _valid_and_denom(labels, ignore_index)
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=h.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h.device)
        tgt = torch.zeros((n,), dtype=torch.float32, device=h.device)
        for off in range(0, v, vb):
            logits = _logits(h, w[off:off + vb])
            m_new = torch.maximum(m, logits.max(dim=-1).values)
            s = s * torch.exp(m - m_new) + torch.sum(
                torch.exp(logits - m_new[:, None]), dim=-1)
            m = m_new
            idx = torch.clamp(safe - off, 0, vb - 1)
            picked = logits.gather(1, idx[:, None])[:, 0]
            in_chunk = (safe >= off) & (safe < off + vb)
            tgt = torch.where(in_chunk, picked, tgt)
            del logits
        lse = m + torch.log(s)
        per_tok = lse - tgt
        if valid is not None:
            per_tok = torch.where(valid, per_tok, 0.0)
        ctx.save_for_backward(h, w, lse, safe)
        ctx.valid, ctx.denom, ctx.vb = valid, denom, vb
        return per_tok.sum() / denom

    @staticmethod
    def backward(ctx, g):
        h, w, lse, safe = ctx.saved_tensors
        vb = ctx.vb
        scale = (g / ctx.denom).float().expand(h.shape[0])
        if ctx.valid is not None:
            scale = torch.where(ctx.valid, scale, 0.0)
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty_like(w)
        for off in range(0, w.shape[0], vb):
            w_c = w[off:off + vb]
            p = torch.exp(_logits(h, w_c) - lse[:, None])
            idx = torch.clamp(safe - off, 0, vb - 1)
            in_chunk = (safe >= off) & (safe < off + vb)
            # p - onehot: -1 at the label inside this chunk, -0.0 (which
            # leaves p as it is) on rows whose label lies elsewhere
            p.scatter_add_(1, idx[:, None], -in_chunk.float()[:, None])
            dlogits = (p * scale[:, None]).to(h.dtype)
            del p
            dh += _mm32(dlogits, w_c)
            dw[off:off + vb] = _mm32(dlogits.t(), h).to(w.dtype)
        return dh.to(h.dtype), dw, None, None, None


def blockwise_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                                   labels: torch.Tensor, num_blocks: int = 8,
                                   ignore_index: Optional[int] = None
                                   ) -> torch.Tensor:
    """Mean CE of softmax(h @ w.T) against ``labels``, streamed over
    ``num_blocks`` vocabulary chunks; the vocabulary must divide by
    ``num_blocks``. ``ignore_index`` as in
    ``fused_linear_cross_entropy``."""
    v = w.shape[0]
    if v % num_blocks:
        raise ValueError(f"vocab {v} not divisible by num_blocks "
                         f"{num_blocks}")
    return _BlockwiseCE.apply(h, w, labels.long(), int(num_blocks),
                              ignore_index)

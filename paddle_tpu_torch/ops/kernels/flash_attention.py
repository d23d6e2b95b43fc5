"""Flash attention: the CUDA kernels ``csrc/flash_attention_sm90.cu``
(forward, dq and dkv on the tensor cores by wgmma and TMA) and
``csrc/flash_attention.cu`` (the bf16 forward, dq and dkv on the tensor
cores by mma.sync, ``fwd_mma_kernel``, ``dq_mma_kernel`` and
``dkv_mma_kernel``; the fp32 forward, dq and dkv as fp32 FMA loops,
blocked in registers behind a cp.async ring up to head dim 128), and their
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: the plain
functions compute what its Pallas kernels ``_fwd_kernel``,
``_dq_kernel`` and ``_dkv_kernel`` compute, on the public ``[B, S, H, D]``
layout, and are fed the same ``lse`` and ``delta = rowsum(dO * O)``:

- GQA: q head ``h`` of batch ``b`` reads kv head ``h // (Hq // Hk)``
  (``_kv_index``); dk/dv sum over each kv head's group of q heads
  without expanding K/V (the plain versions stack the group's q heads
  as extra rows of one product);
- scores: the fp32 product ``scale * (q . k)``, plus an optional
  additive ``bias`` (any tensor broadcastable to ``[B, Hq, Sq, Sk]``,
  added in fp32), then the masks; dk carries the scale explicitly;
- causal masking keeps key ``j`` for query ``i`` iff
  ``j <= i + (Sk - Sq)``: the bottom-right diagonal, not PyTorch's
  top-left ``is_causal``; a row that sees no key gives out = 0 and
  lse = -inf;
- segments (``Segments``: the ``[B, Sq]`` / ``[B, Sk]`` int32 words of
  ``encode_segments``) hide keys of other segments and, under their
  ``causal``, keys past each segment's own diagonal (``_seg_mask``);
- products take their inputs in storage dtype and accumulate in fp32:
  ``p`` is rounded to v's dtype before ``P V`` (and to dO's before
  ``P^T dO``), ``ds`` to k's / q's dtype before its products;
- dropout keeps an element by the murmur3 hash of ``dropout_keep_mask``
  (``_keep_block`` / ``_mix_seed``), bit for bit, in int32 ops; lse
  comes from the undropped probabilities;
- dbias is ``ds`` in fp32: the dq pass emits it for a full-shape bias
  (``dbias=True``); ``flash_dbias_broadcast`` sums it onto a broadcast
  bias's shape one (batch, head) slice at a time (``_dbias_broadcast``).

``flash_fwd``, ``flash_dq`` and ``flash_dkv`` pick by device: a CPU
tensor runs the plain version; a CUDA tensor launches a kernel or raises.
Which kernel is ``flash_route``'s choice, a documented split and not a
fallback: bf16 operands with a head dim that is a multiple of 8 up to 128
and 16-byte aligned take the wgmma kernels (TMA needs those strides and
alignments), everything else (fp32; bf16 head dims above 128 or not a
multiple of 8; operands off 16-byte boundaries) the FMA route, where the
bf16 forward, dq and dkv run on the tensor cores by mma.sync (which takes
any head dim and alignment) and fp32 on FFMA kernels.
fp32 stays off the tensor cores: its contract is fp32 sums in the plain
version's order, which TF32 products, even split into three passes
(3xTF32), do not hold (PERF.md).
Both routes take the bias (a strided fp32 view: broadcast dims are never
materialised), the segment words and the dbias output. The wgmma
forward, dq and dkv kernels take a bias in one of two classes,
``flash_bias_class``'s choice: "keys" (it does not vary along queries, as
every padding mask) is read once per key, "plane" (every other bias, and
any with segments or dbias) element by element.
Each kernel counts its own launches: ``flash_fwd.launches``,
``flash_dq.launches`` and ``flash_dkv.launches`` the FMA route's FFMA
kernels' (fp32), ``flash_fwd.mma.launches``, ``flash_dq.mma.launches`` and
``flash_dkv.mma.launches`` its bf16 mma.sync kernels',
``flash_fwd.wgmma.launches``, ``flash_dq.wgmma.launches`` and
``flash_dkv.wgmma.launches`` the wgmma kernels'; a launch with a bias (its
own template instantiation on both routes) counts instead on
``.bias.launches`` (FFMA), ``.mma_bias.launches`` (bf16 on the FMA route)
or ``.wgmma_bias.launches`` (wgmma, the "plane" class), and a wgmma launch
of the "keys" class on ``.wgmma_keybias.launches``.
``flash_attention_ext`` is the differentiable entry (a
``torch.autograd.Function`` saving ``(q, k, v, out, lse)`` like
``_fa_fwd``/``_fa_bwd``); ``flash_chunk_fwd`` / ``flash_chunk_bwd`` are
the chunk-level entries ring attention builds on.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_plain",
           "flash_dq_plain", "flash_dkv_plain", "flash_dbias_broadcast",
           "flash_attention_ext", "flash_chunk_fwd", "flash_chunk_bwd",
           "flash_route", "flash_bias_class", "Segments", "encode_segments",
           "dropout_keep_mask", "dropout_threshold", "MAX_HEAD_DIM",
           "WGMMA_MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
WGMMA_MAX_HEAD_DIM = 128
_DTYPE_CODES = _build.DTYPE_CODES
_SIGN = -(1 << 31)                    # int32 0x80000000


def _i32(v: int) -> int:
    """uint32 bit pattern as the int32 the hash runs on."""
    return v - (1 << 32) if v >= (1 << 31) else v


_GOLDEN = _i32(0x9E3779B1)
_M1 = _i32(0x85EBCA6B)
_M2 = _i32(0xC2B2AE35)


def dropout_threshold(rate: float) -> int:
    """keep iff ``(hash ^ 0x80000000) >= threshold`` (signed int32), so
    P(drop) == rate (``_dropout_thresh``)."""
    t = min(int(float(rate) * 2 ** 32), 2 ** 32 - 1)
    return _i32(t) ^ _SIGN


def _keep_scale(rate: float) -> float:
    """``1 / (1 - rate)`` rounded to fp32, as the kernels multiply by it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _srl(h: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of an int32 tensor."""
    return (h >> n) & ((1 << (32 - n)) - 1)


def _mix_seed(seed: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """Per-(batch*head) 32-bit seed (``_mix_seed``), int32 wraparound."""
    h = seed.reshape(()).to(torch.int32) ^ (bh * _GOLDEN)
    h = h * _M1
    h = h ^ _srl(h, 7)
    h = h * _M2
    return h ^ _srl(h, 15)


def _keep(seed_bh: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
          sk: int, rate: float) -> torch.Tensor:
    """Keep-mask of ``_keep_block`` at global (row, col) indices, broadcast
    over ``seed_bh`` / ``rows`` / ``cols``."""
    h = (rows * sk + cols) ^ seed_bh
    h = h * _M1
    h = h ^ _srl(h, 13)
    h = h * _M2
    h = h ^ _srl(h, 16)
    return (h ^ _SIGN) >= dropout_threshold(rate)


def dropout_keep_mask(seed, bh_total: int, sq: int, sk: int, rate: float,
                      device=None, bh_start: int = 0) -> torch.Tensor:
    """The full ``[BH, Sq, Sk]`` bool keep-mask the kernels generate for
    int32 ``seed`` (the reference's ``dropout_keep_mask``); ``bh_start``
    gives the slices of (batch * head) indices ``bh_start ..
    bh_start + bh_total - 1``."""
    seed = torch.as_tensor(seed, dtype=torch.int32, device=device)
    dev = seed.device
    bh = torch.arange(bh_start, bh_start + bh_total, dtype=torch.int32,
                      device=dev)
    rows = torch.arange(sq, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(sk, dtype=torch.int32, device=dev)[None, :]
    return _keep(_mix_seed(seed, bh)[:, None, None], rows, cols, sk, rate)



# ---------------------------------------------------------------------------
# bias and segments
# ---------------------------------------------------------------------------

class Segments(NamedTuple):
    """Encoded segment words of one call (``encode_segments``)."""
    q: torch.Tensor          # [B, Sq] int32
    k: torch.Tensor          # [B, Sk] int32
    causal: bool             # per-segment diagonal (the reference's seg_causal)


def encode_segments(seg: torch.Tensor) -> torch.Tensor:
    """Nondecreasing ``[B, S]`` segment ids -> int32 words (``_encode_seg``):
    the id in the high bits and the end-relative position ``local - L``
    biased by 0x8000 in the low 16. Two positions share a segment iff
    their high bits match, and the per-segment causal rule
    ``k_local <= q_local + Lk - Lq`` is ``klow <= qlow``, so unequal q/k
    segment lengths need nothing more. Ids below 2^15, segments at most
    2^15 long."""
    seg = seg.to(torch.int32).contiguous()
    pos = torch.arange(seg.shape[1], dtype=torch.int32, device=seg.device)
    left = torch.searchsorted(seg, seg, side="left").to(torch.int32)
    right = torch.searchsorted(seg, seg, side="right").to(torch.int32)
    v = (pos - left) - (right - left)                # in [-L, -1]
    return (seg << 16) | (v + 0x8000)


def _seg_visible(seg: Segments, rep: int) -> torch.Tensor:
    """``_seg_mask`` in the grouped layout: [B, rep * Sq, Sk] bool."""
    qw = seg.q.repeat(1, rep)[:, :, None]
    kw = seg.k[:, None, :]
    same = (qw >> 16) == (kw >> 16)
    if seg.causal:
        same = same & ((kw & 0xFFFF) <= (qw & 0xFFFF))
    return same


def _bias4(bias: torch.Tensor, b: int, hq: int, sq: int, sk: int
           ) -> torch.Tensor:
    """``bias`` as an fp32 ``[B, Hq, Sq, Sk]`` view: broadcast dims
    expanded with stride 0 (never materialised), the key stride 0 or 1
    (a bias strided along the keys is made contiguous first)."""
    if bias.dim() > 4:
        raise ValueError(f"flash attention: bias {tuple(bias.shape)} has "
                         f"more than 4 dims")
    x = bias.to(torch.float32)
    if x.dim() and x.shape[-1] > 1 and x.stride(-1) != 1:
        x = x.contiguous()
    x = x.reshape((1,) * (4 - x.dim()) + tuple(x.shape))
    try:
        return x.expand(b, hq, sq, sk)
    except RuntimeError as e:
        raise ValueError(f"flash attention: bias {tuple(bias.shape)} does "
                         f"not broadcast to [{b}, {hq}, {sq}, {sk}]") from e


def _bias_shape4(bias: torch.Tensor) -> Tuple[int, ...]:
    return (1,) * (4 - bias.dim()) + tuple(bias.shape)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _grouped(x: torch.Tensor, hk: int) -> torch.Tensor:
    """[B, S, Hq, D] -> fp32 [B, Hk, rep * S, D]: each kv head's group of
    q heads stacked as rows (row ``r * S + i`` is q head ``hk*rep + r``,
    position ``i``)."""
    b, s, hq, d = x.shape
    return x.float().reshape(b, s, hk, hq // hk, d).permute(
        0, 2, 3, 1, 4).reshape(b, hk, (hq // hk) * s, d)


def _ungrouped(x: torch.Tensor, s: int) -> torch.Tensor:
    """Inverse of ``_grouped``: [B, Hk, rep * S, D] -> [B, S, Hq, D]."""
    b, hk, rs, d = x.shape
    rep = rs // s
    return x.reshape(b, hk, rep, s, d).permute(0, 3, 1, 2, 4).reshape(
        b, s, hk * rep, d)


def _kv(x: torch.Tensor) -> torch.Tensor:
    """[B, S, Hk, D] -> fp32 [B, Hk, S, D]."""
    return x.float().permute(0, 2, 1, 3)


def _rows_stat(x: torch.Tensor, hk: int) -> torch.Tensor:
    """[B, Hq, Sq] row statistic -> [B, Hk, rep * Sq, 1]."""
    b, hq, sq = x.shape
    return x.float().reshape(b, hk, (hq // hk) * sq, 1)


def _masked_scores(q, k, causal: bool, scale: float, bias=None,
                   seg: Optional[Segments] = None) -> torch.Tensor:
    """fp32 ``scale * q . k`` (+ bias) as [B, Hk, rep * Sq, Sk], -inf
    where the causal diagonal or the segments hide the key."""
    b, sq, hq, _ = q.shape
    hk, sk = k.shape[2], k.shape[1]
    rep = hq // hk
    s = torch.matmul(_grouped(q, hk), _kv(k).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + _bias4(bias, b, hq, sq, sk).reshape(b, hk, rep * sq, sk)
    if causal:
        qi = torch.arange(sq, device=q.device).repeat(rep)
        kj = torch.arange(sk, device=q.device)
        visible = kj[None, :] <= qi[:, None] + (sk - sq)
        s = s.masked_fill(~visible, float("-inf"))
    if seg is not None:
        s = s.masked_fill(~_seg_visible(seg, rep)[:, None], float("-inf"))
    return s


def _group_keep(seed, q, k, rate: float, bh_start: int = 0) -> torch.Tensor:
    """The dropout keep-mask in the grouped [B, Hk, rep * Sq, Sk] layout;
    ``bh_start``: the (batch * head) index of q's first slice, where q is
    one slice of a larger call."""
    b, sq, hq, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    keep = dropout_keep_mask(seed.to(q.device), b * hq, sq, sk, rate,
                             bh_start=bh_start)
    return keep.reshape(b, hk, (hq // hk) * sq, sk)


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` (the MXU operand cast), back in fp32."""
    return x.to(dtype).float()


def _probs(q, k, lse, causal, scale, bias, seg) -> torch.Tensor:
    """p = exp(s - lse) with a -inf lse (row sees no key) read as 0."""
    lse_g = _rows_stat(lse, k.shape[2])
    lse_safe = torch.where(lse_g == float("-inf"), 0.0, lse_g)
    return torch.exp(_masked_scores(q, k, causal, scale, bias, seg)
                     - lse_safe)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float, rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    seg: Optional[Segments] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of q [B,Sq,Hq,D] over k/v [B,Sk,Hk,D]: returns
    ``(out [B,Sq,Hq,D] in q's dtype, lse [B,Hq,Sq] fp32)``."""
    b, sq, hq, _ = q.shape
    s = _masked_scores(q, k, causal, scale, bias, seg)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        p = torch.where(_group_keep(seed, q, k, rate), p * _keep_scale(rate),
                        0.0)
    acc = torch.matmul(_round_to(p, v.dtype), _kv(v))
    out = torch.where(l > 0, acc / torch.where(l == 0, 1.0, l), 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-38)),
                      float("-inf"))
    return (_ungrouped(out, sq).to(q.dtype),
            lse.reshape(b, hq, sq))


def _ds(q, k, v, do, lse, delta, causal, scale, rate, seed, bias, seg,
        bh_start: int = 0):
    """(p, dP dropped, ds) in the grouped layout, fp32; ``bh_start`` as in
    ``_group_keep``."""
    hk = k.shape[2]
    p = _probs(q, k, lse, causal, scale, bias, seg)
    dp = torch.matmul(_grouped(do, hk), _kv(v).transpose(-1, -2))
    if rate > 0.0:
        dp = torch.where(_group_keep(seed, q, k, rate, bh_start),
                         dp * _keep_scale(rate), 0.0)
    return p, dp, p * (dp - _rows_stat(delta, hk))


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                   rate: float = 0.0, seed: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   seg: Optional[Segments] = None, dbias: bool = False):
    """dq [B,Sq,Hq,D] (q's dtype) from the saved lse and
    delta = rowsum(dO * O), both [B,Hq,Sq] fp32; with ``dbias`` also
    ``ds`` as fp32 [B,Hq,Sq,Sk] (the dq kernel's dbias output)."""
    b, sq, hq, _ = q.shape
    _, _, ds = _ds(q, k, v, do, lse, delta, causal, scale, rate, seed, bias,
                   seg)
    dq = torch.matmul(_round_to(ds, k.dtype), _kv(k)) * scale
    dq = _ungrouped(dq, sq).to(q.dtype)
    if dbias:
        return dq, ds.reshape(b, hq, sq, k.shape[1])
    return dq


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                    rate: float = 0.0, seed: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    seg: Optional[Segments] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Sk,Hk,D] in k's / v's dtype, summed over each kv
    head's group of q heads."""
    hk = k.shape[2]
    p, _, ds = _ds(q, k, v, do, lse, delta, causal, scale, rate, seed, bias,
                   seg)
    p_v = p
    if rate > 0.0:
        p_v = torch.where(_group_keep(seed, q, k, rate),
                          p * _keep_scale(rate), 0.0)
    do_g = _grouped(do, hk)
    dv = torch.matmul(_round_to(p_v, do.dtype).transpose(-1, -2), do_g)
    dk = torch.matmul(_round_to(ds, q.dtype).transpose(-1, -2),
                      _grouped(q, hk)) * scale
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_dbias_broadcast(q, k, v, do, lse, delta, bias: torch.Tensor,
                          causal: bool, scale: float, rate: float = 0.0,
                          seed: Optional[torch.Tensor] = None,
                          seg: Optional[Segments] = None) -> torch.Tensor:
    """dbias of a broadcast bias, fp32 in ``bias``'s shape
    (``_dbias_broadcast``): ds is recomputed one (batch, head) slice at a
    time and summed onto the bias's broadcast dims, so the peak is one
    (Sq, Sk) matrix, never [B, Hq, Sq, Sk]. Plain PyTorch on every device,
    as the reference leaves it to XLA."""
    b, sq, hq, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = hq // hk
    b4 = _bias4(bias, b, hq, sq, sk)
    bb, hb, sqb, skb = _bias_shape4(bias)
    acc = torch.zeros((bb, hb, sqb, skb), dtype=torch.float32,
                      device=q.device)
    for bi in range(b):
        one = (None if seg is None else
               Segments(seg.q[bi:bi + 1], seg.k[bi:bi + 1], seg.causal))
        for h in range(hq):
            # the (bi, h) slice through the plain ds, its dropout hash at
            # the slice's own (batch * head) index
            kv = slice(h // rep, h // rep + 1)
            _, _, ds = _ds(q[bi:bi + 1, :, h:h + 1], k[bi:bi + 1, :, kv],
                           v[bi:bi + 1, :, kv], do[bi:bi + 1, :, h:h + 1],
                           lse[bi:bi + 1, h:h + 1], delta[bi:bi + 1, h:h + 1],
                           causal, scale, rate, seed, b4[bi:bi + 1, h:h + 1],
                           one, bh_start=bi * hq + h)
            red = ds[0, 0]
            if sqb == 1:
                red = red.sum(0, keepdim=True)
            if skb == 1:
                red = red.sum(1, keepdim=True)
            acc[bi if bb > 1 else 0, h if hb > 1 else 0] += red
    return acc.reshape(bias.shape)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, *more) -> Tuple[int, int, int, int, int, int]:
    """Validate the kernels' operands; returns (B, Sq, Sk, Hq, Hk, D)."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16,"
                        f" got {q.dtype}")
    for t in (k, v) + more:
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("flash attention: q, k, v (and dO) must share "
                            "one dtype and device")
    for t in (q, k, v) + more:
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous "
                             "[B, S, H, D] operands")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention: q [B,Sq,Hq,D], k/v [B,Sk,Hk,D];"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hk < 1 or hq % hk:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (Hq % Hk must be 0)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take head_dim 1.."
                         f"{MAX_HEAD_DIM}, got {d}")
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"flash attention: dO {tuple(t.shape)} must "
                             f"match q {tuple(q.shape)}")
    return b, sq, sk, hq, hk, d


def _mask_args(q, dims, bias, seg) -> Tuple[tuple, Optional[torch.Tensor]]:
    """The Mask arguments of a C entry (bias pointer and element strides,
    segment word pointers, seg_causal), and the fp32 bias view they point
    into: the caller keeps it referenced until the launch is enqueued
    (freed earlier, its block could back the call's own outputs)."""
    b, sq, sk, hq, _, _ = dims
    b4 = None
    if bias is not None:
        if bias.device != q.device:
            raise ValueError(f"flash attention: bias on {bias.device}, q on "
                             f"{q.device}")
        b4 = _bias4(bias, b, hq, sq, sk)
        args = (_build.ptr(b4), *b4.stride())
    else:
        args = (None, 0, 0, 0, 0)
    if seg is None:
        return args + (None, None, 0), b4
    for name, t, n in (("q", seg.q, sq), ("k", seg.k, sk)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (b, n)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash attention: {name} segment words must "
                             f"be contiguous int32 [{b}, {n}] on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    return args + (_build.ptr(seg.q), _build.ptr(seg.k),
                   int(bool(seg.causal))), b4


def flash_route(dtype: torch.dtype, head_dim: int,
                addresses: Sequence[int] = ()) -> str:
    """The kernel a CUDA call of ``flash_fwd``, ``flash_dq`` or
    ``flash_dkv`` launches: ``"wgmma"`` (``csrc/flash_attention_sm90.cu``)
    for bf16 with ``head_dim`` a multiple of 8 up to
    ``WGMMA_MAX_HEAD_DIM`` (so the head stride ``D * 2`` and row stride
    ``H * D * 2`` bytes are multiples of 16, as TMA requires) and every
    operand address 16-byte aligned; ``"fma"`` (``csrc/flash_attention.cu``)
    otherwise. A bias or segments do not enter the choice. On the FMA
    route bf16, at any head dim up to 256 and any alignment, runs
    ``fwd_mma_kernel``, ``dq_mma_kernel`` and ``dkv_mma_kernel``
    (mma.sync m16n8k16 behind a cp.async ring, p and ds rounded to bf16
    in registers as the contract asks; dkv splits D between two warps at
    head dims above 128); fp32 with ``head_dim`` up to 128 runs
    ``fwd_fp32_kernel``, ``dq_fp32_kernel`` and ``dkv_fp32_kernel`` (FFMA
    blocked in registers, a cp.async ring), wider fp32 heads the one-tile
    FFMA kernels; the FFMA kernels sum in the plain version's order, so
    in fp32 they give its bits wherever cuBLAS sums in that order too.
    fp32 never takes the tensor cores: TF32 products, even as 3xTF32,
    miss the fp32 tolerance."""
    if (dtype == torch.bfloat16 and head_dim % 8 == 0
            and 0 < head_dim <= WGMMA_MAX_HEAD_DIM
            and all(a % 16 == 0 for a in addresses)):
        return "wgmma"
    return "fma"


def flash_bias_class(shape4: Sequence[int], strides4: Sequence[int],
                     segments: bool = False, dbias: bool = False) -> str:
    """The bias class a wgmma forward, dq or dkv launch takes, for a bias
    viewed as ``[B, Hq, Sq, Sk]`` with element strides ``strides4``
    (``_bias4``'s view): ``"keys"`` when it does not vary along queries
    (query stride 0, or Sq = 1), as ``[B,1,1,Sk]``, ``[1,Hq,1,Sk]``,
    ``[B,Hq,1,Sk]`` and every padding mask, read once per key; ``"plane"``
    otherwise, read element by element. A call with segments or a dbias
    output takes "plane": the "keys" kernels are built without either."""
    if len(shape4) != 4 or len(strides4) != 4:
        raise ValueError(f"flash_bias_class: a 4-d view, got shape "
                         f"{tuple(shape4)}, strides {tuple(strides4)}")
    if segments or dbias:
        return "plane"
    return "keys" if strides4[2] == 0 or shape4[2] == 1 else "plane"


def _route(*tensors: torch.Tensor) -> str:
    q = tensors[0]
    return flash_route(q.dtype, q.shape[-1], [t.data_ptr() for t in tensors])


def _check_stat(name: str, t: torch.Tensor, b: int, hq: int, sq: int):
    if (t.dtype != torch.float32 or tuple(t.shape) != (b, hq, sq)
            or not t.is_contiguous()):
        raise ValueError(f"flash attention: {name} must be contiguous fp32 "
                         f"[{b}, {hq}, {sq}], got {t.dtype} "
                         f"{tuple(t.shape)}")


def _drop_args(rate: float, seed: Optional[torch.Tensor], like):
    """(on, threshold, keep scale, seed pointer) for a launch."""
    if rate <= 0.0:
        return 0, 0, 1.0, None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"flash attention: dropout rate {rate} not in "
                         f"[0, 1)")
    if (seed is None or seed.dtype != torch.int32 or seed.numel() < 1
            or seed.device != like.device):
        raise ValueError("flash attention: dropout needs an int32 seed "
                         "tensor on the operands' device")
    return (1, dropout_threshold(rate), _keep_scale(rate),
            _build.ptr(seed))


def _entry_args(dims, scale, causal, rate, seed, q, route, mask, *extra):
    """The scalar and mask arguments of a C entry, then ``extra`` (dq's
    dbias pointer; the wgmma entries' bias class); the wgmma entries take
    no dtype code (bf16 only)."""
    dtype = () if route == "wgmma" else (_DTYPE_CODES[q.dtype],)
    return (*dims, float(scale), int(bool(causal)),
            *_drop_args(rate, seed, q), *mask, *extra, *dtype,
            _build.stream(q))


def _launch_on(route: str, wrapper, entry: str, tensors, args,
               bias, keys: bool = False) -> None:
    """Launch C entry ``entry`` (``<entry>_sm90`` of
    ``flash_attention_sm90`` on the wgmma route, else of
    ``flash_attention``), counted on ``wrapper``'s counter of that route
    (bf16 on the FMA route: ``.mma``, the mma.sync kernels),
    and with a ``bias`` on the counter of that kernel's bias
    instantiation (with ``keys``, the wgmma "keys" class's); a non-zero
    CUDA error code raises."""
    if route == "wgmma":
        lib = _build.load("flash_attention_sm90")
        counter = (wrapper.wgmma_keybias if keys else
                   wrapper.wgmma_bias if bias is not None else wrapper.wgmma)
        entry += "_sm90"
    else:
        lib = _build.load("flash_attention")
        if tensors[0].dtype == torch.bfloat16:
            counter = wrapper.mma_bias if bias is not None else wrapper.mma
        else:
            counter = wrapper.bias if bias is not None else wrapper
    counter.launches += 1
    rc = getattr(lib, entry)(*map(_build.ptr, tensors), *args)
    _build.check(lib, rc, entry)


def _fwd_launch(q, k, v, causal, scale, rate, seed, bias=None, seg=None,
                route=None, bias_class=None):
    """``route`` defaults to ``flash_route``'s choice; the on-card checks
    also name "fma" for bf16, to hold and time that kernel on the main
    path's inputs. ``bias_class`` as in ``_dq_launch``."""
    dims = _check(q, k, v)
    b, sq, _, hq, _, _ = dims
    mask, bias32 = _mask_args(q, dims, bias, seg)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    route = route or _route(q, k, v, out)
    keys = _keys_class(route, bias32, seg, bias_class=bias_class)
    extra = (int(keys),) if route == "wgmma" else ()
    _launch_on(route, flash_fwd, "flash_fwd", (q, k, v, out, lse),
               _entry_args(dims, scale, causal, rate, seed, q, route, mask,
                           *extra), bias, keys)
    return out, lse


def _keys_class(route: str, bias32, seg, dbias: bool = False,
                bias_class: Optional[str] = None) -> bool:
    """Whether a launch on ``route`` takes the "keys" bias class:
    ``bias_class`` where given, else ``flash_bias_class``'s choice (the
    FMA kernels have no classes)."""
    if route != "wgmma" or bias32 is None:
        return False
    return (bias_class or flash_bias_class(
        bias32.shape, bias32.stride(), seg is not None, dbias)) == "keys"


def _dq_launch(q, k, v, do, lse, delta, causal, scale, rate, seed,
               bias=None, seg=None, dbias=False, route=None,
               bias_class=None):
    """``route`` as in ``_fwd_launch``; ``dbias`` also returns ds as a
    fp32 [B, Hq, Sq, Sk] tensor (zero where the kernel skips a tile).
    ``bias_class`` defaults to ``flash_bias_class``'s choice; the on-card
    checks also name "plane" for a "keys" bias, to hold the two classes
    to the same bits (the kernel refuses a "keys" class for a bias that
    varies along queries)."""
    dims = _check(q, k, v, do)
    b, sq, sk, hq, _, _ = dims
    _check_stat("lse", lse, b, hq, sq)
    _check_stat("delta", delta, b, hq, sq)
    if dbias and bias is None:
        raise ValueError("flash attention: dbias needs a bias")
    mask, bias32 = _mask_args(q, dims, bias, seg)
    dq = torch.empty_like(q)
    db = (torch.zeros((b, hq, sq, sk), dtype=torch.float32, device=q.device)
          if dbias else None)
    route = route or _route(q, k, v, do, dq)
    keys = _keys_class(route, bias32, seg, dbias, bias_class)
    extra = (_build.ptr(db),) + ((int(keys),) if route == "wgmma" else ())
    _launch_on(route, flash_dq, "flash_dq", (q, k, v, do, lse, delta, dq),
               _entry_args(dims, scale, causal, rate, seed, q, route, mask,
                           *extra), bias, keys)
    return (dq, db) if dbias else dq


def _dkv_launch(q, k, v, do, lse, delta, causal, scale, rate, seed,
                bias=None, seg=None, route=None, bias_class=None):
    """``route`` as in ``_fwd_launch``, ``bias_class`` as in
    ``_dq_launch``."""
    dims = _check(q, k, v, do)
    b, sq, _, hq, _, _ = dims
    _check_stat("lse", lse, b, hq, sq)
    _check_stat("delta", delta, b, hq, sq)
    mask, bias32 = _mask_args(q, dims, bias, seg)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    route = route or _route(q, k, v, do, dk, dv)
    keys = _keys_class(route, bias32, seg, bias_class=bias_class)
    extra = (int(keys),) if route == "wgmma" else ()
    _launch_on(route, flash_dkv, "flash_dkv",
               (q, k, v, do, lse, delta, dk, dv),
               _entry_args(dims, scale, causal, rate, seed, q, route, mask,
                           *extra), bias, keys)
    return dk, dv


def flash_fwd(q, k, v, causal: bool, scale: float, rate: float = 0.0,
              seed: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              seg: Optional[Segments] = None):
    """``(out, lse)``: a forward kernel on the card, by ``flash_route``
    (counted in ``flash_fwd.wgmma.launches``, ``flash_fwd.mma.launches``
    (bf16 on the FMA route) or ``flash_fwd.launches`` (fp32), or with a
    bias in ``.wgmma_bias`` / ``.mma_bias`` / ``.bias``, a "keys" bias on
    the wgmma route ``.wgmma_keybias``), ``flash_fwd_plain`` on the
    CPU."""
    return _build.dispatch(flash_fwd_plain, _fwd_launch, q, k, v, causal,
                           scale, rate, seed, bias, seg)


def flash_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
             rate: float = 0.0, seed: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             seg: Optional[Segments] = None, dbias: bool = False):
    """dq, or ``(dq, dbias)`` with ``dbias``: a dq kernel on the card, by
    ``flash_route`` (counted in ``flash_dq.wgmma.launches``,
    ``flash_dq.mma.launches`` (bf16 on the FMA route, ``dq_mma_kernel``)
    or ``flash_dq.launches`` (fp32), or with a bias in ``.wgmma_bias`` /
    ``.mma_bias`` / ``.bias``, a "keys" bias on the wgmma route
    ``.wgmma_keybias``), ``flash_dq_plain`` on the CPU."""
    return _build.dispatch(flash_dq_plain, _dq_launch, q, k, v, do, lse,
                           delta, causal, scale, rate, seed, bias, seg,
                           dbias)


def flash_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
              rate: float = 0.0, seed: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              seg: Optional[Segments] = None):
    """(dk, dv): a dkv kernel on the card, by ``flash_route`` (counted in
    ``flash_dkv.wgmma.launches``, ``flash_dkv.mma.launches`` (bf16 on the
    FMA route, ``dkv_mma_kernel``) or ``flash_dkv.launches`` (fp32), or
    with a bias in ``.wgmma_bias`` / ``.mma_bias`` / ``.bias``, a "keys"
    bias on the wgmma route ``.wgmma_keybias``), ``flash_dkv_plain`` on
    the CPU."""
    return _build.dispatch(flash_dkv_plain, _dkv_launch, q, k, v, do, lse,
                           delta, causal, scale, rate, seed, bias, seg)


class KernelCount:
    """The launch count (``.launches``) of another kernel behind a wrapper
    that routes between several."""

    def __init__(self) -> None:
        self.launches = 0


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0
for _wrapper in (flash_fwd, flash_dq, flash_dkv):
    _wrapper.wgmma = KernelCount()
    _wrapper.bias = KernelCount()
    _wrapper.wgmma_bias = KernelCount()
    _wrapper.wgmma_keybias = KernelCount()
    _wrapper.mma = KernelCount()
    _wrapper.mma_bias = KernelCount()


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta_i = rowsum(dO_i * O_i) as fp32 [B, Hq, Sq]: cheap
    elementwise, plain torch (the reference leaves it to XLA)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, seg_q, seg_k, causal, seg_causal,
                scale, rate):
        seg = None if seg_q is None else Segments(seg_q, seg_k, seg_causal)
        out, lse = flash_fwd(q, k, v, causal, scale, rate, seed, bias, seg)
        ctx.save_for_backward(q, k, v, out, lse, seed, bias, seg_q, seg_k)
        ctx.attrs = (causal, seg_causal, scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seed, bias, seg_q, seg_k = ctx.saved_tensors
        causal, seg_causal, scale, rate = ctx.attrs
        seg = None if seg_q is None else Segments(seg_q, seg_k, seg_causal)
        dout = dout.contiguous()
        delta = _delta(dout, out)
        args = (q, k, v, dout, lse, delta, causal, scale, rate, seed, bias,
                seg)
        dbias = None
        # dbias only when asked for: an attention mask needs none
        if bias is not None and ctx.needs_input_grad[3]:
            b, sq, hq, _ = q.shape
            if _bias_shape4(bias) == (b, hq, sq, k.shape[1]):
                # full shape: the dq kernel emits it tile by tile
                dq, db = flash_dq(*args, dbias=True)
            else:
                dq = flash_dq(*args)
                db = flash_dbias_broadcast(q, k, v, dout, lse, delta, bias,
                                           causal, scale, rate, seed, seg)
            dbias = db.reshape(bias.shape).to(bias.dtype)
        else:
            dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        return dq, dk, dv, dbias, None, None, None, None, None, None, None


def flash_attention_ext(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        seed: Optional[torch.Tensor] = None,
                        q_seg: Optional[torch.Tensor] = None,
                        k_seg: Optional[torch.Tensor] = None,
                        causal: bool = False, scale: Optional[float] = None,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Differentiable flash attention: q [B,Sq,Hq,D], k/v [B,Sk,Hk,D] ->
    out [B,Sq,Hq,D]. ``bias``: an additive bias broadcastable to
    [B,Hq,Sq,Sk] (differentiable: dbias in the bias's shape and dtype,
    computed only when the bias requires grad). ``seed`` (int32, one
    element, on q's device) drives the dropout mask. ``q_seg``/``k_seg``:
    nondecreasing [B,Sq]/[B,Sk] segment ids; attention never crosses a
    segment, and ``causal`` then applies each segment's own diagonal
    (``k_local - Lk <= q_local - Lq``) in place of the global one."""
    if (q_seg is None) != (k_seg is None):
        raise ValueError("flash_attention_ext: give both q_seg and k_seg, "
                         "or neither")
    rate = float(dropout_rate)
    if rate > 0.0 and seed is None:
        raise ValueError("flash_attention_ext: seed is required when "
                         "dropout_rate > 0")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    seg_q = seg_k = None
    seg_causal = False
    if q_seg is not None:
        seg_q = encode_segments(q_seg.to(q.device))
        seg_k = encode_segments(k_seg.to(q.device))
        # per-segment diagonals ride in the words; the global diagonal
        # (and its tile skip) would be wrong where q/k lengths differ
        seg_causal, causal = bool(causal), False
    return _FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), bias,
        seed if rate > 0.0 else None, seg_q, seg_k, bool(causal),
        seg_causal, float(scale), rate)


# ---------------------------------------------------------------------------
# chunk-level entries: the building blocks of ring attention
# ---------------------------------------------------------------------------

def flash_chunk_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial attention of q [B,Sq,Hq,D] against one k/v chunk
    [B,Sc,Hk,D]: ``(out, lse [B,Hq,Sq])`` normalised over this chunk
    only; callers merge chunks by log-sum-exp. GQA-native."""
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                     bool(causal), float(scale))


def flash_chunk_bwd(q, k, v, do, lse, delta, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of one chunk's share, given the global (all chunks
    merged) lse and delta = rowsum(dO * out), both [B,Hq,Sq]: with the
    global lse, p = exp(s - lse) is the chunk's slice of the true
    posterior, so the chunks' gradients sum to the full ones."""
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    dq = flash_dq(q, k, v, do, lse, delta, bool(causal), float(scale))
    dk, dv = flash_dkv(q, k, v, do, lse, delta, bool(causal), float(scale))
    return dq, dk, dv

"""Flash attention: the CUDA kernels ``csrc/flash_attention_sm90.cu``
(forward, dq and dkv on the tensor cores) and ``csrc/flash_attention.cu``
(forward, dq and dkv as fp32 FMA loops), and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: the plain
functions compute what its Pallas kernels ``_fwd_kernel``,
``_dq_kernel`` and ``_dkv_kernel`` compute, on the public ``[B, S, H, D]``
layout, and are fed the same ``lse`` and ``delta = rowsum(dO * O)``:

- GQA: q head ``h`` of batch ``b`` reads kv head ``h // (Hq // Hk)``
  (``_kv_index``); dk/dv sum over each kv head's group of q heads
  without expanding K/V (the plain versions stack the group's q heads
  as extra rows of one product);
- causal masking keeps key ``j`` for query ``i`` iff
  ``j <= i + (Sk - Sq)``: the bottom-right diagonal, not PyTorch's
  top-left ``is_causal``; a row that sees no key gives out = 0 and
  lse = -inf;
- the scale multiplies the fp32 product ``q . k``; dk carries it
  explicitly;
- products take their inputs in storage dtype and accumulate in fp32:
  ``p`` is rounded to v's dtype before ``P V`` (and to dO's before
  ``P^T dO``), ``ds`` to k's / q's dtype before its products;
- dropout keeps an element by the murmur3 hash of ``dropout_keep_mask``
  (``_keep_block`` / ``_mix_seed``), bit for bit, in int32 ops; lse
  comes from the undropped probabilities.

``flash_fwd``, ``flash_dq`` and ``flash_dkv`` pick by device: a CPU
tensor runs the plain version; a CUDA tensor launches a kernel or raises.
Which kernel is ``flash_route``'s choice, a documented split and not a
fallback: bf16 operands with a head dim that is a multiple of 8 up to 128
and 16-byte aligned take the wgmma kernels (TMA needs those strides and
alignments), everything else (fp32, whose contract is exact fp32 where
the tensor cores would give TF32; head dims above 128) the FMA kernels.
Each kernel counts its own launches: ``flash_fwd.launches``,
``flash_dq.launches`` and ``flash_dkv.launches`` the FMA kernels',
``flash_fwd.wgmma.launches``, ``flash_dq.wgmma.launches`` and
``flash_dkv.wgmma.launches`` the wgmma kernels'.
``flash_attention_ext`` is the differentiable entry (a
``torch.autograd.Function`` saving ``(q, k, v, out, lse)`` like
``_fa_fwd``/``_fa_bwd``). An additive bias and segment ids are not
ported yet: they raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_plain",
           "flash_dq_plain", "flash_dkv_plain", "flash_attention_ext",
           "flash_route", "dropout_keep_mask", "dropout_threshold",
           "MAX_HEAD_DIM", "WGMMA_MAX_HEAD_DIM"]

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
                      device=None) -> torch.Tensor:
    """The full ``[BH, Sq, Sk]`` bool keep-mask the kernels generate for
    int32 ``seed`` (the reference's ``dropout_keep_mask``)."""
    seed = torch.as_tensor(seed, dtype=torch.int32, device=device)
    dev = seed.device
    bh = torch.arange(bh_total, dtype=torch.int32, device=dev)
    rows = torch.arange(sq, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(sk, dtype=torch.int32, device=dev)[None, :]
    return _keep(_mix_seed(seed, bh)[:, None, None], rows, cols, sk, rate)


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


def _masked_scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 ``scale * q . k`` as [B, Hk, rep * Sq, Sk], -inf where the
    causal diagonal hides the key."""
    sq, hk, sk = q.shape[1], k.shape[2], k.shape[1]
    s = torch.matmul(_grouped(q, hk), _kv(k).transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device).repeat(q.shape[2] // hk)
        kj = torch.arange(sk, device=q.device)
        visible = kj[None, :] <= qi[:, None] + (sk - sq)
        s = s.masked_fill(~visible, float("-inf"))
    return s


def _group_keep(seed, q, k, rate: float) -> torch.Tensor:
    """The dropout keep-mask in the grouped [B, Hk, rep * Sq, Sk] layout."""
    b, sq, hq, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    keep = dropout_keep_mask(seed.to(q.device), b * hq, sq, sk, rate)
    return keep.reshape(b, hk, (hq // hk) * sq, sk)


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` (the MXU operand cast), back in fp32."""
    return x.to(dtype).float()


def _probs(q, k, lse, causal, scale) -> torch.Tensor:
    """p = exp(s - lse) with a -inf lse (row sees no key) read as 0."""
    lse_g = _rows_stat(lse, k.shape[2])
    lse_safe = torch.where(lse_g == float("-inf"), 0.0, lse_g)
    return torch.exp(_masked_scores(q, k, causal, scale) - lse_safe)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float, rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of q [B,Sq,Hq,D] over k/v [B,Sk,Hk,D]: returns
    ``(out [B,Sq,Hq,D] in q's dtype, lse [B,Hq,Sq] fp32)``."""
    b, sq, hq, _ = q.shape
    hk = k.shape[2]
    s = _masked_scores(q, k, causal, scale)
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


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                   rate: float = 0.0, seed: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """dq [B,Sq,Hq,D] (q's dtype) from the saved lse and
    delta = rowsum(dO * O), both [B,Hq,Sq] fp32."""
    hk, sq = k.shape[2], q.shape[1]
    p = _probs(q, k, lse, causal, scale)
    dp = torch.matmul(_grouped(do, hk), _kv(v).transpose(-1, -2))
    if rate > 0.0:
        dp = torch.where(_group_keep(seed, q, k, rate),
                         dp * _keep_scale(rate), 0.0)
    ds = p * (dp - _rows_stat(delta, hk))
    dq = torch.matmul(_round_to(ds, k.dtype), _kv(k)) * scale
    return _ungrouped(dq, sq).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                    rate: float = 0.0, seed: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Sk,Hk,D] in k's / v's dtype, summed over each kv
    head's group of q heads."""
    hk = k.shape[2]
    p = _probs(q, k, lse, causal, scale)
    do_g = _grouped(do, hk)
    dp = torch.matmul(do_g, _kv(v).transpose(-1, -2))
    p_v = p
    if rate > 0.0:
        keep = _group_keep(seed, q, k, rate)
        p_v = torch.where(keep, p * _keep_scale(rate), 0.0)
        dp = torch.where(keep, dp * _keep_scale(rate), 0.0)
    ds = p * (dp - _rows_stat(delta, hk))
    dv = torch.matmul(_round_to(p_v, do.dtype).transpose(-1, -2), do_g)
    dk = torch.matmul(_round_to(ds, q.dtype).transpose(-1, -2),
                      _grouped(q, hk)) * scale
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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


def flash_route(dtype: torch.dtype, head_dim: int,
                addresses: Sequence[int] = ()) -> str:
    """The kernel a CUDA call of ``flash_fwd``, ``flash_dq`` or
    ``flash_dkv`` launches: ``"wgmma"`` (``csrc/flash_attention_sm90.cu``)
    for bf16 with ``head_dim`` a multiple of 8 up to
    ``WGMMA_MAX_HEAD_DIM`` (so the head stride ``D * 2`` and row stride
    ``H * D * 2`` bytes are multiples of 16, as TMA requires) and every
    operand address 16-byte aligned; ``"fma"`` (``csrc/flash_attention.cu``)
    otherwise."""
    if (dtype == torch.bfloat16 and head_dim % 8 == 0
            and 0 < head_dim <= WGMMA_MAX_HEAD_DIM
            and all(a % 16 == 0 for a in addresses)):
        return "wgmma"
    return "fma"


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


def _common_args(dims, scale, causal, rate, seed, q, route="fma"):
    """The scalar arguments of a C entry; the wgmma entries take no dtype
    code (bf16 only)."""
    dtype = () if route == "wgmma" else (_DTYPE_CODES[q.dtype],)
    return (*dims, float(scale), int(bool(causal)),
            *_drop_args(rate, seed, q), *dtype, _build.stream(q))


def _launch_on(route: str, wrapper, entry: str, tensors, args) -> None:
    """Launch C entry ``entry`` (``<entry>_sm90`` of
    ``flash_attention_sm90`` on the wgmma route, else of
    ``flash_attention``), counted on ``wrapper``'s counter of that
    route; a non-zero CUDA error code raises."""
    if route == "wgmma":
        lib, counter = _build.load("flash_attention_sm90"), wrapper.wgmma
        entry += "_sm90"
    else:
        lib, counter = _build.load("flash_attention"), wrapper
    counter.launches += 1
    rc = getattr(lib, entry)(*map(_build.ptr, tensors), *args)
    _build.check(lib, rc, entry)


def _fwd_launch(q, k, v, causal, scale, rate, seed, route=None):
    """``route`` defaults to ``flash_route``'s choice; the on-card checks
    also name "fma" for bf16, to hold and time that kernel on the main
    path's inputs."""
    dims = _check(q, k, v)
    b, sq, _, hq, _, _ = dims
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    route = route or _route(q, k, v, out)
    _launch_on(route, flash_fwd, "flash_fwd", (q, k, v, out, lse),
               _common_args(dims, scale, causal, rate, seed, q, route))
    return out, lse


def _dq_launch(q, k, v, do, lse, delta, causal, scale, rate, seed,
               route=None):
    """``route`` as in ``_fwd_launch``."""
    dims = _check(q, k, v, do)
    b, sq, _, hq, _, _ = dims
    _check_stat("lse", lse, b, hq, sq)
    _check_stat("delta", delta, b, hq, sq)
    dq = torch.empty_like(q)
    route = route or _route(q, k, v, do, dq)
    _launch_on(route, flash_dq, "flash_dq", (q, k, v, do, lse, delta, dq),
               _common_args(dims, scale, causal, rate, seed, q, route))
    return dq


def _dkv_launch(q, k, v, do, lse, delta, causal, scale, rate, seed,
                route=None):
    """``route`` as in ``_fwd_launch``."""
    dims = _check(q, k, v, do)
    b, sq, _, hq, _, _ = dims
    _check_stat("lse", lse, b, hq, sq)
    _check_stat("delta", delta, b, hq, sq)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    route = route or _route(q, k, v, do, dk, dv)
    _launch_on(route, flash_dkv, "flash_dkv",
               (q, k, v, do, lse, delta, dk, dv),
               _common_args(dims, scale, causal, rate, seed, q, route))
    return dk, dv


def flash_fwd(q, k, v, causal: bool, scale: float, rate: float = 0.0,
              seed: Optional[torch.Tensor] = None):
    """``(out, lse)``: a forward kernel on the card, by ``flash_route``
    (counted in ``flash_fwd.wgmma.launches`` or ``flash_fwd.launches``),
    ``flash_fwd_plain`` on the CPU."""
    return _build.dispatch(flash_fwd_plain, _fwd_launch, q, k, v, causal,
                           scale, rate, seed)


def flash_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
             rate: float = 0.0, seed: Optional[torch.Tensor] = None):
    """dq: a dq kernel on the card, by ``flash_route``
    (``flash_dq.wgmma.launches`` or ``flash_dq.launches``),
    ``flash_dq_plain`` on the CPU."""
    return _build.dispatch(flash_dq_plain, _dq_launch, q, k, v, do, lse,
                           delta, causal, scale, rate, seed)


def flash_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
              rate: float = 0.0, seed: Optional[torch.Tensor] = None):
    """(dk, dv): a dkv kernel on the card, by ``flash_route``
    (``flash_dkv.wgmma.launches`` or ``flash_dkv.launches``),
    ``flash_dkv_plain`` on the CPU."""
    return _build.dispatch(flash_dkv_plain, _dkv_launch, q, k, v, do, lse,
                           delta, causal, scale, rate, seed)


class KernelCount:
    """The launch count (``.launches``) of the second kernel behind a
    wrapper that routes between two."""

    def __init__(self) -> None:
        self.launches = 0


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0
flash_fwd.wgmma = KernelCount()
flash_dq.wgmma = KernelCount()
flash_dkv.wgmma = KernelCount()


class _FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, causal, scale, rate):
        out, lse = flash_fwd(q, k, v, causal, scale, rate, seed)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.attrs = (causal, scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seed = ctx.saved_tensors
        causal, scale, rate = ctx.attrs
        dout = dout.contiguous()
        # delta_i = rowsum(dO_i * O_i): cheap elementwise, plain torch
        # (the reference leaves it to XLA)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dq = flash_dq(q, k, v, dout, lse, delta, causal, scale, rate, seed)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, causal, scale, rate,
                           seed)
        return dq, dk, dv, None, None, None, None


def flash_attention_ext(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        seed: Optional[torch.Tensor] = None,
                        q_seg: Optional[torch.Tensor] = None,
                        k_seg: Optional[torch.Tensor] = None,
                        causal: bool = False, scale: Optional[float] = None,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Differentiable flash attention: q [B,Sq,Hq,D], k/v [B,Sk,Hk,D] ->
    out [B,Sq,Hq,D]. ``seed`` (int32, one element, on q's device) drives
    the dropout mask. ``bias`` and ``q_seg``/``k_seg`` belong to a later
    slice of the port and raise ``NotImplementedError``."""
    if bias is not None or q_seg is not None or k_seg is not None:
        raise NotImplementedError(
            "flash_attention_ext: additive bias and segment ids are not "
            "ported yet (ROADMAP Queue 2)")
    rate = float(dropout_rate)
    if rate > 0.0 and seed is None:
        raise ValueError("flash_attention_ext: seed is required when "
                         "dropout_rate > 0")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        seed if rate > 0.0 else None, bool(causal), float(scale), rate)

"""Transformer layers (counterpart of paddle_tpu/nn/layer/transformer.py):
``MultiHeadAttention``, ``TransformerEncoderLayer`` and
``TransformerEncoder`` with paddle_tpu's module and parameter names and
the ``[in, out]`` linear layout.

Attention runs through ``F.scaled_dot_product_attention``: the
hand-written flash-attention kernels on the card. The string mask
``"causal"`` routes to their native causal path, as in the reference; a
tensor mask becomes the kernels' additive bias (a bool mask first turns
into 0 / -1e9 in the query's dtype, ``_convert_attn_mask``). The decode
cache path (``cache=``) belongs to a later slice.

Layers take ``device`` and an explicit ``generator``: it draws the
initial weights and, afterwards, every dropout mask and attention
dropout seed of the layer.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ...distributed.fleet.recompute import recompute
from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


def _convert_attn_mask(attn_mask, dtype: torch.dtype):
    """``"causal"``, None, or an additive mask: a bool mask (True = attend)
    becomes ``where(m, 0, -1e9)`` in ``dtype``; a float mask passes as it
    is."""
    if isinstance(attn_mask, str):
        if attn_mask != "causal":
            raise ValueError(f"unknown attention mask string {attn_mask!r}; "
                             "the only recognized value is 'causal'")
        return attn_mask
    if attn_mask is not None and attn_mask.dtype == torch.bool:
        return torch.where(attn_mask, 0.0, -1e9).to(dtype)
    return attn_mask


class MultiHeadAttention(nn.Module):
    """q/k/v projections and softmax attention over ``[B, S, E]`` in/out."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if need_weights:
            raise NotImplementedError("MultiHeadAttention: need_weights is "
                                      "not supported")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self._generator = generator
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape(self, t: torch.Tensor) -> torch.Tensor:
        """[B, S, E] -> [B, S, H, D]."""
        return t.reshape(t.shape[0], t.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        mask = _convert_attn_mask(attn_mask, q.dtype)
        causal = isinstance(mask, str)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=None if causal else mask,
            dropout_p=self.dropout,
            is_causal=causal, training=self.training,
            generator=self._generator)
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, layer_norm_eps: float = 1e-5, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, device=device)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (deep copies, so every
    layer starts from the same weights, as in the reference; the copies
    share the layer's generator), then an optional ``norm``. Setting
    ``enable_recompute`` (and ``recompute_policy``) recomputes each layer
    in the backward, in train mode only (``distributed/fleet/recompute``;
    the replay redraws the forward's dropout masks)."""

    def __init__(self, encoder_layer: nn.Module, num_layers: int,
                 norm: Optional[nn.Module] = None):
        super().__init__()
        # generators are streams, not state: the copies keep drawing from
        # the one they were given
        shared = {id(g): g for m in encoder_layer.modules()
                  for g in [getattr(m, "_generator", None)] if g is not None}
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer, dict(shared))
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm
        self.enable_recompute = False
        self.recompute_policy = None

    def forward(self, src, src_mask=None):
        output = src
        for layer in self.layers:
            if self.enable_recompute and self.training:
                output = recompute(layer, output, src_mask,
                                   policy=self.recompute_policy)
            else:
                output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output

"""Llama model family (counterpart of paddle_tpu/models/llama.py).

Module layout and parameter names follow paddle_tpu, so a state_dict
carries across by name (``models/convert.py``); linear weights keep
Paddle's ``[in, out]`` layout. Parameters are drawn in fp32 on the
requested device from an explicit generator; ``write_back`` casts them
(the train cell runs bf16 parameters).

Two paths:

- ``LlamaForCausalLM.decode_step``: the cached decode/prefill step the
  serving engine runs, on any device. Its three RMSNorms per layer pair
  (input, post-attention, final) are the hand-written CUDA kernel on the
  card; attention is the plain, GQA-aware, length-masked
  ``decode_attention``.
- ``LlamaForCausalLM.forward`` and ``loss``: the full-context path,
  differentiable, trained through ``models/trainer.py``. Attention is
  ``F.scaled_dot_product_attention`` with the causal mask (and the
  config's dropout in train mode, drawn from the model's generator): the
  hand-written flash-attention kernels on the card (GQA-native), their
  plain versions on the CPU; the RMSNorms are the RMSNorm kernel. RoPE
  runs in fp32 and its result is rounded back to the projections' dtype,
  so a bf16 model hands the flash kernels bf16 q, k and v (the reference
  passes its attention fp32 q and k beside a bf16 v). ``lm_ce`` picks
  the loss: "plain" (logits, then the CE kernels) or "blockwise" (the
  vocabulary-streamed LM head and CE of ``ops/fused_ce.py``).
  ``use_recompute`` recomputes each decoder layer in the backward, in
  train mode (``distributed/fleet/recompute``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.random import DEFAULT_SEED, make_generator
from ..device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer import Embedding, Linear, RMSNorm
from ..ops.fused_ce import blockwise_linear_cross_entropy
from .decode import (ContiguousKV, apply_rope_at, decode_attention,
                     init_contiguous_cache)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "llama_7b",
           "llama_13b", "llama_tiny", "apply_rotary_pos_emb",
           "causal_lm_loss", "blockwise_lm_loss"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dropout: float = 0.0
    use_recompute: bool = False
    # what a recomputed layer keeps: "full" replays the whole layer;
    # "dots_saveable"/"selective" keep the matmul outputs and replay the
    # rest (distributed/fleet/recompute)
    recompute_policy: str = "full"
    # "plain": logits through lm_head, then CE; "blockwise": the
    # vocabulary-chunked LM head + CE of ops/fused_ce.py (the logits are
    # never held whole)
    lm_ce: str = "plain"


def llama_7b() -> LlamaConfig:
    return LlamaConfig()


def llama_13b() -> LlamaConfig:
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_layers=40, num_heads=40, num_kv_heads=40)


def llama_tiny() -> LlamaConfig:
    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       max_position_embeddings=128)


@functools.lru_cache(maxsize=16)
def _rope_tables_np(seq_len: int, head_dim: int, theta: float):
    """cos/sin ``[seq_len, head_dim/2]`` in float64, as paddle_tpu
    computes them before its cast."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(seq_len), inv)
    return np.cos(freqs), np.sin(freqs)


def _rope_tables(seq_len: int, head_dim: int, theta: float, device=None):
    """The fp32 tables on ``device``."""
    cos, sin = _rope_tables_np(seq_len, head_dim, theta)
    dev = resolve_device(device)
    return (torch.as_tensor(cos, dtype=torch.float32, device=dev),
            torch.as_tensor(sin, dtype=torch.float32, device=dev))


def causal_lm_loss(logits, labels):
    """Token-mean cross entropy over [B, S, V] logits (ignore_index
    -100): the CE kernels on the card."""
    b, s, v = logits.shape
    return F.cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))


def _auto_num_blocks(tokens: int, vocab: int,
                     target_elems: int = 64 * 1024 * 1024) -> int:
    """Vocabulary chunks for the blockwise loss: 8, doubled (while the
    vocabulary still divides, up to 128) until one fp32 [tokens,
    vocab / nb] chunk holds at most ``target_elems`` entries."""
    nb = 8
    while (tokens * (vocab // nb) > target_elems and nb < 128
           and vocab % (nb * 2) == 0):
        nb *= 2
    return nb


def blockwise_lm_loss(h, w, labels, transpose_w: bool = False):
    """Token-mean CE (ignore_index -100) of the LM head ``w`` applied to
    ``h`` [B, S, H], streamed over vocabulary chunks
    (``ops/fused_ce.blockwise_linear_cross_entropy``). ``w`` is [V, H]
    (GPT's tied embedding), or [H, V] with ``transpose_w`` (Llama's
    untied ``lm_head``)."""
    b, s, d = h.shape
    ww = w.t() if transpose_w else w
    nb = _auto_num_blocks(b * s, ww.shape[0])
    return blockwise_linear_cross_entropy(
        h.reshape(b * s, d), ww, labels.reshape(b * s), num_blocks=nb,
        ignore_index=-100)


def apply_rotary_pos_emb(q, k, cos, sin):
    """Interleaved-pair RoPE on [B, S, H, D] at positions ``[0, S)``, in
    the tables' fp32; the results come back in q's and k's dtypes."""
    zeros = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    qr, kr = apply_rope_at(q, k, cos, sin, zeros)
    return qr.to(q.dtype), kr.to(k.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **kw):
        super().__init__()
        self.cfg = cfg
        # draws the attention dropout seeds once the weights are drawn
        self._generator = kw["generator"]
        self.head_dim = cfg.hidden_size // cfg.num_heads
        init = Normal(0.0, 0.02)
        h, d = cfg.hidden_size, self.head_dim
        self.q_proj = Linear(h, cfg.num_heads * d, init, False, **kw)
        self.k_proj = Linear(h, cfg.num_kv_heads * d, init, False, **kw)
        self.v_proj = Linear(h, cfg.num_kv_heads * d, init, False, **kw)
        self.o_proj = Linear(cfg.num_heads * d, h, init, False, **kw)

    def forward(self, h, cos_sin):
        b, s, _ = h.shape
        cfg = self.cfg
        q = self.q_proj(h).reshape(b, s, cfg.num_heads, self.head_dim)
        k = self.k_proj(h).reshape(b, s, cfg.num_kv_heads, self.head_dim)
        v = self.v_proj(h).reshape(b, s, cfg.num_kv_heads, self.head_dim)
        cos, sin = cos_sin
        q, k = apply_rotary_pos_emb(q, k, cos, sin)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=cfg.dropout,
            training=self.training, generator=self._generator)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **kw):
        super().__init__()
        init = Normal(0.0, 0.02)
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(h, i, init, False, **kw)
        self.up_proj = Linear(h, i, init, False, **kw)
        self.down_proj = Linear(i, h, init, False, **kw)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **kw):
        super().__init__()
        dev = kw["device"]
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=dev)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, device=dev)
        self.mlp = LlamaMLP(cfg, **kw)

    def forward(self, h, cos_sin):
        h = h + self.self_attn(self.input_layernorm(h), cos_sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      Normal(0.0, 0.02), **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, **kw) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            device=kw["device"])
        cos, sin = _rope_tables(cfg.max_position_embeddings,
                                cfg.hidden_size // cfg.num_heads,
                                cfg.rope_theta, device=kw["device"])
        # position-only tables: buffers, so they are not state_dict entries
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def _cos_sin(self):
        return self.rope_cos, self.rope_sin

    def forward(self, input_ids):
        if input_ids.shape[1] > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {input_ids.shape[1]} exceeds "
                f"max_position_embeddings={self.cfg.max_position_embeddings}")
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            if self.cfg.use_recompute and self.training:
                h = recompute(layer, h, self._cos_sin,
                              policy=self.cfg.recompute_policy)
            else:
                h = layer(h, self._cos_sin)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM on ``device`` (default ``cuda``), fp32 weights
    drawn from ``generator`` (default: seed 0 on that device), which then
    draws the attention dropout seeds."""

    def __init__(self, cfg: LlamaConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = make_generator(DEFAULT_SEED, dev)
        kw = dict(device=dev, generator=generator)
        self.cfg = cfg
        self.model = LlamaModel(cfg, **kw)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              Normal(0.0, 0.02), False, **kw)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids):
        return self.lm_head(self.model(input_ids))

    def loss(self, input_ids, labels):
        """Token-mean causal-LM loss of ``labels`` (ignore_index -100)
        through the path ``cfg.lm_ce`` names."""
        if self.cfg.lm_ce == "blockwise":
            return blockwise_lm_loss(self.model(input_ids),
                                     self.lm_head.weight, labels,
                                     transpose_w=True)
        return causal_lm_loss(self(input_ids), labels)

    # -- autoregressive decode (use_cache path) ---------------------------
    def decode_meta(self) -> dict:
        """Cache geometry for the serving decode engine (GQA: only
        ``num_kv_heads`` heads are cached)."""
        cfg = self.cfg
        return {"num_layers": cfg.num_layers,
                "num_kv_heads": cfg.num_kv_heads,
                "head_dim": cfg.hidden_size // cfg.num_heads,
                "max_len": cfg.max_position_embeddings,
                "vocab_size": cfg.vocab_size}

    def init_decode_cache(self, batch: int, max_len: Optional[int] = None):
        """Contiguous per-layer (k, v) caches for ``decode_step``, on the
        model's device."""
        m = self.decode_meta()
        return init_contiguous_cache(
            m["num_layers"], batch, max_len or m["max_len"],
            m["num_kv_heads"], m["head_dim"], device=self.device)

    @torch.inference_mode()
    def decode_step(self, tokens, positions, kv_caches, kv_ops=None):
        """One cached decode (or prefill) step.

        ``tokens``: [B, S] (or [B]) ids; ``positions``: [B] absolute
        position of each slot's first token; ``kv_caches``: per-layer
        caches for ``kv_ops`` (default ``ContiguousKV``). Returns
        (logits [B, S, V], new caches). RoPE is applied at each slot's
        own positions; GQA heads are expanded inside
        ``decode_attention``."""
        kv_ops = kv_ops or ContiguousKV()
        dev = self.device
        tok = torch.as_tensor(tokens, device=dev)
        if tok.dim() == 1:
            tok = tok[:, None]
        pos = torch.as_tensor(positions, device=dev)
        b, s = tok.shape
        cfg, m = self.cfg, self.model
        cos, sin = m._cos_sin
        head_dim = cfg.hidden_size // cfg.num_heads
        h = m.embed_tokens(tok)
        new_caches = []
        for i, layer in enumerate(m.layers):
            a = layer.self_attn
            hn = layer.input_layernorm(h)
            q = a.q_proj(hn).reshape(b, s, cfg.num_heads, head_dim)
            k = a.k_proj(hn).reshape(b, s, cfg.num_kv_heads, head_dim)
            v = a.v_proj(hn).reshape(b, s, cfg.num_kv_heads, head_dim)
            q, k = apply_rope_at(q, k, cos, sin, pos)
            k_all, v_all, cache = kv_ops.update(i, kv_caches[i], k, v, pos)
            o = decode_attention(q, k_all, v_all, pos)
            h = h + a.o_proj(o.reshape(b, s, cfg.num_heads * head_dim))
            h = h + layer.mlp(layer.post_attention_layernorm(h))
            new_caches.append(cache)
        return self.lm_head(m.norm(h)), new_caches

"""GPT-2 model family (counterpart of paddle_tpu/models/gpt.py).

Embeddings, a pre-norm ``TransformerEncoder`` with causal attention and
a tied LM head (``logits = h @ wte.T``), with paddle_tpu's module and
parameter names, so a state_dict carries across by name
(``models/convert.py``). On the card every attention forward and
backward is the hand-written flash-attention kernel and every LayerNorm
forward the hand-written LayerNorm kernel. Training goes through
``models/trainer.py`` ``create_train_step``; the loss's cross-entropy
is the hand-written CE forward and backward kernels on the card
(``nn/functional/loss.py``), or with ``lm_ce="blockwise"`` the
vocabulary-streamed LM head and CE (``ops/fused_ce.py``, plain
PyTorch). ``use_recompute`` recomputes each encoder layer in the
backward, in train mode.

``decode_step`` is the cached decode/prefill step the serving engine
runs: the pre-norm layers replayed with positioned cache writes and the
plain, length-masked ``decode_attention`` (the reference has no decode
attention kernel), with every LayerNorm the hand-written kernel on the
card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.random import DEFAULT_SEED, make_generator
from ..device import resolve_device
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer import (Dropout, Embedding, LayerNorm, TransformerEncoder,
                        TransformerEncoderLayer)
from .decode import ContiguousKV, decode_attention, init_contiguous_cache
from .llama import blockwise_lm_loss

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt2_small",
           "gpt2_tiny"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    # "plain": logits through the tied head, then the CE kernels;
    # "blockwise": the vocabulary-chunked LM head + CE of ops/fused_ce.py
    lm_ce: str = "plain"
    # recompute each encoder layer in the backward (train mode only),
    # keeping what recompute_policy names (distributed/fleet/recompute)
    use_recompute: bool = False
    recompute_policy: str = "full"


def gpt2_small() -> GPTConfig:
    return GPTConfig()


def gpt2_tiny() -> GPTConfig:
    """CI-sized config for CPU tests."""
    return GPTConfig(vocab_size=512, max_position_embeddings=128,
                     hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=128, dropout=0.0)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        kw = dict(device=device, generator=generator)
        init = Normal(0.0, 0.02)
        self.wte = Embedding(config.vocab_size, config.hidden_size, init,
                             **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, init, **kw)
        self.drop = Dropout(config.dropout, generator=generator)
        enc_layer = TransformerEncoderLayer(
            d_model=config.hidden_size, nhead=config.num_heads,
            dim_feedforward=config.intermediate_size, dropout=config.dropout,
            activation="gelu", normalize_before=True,
            layer_norm_eps=config.layer_norm_eps, **kw)
        self.encoder = TransformerEncoder(enc_layer, config.num_layers)
        self.encoder.enable_recompute = config.use_recompute
        self.encoder.recompute_policy = config.recompute_policy
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        # positions past the wpe table read its last row: the clamping
        # embedding, as the reference's clipping lookup does
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        h = self.drop(self.wte(input_ids) + self.wpe(pos))
        # "causal" routes to the flash kernels' native causal path
        h = self.encoder(h, src_mask="causal")
        return self.ln_f(h)


class GPTForCausalLM(nn.Module):
    """GPT-2 causal LM in fp32 on ``device`` (default ``cuda``); weights
    drawn from ``generator`` (default: seed 0 on that device), which then
    draws the dropout masks."""

    def __init__(self, config: GPTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = make_generator(DEFAULT_SEED, dev)
        self.config = config
        self.gpt = GPTModel(config, device=dev, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        h = self.gpt(input_ids)
        return torch.matmul(h, self.gpt.wte.weight.t())   # tied LM head

    def loss(self, input_ids: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        if self.config.lm_ce == "blockwise":
            return blockwise_lm_loss(self.gpt(input_ids),
                                     self.gpt.wte.weight, labels)
        logits = self(input_ids)
        b, s, v = logits.shape
        return F.cross_entropy(logits.reshape(b * s, v),
                               labels.reshape(b * s))

    # -- autoregressive decode (use_cache path) ---------------------------
    def decode_meta(self) -> dict:
        """Cache geometry the serving decode engine sizes its KV pools
        from. ``max_len`` is the position table's length: ``wpe`` has no
        row past it."""
        cfg = self.config
        return {"num_layers": cfg.num_layers,
                "num_kv_heads": cfg.num_heads,
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
        """One cached decode (or prefill) step: write this step's K/V at
        ``positions`` and attend over the cached prefix.

        ``tokens``: [B, S] (or [B]) ids, S = 1 for a decode step and the
        prompt bucket for a prefill; ``positions``: [B], the tokens
        already cached per slot (the write start); ``kv_caches``:
        per-layer caches for ``kv_ops`` (default ``ContiguousKV``).
        Returns (logits [B, S, V], new caches). Dropout is never applied.
        Position ids past the ``wpe`` table (right-padding of a prefill
        bucket) clamp to its last row, as in the reference; the masked
        attention never lets a real token see them."""
        kv_ops = kv_ops or ContiguousKV()
        dev = self.device
        tok = torch.as_tensor(tokens, device=dev)
        if tok.dim() == 1:
            tok = tok[:, None]
        pos = torch.as_tensor(positions, device=dev)
        b, s = tok.shape
        gpt = self.gpt
        pos_ids = pos.long()[:, None] + torch.arange(s, device=dev)
        h = gpt.wte(tok) + gpt.wpe(pos_ids)
        new_caches = []
        # the pre-norm encoder layers, replayed with positioned cache
        # writes
        for i, layer in enumerate(gpt.encoder.layers):
            attn = layer.self_attn
            hn = layer.norm1(h)
            q = attn._shape(attn.q_proj(hn))
            k = attn._shape(attn.k_proj(hn))
            v = attn._shape(attn.v_proj(hn))
            k_all, v_all, cache = kv_ops.update(i, kv_caches[i], k, v, pos)
            o = decode_attention(q, k_all, v_all, pos)
            h = h + attn.out_proj(o.reshape(b, s, attn.embed_dim))
            hn = layer.norm2(h)
            h = h + layer.linear2(layer.activation(layer.linear1(hn)))
            new_caches.append(cache)
        h = gpt.ln_f(h)
        return torch.matmul(h, gpt.wte.weight.t()), new_caches   # tied head

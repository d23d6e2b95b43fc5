"""GPT-2 model family (counterpart of paddle_tpu/models/gpt.py).

Embeddings, a pre-norm ``TransformerEncoder`` with causal attention and
a tied LM head (``logits = h @ wte.T``), with paddle_tpu's module and
parameter names, so a state_dict carries across by name
(``models/convert.py``). On the card every attention forward and
backward is the hand-written flash-attention kernel and every LayerNorm
forward the hand-written LayerNorm kernel. Training goes through
``models/trainer.py`` ``create_train_step``; ``decode_step`` belongs to
a later slice of the port.
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
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_eps, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        if s > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings="
                f"{self.config.max_position_embeddings}")
        pos = torch.arange(s, device=input_ids.device)
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
        logits = self(input_ids)
        b, s, v = logits.shape
        return F.cross_entropy(logits.reshape(b * s, v),
                               labels.reshape(b * s))

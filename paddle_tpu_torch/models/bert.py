"""BERT model family (counterpart of paddle_tpu/models/bert.py).

Word, position and token-type embeddings with LayerNorm and dropout, a
post-norm ``TransformerEncoder`` (GELU), a tanh pooler over the first
token, and the pretraining heads: the MLM transform (dense, GELU,
LayerNorm) with a decoder tied to the word embedding (one state-dict
entry, ``bert.embeddings.word_embeddings.weight``) and the NSP head.
Module and parameter names are paddle_tpu's, so a state_dict carries
across by name (``models/convert.py``).

The ``[B, S]`` 0/1 padding mask becomes an additive fp32 ``[B, 1, 1, S]``
bias, ``(1 - mask) * -1e9``, which every attention layer hands to the
flash-attention kernels as their bias (a broadcast view: no ``[B, H, S,
S]`` tensor is made). On the card every attention forward and backward
is a hand-written flash kernel, every LayerNorm forward the LayerNorm
kernel and both cross-entropies (MLM and NSP) the CE kernels. The mask
needs no gradient, so no dbias is computed.

The pipeline construction (``bert_pipeline_model``) and the tensor-
parallel placements (``bert_param_spec``) belong to the distributed
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.random import DEFAULT_SEED, make_generator
from ..device import resolve_device
from ..nn import functional as F
from ..nn.initializer import Constant, Normal
from ..nn.layer import (Dropout, Embedding, LayerNorm, Linear,
                        TransformerEncoder, TransformerEncoderLayer,
                        create_parameter)

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_base", "bert_large",
           "bert_tiny"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    num_labels: int = 2


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096)


def bert_tiny() -> BertConfig:
    """CI-sized config for CPU tests."""
    return BertConfig(vocab_size=256, hidden_size=64, num_layers=2,
                      num_heads=4, intermediate_size=128,
                      max_position_embeddings=64, dropout=0.0)


def _device_and_generator(device, generator):
    """The model's device (default ``cuda``) and its generator (default:
    seed 0 on that device), which draws the weights and then the dropout
    masks."""
    dev = resolve_device(device)
    return dev, generator if generator is not None else make_generator(
        DEFAULT_SEED, dev)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, config: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        init = Normal(0.0, 0.02)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, init, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, init, **kw)
        self.token_type_embeddings = Embedding(
            config.type_vocab_size, config.hidden_size, init, **kw)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(config.dropout, generator=generator)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        s = input_ids.shape[1]
        max_pos = self.position_embeddings.weight.shape[0]
        if s > max_pos:
            raise ValueError(f"sequence length {s} exceeds "
                             f"max_position_embeddings {max_pos}")
        pos = torch.arange(s, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(h))


class BertPooler(nn.Module):
    def __init__(self, hidden_size: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, device=device,
                            generator=generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.tanh(self.dense(h[:, 0]))


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, with_pool: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = _device_and_generator(device, generator)
        kw = dict(device=device, generator=generator)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        layer = TransformerEncoderLayer(
            d_model=config.hidden_size, nhead=config.num_heads,
            dim_feedforward=config.intermediate_size, dropout=config.dropout,
            activation="gelu", normalize_before=False,   # post-LN
            layer_norm_eps=config.layer_norm_eps, **kw)
        self.encoder = TransformerEncoder(layer, config.num_layers)
        self.pooler = BertPooler(config.hidden_size, **kw) \
            if with_pool else None

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None):
        h = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [B, S] 0/1 padding mask -> additive fp32 [B, 1, 1, S]
            attention_mask = ((1.0 - attention_mask.float())
                              * -1e9)[:, None, None, :]
        h = self.encoder(h, src_mask=attention_mask)
        if self.pooler is None:
            return h
        return h, self.pooler(h)


class BertMLMTransform(nn.Module):
    """dense + gelu + LayerNorm: the MLM head before its decoder."""

    def __init__(self, config: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device, generator=generator)
        self.layer_norm = LayerNorm(config.hidden_size,
                                    epsilon=config.layer_norm_eps,
                                    device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(F.gelu(self.dense(h)))


class BertMLMHead(nn.Module):
    """Transform + decoder tied to the word embedding (its weight is
    passed in at call time, so the state_dict holds it once)."""

    def __init__(self, config: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.transform = BertMLMTransform(config, device=device,
                                          generator=generator)
        self.decoder_bias = create_parameter([config.vocab_size],
                                             Constant(0.0), device=device)

    def forward(self, h: torch.Tensor,
                embedding_weight: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.transform(h), embedding_weight.t()) \
            + self.decoder_bias


class BertForPretraining(nn.Module):
    """MLM + NSP heads over ``BertModel``."""

    def __init__(self, config: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = _device_and_generator(device, generator)
        kw = dict(device=device, generator=generator)
        self.bert = BertModel(config, with_pool=True, **kw)
        self.mlm_head = BertMLMHead(config, **kw)
        self.nsp_head = Linear(config.hidden_size, 2, **kw)
        self.config = config

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None):
        h, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm_logits = self.mlm_head(
            h, self.bert.embeddings.word_embeddings.weight)
        return mlm_logits, self.nsp_head(pooled)

    def loss(self, input_ids: torch.Tensor, mlm_labels: torch.Tensor,
             nsp_labels: Optional[torch.Tensor] = None,
             token_type_ids: Optional[torch.Tensor] = None,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MLM cross-entropy over every position whose label is not -100
        (mean over those), plus the NSP cross-entropy when ``nsp_labels``
        are given."""
        mlm_logits, nsp_logits = self(input_ids, token_type_ids,
                                      attention_mask)
        b, s, v = mlm_logits.shape
        loss = F.cross_entropy(mlm_logits.reshape(b * s, v),
                               mlm_labels.reshape(b * s), ignore_index=-100)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, nsp_labels)
        return loss


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = _device_and_generator(device, generator)
        kw = dict(device=device, generator=generator)
        self.bert = BertModel(config, with_pool=True, **kw)
        self.dropout = Dropout(config.dropout, generator=generator)
        self.classifier = Linear(config.hidden_size, config.num_labels, **kw)
        self.config = config

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))

"""Functional ops (counterpart of paddle_tpu/nn/functional)."""
from .activation import gelu, relu, silu, tanh
from .common import dropout, embedding, linear
from .flash_attention import (flash_attention, flash_attn_unpadded,
                              scaled_dot_product_attention)
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["gelu", "relu", "silu", "tanh", "dropout", "embedding",
           "linear", "flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention",
           "cross_entropy", "layer_norm", "rms_norm"]

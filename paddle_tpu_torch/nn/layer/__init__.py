"""Layers (counterpart of paddle_tpu/nn/layer)."""
from .common import Dropout, Embedding, Linear, create_parameter
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "Linear", "LayerNorm", "RMSNorm",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "create_parameter"]

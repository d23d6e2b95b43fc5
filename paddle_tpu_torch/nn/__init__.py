"""Neural-network layers and functions (counterpart of paddle_tpu/nn)."""
from . import functional, initializer
from .layer import (Dropout, Embedding, LayerNorm, Linear,
                    MultiHeadAttention, RMSNorm, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["functional", "initializer", "Dropout", "Embedding", "LayerNorm",
           "Linear", "MultiHeadAttention", "RMSNorm", "TransformerEncoder",
           "TransformerEncoderLayer"]

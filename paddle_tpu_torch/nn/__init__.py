"""Neural-network layers and functions (counterpart of paddle_tpu/nn)."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (Dropout, Embedding, LayerNorm, Linear,
                    MultiHeadAttention, RMSNorm, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["clip", "functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Dropout", "Embedding", "LayerNorm",
           "Linear", "MultiHeadAttention", "RMSNorm", "TransformerEncoder",
           "TransformerEncoderLayer"]

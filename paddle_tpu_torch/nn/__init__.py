"""Neural-network layers and functions (counterpart of paddle_tpu/nn)."""
from . import functional, initializer
from .layer import Embedding, Linear, RMSNorm

__all__ = ["functional", "initializer", "Embedding", "Linear", "RMSNorm"]

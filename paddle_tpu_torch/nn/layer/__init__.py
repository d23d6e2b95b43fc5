"""Layers (counterpart of paddle_tpu/nn/layer)."""
from .common import Embedding, Linear, create_parameter
from .norm import RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm", "create_parameter"]

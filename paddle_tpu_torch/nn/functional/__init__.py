"""Functional ops (counterpart of paddle_tpu/nn/functional)."""
from .activation import silu
from .common import embedding, linear
from .norm import rms_norm

__all__ = ["silu", "embedding", "linear", "rms_norm"]

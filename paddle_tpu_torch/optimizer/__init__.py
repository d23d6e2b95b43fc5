"""Optimizers (counterpart of paddle_tpu/optimizer)."""
from .optimizer import Adam, AdamW

__all__ = ["Adam", "AdamW"]

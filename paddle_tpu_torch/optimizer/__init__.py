"""Optimizers and LR schedules (counterpart of paddle_tpu/optimizer)."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, Optimizer, RMSProp, Rprop)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adagrad", "RMSProp",
           "Adam", "AdamW", "Adamax", "Adadelta", "Lamb", "Rprop"]

"""Serving (counterpart of paddle_tpu/serving; the decode server is
ported, the batch server, router and transport are not yet)."""
from . import decode
from .batcher import (DeadlineExceeded, ServerClosed, ServerOverloaded,
                      ServingError)
from .bucketing import BucketOverflow

__all__ = ["decode", "BucketOverflow", "DeadlineExceeded", "ServerClosed",
           "ServerOverloaded", "ServingError"]

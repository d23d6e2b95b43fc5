"""Distributed training (counterpart of paddle_tpu/distributed).

Ported so far: ``fleet.recompute`` (activation recomputation). The mesh,
collectives and parallel strategies belong to a later slice.
"""
from . import fleet

__all__ = ["fleet"]

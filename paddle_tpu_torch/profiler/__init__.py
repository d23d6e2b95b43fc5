"""Observability (counterpart of paddle_tpu/profiler; only the metrics
primitives are ported so far)."""
from .metrics import Histogram, MetricsBase

__all__ = ["Histogram", "MetricsBase"]

"""Input pipelines (counterpart of paddle_tpu/io; only the device
prefetcher is ported so far)."""
from .prefetch import DevicePrefetcher, PipelineMetrics, prefetch_to_device

__all__ = ["DevicePrefetcher", "PipelineMetrics", "prefetch_to_device"]

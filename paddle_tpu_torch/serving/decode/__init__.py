"""Continuous-batching decode serving over a paged KV cache
(counterpart of paddle_tpu/serving/decode)."""
from .engine import DecodeServer
from .kvcache import (SCRATCH_PAGE, PageAllocator, PagedKV, PagesExhausted,
                      init_paged_cache, page_table_array, pages_for)
from .metrics import DecodeMetrics
from .scheduler import (AdmissionQueue, DecodeRequest, DecodeStream,
                        Scheduler, Slot)

__all__ = ["DecodeServer", "DecodeStream", "DecodeRequest", "DecodeMetrics",
           "AdmissionQueue", "Scheduler", "Slot", "PageAllocator",
           "PagedKV", "PagesExhausted", "SCRATCH_PAGE", "init_paged_cache",
           "page_table_array", "pages_for"]

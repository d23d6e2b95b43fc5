"""Decode-server observability (counterpart of
paddle_tpu/serving/decode/metrics.py; read through
``DecodeServer.stats()`` and ``profiler.decode_stats()``)."""
from __future__ import annotations

from ...profiler.metrics import MetricsBase

__all__ = ["DecodeMetrics"]


class DecodeMetrics(MetricsBase):
    """Thread-safe counters/histograms for one DecodeServer.

    Counters: submitted, completed, rejected_overload, expired, failed,
    preemptions (slots evicted for page pressure; also emitted under the
    legacy name ``preempted``), page_growths (ensure_capacity page
    allocations mid-decode), prefills, decode_steps, tokens_generated,
    compile_count.
    Histograms: batch_size (active slots per decode step),
    slot_occupancy (active / max_slots), page_utilization (used pages /
    usable pool), prefill_ms, decode_step_ms (device step wall time),
    queue_wait_ms (submit -> admission), ttft_ms (submit -> first
    token), inter_token_ms (gap between consecutive emitted tokens of
    one request — the serving SLO pair with ttft_ms),
    tokens_per_request.
    Gauge: queue_depth (pull-type, read at snapshot time).
    """

    COUNTERS = ("submitted", "completed", "rejected_overload", "expired",
                "failed", "preemptions", "page_growths", "prefills",
                "decode_steps", "tokens_generated", "compile_count")
    HISTS = ("batch_size", "slot_occupancy", "page_utilization",
             "prefill_ms", "decode_step_ms", "queue_wait_ms", "ttft_ms",
             "inter_token_ms", "tokens_per_request")

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["name"] = self.name
            for k, h in self._hists.items():
                out[k] = h.snapshot()
        # legacy alias: pre-rename consumers read ``preempted``
        out["preempted"] = out["preemptions"]
        out["queue_depth"] = self._read_gauge()
        return out

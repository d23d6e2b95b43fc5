"""Metrics primitives (the part of paddle_tpu/profiler/metrics.py that
``DecodeMetrics`` and ``PipelineMetrics`` use): ``Histogram``
(bounded-reservoir percentiles) and ``MetricsBase`` (thread-safe
counters + histograms + second totals + a pull-type depth gauge)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

__all__ = ["Histogram", "MetricsBase"]


class Histogram:
    """Streaming histogram: exact count/mean/max plus percentiles from a
    bounded reservoir of the most recent samples."""

    def __init__(self, max_samples: int = 4096):
        self._max = max_samples
        self._ring: List[float] = []
        self._next = 0
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if len(self._ring) < self._max:
            self._ring.append(v)
        else:
            self._ring[self._next] = v
            self._next = (self._next + 1) % self._max

    def percentile(self, p: float) -> float:
        if not self._ring:
            return 0.0
        s = sorted(self._ring)
        idx = min(len(s) - 1, max(0, int(round((p / 100.0) * (len(s) - 1)))))
        return s[idx]

    def snapshot(self) -> Dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count, "mean": mean, "max": self.max,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsBase:
    """Thread-safe metrics bundle: subclasses declare ``COUNTERS``,
    ``HISTS`` and (optionally) ``TIMES`` (float second totals);
    ``set_depth_gauge`` installs a pull-type gauge read at snapshot
    time."""

    COUNTERS: tuple = ()
    HISTS: tuple = ()
    TIMES: tuple = ()

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {k: 0 for k in self.COUNTERS}
        self._times: Dict[str, float] = {k: 0.0 for k in self.TIMES}
        self._hists: Dict[str, Histogram] = {k: Histogram()
                                             for k in self.HISTS}
        self._depth_fn: Optional[Callable[[], int]] = None

    def inc(self, counter: str, n: int = 1):
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def observe(self, hist: str, v: float):
        with self._lock:
            self._hists[hist].observe(v)

    def add_time(self, key: str, seconds: float):
        with self._lock:
            self._times[key] = self._times.get(key, 0.0) + float(seconds)

    def set_depth_gauge(self, fn: Callable[[], int]):
        self._depth_fn = fn

    def __getitem__(self, counter: str) -> int:
        with self._lock:
            return self._counters.get(counter, 0)

    def _read_gauge(self) -> int:
        if self._depth_fn is None:
            return 0
        try:
            return int(self._depth_fn())
        except Exception:   # noqa: BLE001 — a dead owner reads as -1
            return -1

"""Observability (counterpart of paddle_tpu/profiler; the metrics
primitives and the input-pipeline source registry are ported so far).

Input pipelines (``io.DevicePrefetcher``, ``models.run_steps``) register
their live ``PipelineMetrics`` here, so ``pipeline_stats()`` answers for
every running pipeline without holding its owner alive: entries are weak
references, pruned on read.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

from .metrics import Histogram, MetricsBase

__all__ = ["Histogram", "MetricsBase", "register_pipeline_source",
           "unregister_pipeline_source", "pipeline_stats"]


class _SourceRegistry:
    """name -> weakref(metrics object with .snapshot())."""

    def __init__(self, kind: str):
        self._kind = kind
        self._sources: "dict[str, weakref.ref]" = {}
        self._lock = threading.Lock()

    def register(self, name: str, metrics) -> None:
        with self._lock:
            self._sources[name] = weakref.ref(metrics)

    def unregister(self, name: str, metrics=None) -> None:
        # with ``metrics`` given, only if the name still points at it: a
        # later owner of the name keeps its entry
        with self._lock:
            ref = self._sources.get(name)
            if ref is None:
                return
            if metrics is not None and ref() is not None \
                    and ref() is not metrics:
                return
            del self._sources[name]

    def stats(self, name: Optional[str] = None):
        with self._lock:
            live = {}
            for n, ref in list(self._sources.items()):
                m = ref()
                if m is None:
                    del self._sources[n]
                else:
                    live[n] = m
        if name is not None:
            if name not in live:
                raise KeyError(f"no live {self._kind} source named {name!r}")
            return live[name].snapshot()
        return {n: m.snapshot() for n, m in live.items()}


_pipeline_registry = _SourceRegistry("pipeline")


def register_pipeline_source(name: str, metrics) -> None:
    """Register an input-pipeline metrics source (an object with
    ``.snapshot()``); ``DevicePrefetcher`` and ``run_steps`` call it."""
    _pipeline_registry.register(name, metrics)


def unregister_pipeline_source(name: str, metrics=None) -> None:
    """Remove a pipeline source (only if it still points at ``metrics``,
    when given)."""
    _pipeline_registry.unregister(name, metrics)


def pipeline_stats(name: Optional[str] = None):
    """``{pipeline_name: snapshot}`` of every live source, or one snapshot
    when ``name`` is given (``KeyError`` when that source is gone): queue
    depth, per-batch transfer latency and the host-blocked vs
    device-blocked time split."""
    return _pipeline_registry.stats(name)

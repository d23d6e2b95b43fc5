"""Device feed: batches copied to the device ahead of the training loop
(counterpart of paddle_tpu/io/prefetch.py).

A background thread pulls batches from any iterable, optionally stacks
K of them into the ``[K, B, ...]`` layout that
``create_multistep_train_step(steps=K)`` takes, and puts them on the
device ahead of consumption, so host batch assembly and the host-to-
device copy overlap the device's work. On the card each batch is copied
into pinned host memory (a copy from pageable memory would not run
asynchronously) and then to the device on a side CUDA stream with
``non_blocking=True``; an event recorded after the copy is what the
consumer's stream waits on, and ``record_stream`` keeps the caching
allocator from handing the batch's memory back to the side stream while
the consumer's stream still reads it. Paired with ``models.run_steps``
(which fetches losses one step behind), the host never waits inside the
step loop on either side.

``profiler.pipeline_stats()`` reports each prefetcher: the queue-depth
gauge, per-batch transfer latency and the host-blocked vs
device-blocked time split.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .. import profiler
from ..device import resolve_device
from ..profiler.metrics import MetricsBase

__all__ = ["DevicePrefetcher", "PipelineMetrics", "prefetch_to_device"]


class PipelineMetrics(MetricsBase):
    """Counters, histograms and second totals of one input pipeline.

    Counters: batches_in (pulled from the source), batches_out (handed to
    the consumer), stacks (K-stacked super-batches built),
    producer_exceptions. Histograms: transfer_ms (placement of each
    emitted batch, as the producer's host sees it), queue_depth (at each
    consumer get). Seconds: host_blocked_s (the consumer waited on an
    empty queue: input-bound), device_blocked_s (the consumer waited for
    a lagged loss in ``run_steps``: compute-bound), producer_blocked_s
    (the producer waited on a full queue), producer_busy_s (pull, stack
    and copy).
    """

    COUNTERS = ("batches_in", "batches_out", "stacks",
                "producer_exceptions")
    HISTS = ("transfer_ms", "queue_depth")
    TIMES = ("host_blocked_s", "device_blocked_s", "producer_blocked_s",
             "producer_busy_s")

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = dict(self._counters)
            out["name"] = self.name
            out.update({k: round(v, 6) for k, v in self._times.items()})
            for k, h in self._hists.items():
                out[k] = h.snapshot()
        out["queue_depth_now"] = self._read_gauge()
        host, dev = out["host_blocked_s"], out["device_blocked_s"]
        # where did the step loop wait?
        out["bound"] = ("input" if host > dev else
                        "compute" if dev > host else "balanced")
        return out


def _map(fn, item):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(item, tuple):
        return tuple(_map(fn, x) for x in item)
    if isinstance(item, list):
        return [_map(fn, x) for x in item]
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    return fn(item)


def _stack_items(items):
    """K same-structure batches stacked leafwise into ``[K, ...]`` numpy
    arrays on the host (one copy to the device then moves the
    super-batch)."""
    first = items[0]
    if isinstance(first, (tuple, list)):
        out = [_stack_items([it[i] for it in items])
               for i in range(len(first))]
        return tuple(out) if isinstance(first, tuple) else out
    if isinstance(first, dict):
        return {k: _stack_items([it[k] for it in items]) for k in first}
    return np.stack([np.asarray(x) for x in items])


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _pinned(x) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t if t.device.type == "cuda" else t.pin_memory()


class DevicePrefetcher:
    """Iterator over batches on ``device`` (default ``cuda``), filled by a
    daemon thread ``depth`` batches ahead of consumption. ``stack=K``
    stacks K source batches into ``[K, B, ...]``; a ragged tail of fewer
    than K is dropped. Order is the source's (one producer, a FIFO
    queue); the bounded queue is the backpressure. A producer exception
    is raised in the consumer where its batch would have been yielded.
    ``close()`` (or leaving a ``with`` block) stops the producer, also
    mid-epoch."""

    _END = object()

    def __init__(self, iterator: Iterable, depth: int = 2, device=None,
                 stack: Optional[int] = None, name: str = "prefetch",
                 timeout: float = 120.0):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if stack is not None and stack < 1:
            raise ValueError(f"stack must be >= 1, got {stack}")
        self._source = iterator
        self._device = resolve_device(device)
        self._stack = stack
        self._timeout = timeout
        self._stream = (torch.cuda.Stream(device=self._device)
                        if _on_card(self._device) else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self.metrics = PipelineMetrics(name)
        self.metrics.set_depth_gauge(self._q.qsize)
        profiler.register_pipeline_source(name, self.metrics)
        self._thread = threading.Thread(
            target=self._produce, daemon=True,
            name=f"paddle_tpu_torch-prefetch-{name}")
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _place(self, item):
        """``item`` on the device, and the event its copy recorded (None
        off the card, where the copy is done when this returns)."""
        if self._stream is None:
            return _map(lambda x: torch.as_tensor(x).to(self._device,
                                                        copy=True),
                        item), None
        host = _map(_pinned, item)
        with torch.cuda.stream(self._stream):
            out = _map(lambda t: t.to(self._device, non_blocking=True), host)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _put(self, obj) -> bool:
        """Blocking put that stays responsive to ``close()``; False when
        the prefetcher was closed while waiting."""
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                self._q.put(obj, timeout=0.05)
                waited = time.perf_counter() - t0
                if waited > 0.001:   # an uncontended put is ~free
                    self.metrics.add_time("producer_blocked_s", waited)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            it = iter(self._source)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                if self._stack is None:
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    self.metrics.inc("batches_in")
                else:
                    items = []
                    while len(items) < self._stack:
                        try:
                            items.append(next(it))
                        except StopIteration:
                            break
                    self.metrics.inc("batches_in", len(items))
                    if len(items) < self._stack:
                        break   # ragged tail dropped
                    item = _stack_items(items)
                    self.metrics.inc("stacks")
                t1 = time.perf_counter()
                placed = self._place(item)
                self.metrics.observe(
                    "transfer_ms", (time.perf_counter() - t1) * 1e3)
                self.metrics.add_time("producer_busy_s",
                                      time.perf_counter() - t0)
                if not self._put(placed):
                    return
            self._put(self._END)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            self.metrics.inc("producer_exceptions")
            self._put(e)

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted or self._stop.is_set():
            raise StopIteration   # finished, or close()d mid-epoch
        self.metrics.observe("queue_depth", self._q.qsize())
        t0 = time.perf_counter()
        while True:
            # short polls, so that a close() from another thread ends the
            # iteration promptly
            if self._stop.is_set():
                self._exhausted = True
                raise StopIteration
            try:
                item = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                if time.perf_counter() - t0 > self._timeout:
                    self._stop.set()
                    self._exhausted = True
                    raise TimeoutError(
                        f"prefetcher {self.metrics.name!r}: no batch "
                        f"within {self._timeout}s (producer alive="
                        f"{self._thread.is_alive()})") from None
        self.metrics.add_time("host_blocked_s", time.perf_counter() - t0)
        if item is self._END:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            raise item
        out, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            _map(lambda t: t.record_stream(stream), out)
        self.metrics.inc("batches_out")
        return out

    def close(self):
        """Stop the producer and drop what it queued. Idempotent; safe
        mid-epoch. A thread cannot be interrupted inside a blocking
        ``next(source)``, so the join waits up to 5 s for the source to
        yield (the daemon thread never blocks the process's exit)."""
        self._stop.set()
        try:
            while True:   # unblock a producer stuck on a full queue
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        profiler.unregister_pipeline_source(self.metrics.name, self.metrics)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def prefetch_to_device(iterator: Iterable, depth: int = 2, device=None,
                       stack: Optional[int] = None,
                       name: str = "prefetch") -> DevicePrefetcher:
    """Wrap any iterable of batches in a ``DevicePrefetcher`` that keeps
    ``depth`` batches on ``device`` (default ``cuda``) ahead of the
    consumer::

        feed = prefetch_to_device(batches, stack=4, depth=2)
        losses = run_steps(create_multistep_train_step(model, opt,
                                                       steps=4), feed)
    """
    return DevicePrefetcher(iterator, depth=depth, device=device,
                            stack=stack, name=name)

"""Observability (counterpart of paddle_tpu/profiler): the Profiler and
``RecordEvent``, the metrics-source registries with ``export_stats``, and
the flight recorder (``profiler.tracing``, re-exported here).

The Profiler keeps the reference's API and state machine (``scheduler``
states, ``on_trace_ready``, ``step()`` timings, ``summary()``'s table,
``export``, ``events``). Two parts are PyTorch's own:

- **Host op events.** The reference gets one per ``run_op`` dispatch from
  its core hook. The port has no dispatch layer: while a window records
  (and ``timer_only`` is off), ``torch.profiler`` runs with its CPU
  activity, and its op events are the Profiler's, named as PyTorch names
  them (``aten::mm``).
- **Device side.** The reference starts ``jax.profiler``'s XPlane trace
  for a device target and swallows every failure. The port adds
  ``ProfilerActivity.CUDA`` (CUPTI) for any target other than the CPU,
  and a device target that cannot be traced raises: at ``start`` on a
  machine without a card or a build of torch without CUDA (where asking
  for the CUDA activity only warns and records nothing), and when a
  window ends in which kernels were launched and CUPTI recorded none.

One time axis: while a window records through ``torch.profiler``, a
``RecordEvent`` enters a ``torch.profiler.record_function`` of its name
instead of reading a clock itself, so its scope, the ops and the CUDA
kernels are all stamped by the profiler (kineto aligns CUPTI's device
clock with the host's). The window's events are read from
``torch.profiler`` when it ends, on the wall clock in seconds
(``trace_start_ns`` plus each event's offset). With ``timer_only``,
``RecordEvent`` scopes are the only events, on ``perf_counter``.

Subsystems register their live metrics objects here (entries are weak
references, pruned on read): input pipelines (``io.DevicePrefetcher``,
``models.run_steps``) and decode servers so far; the serving, router,
transport and resilience registries exist for the modules still to port.
"""
from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
import weakref
import zlib
from enum import Enum
from typing import Callable, Iterable, List, Optional

from .metrics import Histogram, MetricsBase
from .tracing import (TraceContext, trace_span, trace_event, new_trace_id,
                      current_trace_id, enable_tracing, disable_tracing,
                      tracing_enabled, snapshot_events, export_trace,
                      start_trace_writer, stop_trace_writer,
                      set_clock_offset, set_trace_metadata, record_compile,
                      compile_count, reset_tracing)

__all__ = ["ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "RecordEvent", "Profiler",
           "load_profiler_result", "SummaryView", "serving_stats",
           "register_serving_source", "unregister_serving_source",
           "pipeline_stats", "register_pipeline_source",
           "unregister_pipeline_source", "record_placement_fallback",
           "decode_stats", "register_decode_source",
           "unregister_decode_source", "resilience_stats",
           "register_resilience_source", "unregister_resilience_source",
           "router_stats", "register_router_source",
           "unregister_router_source", "transport_stats",
           "register_transport_source", "unregister_transport_source",
           "export_stats", "stats_registries", "export_protobuf",
           "SortedKeys", "Histogram", "MetricsBase",
           # flight-recorder tracing (profiler.tracing re-exports)
           "TraceContext", "trace_span", "trace_event", "new_trace_id",
           "current_trace_id", "enable_tracing", "disable_tracing",
           "tracing_enabled", "snapshot_events", "export_trace",
           "start_trace_writer", "stop_trace_writer", "set_clock_offset",
           "set_trace_metadata", "record_compile", "compile_count",
           "reset_tracing"]


class ProfilerState(Enum):
    """Parity: profiler.ProfilerState."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2             # accepted for API parity: a device target
    CUSTOM_DEVICE = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-number -> state schedule (parity: make_scheduler:117):
    skip_first CLOSED steps, then cycles of closed/ready/record, the last
    record step of each cycle returning RECORD_AND_RETURN."""
    num_steps = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        cycle = step // num_steps
        if repeat > 0 and cycle >= repeat:
            return ProfilerState.CLOSED
        pos = step % num_steps
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == num_steps - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_state_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


class _HostEvent:
    """One recorded event: ``start``/``end`` in seconds; ``category``
    "user" (a RecordEvent scope), "op" (a host op), "kernel" (device
    work, whose ``tid`` is its stream) or "gpu_user_annotation" (a
    scope's range on the device)."""

    __slots__ = ("name", "start", "end", "tid", "category")

    def __init__(self, name, start, end, tid, category="op"):
        self.name = name
        self.start = start
        self.end = end
        self.tid = tid
        self.category = category

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _HostTracer:
    """Collects one recording window's events; with ``torch_prof`` they
    come from ``torch.profiler`` when the window ends, else from the
    RecordEvent scopes (``timer_only``)."""

    def __init__(self, torch_prof=None):
        self.events: List[_HostEvent] = []
        self.torch_prof = torch_prof
        self.user_names: set = set()
        self._lock = threading.Lock()

    def add(self, name, t0, t1, category="op"):
        ev = _HostEvent(name, t0, t1, threading.get_ident(), category)
        with self._lock:
            self.events.append(ev)


_current: Optional["Profiler"] = None


class RecordEvent:
    """User scope annotation (parity: paddle.profiler.RecordEvent)::

        with profiler.RecordEvent("data_loading"):
            ...

    While a Profiler's window records through ``torch.profiler`` the
    scope is a ``record_function`` of the same name (one time axis with
    the ops and kernels); with ``timer_only`` it is timed on
    ``perf_counter``; with no window recording it records nothing.
    """

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.event_type = event_type
        self._t0 = None
        self._scope = None

    def begin(self):
        prof = _current
        tracer = prof._tracer if prof is not None else None
        if tracer is not None and tracer.torch_prof is not None:
            from torch.profiler import record_function
            with tracer._lock:
                tracer.user_names.add(self.name)
            self._scope = record_function(self.name)
            self._scope.__enter__()
        self._t0 = time.perf_counter()

    def end(self):
        if self._t0 is None:
            return
        t0, self._t0 = self._t0, None
        scope, self._scope = self._scope, None
        if scope is not None:
            scope.__exit__(None, None, None)
            return
        prof = _current
        if prof is not None and prof._tracer is not None:
            prof._tracer.add(self.name, t0, time.perf_counter(), "user")

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None
                          ) -> Callable:
    """on_trace_ready handler writing chrome://tracing JSON
    (parity: export_chrome_tracing:215)."""
    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        worker = worker_name or f"host_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{worker}_time_{int(time.time() * 1000)}"
                      f".paddle_trace.json")
        prof._export_chrome(path)
        prof.last_export_path = path
    return handler


def _device_activities(targets) -> list:
    """torch.profiler's activities for ``targets``: the CPU's always, and
    CUDA (CUPTI) for any other target, which must be traceable here."""
    from torch.profiler import ProfilerActivity, supported_activities
    acts = [ProfilerActivity.CPU]
    if all(t == ProfilerTarget.CPU for t in targets):
        return acts
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"Profiler targets {[t.name for t in targets]} ask for a device "
            f"trace, and this machine has no CUDA device")
    if ProfilerActivity.CUDA not in supported_activities():
        raise RuntimeError(
            f"Profiler targets {[t.name for t in targets]} ask for a device "
            f"trace, and this build of torch ({torch.__version__}) cannot "
            f"trace CUDA (no CUPTI)")
    return acts + [ProfilerActivity.CUDA]


def _torch_events(prof, user_names: set) -> List[_HostEvent]:
    """A finished ``torch.profiler.profile``'s events on the wall clock,
    in seconds: RecordEvent scopes ("user"), host ops ("op"), device
    kernels and copies ("kernel"), and the device-side range kineto
    derives for a scope that launched device work
    ("gpu_user_annotation")."""
    kr = prof.profiler.kineto_results
    base_us = (kr.trace_start_ns() / 1e3 if hasattr(kr, "trace_start_ns")
               else float(kr.trace_start_us()))
    out = []
    for e in prof.events():
        start = (base_us + e.time_range.start) / 1e6
        end = (base_us + e.time_range.end) / 1e6
        user = getattr(e, "is_user_annotation", False) \
            or e.name in user_names
        if str(e.device_type).endswith("CPU"):
            out.append(_HostEvent(e.name, start, end, e.thread,
                                  "user" if user else "op"))
        else:
            out.append(_HostEvent(e.name, start, end,
                                  getattr(e, "device_resource_id", 0),
                                  "gpu_user_annotation" if user
                                  else "kernel"))
    return out


# the host calls that put kernels on the card, as torch.profiler names them
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")


class Profiler:
    """Parity: paddle.profiler.Profiler (profiler.py:346)::

        with Profiler(scheduler=(2, 5), on_trace_ready=...) as p:
            for batch in loader:
                train_step(batch)
                p.step()

    ``targets``: ``ProfilerTarget.CPU`` (host ops, the default) and a
    device target (``GPU``) for CUDA kernels through CUPTI; a device
    target raises where no device trace can be taken.
    """

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, with_flops: bool = False,
                 emit_nvtx: bool = False, custom_device_types=None):
        del record_shapes, profile_memory, with_flops, emit_nvtx
        del custom_device_types
        self.targets = list(targets) if targets else [ProfilerTarget.CPU]
        if isinstance(scheduler, tuple):
            start, end = scheduler
            self.scheduler = make_scheduler(closed=max(start, 0), ready=0,
                                            record=end - start, repeat=1)
        elif scheduler is None:
            self.scheduler = _default_state_scheduler
        else:
            self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._tracer: Optional[_HostTracer] = None
        self._all_events: List[_HostEvent] = []
        self._step_t0 = None
        self._step_durations: List[float] = []
        self.last_export_path = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        global _current
        _current = self
        self.current_state = self.scheduler(self.step_num)
        try:
            self._transition(ProfilerState.CLOSED, self.current_state)
        except BaseException:
            self.current_state = ProfilerState.CLOSED
            _current = None
            raise
        self._step_t0 = time.perf_counter()
        return self

    def stop(self):
        global _current
        try:
            self._transition(self.current_state, ProfilerState.CLOSED,
                             final=True)
        finally:
            self.current_state = ProfilerState.CLOSED
            if _current is self:
                _current = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def step(self, num_samples: Optional[int] = None):
        del num_samples
        now = time.perf_counter()
        if self._step_t0 is not None:
            self._step_durations.append(now - self._step_t0)
        self._step_t0 = now
        prev = self.current_state
        self.step_num += 1
        self.current_state = self.scheduler(self.step_num)
        self._transition(prev, self.current_state)

    # -- state machine -----------------------------------------------------
    def _recording(self, state) -> bool:
        return state in (ProfilerState.RECORD,
                         ProfilerState.RECORD_AND_RETURN)

    def _transition(self, prev, new, final=False):
        was, now = self._recording(prev), self._recording(new) and not final
        if not was and now:
            self._begin_record()
        elif was and (not now or prev == ProfilerState.RECORD_AND_RETURN):
            self._end_record()
            if now and prev == ProfilerState.RECORD_AND_RETURN:
                self._begin_record()

    def _begin_record(self):
        if self.timer_only:
            self._tracer = _HostTracer()
            return
        from torch.profiler import profile
        prof = profile(activities=_device_activities(self.targets))
        prof.start()
        self._tracer = _HostTracer(prof)

    def _end_record(self):
        tracer, self._tracer = self._tracer, None
        if tracer is None:
            return
        if tracer.torch_prof is not None:
            tracer.torch_prof.stop()
            events = _torch_events(tracer.torch_prof, tracer.user_names)
            launched = any(e.name in _LAUNCH_CALLS for e in events)
            if self._device_target() and launched and not any(
                    e.category == "kernel" for e in events):
                raise RuntimeError(
                    "the device trace recorded no kernel while kernels "
                    "were launched: CUPTI did not trace")
            tracer.events.extend(events)
        self._all_events.extend(tracer.events)
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def _device_target(self) -> bool:
        return any(t != ProfilerTarget.CPU for t in self.targets)

    # -- results -----------------------------------------------------------
    def _export_chrome(self, path: str):
        events = []
        for ev in self._all_events or (self._tracer.events
                                       if self._tracer else []):
            events.append({
                "name": ev.name, "ph": "X", "pid": os.getpid(),
                "tid": ev.tid, "ts": ev.start * 1e6,
                "dur": (ev.end - ev.start) * 1e6,
                "cat": ev.category,
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    def export(self, path: str, format: str = "json"):
        del format
        self._export_chrome(path)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms") -> str:
        """Op statistic table (parity: profiler_statistic summary)."""
        del sorted_by, op_detail, thread_sep
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}[time_unit]
        stats = {}
        for ev in self._all_events:
            tot, cnt, mx = stats.get(ev.name, (0.0, 0, 0.0))
            d = ev.end - ev.start
            stats[ev.name] = (tot + d, cnt + 1, max(mx, d))
        rows = sorted(stats.items(), key=lambda kv: -kv[1][0])
        lines = [f"{'Name':<40}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
                 f"{'Avg(' + time_unit + ')':>12}{'Max(' + time_unit + ')':>12}"]
        for name, (tot, cnt, mx) in rows:
            lines.append(f"{name[:39]:<40}{cnt:>8}{tot * unit:>14.3f}"
                         f"{tot / cnt * unit:>12.3f}{mx * unit:>12.3f}")
        if self._step_durations:
            import numpy as np
            sd = np.asarray(self._step_durations)
            lines.append(f"steps: {len(sd)}  avg "
                         f"{sd.mean() * unit:.3f}{time_unit}  p50 "
                         f"{np.percentile(sd, 50) * unit:.3f}{time_unit}")
        text = "\n".join(lines)
        print(text)
        return text

    @property
    def events(self):
        return list(self._all_events)


# -- metrics-source registries -----------------------------------------------
# Subsystems (decode servers, input-pipeline prefetchers/runners) register
# their live metrics objects here so counters and latency histograms are
# retrievable through the profiler API (the framework's one observability
# surface) without holding the owners alive: entries are weak references,
# pruned on read.
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


_serving_registry = _SourceRegistry("serving")
_pipeline_registry = _SourceRegistry("pipeline")
_decode_registry = _SourceRegistry("decode")
_resilience_registry = _SourceRegistry("resilience")
_router_registry = _SourceRegistry("router")
_transport_registry = _SourceRegistry("transport")


def register_serving_source(name: str, metrics) -> None:
    """Register a serving metrics source (an object with .snapshot());
    the batch ``Server``, once ported, calls it on construction."""
    _serving_registry.register(name, metrics)


def unregister_serving_source(name: str, metrics=None) -> None:
    """Remove a source (only if it still points at ``metrics``, when
    given)."""
    _serving_registry.unregister(name, metrics)


def serving_stats(name: Optional[str] = None):
    """``{server_name: snapshot}`` of every live batch server, or one
    snapshot when ``name`` is given (``KeyError`` when it is gone)."""
    return _serving_registry.stats(name)


def register_pipeline_source(name: str, metrics) -> None:
    """Register an input-pipeline metrics source (an object with
    ``.snapshot()``); ``DevicePrefetcher`` and ``run_steps`` call it."""
    _pipeline_registry.register(name, metrics)


def unregister_pipeline_source(name: str, metrics=None) -> None:
    """Remove a pipeline source (only if it still points at ``metrics``,
    when given)."""
    _pipeline_registry.unregister(name, metrics)


# place_by_spec replication fallbacks, surfaced through pipeline_stats();
# a bounded deque, so a long run cannot accumulate unbounded state
_placement_fallbacks = collections.deque(maxlen=100)
_placement_lock = threading.Lock()


def record_placement_fallback(reason: str) -> None:
    """Record a one-line reason for a sharding->replication fallback (the
    sharded trainer's ``place_by_spec``, once ported, calls it)."""
    with _placement_lock:
        _placement_fallbacks.append(str(reason))


def pipeline_stats(name: Optional[str] = None):
    """``{pipeline_name: snapshot}`` of every live source plus a
    ``"placement_fallbacks"`` entry listing the recent fallback reasons,
    or one snapshot when ``name`` is given (``KeyError`` when that source
    is gone): queue depth, per-batch transfer latency and the
    host-blocked vs device-blocked time split."""
    if name is not None:
        return _pipeline_registry.stats(name)
    out = _pipeline_registry.stats()
    with _placement_lock:
        out["placement_fallbacks"] = list(_placement_fallbacks)
    return out


def register_decode_source(name: str, metrics) -> None:
    """Register a decode-server metrics source; ``DecodeServer`` calls it
    on construction."""
    _decode_registry.register(name, metrics)


def unregister_decode_source(name: str, metrics=None) -> None:
    """Remove a decode source (only if it still points at ``metrics``,
    when given)."""
    _decode_registry.unregister(name, metrics)


def decode_stats(name: Optional[str] = None):
    """``{server_name: snapshot}`` of every live ``DecodeServer`` (slot
    occupancy, page utilization, prefill vs decode step time,
    preemptions, time to first token), or one snapshot when ``name`` is
    given (``KeyError`` when that server is gone)."""
    return _decode_registry.stats(name)


def register_resilience_source(name: str, metrics) -> None:
    """Register a resilience metrics source (the checkpoint manager, once
    ported)."""
    _resilience_registry.register(name, metrics)


def unregister_resilience_source(name: str, metrics=None) -> None:
    """Remove a resilience source (only if it still points at
    ``metrics``, when given)."""
    _resilience_registry.unregister(name, metrics)


def resilience_stats(name: Optional[str] = None):
    """``{manager_name: snapshot}``, or one snapshot when ``name`` is
    given (``KeyError`` when it is gone)."""
    return _resilience_registry.stats(name)


def register_router_source(name: str, metrics) -> None:
    """Register a serving-router metrics source (the router, once
    ported)."""
    _router_registry.register(name, metrics)


def unregister_router_source(name: str, metrics=None) -> None:
    """Remove a router source (only if it still points at ``metrics``,
    when given)."""
    _router_registry.unregister(name, metrics)


def router_stats(name: Optional[str] = None):
    """``{router_name: snapshot}``, or one snapshot when ``name`` is given
    (``KeyError`` when it is gone)."""
    return _router_registry.stats(name)


def register_transport_source(name: str, metrics) -> None:
    """Register a wire-transport metrics source (the transport, once
    ported)."""
    _transport_registry.register(name, metrics)


def unregister_transport_source(name: str, metrics=None) -> None:
    """Remove a transport source (only if it still points at
    ``metrics``, when given)."""
    _transport_registry.unregister(name, metrics)


def transport_stats(name: Optional[str] = None):
    """``{endpoint_name: snapshot}``, or one snapshot when ``name`` is
    given (``KeyError`` when it is gone)."""
    return _transport_registry.stats(name)


# the one table of metrics-source scrapes: export_stats() and
# stats_registries() both derive from it
_STATS_SCRAPES = {
    "pipeline": pipeline_stats,
    "serving": serving_stats,
    "decode": decode_stats,
    "resilience": resilience_stats,
    "router": router_stats,
    "transport": transport_stats,
}


def stats_registries() -> tuple:
    """Names of every metrics-source registry ``export_stats()`` scrapes
    (sorted)."""
    return tuple(sorted(_STATS_SCRAPES))


def _flatten_scrape(prefix: str, value, out: list) -> None:
    """dict/number tree -> ``name value`` exposition lines (labels are
    flattened into the metric name; non-numeric leaves are dropped)."""
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten_scrape(f"{prefix}_{k}", v, out)
    elif isinstance(value, (list, tuple)):
        out.append(f"{_sanitize(prefix)}_count {len(value)}")
    elif isinstance(value, bool):
        out.append(f"{_sanitize(prefix)} {int(value)}")
    elif isinstance(value, (int, float)):
        out.append(f"{_sanitize(prefix)} {value}")


def _sanitize(name: str) -> str:
    """Prometheus-legal metric name: every char outside ``[a-zA-Z0-9_]``
    becomes ``_`` (ASCII only), a leading digit gets a ``_`` prefix, and
    a name the rewrite changed gets a stable hash of the original
    appended, so distinct hostile names ("a.b" vs "a-b") stay distinct."""
    clean = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if clean[:1].isdigit():
        clean = "_" + clean
    if clean != name:
        clean = f"{clean}_{zlib.crc32(name.encode('utf-8')):08x}"
    return clean


def export_stats(format: str = "dict"):
    """One scrape over every metrics registry (``stats_registries()``).

    format="dict" returns the nested dict, "json" a JSON string, and
    "text" a Prometheus-style exposition (one ``name value`` line per
    numeric leaf, names prefixed ``paddle_tpu_<registry>_<source>_``, the
    reference's names, so one dashboard reads both)."""
    data = {name: scrape() for name, scrape in _STATS_SCRAPES.items()}
    if format == "dict":
        return data
    if format == "json":
        return json.dumps(data, sort_keys=True, default=str)
    if format == "text":
        lines: list = []
        _flatten_scrape("paddle_tpu", data, lines)
        return "\n".join(lines) + "\n"
    raise ValueError(
        f"unknown export_stats format {format!r}: expected 'dict', "
        "'json', or 'text'")


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def load_profiler_result(filename: str) -> dict:
    with open(filename) as f:
        return json.load(f)


class SortedKeys:
    """Sort keys for summary tables (parity: paddle.profiler.SortedKeys)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


def export_protobuf(dir_name=None, worker_name=None):
    """Return an on-trace-ready handler that pickles the Profiler's
    recorded events, one dict each (parity: paddle.profiler.
    export_protobuf; the reference's handler reads an attribute its
    Profiler never sets and so always writes an empty list)."""
    import pickle
    import socket

    def handle(prof):
        d = dir_name or "./profiler_log"
        os.makedirs(d, exist_ok=True)
        worker = worker_name or \
            f"host_{socket.gethostname()}_{os.getpid()}"
        path = os.path.join(d, f"{worker}_{int(time.time())}.pb.pkl")
        with open(path, "wb") as f:
            pickle.dump([e.as_dict() for e in prof.events], f)
        prof._last_protobuf_path = path
    return handle

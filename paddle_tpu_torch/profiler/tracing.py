"""Flight-recorder tracing: request-scoped spans from the router to the
decode step, cheap enough to leave compiled in everywhere (counterpart
of paddle_tpu/profiler/tracing.py, the same records and the same export,
so ``tools/trace_merge.py`` merges the port's exports with the
reference's).

The port's call sites: ``DecodeServer`` (``decode::enqueue``, ``admit``,
``prefill``, ``step``, ``preempt``, ``page_growth``, ``first_token``,
``finish``, ``cancel``), the serving hosts' ``serving::drain``, every
CUDA-graph capture (``jit::compile``, counted by ``record_compile``) and
``run_steps`` (``train::feed_wait``, ``dispatch``, ``fetch``). No span is
recorded inside a captured callable: host code there runs once, at the
capture, and never on a replay, so the spans wrap the replays.

Design (the three properties everything below serves):

1. **Always compiled in, near-zero when disabled.** Every call site in
   the serving/training hot path goes through ``trace_span(...)`` /
   ``trace_event(...)`` unconditionally; when tracing is disabled those
   are one global load + branch (``trace_span`` returns a shared no-op
   singleton, ``trace_event`` returns immediately). There is no
   decorator magic and no monkey-patching — the call sites are the
   documentation of the span taxonomy.

2. **Flight recorder, not a start/stop profiler.** Enabled tracing
   writes fixed-size records into a bounded per-thread ring buffer: the
   last N spans per thread are ALWAYS available post-hoc (after a hang,
   a kill, a failover) without anyone having pre-armed a profiler run.
   The writer path is lock-free: each thread owns its ring (created
   once per thread under the registry lock — cold path), and a record
   is ``buf[idx % cap] = rec; idx += 1`` — no lock, no allocation
   beyond the record tuple, no syscalls. Readers (``snapshot_events``,
   the background writer) copy ``buf`` under the GIL and tolerate the
   writer lapping them; records are immutable tuples so a torn read is
   impossible.

3. **Cross-process stitching.** Spans carry a ``trace_id`` (stamped by
   the Router at admission, propagated over the wire as frame
   metadata) and are timestamped with ``time.time()`` — the wall
   clock — so ``tools/trace_merge.py`` can merge per-process exports
   into one chrome://tracing timeline, correcting each peer's clock
   with the offset measured at the wire hello handshake
   (``set_clock_offset``).

SIGKILL survivability: ``start_trace_writer`` runs a background thread
that atomically rewrites the trace file every ``interval_s`` — a host
killed mid-stream leaves its last flushed ring snapshot on disk, which
is exactly what the failover drill stitches.

Env knobs (read at import): ``PADDLE_TRACE=1`` enables tracing,
``PADDLE_TRACE_RING`` sets the per-thread ring capacity (default 4096),
``PADDLE_TRACE_DIR`` is where the reference's ``serving.host`` drops
per-process trace files (the port's serving host is not ported yet).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["TraceContext", "trace_span", "trace_event", "new_trace_id",
           "current_trace_id", "enable_tracing", "disable_tracing",
           "tracing_enabled", "snapshot_events", "export_trace",
           "start_trace_writer", "stop_trace_writer", "set_clock_offset",
           "set_trace_metadata", "record_compile", "compile_count",
           "reset_tracing"]

DEFAULT_RING_SIZE = 4096

# the one flag the disabled hot path reads: module global, plain bool
_enabled = False
_ring_size = DEFAULT_RING_SIZE

# per-thread rings: each thread writes only its own ring (no writer
# lock); the registry of live rings is only touched on first use per
# thread and by readers
_tls = threading.local()
_registry_lock = threading.Lock()
_rings: list = []

# process-wide trace metadata (backend_id, role, ...) and measured
# clock offsets to wire peers — embedded in every export so the merge
# tool can map pids to roles and align clocks
_meta_lock = threading.Lock()
_metadata: dict = {}
_clock_offsets: dict = {}

# compile watcher: every CUDA-graph capture (jit.Graphs.capture) reports
# here, making "zero new captures in steady state" a live observable
_compile_lock = threading.Lock()
_compile_count = 0

_writer_lock = threading.Lock()
_writer: Optional[tuple] = None     # (thread, stop_event, path)


class _Ring:
    """Bounded single-writer event ring. ``push`` is the hot path: one
    store and one increment, no lock (the owning thread is the only
    writer; ``snapshot`` copies under the GIL and drops the at-most-one
    slot the writer may be overwriting concurrently)."""

    __slots__ = ("buf", "cap", "idx", "ident", "thread_name")

    def __init__(self, cap: int, ident: int, thread_name: str):
        self.buf = [None] * cap
        self.cap = cap
        self.idx = 0
        self.ident = ident
        self.thread_name = thread_name

    def push(self, rec) -> None:
        self.buf[self.idx % self.cap] = rec
        self.idx += 1

    def snapshot(self) -> list:
        buf = list(self.buf)        # atomic-enough: one bytecode op
        idx = self.idx
        if idx <= self.cap:
            return [r for r in buf[:idx] if r is not None]
        # oldest-first from the wrap point; the slot at idx % cap is
        # the one the writer may be mid-overwrite on — records are
        # immutable tuples, so at worst we see old-or-new, never torn
        start = idx % self.cap
        return [r for r in buf[start:] + buf[:start] if r is not None]


def _ring() -> _Ring:
    r = getattr(_tls, "ring", None)
    if r is None:
        t = threading.current_thread()
        r = _Ring(_ring_size, threading.get_ident(), t.name)
        with _registry_lock:        # cold: once per thread
            _rings.append(r)
        _tls.ring = r
    return r


# -- trace context ------------------------------------------------------------

def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (random, collision-negligible for a
    fleet's request volume)."""
    return os.urandom(8).hex()


class TraceContext:
    """Thread-scoped current trace id. The Router enters one per
    dispatched request so every span recorded on that worker thread —
    including ones that don't pass ``trace_id=`` explicitly — lands
    under the request's id::

        with TraceContext(rid):
            ... trace_span("router::dispatch") ...

    Nesting restores the outer id on exit.
    """

    __slots__ = ("trace_id", "_prev")

    def __init__(self, trace_id: Optional[str]):
        self.trace_id = trace_id
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "trace_id", None)
        _tls.trace_id = self.trace_id
        return self

    def __exit__(self, *exc):
        _tls.trace_id = self._prev
        return False


def current_trace_id() -> Optional[str]:
    """The thread's current trace id (set by ``TraceContext``), or
    None outside any request scope."""
    return getattr(_tls, "trace_id", None)


# -- recording ---------------------------------------------------------------
# record tuple: (name, cat, ph, ts, dur, trace_id, attrs)
#   ph "X" = complete span (dur in seconds), "i" = instant (dur None)

class _Span:
    """Active span handle; records on ``__exit__``/``end``."""

    __slots__ = ("name", "cat", "trace_id", "attrs", "_t0")

    def __init__(self, name, cat, trace_id, attrs):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.attrs = attrs
        self._t0 = time.time()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self) -> None:
        t0 = self._t0
        if t0 is None:
            return
        self._t0 = None
        _ring().push((self.name, self.cat, "X", t0, time.time() - t0,
                      self.trace_id, self.attrs))


class _NullSpan:
    """Shared disabled-mode span: no state, no recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


def trace_span(name: str, cat: str = "app", trace_id: Optional[str] = None,
               **attrs):
    """Span context manager. Disabled: returns the shared no-op
    singleton (one branch, zero allocation). Enabled: records a
    complete ("X") event into the calling thread's ring on exit.
    ``trace_id`` defaults to the thread's ``TraceContext``."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, cat,
                 trace_id if trace_id is not None
                 else getattr(_tls, "trace_id", None),
                 attrs or None)


def trace_event(name: str, cat: str = "app",
                trace_id: Optional[str] = None, **attrs) -> None:
    """Instant event (chrome ph "i"). Disabled: immediate return."""
    if not _enabled:
        return
    _ring().push((name, cat, "i", time.time(), None,
                  trace_id if trace_id is not None
                  else getattr(_tls, "trace_id", None),
                  attrs or None))


# -- enable / disable --------------------------------------------------------

def enable_tracing(ring_size: Optional[int] = None) -> None:
    """Turn the flight recorder on. ``ring_size`` (events per thread)
    applies to rings created after this call; live rings keep their
    capacity."""
    global _enabled, _ring_size
    if ring_size is not None:
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        _ring_size = int(ring_size)
    _enabled = True


def disable_tracing() -> None:
    """Turn the flight recorder off. Recorded events stay readable."""
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    return _enabled


def reset_tracing() -> None:
    """Drop every ring, metadata, clock offsets, and the compile count
    (test isolation; also stops a live trace writer)."""
    global _compile_count
    stop_trace_writer()
    with _registry_lock:
        _rings.clear()
    # threads keep their _tls.ring object but it's no longer
    # registered; force re-registration on next push
    _tls.ring = None
    with _meta_lock:
        _metadata.clear()
        _clock_offsets.clear()
    with _compile_lock:
        _compile_count = 0


# -- metadata / clock --------------------------------------------------------

def set_trace_metadata(**kv) -> None:
    """Attach process-wide metadata (``backend_id=...``, ``role=...``)
    embedded in every export under ``paddleTrace.metadata``."""
    with _meta_lock:
        _metadata.update(kv)


def set_clock_offset(peer: str, offset_s: float) -> None:
    """Record the measured wall-clock offset to ``peer`` (seconds to ADD
    to this process's clock to land on the peer's). The transport client
    measures it at the hello handshake; ``tools/trace_merge.py`` uses it
    to align per-process timelines."""
    with _meta_lock:
        _clock_offsets[str(peer)] = float(offset_s)


def clock_offsets() -> dict:
    with _meta_lock:
        return dict(_clock_offsets)


# -- compile watcher ---------------------------------------------------------

def record_compile(name: str) -> None:
    """Called by ``jit.Graphs.capture`` on every CUDA-graph capture (the
    counterpart of the reference's XLA compile): bumps the live counter
    and drops an instant event, so "zero new captures in steady state"
    is observable from the trace itself."""
    global _compile_count
    with _compile_lock:
        _compile_count += 1
    trace_event("jit::compile", cat="jit", fn=name)


def compile_count() -> int:
    """Captures recorded since process start (or reset)."""
    with _compile_lock:
        return _compile_count


# -- export ------------------------------------------------------------------

def snapshot_events() -> list:
    """Every recorded event as chrome://tracing dicts (ts/dur in µs,
    wall-clock based). Does not disturb writers."""
    with _registry_lock:
        rings = list(_rings)
    pid = os.getpid()
    out = []
    for ring in rings:
        for rec in ring.snapshot():
            name, cat, ph, ts, dur, trace_id, attrs = rec
            ev = {"name": name, "cat": cat, "ph": ph, "pid": pid,
                  "tid": ring.ident, "ts": ts * 1e6}
            if ph == "X":
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "t"
            args = {}
            if trace_id is not None:
                args["trace_id"] = trace_id
            if attrs:
                args.update(attrs)
            if args:
                ev["args"] = args
            out.append(ev)
    out.sort(key=lambda e: e["ts"])
    return out


def _trace_payload() -> dict:
    with _registry_lock:
        rings = list(_rings)
    pid = os.getpid()
    events = [{"name": f"thread_name: {r.thread_name}", "ph": "M",
               "pid": pid, "tid": r.ident, "ts": 0,
               "args": {"name": r.thread_name}} for r in rings]
    events.extend(snapshot_events())
    with _meta_lock:
        meta = dict(_metadata)
        offsets = dict(_clock_offsets)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "paddleTrace": {"pid": pid, "metadata": meta,
                            "clock_offsets": offsets,
                            "compile_count": compile_count()}}


def export_trace(path: str) -> str:
    """Write this process's flight-recorder contents as chrome://tracing
    JSON (atomically: tmp + rename). Returns ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(_trace_payload(), f)
    os.replace(tmp, path)
    return path


# -- background writer (SIGKILL survivability) -------------------------------

def _write_loop(path: str, interval_s: float,
                stop: threading.Event) -> None:
    while True:
        stopped = stop.wait(interval_s)
        try:
            export_trace(path)
        except OSError:
            pass        # disk full/unwritable: keep recording in-memory
        if stopped:
            return


def start_trace_writer(path: str, interval_s: float = 0.2) -> None:
    """Start (or retarget) the background flusher: atomically rewrites
    ``path`` every ``interval_s`` so a SIGKILLed process leaves its last
    ring snapshot on disk for post-mortem stitching."""
    global _writer
    with _writer_lock:
        prev = _writer
        _writer = None
    if prev is not None:
        _join_writer(prev)
    stop = threading.Event()
    t = threading.Thread(target=_write_loop, args=(path, interval_s, stop),
                         name="trace-writer", daemon=True)
    with _writer_lock:
        _writer = (t, stop, path)
    t.start()


def _join_writer(writer: tuple, timeout: float = 5.0) -> None:
    t, stop, _ = writer
    stop.set()
    t.join(timeout)


def stop_trace_writer(timeout: float = 5.0) -> None:
    """Final flush + join of the background writer (bounded)."""
    global _writer
    with _writer_lock:
        writer, _writer = _writer, None
    if writer is not None:
        _join_writer(writer, timeout)


# -- env auto-enable ---------------------------------------------------------

def _init_from_env() -> None:
    if os.environ.get("PADDLE_TRACE", "").lower() in ("1", "true", "on"):
        size = os.environ.get("PADDLE_TRACE_RING")
        enable_tracing(int(size) if size else None)


_init_from_env()

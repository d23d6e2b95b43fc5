"""PyTorch port: the flight recorder (paddle_tpu_torch/profiler/tracing.py)
against paddle_tpu.profiler.tracing.

1. Records: the same sequence of ``trace_span`` / ``trace_event`` /
   ``TraceContext`` / ``record_compile`` calls through both modules gives
   the same records, but for ``ts``, ``dur``, ``pid`` and ``tid``: nested
   contexts, explicit ids, attributes, a wrapped ring, an idempotent
   ``end()``, the disabled no-op singleton, and the export's schema
   (``paddleTrace``: pid, metadata, clock offsets, compile count).
2. The background writer flushes without a stop and once more at the
   stop; the environment knobs enable tracing and size the ring.
3. Merge: a port export and a reference export go through the reference's
   ``tools/trace_merge.py`` with a clock offset and come out aligned.
4. ``run_steps``: the port's spans over a feed are the reference's
   (names, counts and ``step`` attributes).

The two modules keep separate globals; each test starts with both reset,
disabled and at the default ring size, and ends with them reset,
disabled and at the ring size it found.
"""
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import run_steps as jrun_steps
from paddle_tpu.profiler import tracing as rtr
from paddle_tpu_torch.models import run_steps
from paddle_tpu_torch.profiler import tracing as ptr
from tools.trace_merge import merge_traces

BOTH = (rtr, ptr)


@pytest.fixture(autouse=True)
def _clean():
    # another test in the process may have left a ring size set (the
    # reference's own tests do): start from the default, restore after
    sizes = [m._ring_size for m in BOTH]
    for m in BOTH:
        m.reset_tracing()
        m.disable_tracing()
        m._ring_size = m.DEFAULT_RING_SIZE
    yield
    for m, size in zip(BOTH, sizes):
        m.reset_tracing()
        m.disable_tracing()
        m._ring_size = size


def _strip(events):
    """The records without what may differ between two processes' runs:
    timestamps, durations, pids and thread ids."""
    return [{k: v for k, v in e.items()
             if k not in ("ts", "dur", "pid", "tid")} for e in events]


def _script(tr):
    """One sequence of flight-recorder calls; returns its events."""
    tr.enable_tracing()
    with tr.TraceContext("tid1"):
        with tr.trace_span("outer", cat="t", k=1):
            tr.trace_event("inner", cat="t")
        with tr.TraceContext("tid2"):
            tr.trace_event("nested", n=2.5)
            with tr.trace_span("nested_span"):
                pass
        tr.trace_event("restored")
    with tr.TraceContext("ctx"):
        with tr.trace_span("s", trace_id="explicit", who="x"):
            pass
    tr.trace_event("no_context", cat="app")
    tr.record_compile("fwd")
    tr.record_compile("bwd")
    span = tr.trace_span("handle", cat="h")
    span.end()
    span.end()
    with span:              # a later with-block records nothing either
        pass
    assert tr.current_trace_id() is None
    return tr.snapshot_events()


def test_the_same_calls_give_the_same_records():
    ref = _script(rtr)
    got = _script(ptr)
    assert _strip(got) == _strip(ref)
    assert len(got) == 10
    assert ptr.compile_count() == rtr.compile_count() == 2
    by = {e["name"]: e for e in got}
    assert by["outer"]["ph"] == "X" and by["outer"]["dur"] >= 0
    assert by["inner"]["ph"] == "i" and by["inner"]["s"] == "t"
    assert by["restored"]["args"]["trace_id"] == "tid1"
    assert by["s"]["args"] == {"trace_id": "explicit", "who": "x"}
    assert all(e["ts"] > 1e15 for e in got)     # wall-clock µs


def test_ring_wraps_alike_and_keeps_the_newest():
    out = []
    for tr in BOTH:
        tr.enable_tracing(ring_size=8)
        for i in range(50):
            tr.trace_event(f"e{i}", i=i)
        out.append(tr.snapshot_events())
    assert _strip(out[0]) == _strip(out[1])
    assert [e["name"] for e in out[1]] == [f"e{i}" for i in range(42, 50)]
    for tr in BOTH:
        with pytest.raises(ValueError):
            tr.enable_tracing(ring_size=0)


def test_disabled_tracing_is_the_shared_no_op():
    for tr in BOTH:
        s1 = tr.trace_span("x")
        s2 = tr.trace_span("y", cat="z", k=1)
        assert s1 is s2
        with s1:
            tr.trace_event("e", k=2)
        s1.end()
        assert tr.snapshot_events() == [] and not tr.tracing_enabled()
    # record_compile counts with tracing off too, and records no event
    ptr.record_compile("f")
    assert ptr.compile_count() == 1 and ptr.snapshot_events() == []


def test_export_schema_matches_the_reference(tmp_path):
    docs = []
    for i, tr in enumerate(BOTH):
        tr.enable_tracing()
        tr.set_trace_metadata(backend_id="hA", role="host")
        tr.set_clock_offset("peer0", 0.25)
        tr.record_compile("f")
        with tr.trace_span("s", cat="t"):
            pass
        path = str(tmp_path / f"sub{i}" / "t.json")
        assert tr.export_trace(path) == path
        with open(path) as f:
            docs.append(json.load(f))
    ref, got = docs
    assert set(got) == set(ref) == {"traceEvents", "displayTimeUnit",
                                    "paddleTrace"}
    assert got["paddleTrace"] == ref["paddleTrace"] == {
        "pid": os.getpid(), "metadata": {"backend_id": "hA", "role": "host"},
        "clock_offsets": {"peer0": 0.25}, "compile_count": 1}
    assert _strip(got["traceEvents"]) == _strip(ref["traceEvents"])
    assert {e["ph"] for e in got["traceEvents"]} == {"M", "X", "i"}
    assert not [p for p in os.listdir(tmp_path / "sub1") if ".tmp" in p]


def test_background_writer_flushes_without_a_stop(tmp_path):
    ptr.enable_tracing()
    path = str(tmp_path / "flight.json")
    ptr.start_trace_writer(path, interval_s=0.02)
    ptr.trace_event("before_kill")
    end = time.monotonic() + 5
    seen = False
    while time.monotonic() < end and not seen:
        if os.path.exists(path):
            with open(path) as f:
                seen = "before_kill" in [e["name"]
                                         for e in json.load(f)["traceEvents"]]
        time.sleep(0.02)
    assert seen
    ptr.trace_event("at_stop")
    ptr.stop_trace_writer(timeout=5.0)
    assert ptr._writer is None
    with open(path) as f:
        assert "at_stop" in [e["name"] for e in json.load(f)["traceEvents"]]


def test_environment_knobs_alike(monkeypatch):
    monkeypatch.setenv("PADDLE_TRACE", "on")
    monkeypatch.setenv("PADDLE_TRACE_RING", "16")
    for tr in BOTH:
        tr._init_from_env()
        assert tr.tracing_enabled() and tr._ring_size == 16
        tr.disable_tracing()
    monkeypatch.setenv("PADDLE_TRACE", "0")
    for tr in BOTH:
        tr._init_from_env()
        assert not tr.tracing_enabled()


def test_a_port_export_merges_with_a_reference_export(tmp_path):
    """The reference process (the router's clock) measured the port
    process ``h0`` 0.5 s ahead: the merge moves every port event back by
    0.5 s and leaves the reference's where they were."""
    rtr.enable_tracing()
    ptr.enable_tracing()
    rtr.set_trace_metadata(role="router")
    rtr.set_clock_offset("h0", 0.5)
    ptr.set_trace_metadata(backend_id="h0", role="host")
    with rtr.trace_span("router::dispatch", trace_id="r1"):
        ptr.trace_event("decode::enqueue", cat="decode", trace_id="r1")
        with ptr.trace_span("decode::prefill", trace_id="r1"):
            pass
    ptr.trace_event("other", trace_id="r2")
    ref_path = rtr.export_trace(str(tmp_path / "router.json"))
    port_path = ptr.export_trace(str(tmp_path / "host.json"))
    merged = merge_traces([ref_path, port_path], trace_id="r1")
    shifts = {m["path"]: m["shift_us"] for m in merged["paddleTrace"]["merged"]}
    assert shifts == {ref_path: 0.0, port_path: -0.5e6}
    before = {e["name"]: e["ts"] for e in ptr.snapshot_events()
              + rtr.snapshot_events()}
    got = {e["name"]: e["ts"] for e in merged["traceEvents"]
           if e["ph"] != "M"}
    assert set(got) == {"router::dispatch", "decode::enqueue",
                        "decode::prefill"}
    assert got["router::dispatch"] == before["router::dispatch"]
    for name in ("decode::enqueue", "decode::prefill"):
        assert got[name] == pytest.approx(before[name] - 0.5e6, abs=1e-3)


def _spans(tr):
    return [(e["name"], e["args"]["step"]) for e in tr.snapshot_events()
            if e["name"].startswith("train::")]


def test_run_steps_spans_match_the_reference():
    rng = np.random.RandomState(0)
    feed = [(rng.randint(0, 9, (2, 4)), rng.randint(0, 9, (2, 4)))
            for _ in range(3)]

    def jstep(params, opt_state, key, ids, labels, lr):
        return jnp.float32(ids.sum()), params, opt_state

    def pstep(ids, labels, lr):
        return torch.as_tensor(ids).sum().float()

    rtr.enable_tracing()
    _, _, want = jrun_steps(jstep, {}, {}, feed, start_step=5)
    ptr.enable_tracing()
    got = run_steps(pstep, feed, start_step=5)
    assert [float(v) for v in got] == [float(v) for v in want]
    ref, port = _spans(rtr), _spans(ptr)
    assert sorted(port) == sorted(ref)
    assert sorted(port) == sorted(
        [(f"train::{k}", i) for k in ("feed_wait", "dispatch", "fetch")
         for i in (5, 6, 7)])

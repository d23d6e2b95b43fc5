"""PyTorch port: the Profiler, RecordEvent and the metrics-source
registries (paddle_tpu_torch/profiler) against paddle_tpu.profiler.

1. ``make_scheduler`` gives the reference's states over steps 0-20, and a
   Profiler over those steps calls ``on_trace_ready`` as often.
2. The Profiler on the CPU: PyTorch's op events (``aten::mm``, where the
   reference's dispatch hook names ``matmul``) and ``RecordEvent``
   scopes, on one time axis (an op run inside a scope starts and ends
   inside it); a scheduled window records one step; the chrome export's
   keys and ``summary()``'s header are the reference's; ``timer_only``
   records the scopes alone; ``export_protobuf`` dumps the recorded
   events (the reference's handler dumps an empty list: it reads an
   attribute its Profiler never sets).
3. No fallback: a GPU target raises on this CPU-only build and leaves no
   Profiler current; a device window that launched kernels and recorded
   none raises at its end.
4. Scrape: ``_sanitize`` gives the reference's names on the reference
   test's hostile names; ``export_stats`` in all three forms equals the
   reference's for the same registered fake sources; the registries'
   weak references and ``unregister`` guard behave alike.
5. Every name of the reference's ``profiler.__all__`` and
   ``tracing.__all__`` is exported.
"""
import collections
import json
import pickle
import re
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as rprof
from paddle_tpu.profiler import tracing as rtr
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.profiler import tracing as ptr

REGISTRIES = ("_serving_registry", "_pipeline_registry", "_decode_registry",
              "_resilience_registry", "_router_registry",
              "_transport_registry")


def _work():
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 8)
                         .astype(np.float32))
    return (torch.matmul(x, x) * 2).sum()


def _rwork():
    x = paddle.to_tensor(np.random.RandomState(0).randn(8, 8)
                         .astype(np.float32))
    return (paddle.matmul(x, x) * 2).sum()


# -- 1. scheduler ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2, repeat=1),
    dict(closed=0, ready=0, record=1, repeat=2, skip_first=3),
    dict(closed=2, ready=1, record=3, repeat=0, skip_first=1),
    dict(closed=0, ready=2, record=1),
])
def test_scheduler_states_and_trace_ready_calls_match(kw):
    want = [rprof.make_scheduler(**kw)(i).name for i in range(21)]
    got = [prof.make_scheduler(**kw)(i).name for i in range(21)]
    assert got == want
    calls = []
    for mod, tag in ((rprof, "ref"), (prof, "port")):
        with mod.Profiler(scheduler=mod.make_scheduler(**kw),
                          on_trace_ready=lambda p, t=tag: calls.append(t),
                          timer_only=True) as p:
            for _ in range(20):
                p.step()
    assert calls.count("port") == calls.count("ref") > 0


def test_tuple_scheduler_records_its_window_once():
    calls = []
    with prof.Profiler(scheduler=(2, 4),
                       on_trace_ready=lambda p: calls.append(p.step_num)
                       ) as p:
        for _ in range(6):
            _work()
            p.step()
    assert calls == [4]
    assert len([e for e in p.events if e.name == "aten::mm"]) == 2


# -- 2. the Profiler on the CPU ----------------------------------------------

def test_op_events_and_scopes_share_one_time_axis():
    with prof.Profiler() as p:
        with prof.RecordEvent("user_scope"):
            _work()
    by = collections.defaultdict(list)
    for e in p.events:
        by[e.name].append(e)
    (scope,) = by["user_scope"]
    (mm,) = by["aten::mm"]
    assert scope.category == "user" and mm.category == "op"
    assert scope.start <= mm.start <= mm.end <= scope.end
    assert abs(scope.start - time.time()) < 60          # the wall clock
    assert not [e for e in p.events if e.category == "kernel"]


def test_chrome_export_keys_match_the_reference(tmp_path):
    docs = []
    for mod, work in ((rprof, _rwork), (prof, _work)):
        handler = mod.export_chrome_tracing(str(tmp_path / mod.__name__))
        with mod.Profiler(scheduler=mod.make_scheduler(
                closed=0, ready=0, record=1, repeat=1),
                on_trace_ready=handler) as p:
            with mod.RecordEvent("scope"):
                work()
            p.step()
        with open(p.last_export_path) as f:
            docs.append(json.load(f))
        assert p.last_export_path.endswith(".paddle_trace.json")
    ref, got = docs
    assert set(got) == set(ref)
    keys = {frozenset(e) for e in ref["traceEvents"]}
    assert {frozenset(e) for e in got["traceEvents"]} == keys
    names = {e["name"] for e in got["traceEvents"]}
    assert {"scope", "aten::mm"} <= names
    assert "matmul" in {e["name"] for e in ref["traceEvents"]}
    assert prof.load_profiler_result(p.last_export_path) == got


def test_summary_table_has_the_references_format(capsys):
    texts = []
    for mod, work in ((rprof, _rwork), (prof, _work)):
        with mod.Profiler() as p:
            for _ in range(3):
                work()
                p.step()
        texts.append(p.summary(time_unit="us"))
    ref, got = (t.splitlines() for t in texts)
    assert got[0] == ref[0]
    assert re.match(r"steps: 3  avg [0-9.]+us  p50 [0-9.]+us$", got[-1])
    assert any(line.startswith("aten::mm ") for line in got)
    assert "aten::mm" in capsys.readouterr().out


def test_timer_only_records_the_scopes_alone():
    out = []
    for mod, work in ((rprof, _rwork), (prof, _work)):
        with mod.Profiler(timer_only=True) as p:
            with mod.RecordEvent("a"):
                work()
                with mod.RecordEvent("b"):
                    pass
        out.append(sorted((e.name, e.category) for e in p.events))
    assert out[0] == out[1] == [("a", "user"), ("b", "user")]


def test_export_protobuf_dumps_the_recorded_events(tmp_path):
    paths = []
    for mod, work in ((rprof, _rwork), (prof, _work)):
        with mod.Profiler(timer_only=True,
                          on_trace_ready=mod.export_protobuf(
                              str(tmp_path / mod.__name__), "w")) as p:
            with mod.RecordEvent("scope"):
                work()
        paths.append(p._last_protobuf_path)
    with open(paths[0], "rb") as f:
        assert pickle.load(f) == []         # the reference's fault
    with open(paths[1], "rb") as f:
        got = pickle.load(f)
    assert [e["name"] for e in got] == ["scope"]
    assert set(got[0]) == {"name", "start", "end", "tid", "category"}


def test_record_event_outside_a_window_records_nothing():
    e = prof.RecordEvent("idle")
    e.end()                         # end before begin: no-op
    with e:
        _work()
    with prof.Profiler(scheduler=prof.make_scheduler(
            closed=1, ready=0, record=1, repeat=1)) as p:
        with prof.RecordEvent("closed_step"):
            _work()
        p.step()
        with prof.RecordEvent("recorded_step"):
            _work()
    names = {ev.name for ev in p.events}
    assert "recorded_step" in names and "closed_step" not in names
    assert prof._current is None


# -- 3. no fallback ----------------------------------------------------------

def test_gpu_target_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for target in (prof.ProfilerTarget.GPU, prof.ProfilerTarget.TPU):
        p = prof.Profiler(targets=[prof.ProfilerTarget.CPU, target])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p.start()
        assert prof._current is None
        assert p.current_state == prof.ProfilerState.CLOSED
    with prof.Profiler(targets=[prof.ProfilerTarget.GPU],
                       timer_only=True) as p:       # nothing traced
        with prof.RecordEvent("t"):
            pass
    assert [e.name for e in p.events] == ["t"]


def test_a_device_window_without_kernel_records_raises(monkeypatch):
    """Kernels launched in a device window and none in CUPTI's records:
    the trace did not run, and ``stop`` says so (here the CPU activity
    stands in for the device's, and the launch is a recorded host op)."""
    from torch.profiler import ProfilerActivity
    monkeypatch.setattr(prof, "_device_activities",
                        lambda targets: [ProfilerActivity.CPU])
    launch = prof._HostEvent("cudaGraphLaunch", 1.0, 2.0, 0, "op")
    monkeypatch.setattr(prof, "_torch_events", lambda p, names: [launch])
    p = prof.Profiler(targets=[prof.ProfilerTarget.GPU]).start()
    with pytest.raises(RuntimeError, match="CUPTI did not trace"):
        p.stop()
    assert prof._current is None
    with prof.Profiler() as p:          # a CPU window needs no kernel
        pass
    assert [e.name for e in p.events] == ["cudaGraphLaunch"]


# -- 4. scrape ---------------------------------------------------------------

HOSTILE = ["a.b", "a-b", "a b", "a/b", "héllo", "hèllo", "0lead", "_lead",
           "x:y", "x;y", "paddle_tpu_decode_ttft_ms_p99", "A_z0_9"]


def test_sanitize_matches_the_reference():
    got = [prof._sanitize(n) for n in HOSTILE]
    assert got == [rprof._sanitize(n) for n in HOSTILE]
    assert len(set(got)) == len(HOSTILE)


class _Source:
    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return self.snap


@pytest.fixture
def fresh_registries(monkeypatch):
    """Empty registries on both sides, so other tests' live sources do
    not enter the scrape."""
    for mod in (rprof, prof):
        for name in REGISTRIES:
            monkeypatch.setattr(mod, name, mod._SourceRegistry(name[1:-9]))
        monkeypatch.setattr(mod, "_placement_fallbacks",
                            collections.deque(maxlen=100))


def test_export_stats_matches_the_reference(fresh_registries):
    snaps = {
        "decode": ("srv.0", {"completed": 3, "tokens_generated": 24,
                             "ttft_ms": {"count": 3, "p50": 1.5},
                             "name": "srv.0", "ok": True}),
        "pipeline": ("feed-a", {"batches_out": 4, "bound": "host",
                                "transfer_ms": {"p99": 0.25}}),
        "serving": ("0lead", {"queue": [1, 2, 3]}),
        "router": ("r b", {"retries": 0}),
        "transport": ("x:y", {"bytes_in": 10}),
        "resilience": ("héllo", {"restarts": 1}),
    }
    keep = []
    for mod in (rprof, prof):
        for kind, (name, snap) in snaps.items():
            src = _Source(snap)
            keep.append(src)
            getattr(mod, f"register_{kind}_source")(name, src)
        mod.record_placement_fallback("w: 3 does not divide 4")
    for fmt in ("dict", "json", "text"):
        assert prof.export_stats(fmt) == rprof.export_stats(fmt)
    text = prof.export_stats("text")
    # "srv.0" was rewritten, so each of its names carries the hash suffix
    assert re.search(r"^paddle_tpu_decode_srv_0_ok_[0-9a-f]{8} 1$", text,
                     re.M)
    assert "paddle_tpu_pipeline_placement_fallbacks_count 1" in text
    pat = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    for line in text.strip().splitlines():
        name, _, value = line.rpartition(" ")
        assert pat.match(name), line
        float(value)
    assert prof.stats_registries() == rprof.stats_registries()
    with pytest.raises(ValueError, match="unknown export_stats format"):
        prof.export_stats("xml")
    assert prof.decode_stats("srv.0") == rprof.decode_stats("srv.0")


def test_registries_hold_weak_references_and_guard_unregister(
        fresh_registries):
    a, b = _Source({"n": 1}), _Source({"n": 2})
    prof.register_decode_source("s", a)
    prof.register_decode_source("s", b)             # a later owner
    prof.unregister_decode_source("s", a)           # the older one's close
    assert prof.decode_stats("s") == {"n": 2}
    prof.unregister_decode_source("s", b)
    with pytest.raises(KeyError, match="no live decode source"):
        prof.decode_stats("s")
    prof.register_router_source("gone", _Source({}))   # dies at once
    assert prof.router_stats() == {}
    prof.record_placement_fallback("r")
    assert prof.pipeline_stats()["placement_fallbacks"] == ["r"]


# -- 5. the surface ----------------------------------------------------------

def test_every_reference_name_is_exported():
    assert set(rprof.__all__) <= set(prof.__all__)
    assert set(rtr.__all__) <= set(ptr.__all__)
    for name in prof.__all__:
        assert hasattr(prof, name), name
    assert prof.trace_span is ptr.trace_span

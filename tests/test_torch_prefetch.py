"""PyTorch port: the device prefetcher (paddle_tpu_torch/io/prefetch.py)
and the pipeline-source registry (paddle_tpu_torch/profiler) against
paddle_tpu's.

On the CPU (``device="cpu"``): order, ``stack=K`` with its ragged tail
dropped, backpressure at ``depth``, a producer error raised where its
batch would have been, ``close()`` mid-epoch, and the snapshot keys of
``pipeline_stats`` against the reference's. The card branch runs here
with the CUDA calls patched: each batch is pinned, copied with
``non_blocking=True`` on the side stream, an event is recorded there,
and the consumer's stream waits on it and is recorded on every tensor.
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprofiler
from paddle_tpu.io import prefetch_to_device as jprefetch
from paddle_tpu_torch import profiler
from paddle_tpu_torch.io import DevicePrefetcher, prefetch_to_device


def _batches(n, batch=2, seq=8):
    """Batch i is filled with i, so order shows in the payload."""
    return [(np.full((batch, seq), i, np.int32),
             np.full((batch, seq), i, np.int32)) for i in range(n)]


def test_order_and_values_match_the_reference():
    data = _batches(12)
    with jprefetch(iter(data), depth=3, name="ref_order") as rf:
        ref = [tuple(np.asarray(t) for t in b) for b in rf]
    with prefetch_to_device(iter(data), depth=3, device="cpu",
                            name="t_order") as pf:
        got = list(pf)
    assert len(got) == len(ref) == 12
    for (x, y), (rx, ry) in zip(got, ref):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), rx)
        np.testing.assert_array_equal(y.numpy(), ry)


def test_batches_are_copies_of_the_source():
    a = np.zeros((2, 3), np.int64)
    with prefetch_to_device([(a, a)], device="cpu") as pf:
        (x, _), = list(pf)
    a[:] = 7
    assert int(x.sum()) == 0


def test_stack_drops_the_ragged_tail_as_the_reference():
    data = _batches(10)
    with jprefetch(iter(data), stack=3, name="ref_stack") as rf:
        ref = [np.asarray(b[0]) for b in rf]
        rsnap = rf.metrics.snapshot()
    with prefetch_to_device(iter(data), stack=3, device="cpu",
                            name="t_stack") as pf:
        got = [b[0] for b in pf]
        snap = pf.metrics.snapshot()
    assert [tuple(g.shape) for g in got] == [(3, 2, 8)] * 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    for k in ("batches_in", "batches_out", "stacks"):
        assert snap[k] == rsnap[k], k
    assert snap["batches_in"] == 10 and snap["stacks"] == 3


def test_backpressure_holds_the_producer_at_depth():
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield np.full((2,), i)

    pf = DevicePrefetcher(source(), depth=2, device="cpu", name="t_bp")
    try:
        time.sleep(0.3)
        # depth batches queued, one more pulled and waiting to be put
        assert len(pulled) <= 3
        assert pf.metrics.snapshot()["queue_depth_now"] == 2
        assert int(next(pf)[0]) == 0
    finally:
        pf.close()


def test_producer_error_is_raised_where_its_batch_would_be():
    def source():
        for i in range(3):
            yield np.full((2,), i)
        raise RuntimeError("source broke at 3")

    pf = prefetch_to_device(source(), device="cpu", name="t_err")
    got = [int(next(pf)[0]) for _ in range(3)]
    with pytest.raises(RuntimeError, match="broke at 3"):
        next(pf)
    assert got == [0, 1, 2]
    assert pf.metrics["producer_exceptions"] == 1
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_close_stops_the_thread_mid_epoch_and_unregisters():
    def endless():
        i = 0
        while True:
            yield np.full((2,), i)
            i += 1

    pf = prefetch_to_device(endless(), depth=2, device="cpu", name="t_cl")
    assert int(next(pf)[0]) == 0
    assert "t_cl" in profiler.pipeline_stats()
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._thread.daemon
    with pytest.raises(StopIteration):
        next(pf)
    assert "t_cl" not in profiler.pipeline_stats()
    pf.close()                                   # idempotent
    with pytest.raises(ValueError):
        DevicePrefetcher([], depth=0, device="cpu")
    with pytest.raises(ValueError):
        DevicePrefetcher([], stack=0, device="cpu")


def test_registry_and_snapshot_keys_match_the_reference():
    data = _batches(4)
    with jprefetch(iter(data), name="same_name") as rf:
        list(rf)
        ref = jprofiler.pipeline_stats()
        rsnap = jprofiler.pipeline_stats("same_name")
    with prefetch_to_device(iter(data), device="cpu",
                            name="same_name") as pf:
        list(pf)
        got = profiler.pipeline_stats()
        snap = profiler.pipeline_stats("same_name")
    # both list the place_by_spec fallbacks beside the sources (the
    # port's stay empty until its sharded trainer is ported; other tests'
    # pipelines may still be live on either side)
    assert "same_name" in got and "same_name" in ref
    assert "placement_fallbacks" in ref and got["placement_fallbacks"] == []
    assert set(snap) == set(rsnap)
    for k in ("transfer_ms", "queue_depth"):
        assert set(snap[k]) == set(rsnap[k])
    assert snap["batches_out"] == rsnap["batches_out"] == 4
    with pytest.raises(KeyError):
        profiler.pipeline_stats("same_name")      # unregistered at close


def test_registry_entry_of_a_later_owner_survives_an_earlier_close():
    class M:
        def snapshot(self):
            return {"n": 1}

    a, b = M(), M()
    profiler.register_pipeline_source("shared", a)
    profiler.register_pipeline_source("shared", b)
    profiler.unregister_pipeline_source("shared", a)
    assert profiler.pipeline_stats("shared") == {"n": 1}
    profiler.unregister_pipeline_source("shared", b)
    del a, b
    assert "shared" not in profiler.pipeline_stats()


def test_card_branch_pins_copies_on_a_side_stream_and_waits(monkeypatch):
    """The CUDA calls patched to record what the prefetcher does with
    them: every copy to the card reads pinned memory, is non-blocking,
    runs on the side stream with an event recorded there after it, and
    the consumer's stream waits on that event and is recorded on each
    tensor handed out."""
    log, lock = [], threading.Lock()
    current = []

    def note(*e):
        with lock:
            log.append(e)

    class FakeStream:
        def __init__(self, device=None, name="side"):
            self.name = name

        def wait_event(self, ev):
            note("wait", self.name, ev.stream)

    class FakeEvent:
        stream = None

        def record(self, stream=None):
            self.stream = stream.name
            note("record", stream.name)

    @contextlib.contextmanager
    def stream_ctx(s):
        current.append(s.name)
        yield
        current.pop()

    consumer = FakeStream(name="consumer")
    pinned = set()

    def pin_memory(self):
        t = self.clone()
        pinned.add(t.data_ptr())
        return t

    orig_to = torch.Tensor.to

    def to(self, *a, **k):
        if a and str(a[0]) == "cuda":
            note("copy", self.data_ptr() in pinned, k.get("non_blocking"),
                 current[-1] if current else None)
            return self.clone()
        return orig_to(self, *a, **k)

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "stream", stream_ctx)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: consumer)
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: note("record_stream", s.name))
    with prefetch_to_device(iter(_batches(6)), depth=2, stack=2,
                            name="t_card") as pf:
        out = list(pf)
    assert len(out) == 3
    assert [int(x[1, 0, 0]) for x, _ in out] == [1, 3, 5]
    copies = [e for e in log if e[0] == "copy"]
    assert copies == [("copy", True, True, "side")] * 6
    assert [e for e in log if e[0] == "record"] == [("record", "side")] * 3
    assert [e for e in log if e[0] == "wait"] == \
        [("wait", "consumer", "side")] * 3
    assert [e for e in log if e[0] == "record_stream"] == \
        [("record_stream", "consumer")] * 6

"""PyTorch port: the continuous-batching DecodeServer
(paddle_tpu_torch/serving/decode) on the CPU.

1. Against paddle_tpu: both servers get the same prompts and the same
   weights (carried by name), greedy, and must give identical token ids;
   with the flight recorder on and fixed trace ids, preempting, every
   request's events and their attributes (times aside) are the
   reference's, in order. The server registers its metrics with the
   profiler (``decode_stats``) and unregisters at shutdown.
2. The host bookkeeping cases of tests/test_serving_decode.py (buckets,
   page allocator, scheduler) and the lifecycle cases of
   tests/test_serving_decode_server.py (shedding, deadlines, drain,
   preemption under admission="prefill"), run against the port.

Small bucket sets keep paddle_tpu's compile count (one XLA program per
step signature) low.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import decode as jdecode
from paddle_tpu_torch.core.random import make_generator
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     state_dict_from_numpy)
from paddle_tpu_torch.serving import (BucketOverflow, DeadlineExceeded,
                                      ServerClosed, ServerOverloaded,
                                      ServingError, decode)
from paddle_tpu_torch.serving.bucketing import (bucket_example, next_bucket,
                                                next_bucket_strict,
                                                page_buckets, pow2_buckets)


@pytest.fixture(scope="module")
def model():
    m = LlamaForCausalLM(llama_tiny(), device="cpu",
                         generator=make_generator(0, "cpu"))
    m.eval()
    return m


def _ref_greedy(model, prompt, n):
    seq = list(prompt)
    toks = []
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.as_tensor([seq]))
            t = int(torch.argmax(logits[0, -1]))
            toks.append(t)
            seq.append(t)
    return toks


def _server(model, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_len", 4)
    kw.setdefault("max_context", 32)
    kw.setdefault("prefill_buckets", [8])
    return decode.DecodeServer(model, device="cpu", **kw)


def _prompt(rng, n):
    return rng.randint(0, 250, (n,)).astype(np.int32)


# -- 1. against paddle_tpu ----------------------------------------------------

def test_greedy_tokens_identical_to_paddle_tpu():
    paddle.seed(0)
    cfg = jax_llama_tiny()
    cfg.hidden_size = 128
    jm = JaxLlama(cfg)
    jm.eval()
    tcfg = llama_tiny()
    tcfg.hidden_size = 128
    tm = LlamaForCausalLM(tcfg, device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    rng = np.random.RandomState(0)
    prompts = [_prompt(rng, n) for n in (5, 9, 12, 3)]
    kw = dict(max_slots=2, page_len=8, max_context=32, prefill_buckets=[16])
    with jdecode.DecodeServer(jm, **kw) as srv:
        streams = [srv.submit(p, max_new_tokens=6) for p in prompts]
        ref = [[int(t) for t in s.result(timeout=120)] for s in streams]
    with decode.DecodeServer(tm, device="cpu", **kw) as srv:
        streams = [srv.submit(p, max_new_tokens=6) for p in prompts]
        got = [[int(t) for t in s.result(timeout=120)] for s in streams]
        st = srv.stats()
    assert got == ref
    assert st["completed"] == 4 and st["tokens_generated"] == 24


# times: the only attributes that may differ between the two servers
_TIMED_ATTRS = ("queue_wait_ms", "ttft_ms")


def _traced_run(server_cls, model, prompts, tr, **kw):
    """Serve ``prompts`` with tracing on and the ids ``r0``, ``r1``, ...;
    returns the tokens, the stats and each request's events in order:
    (name, attributes without the timed ones)."""
    size = tr._ring_size        # another test may have left it small
    tr.reset_tracing()
    tr.enable_tracing(ring_size=tr.DEFAULT_RING_SIZE)
    try:
        with server_cls(model, name="traced", **kw) as srv:
            # the worker waits at its first prefill until every request
            # is queued, so both servers admit them in the same order
            with srv._exec._lock:
                streams = [srv.submit(p, max_new_tokens=6, trace_id=f"r{i}")
                           for i, p in enumerate(prompts)]
            toks = [[int(t) for t in s.result(timeout=120)] for s in streams]
            stats = srv.stats()
        events = tr.snapshot_events()
    finally:
        tr.disable_tracing()
        tr._ring_size = size
    per = {}
    for e in events:
        args = dict(e.get("args", {}))
        rid = args.pop("trace_id", None)
        if rid is not None:
            per.setdefault(rid, []).append(
                (e["name"], {k: (v if k not in _TIMED_ATTRS else "t")
                             for k, v in args.items()}))
    return toks, stats, per, events


def test_trace_events_per_request_match_paddle_tpu():
    """The tiny Llama behind both servers, preempting (admission
    "prefill" on 8 usable pages): every request's flight-recorder events
    and their attributes are the reference's, in the same order."""
    from paddle_tpu.profiler import tracing as rtr
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler import tracing as ptr
    paddle.seed(0)
    cfg = jax_llama_tiny()
    cfg.hidden_size = 128
    jm = JaxLlama(cfg)
    jm.eval()
    tcfg = llama_tiny()
    tcfg.hidden_size = 128
    tm = LlamaForCausalLM(tcfg, device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    rng = np.random.RandomState(0)
    prompts = [_prompt(rng, n) for n in (5, 9, 12, 3)]
    kw = dict(max_slots=2, page_len=4, max_context=32, prefill_buckets=[16],
              admission="prefill", num_pages=9)
    ref = _traced_run(jdecode.DecodeServer, jm, prompts, rtr, **kw)
    got = _traced_run(decode.DecodeServer, tm, prompts, ptr, device="cpu",
                      **kw)
    try:
        assert got[0] == ref[0]
        assert got[2] == ref[2]
        names = [n for n, _ in got[2]["r3"]]
        assert names[:4] == ["decode::enqueue", "decode::admit",
                             "decode::prefill", "decode::first_token"]
        assert names[-1] == "decode::finish"
        assert "decode::preempt" in names
        assert any("decode::page_growth" in [n for n, _ in seq]
                   for seq in got[2].values())
        stats, events = got[1], got[3]
        steps = [e for e in events if e["name"] == "decode::step"]
        assert len(steps) == stats["decode_steps"] > 0
        assert [e["args"]["host"] for e in events
                if e["name"] == "serving::drain"] == ["traced"]
        assert "traced" not in profiler.decode_stats()
    finally:
        ptr.reset_tracing()
        rtr.reset_tracing()


def test_server_registers_its_metrics_with_the_profiler(model):
    from paddle_tpu_torch import profiler
    with _server(model, name="registered") as srv:
        srv.generate(_prompt(np.random.RandomState(1), 4),
                     max_new_tokens=2, timeout=60)
        assert profiler.decode_stats("registered") == srv.stats()
        assert "registered" in profiler.export_stats()["decode"]
    with pytest.raises(KeyError):
        profiler.decode_stats("registered")


# -- 2a. buckets, allocator, scheduler (tests/test_serving_decode.py) --------

class TestBucketing:
    def test_page_buckets_pow2_with_max(self):
        assert page_buckets(8) == [1, 2, 4, 8]
        assert page_buckets(6) == [1, 2, 4, 6]

    def test_next_bucket_strict_raises_bucket_overflow(self):
        assert next_bucket_strict(3, [4, 8]) == 4
        with pytest.raises(BucketOverflow) as ei:
            next_bucket_strict(9, [4, 8], "page count")
        assert "page count 9" in str(ei.value)

    def test_bucket_overflow_is_value_error(self):
        assert issubclass(BucketOverflow, ValueError)
        with pytest.raises(BucketOverflow):
            bucket_example(np.zeros((9, 2)), [4, 8])

    def test_next_bucket_still_optional(self):
        assert next_bucket(9, [4, 8]) is None
        assert pow2_buckets(12) == [1, 2, 4, 8, 12]


class TestPageAllocator:
    def test_alloc_free_roundtrip(self):
        a = decode.PageAllocator(6)
        assert a.available() == 5
        got = a.alloc(3)
        assert len(got) == 3 and 0 not in got
        assert a.used == 3
        a.free(got)
        assert a.available() == 5

    def test_exhaustion_takes_nothing(self):
        a = decode.PageAllocator(4)
        a.alloc(2)
        with pytest.raises(decode.PagesExhausted):
            a.alloc(2)
        assert a.available() == 1

    def test_double_free_rejected(self):
        a = decode.PageAllocator(4)
        (p,) = a.alloc(1)
        a.free([p])
        with pytest.raises(ValueError):
            a.free([p])

    def test_pages_for(self):
        assert decode.pages_for(1, 4) == 1
        assert decode.pages_for(4, 4) == 1
        assert decode.pages_for(5, 4) == 2

    def test_page_table_array_pads_with_scratch(self):
        t = decode.page_table_array([[3, 1], [2]], 4)
        assert t.shape == (2, 4) and t.dtype == np.int32
        assert list(t[0]) == [3, 1, 0, 0]
        assert list(t[1]) == [2, 0, 0, 0]


class TestScheduler:
    def _mk(self, admission="worst_case", num_pages=9, max_slots=2):
        return decode.Scheduler(
            max_slots=max_slots, allocator=decode.PageAllocator(num_pages),
            page_len=4, max_context=16, prefill_buckets=[8],
            page_buckets=[1, 2, 4], batch_buckets=[1, 2],
            admission=admission)

    def _req(self, plen=5, max_new=8):
        return decode.DecodeRequest(np.arange(plen, dtype=np.int32),
                                    max_new, None, None)

    def test_worst_case_admission_reserves_growth(self):
        s = self._mk(num_pages=9)
        a = s.try_admit(self._req())
        assert a is not None and len(a.pages) == 2 and a.reserved == 2
        assert s.try_admit(self._req()) is not None
        assert s.try_admit(self._req()) is None

    def test_prefill_admission_overcommits_then_preempts(self):
        s = self._mk(admission="prefill", num_pages=6)
        a = s.try_admit(self._req())
        b = s.try_admit(self._req())
        assert a and b and s.allocator.available() == 1
        a.length = 8
        assert s.ensure_capacity(a) == []
        assert s.allocator.available() == 0
        b.length = 8
        assert len(s.ensure_capacity(b)) == 1

    def test_never_admissible_request_raises_not_requeues(self):
        with pytest.raises(decode.PagesExhausted):
            self._mk(num_pages=4).try_admit(self._req())
        with pytest.raises(decode.PagesExhausted):
            self._mk(admission="prefill", num_pages=2).try_admit(
                self._req())

    def test_release_returns_pages_and_reservation(self):
        s = self._mk()
        a = s.try_admit(self._req())
        before = s.allocator.available()
        s.release(a)
        assert s.allocator.available() == before + 2
        assert s._reserved_total == 0

    def test_decode_shape_buckets(self):
        s = self._mk()
        s.try_admit(self._req())
        assert s.decode_shape() == (1, 2)
        s.try_admit(self._req())
        assert s.decode_shape() == (2, 2)


# -- 2b. the server (tests/test_serving_decode_server.py) --------------------

class TestServing:
    def test_concurrent_mixed_traffic_matches_reference(self, model):
        rng = np.random.RandomState(0)
        reqs = [(_prompt(rng, int(rng.randint(3, 14))),
                 int(rng.randint(2, 8))) for _ in range(8)]
        refs = [_ref_greedy(model, p, g) for p, g in reqs]
        with _server(model, max_slots=4, prefill_buckets=[16],
                     max_queue_size=32) as srv:
            streams = [None] * len(reqs)

            def client(i):
                streams[i] = srv.submit(reqs[i][0], max_new_tokens=reqs[i][1])

            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True)
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            outs = [[int(x) for x in s.result(timeout=120)]
                    for s in streams]
            st = srv.stats()
        assert outs == refs
        assert st["completed"] == len(reqs)
        assert st["tokens_generated"] == sum(g for _, g in reqs)
        assert st["decode_steps"] < st["tokens_generated"]

    def test_streaming_and_eos(self, model):
        rng = np.random.RandomState(2)
        prompt = _prompt(rng, 5)
        ref = _ref_greedy(model, prompt, 8)
        with _server(model) as srv:
            stream = srv.submit(prompt, max_new_tokens=4)
            assert [int(t) for t in stream] == ref[:4]
            assert stream.finish_reason == "length"
            eos = ref[2]
            stream = srv.submit(prompt, max_new_tokens=8, eos_id=eos)
            out = [int(t) for t in stream.result(timeout=120)]
            assert stream.finish_reason == "eos"
        assert out == ref[:ref.index(eos) + 1]

    def test_warmup_registers_every_bucket_pair(self, model):
        with _server(model, page_len=8, prefill_buckets=[16]) as srv:
            n = srv.warmup()
            # decode: batch {1,2} x page {1,2,4}; prefill: 16 -> 2 pages
            assert n == 2 * 3 + 1
            assert srv.num_executables() == n
            assert srv.warmup() == 0
            assert srv.bucket_config() == {
                "batch_buckets": [1, 2], "prefill_buckets": [16],
                "page_buckets": [1, 2, 4], "page_len": 8,
                "max_context": 32}
            assert srv.active_slots() == 0 and srv.queue_depth() == 0
            srv.generate(_prompt(np.random.RandomState(4), 9),
                         max_new_tokens=3, timeout=120)
            assert srv.stats()["compile_count"] == n

    def test_warmup_makes_every_executable_through_compile_for(self,
                                                               model):
        """``warmup()`` makes one executable per signature through
        ``StaticFunction.compile_for`` (the pools passed as themselves), a
        served run after it makes none, and every step hands back the
        server's own pool tensors."""
        with _server(model, page_len=8, prefill_buckets=[16]) as srv:
            made, steps = [], []
            real_compile, real_run = srv._sf.compile_for, srv._exec.run

            def compile_for(*specs):
                made.append(specs)
                return real_compile(*specs)

            def run(host_arrays, pools):
                out = real_run(host_arrays, pools)
                steps.append(all(a is b for a, b in zip(out[1:], pools))
                             and len(out) == len(pools) + 1)
                return out
            srv._sf.compile_for = compile_for
            srv._exec.run = run
            n = srv.warmup()
            assert len(made) == n == 2 * 3 + 1
            pools = list(srv._pools)
            assert all(all(a is b for a, b in zip(spec[4:], pools))
                       for spec in made)
            srv.generate(_prompt(np.random.RandomState(4), 9),
                         max_new_tokens=3, timeout=120)
            assert len(made) == n and srv.stats()["compile_count"] == n
            assert steps and all(steps)
            assert all(a is b for a, b in zip(srv._pools, pools))

    def test_overload_sheds(self, model):
        with _server(model, max_slots=1, max_queue_size=1) as srv:
            rng = np.random.RandomState(5)
            shed, streams = 0, []
            for _ in range(8):
                try:
                    streams.append(srv.submit(_prompt(rng, 5),
                                              max_new_tokens=6))
                except ServerOverloaded:
                    shed += 1
            assert shed >= 1
            for s in streams:
                s.result(timeout=120)
            st = srv.stats()
        assert st["rejected_overload"] == shed
        assert st["completed"] == len(streams)

    def test_queue_deadline_expires(self, model):
        with _server(model, max_slots=1, max_queue_size=8) as srv:
            rng = np.random.RandomState(6)
            busy = srv.submit(_prompt(rng, 5), max_new_tokens=20)
            doomed = srv.submit(_prompt(rng, 5), max_new_tokens=4,
                                deadline_ms=1.0)
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=120)
            busy.result(timeout=120)
            assert srv.stats()["expired"] == 1

    def test_over_budget_requests_rejected_at_submit(self, model):
        prompt = np.arange(5, dtype=np.int32)
        with _server(model, num_pages=5) as srv:
            with pytest.raises(BucketOverflow, match="pages"):
                srv.submit(prompt, max_new_tokens=20)
            got = [int(t) for t in
                   srv.submit(prompt, max_new_tokens=3).result(timeout=120)]
            assert got == _ref_greedy(model, prompt, 3)
        with _server(model, max_slots=1, max_context=16) as srv:
            with pytest.raises(BucketOverflow):
                srv.submit(np.arange(9, dtype=np.int32))
            with pytest.raises(BucketOverflow):
                srv.submit(np.arange(8, dtype=np.int32), max_new_tokens=9)

    def test_shutdown_rejects_then_drains(self, model):
        rng = np.random.RandomState(8)
        srv = _server(model)
        stream = srv.submit(_prompt(rng, 5), max_new_tokens=4)
        srv.shutdown(drain=True)
        assert len(stream.result(timeout=5)) == 4
        with pytest.raises(ServerClosed):
            srv.submit(_prompt(rng, 5))
        srv.shutdown()                               # idempotent

    def test_drain_finishes_backlog_behind_a_full_slot_table(self, model):
        rng = np.random.RandomState(12)
        srv = _server(model, max_slots=1, max_queue_size=4)
        streams = [srv.submit(_prompt(rng, 5), max_new_tokens=6)
                   for _ in range(3)]
        srv.shutdown(drain=True, timeout=60)
        for s in streams:
            assert len(s.result(timeout=5)) == 6
        assert srv.stats()["completed"] == 3

    def test_preemption_preserves_greedy_output(self, model):
        rng = np.random.RandomState(9)
        p1, p2 = _prompt(rng, 5), _prompt(rng, 6)
        r1, r2 = _ref_greedy(model, p1, 8), _ref_greedy(model, p2, 8)
        with _server(model, admission="prefill", num_pages=5) as srv:
            s1 = srv.submit(p1, max_new_tokens=8)
            s2 = srv.submit(p2, max_new_tokens=8)
            o1 = [int(x) for x in s1.result(timeout=120)]
            o2 = [int(x) for x in s2.result(timeout=120)]
            st = srv.stats()
        assert o1 == r1 and o2 == r2
        assert st["preempted"] >= 1 and st["completed"] == 2

    def test_worker_survives_step_failure(self, model, monkeypatch):
        from paddle_tpu_torch.serving.decode import engine
        real = engine._DecodeStepLayer.sample
        state = {"fail": True}

        def flaky(self, logits, last_index):
            if state["fail"]:
                state["fail"] = False
                raise RuntimeError("injected step failure")
            return real(self, logits, last_index)

        prompt = np.arange(5, dtype=np.int32)
        ref = _ref_greedy(model, prompt, 4)
        with _server(model) as srv:
            monkeypatch.setattr(engine._DecodeStepLayer, "sample", flaky)
            with pytest.raises(ServingError):
                srv.submit(prompt, max_new_tokens=4).result(timeout=120)
            got = [int(t) for t in
                   srv.submit(prompt, max_new_tokens=4).result(timeout=120)]
        assert got == ref and not state["fail"]

    def test_cancel_settles_a_running_stream(self, model):
        with _server(model, max_slots=1, max_context=32) as srv:
            s = srv.submit(np.arange(5, dtype=np.int32), max_new_tokens=24)
            s.next_token(0, timeout=120)
            srv.cancel(s)
            with pytest.raises(DeadlineExceeded):
                s.result(timeout=120)
            assert not srv.cancel(s)

    def test_temperature_sampling_follows_its_generator(self, model):
        prompt = np.arange(6, dtype=np.int32)
        outs = []
        for _ in range(2):
            with _server(model, temperature=1.0,
                         generator=make_generator(7, "cpu")) as srv:
                outs.append([int(t) for t in srv.generate(
                    prompt, max_new_tokens=8, timeout=120)])
        assert outs[0] == outs[1]
        assert all(0 <= t < 256 for t in outs[0])

    def test_model_must_be_on_the_server_device(self, model):
        # the server's device defaults to cuda: a CPU model is refused
        # before anything is allocated
        with pytest.raises(ValueError, match="cuda"):
            decode.DecodeServer(model, max_slots=1)

"""PyTorch port: paddle_tpu_torch.jit (to_static, StaticFunction,
compile_for) against paddle_tpu.jit, and its capture bookkeeping on the
CPU.

1. Against the reference: ``to_static`` of a small MLP, called without
   grad, and a ``compile_for`` executable give the reference's outputs
   from the same weights (carried through numpy); calls with grad run
   eagerly (gradients flow); weight updates in place and a
   ``write_back`` rebinding are both seen by the next call; InputSpec
   and ``cache_size`` count signatures.
2. The card branch on the CPU: ``torch.cuda``'s graph, stream and pool
   calls are replaced by fakes (``fake_card``). A fake graph records the
   aten ops its capture ran (a TorchDispatchMode) and a replay runs them
   again in order on the same tensors, writing each result into the
   tensor the capture produced: a CUDA graph's semantics (fixed
   addresses, kernels re-run, in-place writes, registered generators
   drawing on). Under it: one capture per signature, replays copy into
   the same static inputs, outputs are clones but an adopted input,
   launches recorded at capture are added per replay, a rebinding
   re-captures, a capture failure raises with nothing run eagerly,
   ``FLAGS_check_index_bounds`` under capture raises, ``recompute``
   under capture replays the forward's draws, a generator drawn from is
   registered; and a captured train step (``create_train_step``, with
   recompute and dropout too, ``create_multistep_train_step`` with
   ``accumulate``) equals the eager steps bit for bit, with a returned
   loss that no later replay overwrites; all owners capture on one
   stream; dropping a StaticFunction, its
   executables or a train step frees the model without the cyclic
   garbage collector (its graphs hold no cycle back to their owner);
   every capture counts once in the flight recorder's
   ``compile_count()`` with a ``jit::compile`` event and span, and a
   ``RecordEvent`` inside a call captured under a Profiler leaves the
   capture working.
"""
import contextlib
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu import jit as rjit
from paddle_tpu_torch import jit, set_flags
from paddle_tpu_torch.core.random import make_generator
from paddle_tpu_torch.distributed.fleet.recompute import recompute
from paddle_tpu_torch.models import (GPTForCausalLM,
                                     create_multistep_train_step,
                                     create_train_step, gpt2_tiny,
                                     write_back)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW


def _nets(seed=0):
    """The reference's MLP and the port's, with the reference's weights
    (both keep Paddle's [in, out] layout)."""
    paddle.seed(seed)
    ref = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                               paddle.nn.Linear(16, 4))
    port = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.ReLU(),
                               Linear(16, 4, device="cpu"))
    with torch.no_grad():
        for k, v in port.state_dict().items():
            v.copy_(torch.from_numpy(ref.state_dict()[k].numpy()))
    return ref, port


def _x(shape=(3, 8), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- 1. against the reference -----------------------------------------------

def test_to_static_and_compile_for_match_the_reference():
    ref, port = _nets()
    x = _x()
    with paddle.no_grad():
        want = rjit.to_static(ref)(paddle.to_tensor(x)).numpy()
        sf = rjit.StaticFunction(ref)
        want_aot = np.asarray(sf.compile_for(rjit.InputSpec([3, 8]))(
            sf._state(), jax.random.key(0), x))
    static = jit.to_static(port)
    with torch.no_grad():
        got = static(torch.from_numpy(x))
        got_aot = static.compile_for(jit.InputSpec([3, 8]))(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_aot.numpy(), want_aot, rtol=1e-6,
                               atol=1e-7)
    assert not got.requires_grad


def test_decorator_on_function():
    @jit.to_static
    def f(x):
        return (x * 2 + 1).sum()

    with torch.no_grad():
        assert float(f(torch.ones(2, 2))) == 12.0
    assert isinstance(f, jit.StaticFunction)


def test_training_calls_run_eagerly():
    _, port = _nets()
    static = jit.to_static(port)
    x = torch.from_numpy(_x((4, 8)))
    loss = (static(x) ** 2).mean()
    assert loss.requires_grad
    loss.backward()
    assert all(p.grad is not None for p in port.parameters())
    assert static.cache_size() == 0          # no no-grad call was made
    # the Layer protocol passes through
    assert static.training is port.training
    assert list(static.parameters()) == list(port.parameters())
    torch.testing.assert_close(static.forward(x), port(x))


def test_state_updates_visible():
    """The reference's test_state_updates_visible, with a rebinding
    (``write_back``) beside the update in place."""
    _, port = _nets()
    static = jit.to_static(port)
    x = torch.ones(1, 8)
    with torch.no_grad():
        y0 = static(x).clone()
        port[0].weight.mul_(0.0)                          # in place
        y1 = static(x).clone()
        write_back(port, {"2.bias": torch.full((4,), 5.0)})   # rebinding
        y2 = static(x).clone()
        want = port(x)
    assert not torch.equal(y0, y1) and not torch.equal(y1, y2)
    assert torch.equal(y2, want)


def test_input_spec_and_cache_size_count_signatures():
    spec = jit.InputSpec([2, None], "bfloat16", name="x")
    assert spec.dtype is torch.bfloat16 and spec.name == "x"
    assert jit.InputSpec([1], np.int32).dtype is torch.int32
    assert jit.InputSpec([1], torch.float16).dtype is torch.float16
    with pytest.raises(ValueError, match="dynamic"):
        spec.concrete()
    with pytest.raises(TypeError):
        jit.InputSpec([1], "not_a_dtype")
    _, port = _nets()
    static = jit.to_static(port)
    with torch.no_grad():
        for rows in (1, 2, 1, 3, 2):
            static(torch.zeros(rows, 8))
    assert static.cache_size() == 3
    assert jit.signature([jit.InputSpec([2, 3], "int32"),
                          np.zeros((2, 3), np.int32),
                          ((2, 3), np.int32),
                          torch.zeros(2, 3, dtype=torch.int32)]) == \
        (((2, 3), torch.int32),) * 4


def test_module_level_switches():
    def f(x):
        return x + 1
    assert jit.not_to_static(f) is f
    jit.enable_to_static(False)
    try:
        assert jit.to_static(f) is f
    finally:
        jit.enable_to_static(True)
    assert isinstance(jit.to_static(f), jit.StaticFunction)
    jit.set_code_level(3)
    jit.set_verbosity(2)
    jit.ignore_module([np])
    assert jit._CODE_LEVEL == 3 and jit._VERBOSITY == 2
    assert np in jit._IGNORED_MODULES


# -- 2. the card branch on the CPU ------------------------------------------

class _Recorder(TorchDispatchMode):
    """Keeps every aten op run under it, with its arguments and result,
    and what ``undo()`` needs to take the run's effects back, as a real
    capture makes none: the first value of every tensor an op writes,
    and the state of every generator drawn from."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self._saved = {}
        self._gens = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            arg = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _tensors(arg):
                if id(t) not in self._saved:
                    self._saved[id(t)] = (t, t.clone())
        gen = kwargs.get("generator")
        if gen is not None and id(gen) not in self._gens:
            self._gens[id(gen)] = (gen, gen.get_state())
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out

    @torch.no_grad()
    def undo(self):
        for t, v in reversed(list(self._saved.values())):
            t.copy_(v)
        for gen, st in self._gens.values():
            gen.set_state(st)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


class FakeGraph:
    """torch.cuda.CUDAGraph on the CPU: the capture's aten ops, run
    again by each replay on the tensors the capture used, each result
    written into the tensor the capture produced."""
    made = []

    def __init__(self):
        self.ops = None
        self.replays = 0
        self.generators = []
        FakeGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    @torch.no_grad()
    def replay(self):
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            for o, n in zip(_tensors(out), _tensors(new)):
                if o is not n:
                    o.copy_(n)
        self.replays += 1


class _FakeGraphContext:
    def __init__(self, graph, pool=None, stream=None,
                 capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        assert pool is not None and stream is not None
        self.graph = graph

    def __enter__(self):
        self.rec = _Recorder()
        self.rec.__enter__()

    def __exit__(self, *exc):
        self.rec.__exit__(*exc)
        self.rec.undo()
        self.graph.ops = self.rec.ops
        return False


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """Calls on CPU tensors take the card branch, over fake graphs."""
    FakeGraph.made = []
    monkeypatch.setattr(jit, "captures_on", lambda device: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeGraphContext)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(jit, "_streams", {})
    return FakeGraph


class _Counter:
    launches = 0


def test_one_capture_per_signature_and_replays_into_static_inputs(
        fake_card, monkeypatch):
    counter = _Counter()
    monkeypatch.setattr(jit, "_launch_counters", lambda: {"k": counter})
    _, port = _nets()

    class Counted(torch.nn.Module):
        def forward(self, x):
            counter.launches += 2            # two "kernels" per call
            return port(x)

    sf = jit.StaticFunction(Counted())
    x1, x2 = (torch.from_numpy(_x(seed=s)) for s in (1, 2))
    with torch.no_grad():
        want1, want2 = port(x1), port(x2)
        counter.launches = 0
        y1 = sf(x1)
        # the warm-up ran eagerly (2 launches); the capture's 2 were taken
        # back; the replay made 2
        assert counter.launches == 4 and sf.compile_count == 1
        exe = sf._live[jit.signature([x1])]
        buf = exe.inputs[0]
        ptr = buf.data_ptr()
        y2 = sf(x2)
        assert counter.launches == 6 and sf.compile_count == 1
        assert exe.inputs[0] is buf and buf.data_ptr() == ptr
        assert torch.equal(buf, x2)
        sf(torch.zeros(5, 8))                          # a new signature
    assert sf.compile_count == 2 and sf.cache_size() == 2
    torch.testing.assert_close(y1, want1, rtol=0, atol=0)
    torch.testing.assert_close(y2, want2, rtol=0, atol=0)
    # outputs are clones: the second replay left the first result alone
    assert y1.data_ptr() != y2.data_ptr()
    assert [g.replays for g in fake_card.made] == [2, 1]


def test_compile_for_adopts_a_tensor_and_returns_it_as_itself(fake_card):
    pool = torch.zeros(4, 3)

    def write(rows, pool):
        pool.index_put_((rows.long(),), torch.ones(rows.shape[0], 3))
        return rows.sum(), pool

    sf = jit.StaticFunction(write)
    exe = sf.compile_for(((2,), np.int32), pool)
    assert exe.inputs[1] is pool
    pool.zero_()                    # the warm-up wrote the scratch row 0
    total, out = exe(np.asarray([1, 3], np.int32), pool)
    assert out is pool and int(total) == 4
    assert pool[:, 0].tolist() == [0.0, 1.0, 0.0, 1.0]
    total, out = exe(np.asarray([2, 2], np.int32), pool)
    assert out is pool and int(total) == 4
    assert pool[:, 0].tolist() == [0.0, 1.0, 1.0, 1.0]
    assert sf.compile_count == 1


def test_in_place_update_is_read_and_rebinding_recaptures(fake_card):
    _, port = _nets()
    sf = jit.to_static(port)
    x = torch.ones(1, 8)
    with torch.no_grad():
        y0 = sf(x)
        port[0].weight.mul_(0.5)
        y1 = sf(x)
        assert sf.compile_count == 1
        torch.testing.assert_close(y1, port(x), rtol=0, atol=0)
        write_back(port, {"2.bias": torch.full((4,), 3.0)})
        y2 = sf(x)
        assert sf.compile_count == 2
        torch.testing.assert_close(y2, port(x), rtol=0, atol=0)
        y3 = sf(x)
    assert sf.compile_count == 2
    assert not torch.equal(y0, y1) and torch.equal(y2, y3)


def test_a_failed_capture_raises_and_runs_nothing(fake_card):
    state = {"calls": 0, "capturing": []}

    def f(x):
        state["calls"] += 1
        state["capturing"].append(jit.is_capturing())
        if jit.is_capturing():
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1

    sf = jit.StaticFunction(f)
    with torch.no_grad(), pytest.raises(jit.CaptureError,
                                        match="not permitted"):
        sf(torch.zeros(2))
    # the warm-up and the capture ran; nothing ran eagerly after it
    assert state == {"calls": 2, "capturing": [False, True]}
    assert not jit.is_capturing()


def test_check_index_bounds_raises_under_capture(fake_card):
    weight = torch.randn(10, 4)
    sf = jit.StaticFunction(lambda ids: F.embedding(ids, weight))
    set_flags({"check_index_bounds": True})
    try:
        with torch.no_grad(), pytest.raises(jit.CaptureError,
                                            match="check_index_bounds"):
            sf(torch.tensor([1, 2]))
    finally:
        set_flags({"check_index_bounds": False})


def test_recompute_under_capture_replays_the_forwards_draws(fake_card):
    """Under a capture the replay reads the forward's draws back: the
    gradient of a dropped-out segment is the one an eager recompute
    gives, and the segment's generator is drawn from once per call."""
    gen = torch.Generator().manual_seed(5)

    class Step(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = Linear(4, 4, device="cpu")
            self._generator = gen

        def seg(self, x):
            return F.dropout(self.lin(x), 0.5, generator=gen)

        def forward(self, x):
            with torch.enable_grad():
                x = x.detach().requires_grad_()
                recompute(self.seg, x).square().sum().backward()
                return x.grad

    step = Step()
    x = torch.randn(3, 4)
    want = [step(x) for _ in range(3)]
    gen.manual_seed(5)
    sf = jit.StaticFunction(step)
    with torch.no_grad():
        got = [sf(x) for _ in range(3)]
    assert sf.compile_count == 1 and fake_card.made[0].generators == [gen]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(want[0], want[1])     # each call drew anew


def test_a_generator_drawn_from_is_registered(fake_card):
    gen = torch.Generator().manual_seed(3)
    idle = torch.Generator().manual_seed(4)

    class Noisy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self._generator = gen
            self.quiet = torch.nn.Module()
            self.quiet._generator = idle

        def forward(self, x):
            return x + torch.rand(x.shape, generator=gen)

    sf = jit.StaticFunction(Noisy())
    x = torch.zeros(5)
    ref_gen = torch.Generator().manual_seed(3)
    want = [x + torch.rand(5, generator=ref_gen) for _ in range(3)]
    with torch.no_grad():
        got = [sf(x) for _ in range(3)]
    # the warm-up's draw was put back: the replays draw what eager calls
    # would have, in order
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fake_card.made[0].generators == [gen]


def _gpt(seed=1, dropout=0.0, **cfg):
    cfg = dataclasses.replace(gpt2_tiny(), dropout=dropout, **cfg)
    m = GPTForCausalLM(cfg, device="cpu", generator=make_generator(seed,
                                                                   "cpu"))
    m.train(dropout > 0)
    return m


def _batches(n, lead=(), seed=0):
    ids = np.random.RandomState(seed).randint(
        0, 512, (n, *lead, 2, 17))
    return ids[..., :-1], ids[..., 1:]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_captured_train_steps_equal_eager_steps_bit_for_bit(fake_card,
                                                            dropout):
    x, y = _batches(4)
    runs = {}
    for captured in (False, True):
        m = _gpt(dropout=dropout)
        opt = AdamW(1e-3, parameters=m.parameters(), weight_decay=0.01)
        if captured:
            step = create_train_step(m, opt)
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jit, "captures_on", lambda device: False)
                step = create_train_step(m, opt)
        losses, grads = [], []
        for i in range(4):
            losses.append(step(x[i], y[i], 1e-3 * (i + 1)))
            grads.append([p.grad.clone() for p in m.parameters()])
        runs[captured] = (losses, [p.detach().clone()
                                   for p in m.parameters()], opt, step,
                          grads)
    (eager, p_eager, o_eager, _, g_eager), (got, p_got, o_got, step,
                                            g_got) = runs[False], runs[True]
    assert step.compile_count == 1 and fake_card.made[0].replays == 3
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    # each step's gradients stay on the parameters, the first (eager)
    # call's copied into the graph's own
    assert all(torch.equal(a, b) for ga, gb in zip(g_got, g_eager)
               for a, b in zip(ga, gb))
    assert all(p.grad is t for p, t in zip(
        step._params, step._grads[next(iter(step._grads))]))
    assert all(torch.equal(a, b) for a, b in zip(p_got, p_eager))
    # the host counts advanced once a replay; the losses kept are clones
    assert o_got.state_dict()["step"] == o_eager.state_dict()["step"] == 4
    assert len({t.data_ptr() for t in got}) == 4
    assert (fake_card.made[0].generators != []) == (dropout > 0)


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_captured_recompute_with_dropout_equals_eager(fake_card, policy):
    """GPT-2 with every layer recomputed and dropout 0.1 (attention seeds
    and the residual masks): the captured steps equal the eager steps,
    whose replays restore the generator, bit for bit."""
    x, y = _batches(3)
    runs = {}
    for captured in (False, True):
        m = _gpt(dropout=0.1, use_recompute=True, recompute_policy=policy)
        opt = AdamW(1e-3, parameters=m.parameters(), weight_decay=0.01)
        with pytest.MonkeyPatch.context() as mp:
            if not captured:
                mp.setattr(jit, "captures_on", lambda device: False)
            step = create_train_step(m, opt)
        losses = [step(x[i], y[i], 1e-3) for i in range(3)]
        runs[captured] = (losses, [p.detach().clone()
                                   for p in m.parameters()])
    assert fake_card.made[0].replays == 2
    assert all(torch.equal(a, b) for a, b in zip(runs[True][0],
                                                 runs[False][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                 runs[False][1]))


def test_captured_multistep_with_accumulate_equals_eager(fake_card):
    x, y = _batches(3, lead=(2, 2))                  # [3, K=2, M=2, B, S]
    runs = {}
    for captured in (False, True):
        m = _gpt(dropout=0.1)
        opt = AdamW(1e-3, parameters=m.parameters())
        with pytest.MonkeyPatch.context() as mp:
            if not captured:
                mp.setattr(jit, "captures_on", lambda device: False)
            step = create_multistep_train_step(m, opt, steps=2,
                                               accumulate=2)
        losses = [step(x[i], y[i], 1e-3) for i in range(3)]
        runs[captured] = (torch.cat(losses), [p.detach().clone()
                                              for p in m.parameters()])
        with pytest.raises(ValueError, match="steps=2"):
            step(x[0, :1], y[0, :1], 1e-3)
    assert torch.equal(runs[True][0], runs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(*(runs[c][1]
                                                    for c in (True, False))))
    assert fake_card.made[0].replays == 2


def test_rebinding_a_parameter_recaptures_the_train_step(fake_card):
    m = _gpt()
    step = create_train_step(m, AdamW(1e-3, parameters=m.parameters()))
    x, y = _batches(3)
    step(x[0], y[0], 1e-3)
    step(x[1], y[1], 1e-3)
    assert step.compile_count == 1
    name, p = next(iter(m.named_parameters()))
    write_back(m, {name: p.detach().clone()})
    step(x[2], y[2], 1e-3)
    assert step.compile_count == 2


def test_owners_share_one_capture_stream(fake_card, monkeypatch):
    """Every owner warms up and captures on the device's one capture
    stream (cuBLAS keeps a workspace for each stream it ran on)."""
    made = []
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: (
        made.append(_FakeStream()) or made[-1]))
    sfs = [jit.to_static(_nets(seed)[1]) for seed in (0, 1)]
    with torch.no_grad():
        for sf in sfs:
            sf(torch.ones(1, 8))
    m = _gpt()
    step = create_train_step(m, AdamW(1e-3, parameters=m.parameters()))
    x, y = _batches(1)
    step(x[0], y[0], 1e-3)
    assert len(made) == 1 and step.compile_count == 1
    assert all(o._graphs.stream is made[0] for o in (*sfs, step))


def test_dropping_the_owners_frees_the_models(fake_card):
    gc.collect()
    gc.disable()
    try:
        _, port = _nets()
        sf = jit.to_static(port)
        with torch.no_grad():
            sf(torch.ones(1, 8))
        exe = sf.compile_for(jit.InputSpec([2, 8]))
        exe(np.ones((2, 8), np.float32))
        m = _gpt()
        step = create_train_step(m, AdamW(1e-3, parameters=m.parameters()))
        x, y = _batches(2)
        for i in range(2):
            step(x[i], y[i], 1e-3)
        refs = [weakref.ref(port), weakref.ref(m)]
        del sf, exe, port, m, step
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_every_capture_is_recorded_as_a_compile(fake_card):
    """Each capture, a re-capture after a rebinding included, bumps the
    flight recorder's compile count once and records a ``jit::compile``
    event and span; replays record nothing."""
    from paddle_tpu_torch.profiler import tracing
    tracing.reset_tracing()
    tracing.enable_tracing()
    try:
        _, port = _nets()
        sf = jit.to_static(port)
        with torch.no_grad():
            for x in (torch.ones(1, 8), torch.zeros(1, 8), torch.ones(2, 8)):
                sf(x)
            assert tracing.compile_count() == sf.compile_count == 2
            write_back(port, {"2.bias": torch.full((4,), 3.0)})
            sf(torch.ones(1, 8))
            sf(torch.ones(1, 8))
        assert tracing.compile_count() == sf.compile_count == 3
        events = [e for e in tracing.snapshot_events()
                  if e["name"] == "jit::compile"]
        assert sorted(e["ph"] for e in events) == ["X"] * 3 + ["i"] * 3
        assert {e["args"]["fn"] for e in events} == {"Sequential"}
        assert [e["args"]["arity"] for e in events if e["ph"] == "X"] == \
            [1, 1, 1]
    finally:
        tracing.reset_tracing()
        tracing.disable_tracing()


def test_a_record_event_inside_a_capture_stays_on_the_host(fake_card):
    """A RecordEvent entered inside a captured call while a Profiler
    records (a ``record_function``) does not break the capture, and the
    replays compute what the call computes. The fake graph records every
    op the capture dispatched, the profiler's host-side scope ops among
    them; its tensor ops are the call's alone. (A CUDA graph holds device
    work only; ``chip_smoke.py`` phase ``observe`` profiles such a replay
    on the card.)"""
    from paddle_tpu_torch import profiler

    def f(x):
        with profiler.RecordEvent("inside"):
            return x * 2 + 1

    sf = jit.StaticFunction(f)
    with profiler.Profiler() as p, torch.no_grad():
        sf(torch.ones(3))
        y = sf(torch.full((3,), 2.0))
    assert torch.equal(y, torch.full((3,), 5.0))
    (g,) = fake_card.made
    assert g.replays == 2
    assert [str(op) for op, *_ in g.ops if str(op).startswith("aten.")] \
        == ["aten.mul.Tensor", "aten.add.Tensor"]
    assert "inside" in {e.name for e in p.events}

"""PyTorch port: the training loop (paddle_tpu_torch/models/trainer.py
``create_multistep_train_step`` and ``run_steps``) on gpt2_tiny (2
layers), against the port's own single step and paddle_tpu's trainer.

- ``steps=K`` equals K ``create_train_step`` calls on a twin model bit
  for bit (losses, parameters), with dropout 0 and 0.1 (the dropout
  masks drawn from the model's generator in the same order);
- ``accumulate=M`` (SGD, whose update is linear in the gradient) equals
  the concatenated batch at the reference test's tolerances (losses
  rtol 1e-5 / atol 1e-6, parameters rtol 1e-4 / atol 1e-5), and so do
  paddle_tpu's ``create_multistep_train_step`` losses and parameters
  from the same weights;
- a mis-stacked input raises the reference's ``ValueError`` before any
  update;
- ``run_steps`` over a list and over ``prefetch_to_device`` gives the
  synchronous loop's losses bit for bit, with ``lr`` a callable,
  ``log_every`` and ``start_step``;
- on the card branch (CUDA calls patched) ``run_steps`` fetches each
  loss through a pinned buffer and an event, one step behind, and never
  through ``.item()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import create_multistep_train_step as jmultistep
from paddle_tpu.models import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu_torch import profiler
from paddle_tpu_torch.io import prefetch_to_device
from paddle_tpu_torch.models import (GPTForCausalLM,
                                     create_multistep_train_step,
                                     create_train_step, gpt2_tiny,
                                     run_steps, state_dict_from_numpy)
from paddle_tpu_torch.models import trainer
from paddle_tpu_torch.optimizer import SGD, AdamW

K, M = 2, 2
SEQ = 16


@pytest.fixture(scope="module")
def weights():
    paddle.seed(23)
    jm = JaxGPT(jax_gpt2_tiny())
    jm.eval()
    return jm, {k: v.numpy() for k, v in jm.state_dict().items()}


def _model(weights, dropout=0.0, seed=5):
    cfg = dataclasses.replace(gpt2_tiny(), dropout=dropout)
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    state_dict_from_numpy(m, weights[1])
    m.train(dropout > 0)
    return m


def _data(n, batch=2, seed=0):
    ids = np.random.RandomState(seed).randint(0, 512, (n, batch, SEQ + 1))
    return ids[..., :-1], ids[..., 1:]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_k_steps_equal_k_single_steps_bit_for_bit(weights, dropout):
    x, y = _data(K)
    single = _model(weights, dropout)
    step = create_train_step(single, AdamW(1e-3,
                                           parameters=single.parameters()))
    ref = [step(x[i], y[i], 1e-3) for i in range(K)]
    multi = _model(weights, dropout)
    step_k = create_multistep_train_step(
        multi, AdamW(1e-3, parameters=multi.parameters()), steps=K)
    got = step_k(x, y, 1e-3)
    assert got.shape == (K,)
    assert torch.equal(got, torch.stack(ref))
    for (n, p), q in zip(single.named_parameters(), multi.parameters()):
        assert torch.equal(p, q), n


def _concat_and_accumulate(weights):
    """The same tokens as one [4, S] batch per step, and as M = 2
    microbatches of [2, S]; SGD 5e-3, K steps each."""
    x, y = _data(1, batch=4, seed=1)
    x, y = np.tile(x, (K, 1, 1)), np.tile(y, (K, 1, 1))
    cat = _model(weights)
    losses_cat = create_multistep_train_step(
        cat, SGD(0.05, parameters=cat.parameters()), steps=K)(x, y, 5e-3)
    acc = _model(weights)
    step_a = create_multistep_train_step(
        acc, SGD(0.05, parameters=acc.parameters()), steps=K,
        accumulate=M)
    losses_acc = step_a(x.reshape(K, M, 2, SEQ), y.reshape(K, M, 2, SEQ),
                        5e-3)
    return (x, y), (cat, losses_cat), (acc, losses_acc)


def test_accumulation_matches_the_concatenated_batch(weights):
    _, (cat, lc), (acc, la) = _concat_and_accumulate(weights)
    np.testing.assert_allclose(la.numpy(), lc.numpy(), rtol=1e-5, atol=1e-6)
    for (n, p), q in zip(cat.named_parameters(), acc.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_accumulation_matches_the_reference_multistep(weights):
    """paddle_tpu's ``create_multistep_train_step(steps=K,
    accumulate=M)`` on the same weights and microbatches."""
    (x, y), _, (acc, la) = _concat_and_accumulate(weights)
    jm = weights[0]
    step_a, p, s = jmultistep(jm, paddle.optimizer.SGD(
        0.05, parameters=jm.parameters()), steps=K, accumulate=M)
    ref, p, s = step_a(p, s, jax.random.key(0),
                       jnp.asarray(x.reshape(K, M, 2, SEQ)),
                       jnp.asarray(y.reshape(K, M, 2, SEQ)), 5e-3)
    np.testing.assert_allclose(la.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    for n, q in acc.named_parameters():
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(p[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_mis_stacked_inputs_raise_before_any_update(weights):
    m = _model(weights)
    before = [p.detach().clone() for p in m.parameters()]
    opt = SGD(0.05, parameters=m.parameters())
    x, y = _data(3)
    with pytest.raises(ValueError, match="steps=2 expects"):
        create_multistep_train_step(m, opt, steps=K)(x, y, 1e-3)
    step_a = create_multistep_train_step(m, opt, steps=K, accumulate=M)
    x3 = np.zeros((K, 3, 2, SEQ), np.int64)
    with pytest.raises(ValueError, match="accumulate=2 expects"):
        step_a(x3, x3, 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))


def _lr(i):
    return 1e-3 * (1 + 0.5 * i)


@pytest.mark.parametrize("feed_kind", ["list", "prefetch"])
def test_run_steps_equals_the_synchronous_loop(weights, feed_kind):
    x, y = _data(2 * K, seed=2)
    batches = [(x[i], y[i]) for i in range(2 * K)]
    sync = _model(weights)
    step_s = create_multistep_train_step(
        sync, AdamW(1e-3, parameters=sync.parameters()), steps=K)
    ref = [step_s(np.stack(x[j:j + K]), np.stack(y[j:j + K]),
                  _lr(3 + j // K)).numpy() for j in range(0, 2 * K, K)]
    run = _model(weights)
    step_r = create_multistep_train_step(
        run, AdamW(1e-3, parameters=run.parameters()), steps=K)
    if feed_kind == "list":
        feed = [(np.stack(x[j:j + K]), np.stack(y[j:j + K]))
                for j in range(0, 2 * K, K)]
    else:
        feed = prefetch_to_device(iter(batches), stack=K, device="cpu",
                                  name="t_run")
    logged = []
    got = run_steps(step_r, feed, lr=_lr, log_every=2, start_step=3,
                    on_log=lambda i, v: logged.append((i, v)),
                    name="t_run_steps")
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert [i for i, _ in logged] == [4]
    np.testing.assert_array_equal(logged[0][1], ref[1])
    for (n, p), q in zip(sync.named_parameters(), run.parameters()):
        assert torch.equal(p, q), n
    assert "t_run_steps" not in profiler.pipeline_stats()
    if feed_kind == "prefetch":
        snap = feed.metrics.snapshot()
        assert snap["batches_out"] == 2 and snap["device_blocked_s"] >= 0
        feed.close()


def test_run_steps_registers_its_metrics_while_it_runs(weights):
    seen = []

    def step(ids, labels, lr):
        seen.append(profiler.pipeline_stats("loop")["batches_out"])
        return torch.tensor(float(lr))

    out = run_steps(step, [(0, 0)] * 3, lr=0.5, name="loop")
    assert seen == [1, 2, 3] and [float(v) for v in out] == [0.5] * 3
    assert "loop" not in profiler.pipeline_stats()


def test_card_branch_fetches_through_a_pinned_buffer_and_event(
        monkeypatch):
    """Each loss is copied into pinned host memory with
    ``non_blocking=True`` right behind its step and an event recorded;
    step i's loss is read after step i + 1 is dispatched, by waiting on
    step i's event, never with ``.item()``."""
    log = []

    class FakeEvent:
        def record(self, stream=None):
            self.n = len([e for e in log if e[0] == "record"])
            log.append(("record", self.n))

        def synchronize(self):
            log.append(("wait", self.n))

    orig_empty = torch.empty

    def empty(*a, pin_memory=False, **k):
        log.append(("alloc", pin_memory))
        return orig_empty(*a, **k)

    orig_copy = torch.Tensor.copy_

    def copy_(self, src, non_blocking=False):
        log.append(("copy", non_blocking))
        return orig_copy(self, src)

    def item(self):
        raise AssertionError(".item() would wait for every step enqueued")

    monkeypatch.setattr(trainer, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    monkeypatch.setattr(torch.Tensor, "item", item)

    def step(ids, labels, lr):
        log.append(("dispatch", int(ids)))
        return torch.full((), float(ids))

    got = run_steps(step, [(i, i) for i in range(3)])
    assert [float(v) for v in got] == [0.0, 1.0, 2.0]
    assert log == [("dispatch", 0), ("alloc", True), ("copy", True),
                   ("record", 0),
                   ("dispatch", 1), ("alloc", True), ("copy", True),
                   ("record", 1), ("wait", 0),
                   ("dispatch", 2), ("alloc", True), ("copy", True),
                   ("record", 2), ("wait", 1),
                   ("wait", 2)]

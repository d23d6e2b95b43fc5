"""Training-step factories and the loop runner (counterpart of
paddle_tpu/models/trainer.py).

paddle_tpu stages forward, backward and the optimizer sweep into one
jitted XLA program over functional parameter trees. The port's steps
work on the module in place: forward, the backward (the flash-attention
backward kernels on the card) and ``optimizer.apply_gradients``, which
updates the parameters and the optimizer's tensors in place, the
counterpart of the reference's buffer donation. As in the reference,
these steps take the learning rate as an argument and never clip: only
the eager ``optimizer.step()`` reads a schedule and applies
``grad_clip``. The weight decay mask is the reference's ``_wd_mask``.

On the card a step is the counterpart of the reference's one jitted
program: one CUDA graph per (ids, labels) signature (``_CapturedStep``,
over ``jit.Graphs``). A signature's first call runs eagerly on the
capture stream, which sets up the libraries and the optimizer's state
outside the capture, and is then captured (the first step's gradients
wait in host memory meanwhile, so the card never holds them beside the
graph's); every later call copies its
batch into the graph's static inputs, fills the rate into a 0-d fp64
buffer the graph reads, replays, and returns a clone of the loss, which
a later replay cannot overwrite. A K-step call with ``accumulate=M`` is
one graph. The model's generators that the first call drew from
(dropout) are registered with the graph, each replay advances the
optimizer's host-side step counts, and a rebinding of a parameter, a
master weight or an optimizer tensor is captured again before the next
replay. On the CPU every call runs eagerly.

``create_multistep_train_step`` runs K such steps per call (the
counterpart of the reference's ``lax.scan``), with ``accumulate=M``
microbatches per step whose gradients are summed in fp32 beside the
parameters and averaged before one update. ``run_steps`` drives either
step over a feed without waiting on the step it has just dispatched: on
the card each loss is copied to pinned host memory behind its step and
read one step later, after an event recorded behind that copy.
"""
from __future__ import annotations

import functools
import time
import warnings
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import jit, profiler
from ..io.prefetch import DevicePrefetcher, PipelineMetrics
from ..profiler import tracing

__all__ = ["create_train_step", "create_multistep_train_step", "run_steps",
           "write_back"]


def _wd_mask(names: Iterable[str]) -> Dict[str, bool]:
    """No weight decay on biases and norm parameters."""
    return {n: ("bias" not in n and "norm" not in n.lower()
                and "ln_" not in n) for n in names}


def _pieces(model: nn.Module, loss_fn: Optional[Callable]):
    """The trainable parameters, their weight-decay mask by id, the
    model's device and the loss call shared by the step factories."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    mask = _wd_mask(n for n, _ in named)
    wd_mask = {id(p): mask[n] for n, p in named}
    device = named[0][1].device

    def loss_call(ids, labels):
        if loss_fn is not None:
            return loss_fn(model, ids, labels)
        return model.loss(ids, labels)

    return [p for _, p in named], wd_mask, device, loss_call


def _step_body(optimizer, wd_mask, loss_call):
    """One eager step on device tensors: the body of a train step."""
    def body(ids, labels, lr) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_call(ids, labels)
        loss.backward()
        optimizer.apply_gradients(lr, wd_mask=wd_mask)
        return loss.detach()
    return body


def _watched(optimizer, params) -> list:
    """The tensors a captured step updates in place: the parameters, the
    master weights and every optimizer state tensor."""
    out = list(params) + list(optimizer._master_weights.values())
    for p in params:
        st = optimizer.state.get(p)
        if st:
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory (pinned, and enqueued without a
    wait, for a tensor on the card)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return out.copy_(t, non_blocking=t.is_cuda)


class _CapturedStep:
    """``body(ids, labels, lr)`` as one CUDA graph per (ids, labels)
    signature (module docstring). The graphs share one ``jit.Graphs``:
    one memory pool and capture stream; the tensors they update in place
    (parameters, master weights, optimizer state) are watched for
    rebinding."""

    def __init__(self, body, model, optimizer, params, device, check=None):
        self._body = body
        self._check = check
        self._params = params
        self._device = device
        # the watch holds the optimizer and parameters, not this object:
        # no reference cycle keeps a dropped model alive
        self._graphs = jit.Graphs(device, jit._module_generators(model),
                                  functools.partial(_watched, optimizer,
                                                    params), "train step")
        self._by_sig: dict = {}
        self._grads: dict = {}  # each graph's gradients, by signature
        self._lr = None         # the rate's 0-d fp64 buffer
        self._last = None       # the graph whose gradients p.grad holds
        self._host = (optimizer._host_counts, optimizer._add_host_counts)

    def _capture(self, key, inputs):
        g = self._by_sig[key] = self._graphs.capture(self._body, inputs,
                                                     host=self._host)
        self._grads[key] = [p.grad for p in self._params]
        return g

    def __call__(self, ids, labels, lr) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self._device)
        labels = torch.as_tensor(labels, device=self._device)
        if self._check is not None:
            self._check(ids)
        key = jit.signature((ids, labels))
        g = self._by_sig.get(key)
        if g is None:
            # the signature's first step, eagerly on the capture stream.
            # Its gradients wait in host memory while the graph makes its
            # own (the device never holds both sets), then are copied
            # into the graph's, which the parameters keep.
            loss = self._graphs.warm_up(self._body, (ids, labels, lr),
                                        restore=False)
            held = [None if p.grad is None else _to_host(p.grad)
                    for p in self._params]
            for p in self._params:
                p.grad = None
            if self._lr is None:
                self._lr = torch.zeros((), dtype=torch.float64,
                                       device=self._device)
            self._capture(key, [ids.clone(), labels.clone(), self._lr])
            for p, h in zip(self._params, held):
                if h is None or p.grad is None:
                    p.grad = None
                else:
                    p.grad.copy_(h, non_blocking=True)
            self._last = None
            return loss
        if self._graphs.stale(g):
            g = self._capture(key, g.inputs)
        self._lr.fill_(lr)
        loss = g.run((ids, labels, self._lr))
        if self._last is not g:
            for p, t in zip(self._params, self._grads[key]):
                p.grad = t
            self._last = g
        return loss

    @property
    def compile_count(self) -> int:
        """Graphs captured, re-captures after a rebinding included."""
        return self._graphs.compile_count


def _step(body, model, optimizer, params, device, check=None):
    """The train step of ``body``: captured on the card, else eager.
    ``ids``/``labels`` are moved to ``device`` and checked by ``check``
    first."""
    if jit.captures_on(device):
        return _CapturedStep(body, model, optimizer, params, device, check)

    def train_step(ids, labels, lr) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=device)
        labels = torch.as_tensor(labels, device=device)
        if check is not None:
            check(ids)
        return body(ids, labels, lr)
    return train_step


def create_train_step(model: nn.Module, optimizer,
                      loss_fn: Optional[Callable] = None):
    """``train_step(ids, labels, lr) -> loss``: one forward, backward and
    ``optimizer`` update over ``model``'s trainable parameters, in place.
    ``model.loss(ids, labels)`` is the loss unless ``loss_fn(model, ids,
    labels)`` is given. ``ids``/``labels`` are moved to the model's
    device; the returned loss is a detached 0-d tensor there (reading it
    synchronises). The gradients of the step stay on the parameters
    until the next step. On the card, one CUDA graph per (ids, labels)
    signature (module docstring; ``train_step.compile_count`` counts the
    captures)."""
    params, wd_mask, device, loss_call = _pieces(model, loss_fn)
    return _step(_step_body(optimizer, wd_mask, loss_call), model,
                 optimizer, params, device)


def create_multistep_train_step(model: nn.Module, optimizer,
                                loss_fn: Optional[Callable] = None,
                                steps: int = 8, accumulate: int = 1):
    """``step_k(ids, labels, lr) -> losses``: ``steps`` optimizer updates
    per call, all at rate ``lr``, over inputs stacked ``[K, B, S]`` (K =
    ``steps``), or ``[K, M, B, S]`` with ``accumulate=M``. Returns the
    ``[K]`` losses as a detached tensor on the model's device.

    With ``accumulate=M`` > 1 each update runs M microbatches: their
    gradients are summed in fp32 (beside the parameters, whatever their
    dtype), divided by M and applied once; the step's loss is the
    microbatch mean. Dropout draws from the model's generator in order,
    microbatch by microbatch (the reference folds ``i * M + j`` into its
    key). A leading dim other than K, or a microbatch dim other than M,
    raises ``ValueError`` before anything runs."""
    params, wd_mask, device, loss_call = _pieces(model, loss_fn)
    single = _step_body(optimizer, wd_mask, loss_call)

    def check(ids):
        if ids.shape[0] != steps:
            raise ValueError(
                f"steps={steps} expects inputs stacked [{steps}, "
                f"batch, ...]; got leading dim {ids.shape[0]} in "
                f"{tuple(ids.shape)}")
        if accumulate > 1 and ids.shape[1] != accumulate:
            raise ValueError(
                f"accumulate={accumulate} expects inputs stacked "
                f"[steps, {accumulate}, batch, ...]; got microbatch dim "
                f"{ids.shape[1]} in {tuple(ids.shape)}")

    def body(ids, labels, lr) -> torch.Tensor:
        losses = []
        for i in range(steps):
            if accumulate == 1:
                losses.append(single(ids[i], labels[i], lr))
                continue
            gsum = {id(p): torch.zeros_like(p, dtype=torch.float32)
                    for p in params}
            lsum = torch.zeros((), dtype=torch.float32, device=device)
            for j in range(accumulate):
                optimizer.zero_grad(set_to_none=True)
                loss = loss_call(ids[i, j], labels[i, j])
                loss.backward()
                with torch.no_grad():
                    for p in params:
                        if p.grad is not None:
                            gsum[id(p)].add_(p.grad.float())
                    lsum = lsum + loss.detach().float()
            optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                grads = {k: g.div_(accumulate) for k, g in gsum.items()}
            optimizer.apply_gradients(lr, wd_mask=wd_mask, grads=grads)
            losses.append(lsum / accumulate)
        return torch.stack(losses)

    return _step(body, model, optimizer, params, device, check)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


class _LaggedLoss:
    """A step's loss on its way to the host. On the card: copied into
    pinned host memory right behind the step, with an event recorded
    behind the copy; ``get()`` waits on that event only, not on the steps
    enqueued after it (``.item()`` would wait for them too)."""

    def __init__(self, loss: torch.Tensor):
        loss = loss.detach()
        if _on_card(loss):
            self._host = torch.empty(loss.shape, dtype=loss.dtype,
                                     pin_memory=True)
            self._host.copy_(loss, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
        else:
            self._host, self._ready = loss, None

    def get(self) -> np.ndarray:
        if self._ready is not None:
            self._ready.synchronize()
        return self._host.numpy()


def run_steps(step, feed, *, lr=1e-3, log_every: int = 0,
              on_log: Optional[Callable] = None, name: Optional[str] = None,
              start_step: int = 0) -> list:
    """Drive ``step`` (a ``create_train_step`` or
    ``create_multistep_train_step`` product) over every ``(ids, labels)``
    batch of ``feed``, never waiting on the step just dispatched: step
    ``i``'s loss is fetched after step ``i + 1`` is enqueued. ``lr`` is a
    float or ``callable(i) -> float`` of the step index ``i``, which
    starts at ``start_step``. ``log_every=N`` calls ``on_log(i, loss)``
    for each fetched step ``i`` divisible by N.

    Returns the fetched losses in order, as numpy values (0-d for the
    single step, ``[K]`` for the multistep one).

    Wait times go to ``profiler.pipeline_stats()``: time blocked on
    ``feed`` counts as host_blocked_s (input-bound), time blocked on a
    lagged loss as device_blocked_s (compute-bound). A
    ``DevicePrefetcher`` feed's own metrics take them (it counts its
    waits itself); any other feed gets a ``PipelineMetrics`` named
    ``name`` (default ``"run_steps"``) for the run.

    With tracing on, each step records ``train::feed_wait`` (the wait for
    its batch), ``train::dispatch`` and, for its lagged loss,
    ``train::fetch`` in the flight recorder, each with ``step=i``."""
    lr_fn = lr if callable(lr) else (lambda i: lr)
    owns_metrics = not isinstance(feed, DevicePrefetcher)
    if owns_metrics:
        metrics = PipelineMetrics(name or "run_steps")
        profiler.register_pipeline_source(metrics.name, metrics)
    else:
        metrics = feed.metrics
    losses = []

    def fetch(pending: _LaggedLoss, i: int):
        t0 = time.perf_counter()
        with tracing.trace_span("train::fetch", cat="train", step=i):
            got = pending.get()
        metrics.add_time("device_blocked_s", time.perf_counter() - t0)
        losses.append(got)
        if log_every and on_log is not None and i % log_every == 0:
            on_log(i, got)

    pending = None
    i = start_step
    try:
        it = iter(feed)
        while True:
            t0 = time.perf_counter()
            # span handle, not a with-block: a StopIteration break drops
            # it unrecorded instead of logging a wait for no batch
            feed_span = tracing.trace_span("train::feed_wait", cat="train",
                                           step=i)
            try:
                ids, labels = next(it)
            except StopIteration:
                break
            feed_span.end()
            if owns_metrics:
                metrics.add_time("host_blocked_s", time.perf_counter() - t0)
                metrics.inc("batches_out")
            with tracing.trace_span("train::dispatch", cat="train", step=i):
                lagged = _LaggedLoss(step(ids, labels, lr_fn(i)))
            if pending is not None:
                fetch(pending, i - 1)
            pending = lagged
            i += 1
        if pending is not None:
            fetch(pending, i - 1)
    finally:
        if owns_metrics:
            profiler.unregister_pipeline_source(metrics.name, metrics)
    return losses


def write_back(model: nn.Module, params: Mapping[str, torch.Tensor],
               strict: bool = False) -> None:
    """Replace the named parameters' data with ``params`` (dtype and
    device included: casting a model's weights to bf16 is
    ``write_back(model, {k: v.bfloat16() ...})``). Names not on the model
    warn, or raise ``KeyError`` with ``strict=True``."""
    entries = dict(model.named_parameters())
    unknown = sorted(k for k in params if k not in entries)
    if unknown:
        msg = (f"write_back: {len(unknown)} param(s) not on the model, "
               f"dropped: {unknown[:5]}{'...' if len(unknown) > 5 else ''}")
        if strict:
            raise KeyError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    with torch.no_grad():
        for k, v in params.items():
            if k in entries:
                entries[k].data = v

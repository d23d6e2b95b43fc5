"""Training-step factories and the loop runner (counterpart of
paddle_tpu/models/trainer.py).

paddle_tpu stages forward, backward and the optimizer sweep into one
jitted XLA program over functional parameter trees. PyTorch runs
eagerly, so the port's steps work on the module in place: forward, the
backward (the flash-attention backward kernels on the card) and
``optimizer.apply_gradients``, which updates the parameters and moments
in place, the counterpart of the reference's buffer donation. As in the
reference, these steps take the learning rate as an argument and never
clip: only the eager ``optimizer.step()`` reads a schedule and applies
``grad_clip``. The weight decay mask is the reference's ``_wd_mask``.

``create_multistep_train_step`` runs K such steps per call (the
counterpart of the reference's ``lax.scan``), with ``accumulate=M``
microbatches per step whose gradients are summed in fp32 beside the
parameters and averaged before one update. ``run_steps`` drives either
step over a feed without waiting on the step it has just dispatched: on
the card each loss is copied to pinned host memory behind its step and
read one step later, after an event recorded behind that copy.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import profiler
from ..io.prefetch import DevicePrefetcher, PipelineMetrics

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


def create_train_step(model: nn.Module, optimizer,
                      loss_fn: Optional[Callable] = None):
    """``train_step(ids, labels, lr) -> loss``: one forward, backward and
    ``optimizer`` update over ``model``'s trainable parameters, in place.
    ``model.loss(ids, labels)`` is the loss unless ``loss_fn(model, ids,
    labels)`` is given. ``ids``/``labels`` are moved to the model's
    device; the returned loss is a detached 0-d tensor there (reading it
    synchronises). The gradients of the step stay on the parameters
    until the next step."""
    _, wd_mask, device, loss_call = _pieces(model, loss_fn)

    def train_step(ids, labels, lr: float) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=device)
        labels = torch.as_tensor(labels, device=device)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_call(ids, labels)
        loss.backward()
        optimizer.apply_gradients(lr, wd_mask=wd_mask)
        return loss.detach()

    return train_step


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
    single = create_train_step(model, optimizer, loss_fn)

    def step_k(ids, labels, lr: float) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=device)
        labels = torch.as_tensor(labels, device=device)
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

    return step_k


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
    ``name`` (default ``"run_steps"``) for the run."""
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
            try:
                ids, labels = next(it)
            except StopIteration:
                break
            if owns_metrics:
                metrics.add_time("host_blocked_s", time.perf_counter() - t0)
                metrics.inc("batches_out")
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

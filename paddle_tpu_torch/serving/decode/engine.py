"""Continuous-batching decode server over a paged KV cache (counterpart
of paddle_tpu/serving/decode/engine.py).

``DecodeServer`` keeps paddle_tpu's contract (bounded queue +
``ServerOverloaded`` shedding, per-request deadlines, drain/shutdown,
metrics) and serves autoregressive generation: ``submit(prompt)``
returns a ``DecodeStream`` that yields tokens as the engine produces
them.

Execution model — one worker thread:

- Every step (prefill of one admitted request, or one decode step of
  the whole active batch) is one call of ``StaticFunction(
  _DecodeStepLayer(...))``. ``_StepExecutor`` keeps one
  ``compile_for`` executable per step signature, as paddle_tpu does:
  (batch bucket, page bucket) for decode and (prompt bucket, page
  bucket) for prefill. On the card each executable is one CUDA graph,
  captured by ``warmup()`` or at the signature's first step, and a step
  copies its int32 host arrays into the graph's static inputs and
  replays it; on the CPU it runs eagerly. ``compile_count`` and
  ``num_executables()`` count the executables.
- The KV pools are written in place (see ``kvcache.py``): the
  counterpart of donating them back to each step on the TPU. They are
  the graphs' own static inputs (``compile_for`` adopts them), so a
  step returns the server's pool tensors themselves; the only copy to
  the host is the ``[B]`` sampled tokens.
- Between steps the scheduler admits queued requests into free slots,
  grows sequences by one page at page boundaries, and evicts finished/
  expired sequences — host bookkeeping over fixed-shape device state.

paddle_tpu's flight-recorder spans and events (``profiler.tracing``)
and its profiler registry are left out until those modules are ported.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...core.random import DEFAULT_SEED, make_generator
from ...device import resolve_device
from ...jit import StaticFunction, signature
from ..batcher import (DeadlineExceeded, ServerClosed, ServerOverloaded,
                       ServingError)
from ..bucketing import (BucketOverflow, next_bucket_strict, page_buckets,
                         pow2_buckets)
from ..lifecycle import ServerLifecycleMixin
from .kvcache import (PageAllocator, PagedKV, PagesExhausted,
                      init_paged_cache, page_table_array, pages_for)
from .metrics import DecodeMetrics
from .scheduler import AdmissionQueue, DecodeRequest, DecodeStream, Scheduler

__all__ = ["DecodeServer", "DecodeStream"]

_server_ids = itertools.count()


class _DecodeStepLayer(nn.Module):
    """The one step function: paged-cache decode + sampling.

    forward(tokens [B,S], positions [B], page_rows [B,P],
            last_index [B], *pools) -> (next_token [B], *pools)

    Greedy when ``temperature == 0`` (argmax needs no randomness, so
    decode is deterministic); otherwise a temperature-scaled categorical
    draw from the layer's own ``torch.Generator``. Sampling happens on
    the device so only ``[B]`` token ids ever cross to the host.
    """

    def __init__(self, model, page_len: int, temperature: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.model = model
        self._page_len = int(page_len)
        self._temperature = float(temperature)
        self._generator = generator

    def sample(self, logits, last_index):
        rows = torch.arange(logits.shape[0], device=logits.device)
        last = logits[rows, last_index.long()]                  # [B, V]
        if self._temperature > 0.0:
            probs = torch.softmax(last.float() / self._temperature, dim=-1)
            return torch.multinomial(
                probs, 1, generator=self._generator)[:, 0].to(torch.int32)
        return torch.argmax(last, dim=-1).to(torch.int32)

    def forward(self, tokens, positions, page_rows, last_index, *pools):
        caches = [(pools[2 * i], pools[2 * i + 1])
                  for i in range(len(pools) // 2)]
        ops = PagedKV(page_rows, self._page_len)
        logits, new_caches = self.model.decode_step(
            tokens, positions, caches, kv_ops=ops)
        nxt = self.sample(logits, last_index)
        flat = [a for pair in new_caches for a in pair]
        return (nxt, *flat)


class _StepExecutor:
    """``compile_for``-backed executable cache keyed on the full step
    signature. No LRU: the bucket sets bound the key space by design,
    and ``compile_count`` is the quantity tests pin: an executable made,
    or a graph captured again after the model's weights were rebound."""

    def __init__(self, sf: StaticFunction, metrics: DecodeMetrics):
        self._sf = sf
        self._compiled: dict = {}
        self._metrics = metrics
        # covers compile AND run: warmup() captures from the caller's
        # thread, the worker from its own, and a capture must not
        # interleave with another thread's replay
        self._lock = threading.Lock()

    def _get(self, specs):
        """The executable of ``specs``, made when missing (under the
        lock); returns (executable, made)."""
        key = signature(specs)
        compiled = self._compiled.get(key)
        if compiled is not None:
            return compiled, False
        compiled = self._compiled[key] = self._sf.compile_for(*specs)
        self._metrics.inc("compile_count")
        return compiled, True

    def compile(self, specs) -> bool:
        """Ensure an executable exists for ``specs`` ((shape, dtype)
        pairs, arrays, or the pool tensors themselves); True when this
        call made it."""
        with self._lock:
            return self._get(specs)[1]

    def run(self, host_arrays, pools):
        """One step: the int32 host arrays go into the executable's
        inputs, the pools are updated in place and returned as
        themselves. ``inference_mode`` is entered here, in the calling
        (worker) thread, since the mode is thread-local."""
        args = list(host_arrays) + list(pools)
        with self._lock:
            compiled, _ = self._get(args)
            before = self._sf.compile_count
            with torch.inference_mode():
                out = compiled(*args)
            recaptured = self._sf.compile_count - before
        if recaptured:
            self._metrics.inc("compile_count", recaptured)
        if any(a is not b for a, b in zip(out[1:], pools)):
            raise ServingError("the step returned KV pools other than the "
                               "server's own tensors")
        return out

    def signatures(self) -> list:
        with self._lock:
            return list(self._compiled)


class DecodeServer(ServerLifecycleMixin):
    """Continuous-batching autoregressive decode server.

    Example::

        model = LlamaForCausalLM(llama_7b())              # on cuda
        with DecodeServer(model, max_slots=8, page_len=16,
                          max_context=512) as srv:
            stream = srv.submit(prompt_ids, max_new_tokens=32)
            for tok in stream:          # tokens as they are generated
                ...
            ids = stream.result()       # or block for all of them

    Parameters
    ----------
    model: a module with the decode protocol (``decode_step`` +
        ``decode_meta``), on ``device``.
    max_slots: decode batch capacity (concurrent running sequences).
    page_len: tokens per KV page.
    max_context: longest prompt+generation a request may reach
        (default: the model's max_position_embeddings).
    num_pages: physical pages per layer pool (default: enough for every
        slot at max_context, +1 scratch — i.e. no admission blocking).
    max_new_tokens: per-request default generation budget.
    batch_buckets / prefill_buckets: admissible decode batch sizes and
        padded prompt lengths (defaults: powers of two). Together with
        the page buckets they bound the step signatures:
        |batch_buckets| x |page_buckets| decode shapes +
        |prefill_buckets| prefill shapes (each at its page bucket).
    admission: "worst_case" (reserve a sequence's maximum pages at
        admission; never preempts) or "prefill" (reserve only the
        prompt's pages; page exhaustion preempts the fewest-generated
        slot back into the queue).
    temperature: 0 = greedy argmax (deterministic); > 0 samples.
    generator: the sampler's ``torch.Generator`` on ``device`` (default:
        seed 0); used only when ``temperature > 0``.
    max_queue_size: bound on queued requests (ServerOverloaded beyond).
    default_deadline_ms: applied when submit() passes none.
    eos_id: default stop token (per-request override in submit()).
    device: where the pools live and the steps run (default ``cuda``);
        the model must already be there.
    """

    def __init__(self, model, *, max_slots: int = 8, page_len: int = 16,
                 max_context: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_new_tokens: int = 64,
                 batch_buckets: Optional[Sequence[int]] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 admission: str = "worst_case",
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 max_queue_size: int = 128,
                 default_deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 name: Optional[str] = None,
                 poll_ms: float = 5.0,
                 device=None):
        meta = getattr(model, "decode_meta", None)
        if meta is None or not hasattr(model, "decode_step"):
            raise TypeError(
                f"cannot decode-serve a {type(model).__name__}: the model "
                "must implement the decode protocol (decode_meta + "
                "decode_step — see models/decode.py)")
        self._meta = meta()
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(f"model is on {model_dev}, server device is "
                             f"{self.device}")
        self.name = name or f"decode_server_{next(_server_ids)}"
        self.page_len = int(page_len)
        self.max_context = int(min(max_context or self._meta["max_len"],
                                   self._meta["max_len"]))
        pages_per_seq = pages_for(self.max_context, self.page_len)
        if num_pages is None:
            num_pages = max_slots * pages_per_seq + 1
        self.default_max_new_tokens = int(max_new_tokens)
        self.default_eos_id = eos_id
        self._default_deadline_s = (None if default_deadline_ms is None
                                    else float(default_deadline_ms) / 1e3)
        self._poll_s = float(poll_ms) / 1e3

        self._batch_buckets = (sorted(batch_buckets) if batch_buckets
                               else pow2_buckets(max_slots))
        if max(self._batch_buckets) < max_slots:
            raise ValueError(
                f"largest batch bucket {max(self._batch_buckets)} < "
                f"max_slots {max_slots}")
        self._page_buckets = page_buckets(pages_per_seq)
        self._prefill_buckets = (sorted(prefill_buckets) if prefill_buckets
                                 else pow2_buckets(self.max_context))
        if max(self._prefill_buckets) > pages_per_seq * self.page_len:
            raise ValueError(
                f"largest prefill bucket {max(self._prefill_buckets)} "
                f"exceeds the per-sequence page budget "
                f"({pages_per_seq} pages x {self.page_len})")

        self._metrics = DecodeMetrics(self.name)
        self._pools = [a for pair in init_paged_cache(
            self._meta["num_layers"], num_pages, self.page_len,
            self._meta["num_kv_heads"], self._meta["head_dim"],
            self._meta.get("dtype", torch.float32), device=self.device)
            for a in pair]
        if temperature > 0.0 and generator is None:
            generator = make_generator(DEFAULT_SEED, self.device)
        self._sf = StaticFunction(
            _DecodeStepLayer(model, self.page_len, temperature, generator))
        self._exec = _StepExecutor(self._sf, self._metrics)
        self._sched = Scheduler(
            max_slots=max_slots, allocator=PageAllocator(num_pages),
            page_len=self.page_len, max_context=self.max_context,
            prefill_buckets=self._prefill_buckets,
            page_buckets=self._page_buckets,
            batch_buckets=self._batch_buckets, admission=admission)
        self._queue = AdmissionQueue(max_queue_size)
        self._metrics.set_depth_gauge(self._queue.qsize)

        self._stop = threading.Event()
        self._abort = False
        self._closed = False
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._step_loop,
                                        name=self.name, daemon=True)
        self._worker.start()

    # -- client API --------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> DecodeStream:
        """Enqueue one generation request (``prompt``: 1-D token ids).
        Returns a DecodeStream; a full queue raises ServerOverloaded, a
        closed server ServerClosed, an over-budget prompt
        BucketOverflow."""
        if self._is_closed():
            raise ServerClosed("server is shutting down")
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        arr = np.asarray(prompt).reshape(-1).astype(np.int32)
        if arr.size == 0:
            raise ValueError("prompt must contain at least one token")
        mnt = int(max_new_tokens if max_new_tokens is not None
                  else self.default_max_new_tokens)
        if mnt < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # fail over-budget requests at submit time, uniformly
        next_bucket_strict(arr.size, self._prefill_buckets,
                           "prompt length")
        if arr.size + mnt > self.max_context:
            raise BucketOverflow(
                f"prompt ({arr.size}) + max_new_tokens ({mnt}) exceeds "
                f"max_context {self.max_context}")
        deadline_s = (float(deadline_ms) / 1e3 if deadline_ms is not None
                      else self._default_deadline_s)
        req = DecodeRequest(
            arr, mnt, eos_id if eos_id is not None else self.default_eos_id,
            None if deadline_s is None else time.monotonic() + deadline_s)
        # a request whose page budget exceeds the whole pool can never
        # be admitted — fail it here (synchronously) rather than letting
        # it wedge the admission queue head (reads only immutable
        # scheduler config, so no lock needed on the client thread)
        need = self._sched.admission_pages(req)
        if need > self._sched.usable_pages:
            raise BucketOverflow(
                f"request needs {need} KV pages under "
                f"{self._sched.admission!r} admission but the pool has "
                f"only {self._sched.usable_pages} usable pages — raise "
                "num_pages or lower max_new_tokens")
        # counted BEFORE put: drain()'s submitted==settled invariant
        self._metrics.inc("submitted")
        try:
            self._queue.put(req)
        except ServerOverloaded:
            self._metrics.inc("submitted", -1)
            self._metrics.inc("rejected_overload")
            raise
        except ServerClosed:
            self._metrics.inc("submitted", -1)
            raise
        return req.stream

    def generate(self, prompt, *, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous submit + wait; returns the generated token ids."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id).result(timeout)

    def warmup(self, *, decode: bool = True, prefill: bool = True) -> int:
        """Make the executable of every admissible step signature: all
        (batch bucket, page bucket) decode pairs and every prefill bucket
        at its own page bucket. On the card each is a captured CUDA
        graph, whose warm-up runs the step once on zero-filled inputs:
        page table rows of the scratch page, so the pools' pages stay
        as they were. Returns the number of new executables."""
        def specs(b, s, p):
            return [((b, s), np.int32), ((b,), np.int32),
                    ((b, p), np.int32), ((b,), np.int32)] + self._pools

        n = 0
        if decode:
            for bb in self._batch_buckets:
                for pb in self._page_buckets:
                    n += bool(self._exec.compile(specs(bb, 1, pb)))
        if prefill:
            for sb in self._prefill_buckets:
                pb = next_bucket_strict(pages_for(sb, self.page_len),
                                        self._page_buckets, "page count")
                n += bool(self._exec.compile(specs(1, sb, pb)))
        return n

    def stats(self) -> dict:
        """Metrics snapshot."""
        return self._metrics.snapshot()

    @property
    def metrics(self) -> DecodeMetrics:
        return self._metrics

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def cancel(self, stream: DecodeStream) -> bool:
        """Best-effort server-side cancel of one in-flight request,
        identified by its stream: the request's deadline is forced into
        the past, so the worker expires it at its next step (settling
        the stream as DeadlineExceeded, pages freed). Returns False when
        the stream is already settled or unknown."""
        # a request in transit between the queue pop and its slot
        # install is visible to neither scan — re-scan a few times so
        # the admission window (pure host bookkeeping, microseconds)
        # cannot orphan the stream
        for _ in range(3):
            if stream.done():
                return False
            if self._queue.expire_stream(stream):
                return True
            # slot entries flip atomically between None and a Slot (the
            # active_slots contract); forcing req.deadline from this
            # thread is a benign cross-thread store the worker re-reads
            # every step
            for slot in list(self._sched.slots):
                if slot is not None and slot.req.stream is stream:
                    slot.req.deadline = time.monotonic() - 1.0
                    return True
            time.sleep(0.002)
        return False

    def active_slots(self) -> int:
        """Running sequences right now (a cross-thread occupancy
        sample)."""
        return self._sched.active_count()

    def bucket_config(self) -> dict:
        """The (batch, prefill, page) bucket sets that bound this
        server's step signatures."""
        return {"batch_buckets": list(self._batch_buckets),
                "prefill_buckets": list(self._prefill_buckets),
                "page_buckets": list(self._page_buckets),
                "page_len": self.page_len,
                "max_context": self.max_context}

    def num_executables(self) -> int:
        return len(self._exec.signatures())

    # -- lifecycle ---------------------------------------------------------
    # drain/close/__enter__/__exit__/__del__ come from ServerLifecycleMixin
    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None):
        """Stop admitting; with ``drain`` finish all queued and running
        requests, otherwise abort them with ServerClosed. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.close()
        if drain:
            self.drain(timeout)
        else:
            self._abort = True
        self._stop.set()
        self._worker.join(timeout if timeout is not None else 30.0)
        if not drain:
            # requests the worker didn't get to (it exits after
            # aborting): settle anything left so result() never hangs
            for r in self._queue.flush():
                r.stream._fail(
                    ServerClosed("server shut down before execution"))
                self._metrics.inc("failed")

    # -- worker ------------------------------------------------------------
    def _step_loop(self):
        """The scheduler's step loop: admit -> grow/preempt -> one
        batched decode step -> emit, forever."""
        while True:
            if self._stop.is_set() and self._abort:
                self._abort_all()
                return
            self._expire_active()
            self._admit()
            active = self._sched.active()
            if not active:
                if self._stop.is_set() and self._queue.qsize() == 0:
                    return
                self._queue.wait_nonempty(self._poll_s)
                continue
            try:
                self._decode_step()
            except Exception as e:  # noqa: BLE001 — the worker must survive
                self._fail_active(
                    ServingError(f"decode step failed: {e!r}"))

    def _abort_all(self):
        exc = ServerClosed("server shut down before completion")
        for slot in self._sched.active():
            self._sched.release(slot)
            slot.req.stream._fail(exc)
            self._metrics.inc("failed")
        for r in self._queue.flush():
            r.stream._fail(exc)
            self._metrics.inc("failed")

    def _fail_active(self, exc: ServingError):
        for slot in self._sched.active():
            self._sched.release(slot)
            slot.req.stream._fail(exc)
            self._metrics.inc("failed")

    def _expire_active(self):
        now = time.monotonic()
        for slot in self._sched.active():
            if slot.req.expired(now):
                self._sched.release(slot)
                slot.req.stream._fail(DeadlineExceeded(
                    "deadline passed mid-generation "
                    f"({slot.req.generated} tokens in)"))
                self._metrics.inc("expired")

    def _admit(self):
        """Admit queued requests into free slots (FIFO, head-of-line:
        the first request that does not fit stops admission — a
        deterministic policy the occupancy metrics make visible)."""
        while True:
            req, dropped = self._queue.pop_ready()
            for r in dropped:
                r.stream._fail(DeadlineExceeded("deadline passed in queue"))
                self._metrics.inc("expired")
            if req is None:
                return
            try:
                slot = self._sched.try_admit(req)
            except (BucketOverflow, ServingError) as e:
                # a preemption-grown prompt can outgrow the prefill
                # buckets — settle it rather than wedging the queue head
                req.stream._fail(e)
                self._metrics.inc("failed")
                continue
            if slot is None:
                self._queue.put(req, front=True)
                return
            try:
                self._prefill(slot)
            except Exception as e:  # noqa: BLE001 — fail the request only
                self._sched.release(slot)
                req.stream._fail(
                    ServingError(f"prefill failed: {e!r}"))
                self._metrics.inc("failed")

    def _prefill(self, slot):
        req = slot.req
        eff = req.effective_prompt
        t0 = time.monotonic()
        self._metrics.observe("queue_wait_ms", (t0 - req.t_submit) * 1e3)
        sb = next_bucket_strict(len(eff), self._prefill_buckets,
                                "prompt length")
        tokens = np.zeros((1, sb), np.int32)
        tokens[0, :len(eff)] = eff
        pb = next_bucket_strict(len(slot.pages), self._page_buckets,
                                "page count")
        rows = page_table_array([slot.pages], pb)
        out = self._exec.run(
            [tokens, np.zeros((1,), np.int32), rows,
             np.asarray([len(eff) - 1], np.int32)], self._pools)
        # the sampled token IS the response payload this step exists to
        # produce (and the input of the next step): one [1] copy to host
        nxt = int(out[0].cpu()[0])
        slot.length = len(eff)
        self._metrics.inc("prefills")
        self._metrics.observe("prefill_ms",
                              (time.monotonic() - t0) * 1e3)
        self._emit(slot, nxt)

    def _decode_step(self):
        # growth first: every active slot must be able to write one row
        for slot in list(self._sched.active()):
            if self._sched.slots[slot.index] is not slot:
                continue      # preempted by an earlier slot's growth
            try:
                pages_before = len(slot.pages)
                for req in self._sched.ensure_capacity(slot):
                    self._metrics.inc("preemptions")
                    self._queue.put(req, front=True)
                grown = len(slot.pages) - pages_before
                if grown > 0:
                    self._metrics.inc("page_growths", grown)
            except PagesExhausted as e:
                # pool cannot hold even this one sequence: fail it
                self._sched.release(slot)
                slot.req.stream._fail(ServingError(
                    f"KV pool exhausted and nothing to preempt: {e}"))
                self._metrics.inc("failed")
        active = self._sched.active()
        if not active:
            return
        t0 = time.monotonic()
        bb, pb = self._sched.decode_shape()
        tokens = np.zeros((bb, 1), np.int32)
        positions = np.zeros((bb,), np.int32)
        rows_src = [[] for _ in range(bb)]
        for row, slot in enumerate(active):
            tokens[row, 0] = slot.last_token
            positions[row] = slot.length
            rows_src[row] = slot.pages
        rows = page_table_array(rows_src, pb)
        out = self._exec.run(
            [tokens, positions, rows, np.zeros((bb,), np.int32)],
            self._pools)
        # ONE batched copy of [B] sampled ids per decode step (clients
        # stream them; the host scheduler needs them for eos/length)
        nxt = out[0].cpu().numpy()
        alloc = self._sched.allocator
        self._metrics.inc("decode_steps")
        self._metrics.observe("decode_step_ms",
                              (time.monotonic() - t0) * 1e3)
        self._metrics.observe("batch_size", len(active))
        self._metrics.observe("slot_occupancy",
                              len(active) / self._sched.max_slots)
        self._metrics.observe("page_utilization",
                              alloc.used / max(1, alloc.num_pages - 1))
        for row, slot in enumerate(active):
            slot.length += 1
            self._emit(slot, int(nxt[row]))

    def _emit(self, slot, token: int):
        """Stream one sampled token and settle the sequence if it just
        finished (eos, generation budget, or context limit)."""
        req = slot.req
        now = time.monotonic()
        if req.generated == 0:
            self._metrics.observe("ttft_ms", (now - req.t_submit) * 1e3)
        elif slot.t_last_emit is not None:
            self._metrics.observe("inter_token_ms",
                                  (now - slot.t_last_emit) * 1e3)
        slot.t_last_emit = now
        slot.last_token = token       # input of the next decode step
        req.stream._put(token)
        self._metrics.inc("tokens_generated")
        reason = None
        if req.eos_id is not None and token == req.eos_id:
            reason = "eos"
        elif req.remaining_new <= 0:
            reason = "length"
        elif slot.length + 1 > self.max_context:
            # the next decode step would write past the context budget
            reason = "length"
        if reason is not None:
            self._sched.release(slot)
            self._metrics.inc("completed")
            self._metrics.observe("tokens_per_request", req.generated)
            req.stream._finish(reason)

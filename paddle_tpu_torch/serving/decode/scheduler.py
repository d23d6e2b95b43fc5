"""Continuous-batching scheduler: slots, admission, growth, preemption
(a copy of paddle_tpu/serving/decode/scheduler.py, which the port may
not import; request trace ids come back with profiler/tracing.py).

Pure host-side bookkeeping: the engine's single worker
thread calls into one ``Scheduler`` between decode steps, so sequences
join and leave the running batch at step granularity — a finished
8-token request never waits for a 512-token neighbor, which is where
continuous batching's tokens/s win over static batching comes from.

Lifecycle of one request::

            submit()                 admit()            each step
    client ---------> AdmissionQueue -------> Slot ----------------+
                          |  expired            | grow: +1 page     |
                          v                     | at page boundary  |
                    DeadlineExceeded            v                   v
                                       [pool empty: preempt     stream
                                        fewest-generated slot,  token
                                        fold generated tokens
                                        into its prompt, requeue]
            finish: eos / max_new_tokens / deadline -> free pages,
            settle stream, slot reusable next step

Admission policies: ``"worst_case"`` reserves every page a sequence
could ever need (prompt bucket + max_new_tokens) up front — admission
may wait, decode never preempts. ``"prefill"`` reserves only the prompt
bucket's pages — higher occupancy, and mid-decode growth can preempt
the cheapest (fewest generated tokens) slot, whose request re-enters
the queue with its generated tokens folded into the prompt (greedy
decode restarts bit-identically; already-streamed tokens are not
re-emitted).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..batcher import (DeadlineExceeded, ServerClosed, ServerOverloaded,
                       ServingError)
from ..bucketing import next_bucket_strict
from .kvcache import PageAllocator, PagesExhausted, pages_for

__all__ = ["DecodeStream", "DecodeRequest", "AdmissionQueue", "Slot",
           "Scheduler"]

_seq = itertools.count()


class DecodeStream:
    """Per-request token stream handed back by ``DecodeServer.submit``.

    Tokens arrive as the engine generates them; iteration yields each
    int token id and ends when the request finishes. ``result()`` waits
    for the terminal state and returns every generated token. Terminal
    failures (deadline, shutdown, execution error) raise from both."""

    def __init__(self):
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._done = False
        self._exc: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None   # "eos"|"length"|...

    # -- engine side -------------------------------------------------------
    def _put(self, token: int):
        with self._cond:
            self._tokens.append(int(token))
            self._cond.notify_all()

    def _finish(self, reason: str):
        with self._cond:
            if not self._done:
                self._done = True
                self.finish_reason = reason
                self._cond.notify_all()

    def _fail(self, exc: BaseException):
        with self._cond:
            if not self._done:
                self._done = True
                self._exc = exc
                self.finish_reason = "error"
                self._cond.notify_all()

    # -- client side -------------------------------------------------------
    def done(self) -> bool:
        with self._cond:
            return self._done

    def token_count(self) -> int:
        with self._cond:
            return len(self._tokens)

    def next_token(self, index: int, timeout: Optional[float] = None):
        """Token at ``index`` once available; None when the stream ended
        before producing it; raises the terminal exception on failure."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if index < len(self._tokens):
                    return self._tokens[index]
                if self._done:
                    if self._exc is not None:
                        raise self._exc
                    return None
                remaining = None if end is None else end - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise DeadlineExceeded(
                        f"no token {index} within {timeout}s")
                self._cond.wait(remaining if remaining is not None else 1.0)

    def __iter__(self):
        i = 0
        while True:
            t = self.next_token(i)
            if t is None:
                return
            yield t
            i += 1

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; all generated token ids."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._done:
                remaining = None if end is None else end - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise DeadlineExceeded(f"not finished within {timeout}s")
                self._cond.wait(remaining if remaining is not None else 1.0)
            if self._exc is not None:
                raise self._exc
            return np.asarray(self._tokens, dtype=np.int32)


class DecodeRequest:
    """One queued generation request. After a preemption the already
    generated tokens become part of the *effective* prompt, so a greedy
    re-prefill continues the sequence identically without re-emitting
    anything."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "deadline",
                 "stream", "t_submit", "seq", "trace_id")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 eos_id: Optional[int], deadline: Optional[float],
                 trace_id: Optional[str] = None):
        self.prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline = deadline          # absolute monotonic or None
        self.stream = DecodeStream()
        self.t_submit = time.monotonic()
        self.seq = next(_seq)
        # request-scoped flight-recorder id (stamped by the caller, or
        # minted by submit) — every lifecycle event carries it
        self.trace_id = trace_id

    @property
    def generated(self) -> int:
        # the engine worker is the only writer of stream._tokens and the
        # only caller here, so the unlocked read is single-threaded
        return len(self.stream._tokens)

    @property
    def effective_prompt(self) -> np.ndarray:
        if not self.stream._tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt,
             np.asarray(self.stream._tokens, dtype=np.int32)])

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - self.generated

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)


class AdmissionQueue:
    """Bounded FIFO with deadline-aware pop (the decode analog of
    ``batcher.RequestQueue`` — no signature grouping: every request
    flows through the same bucketed prefill)."""

    def __init__(self, max_depth: int):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._cond = threading.Condition()
        self._q: deque = deque()
        self._closed = False

    def qsize(self) -> int:
        with self._cond:
            return len(self._q)

    def put(self, req: DecodeRequest, front: bool = False):
        with self._cond:
            # front=True is the engine's OWN requeue (head-of-line
            # admission retry, preemption victim): the request was
            # accepted before any close(), so it is exempt from both the
            # closed check (drain must finish accepted work — rejecting
            # it would kill the worker mid-drain and hang shutdown) and
            # the depth bound (it was admitted once already)
            if self._closed and not front:
                raise ServerClosed("server is shutting down")
            if len(self._q) >= self.max_depth and not front:
                raise ServerOverloaded(
                    f"decode queue full ({len(self._q)}/{self.max_depth}); "
                    "retry with backoff")
            (self._q.appendleft if front else self._q.append)(req)
            self._cond.notify_all()

    def pop_ready(self, now: Optional[float] = None
                  ) -> Tuple[Optional[DecodeRequest], List[DecodeRequest]]:
        """(next request or None, expired requests skipped past)."""
        now = time.monotonic() if now is None else now
        expired: List[DecodeRequest] = []
        with self._cond:
            while self._q:
                r = self._q.popleft()
                if r.expired(now):
                    expired.append(r)
                else:
                    return r, expired
            return None, expired

    def peek(self) -> Optional[DecodeRequest]:
        with self._cond:
            return self._q[0] if self._q else None

    def expire_stream(self, stream) -> bool:
        """Force-expire the queued request owning ``stream`` (the
        transport-side cancel: the remote client abandoned it). It
        settles as DeadlineExceeded at the next pop."""
        with self._cond:
            for r in self._q:
                if r.stream is stream:
                    r.deadline = time.monotonic() - 1.0
                    return True
        return False

    def wait_nonempty(self, timeout: float) -> bool:
        with self._cond:
            if self._q:
                return True
            # graft-lint: disable=GL704 -- the predicate re-check IS the
            # return value: this is the bounded wait primitive, and every
            # caller loops on it (wait_nonempty -> pop_ready -> repeat)
            self._cond.wait(timeout)
            return bool(self._q)

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def flush(self) -> List[DecodeRequest]:
        with self._cond:
            out = list(self._q)
            self._q.clear()
            return out


class Slot:
    """One row of the decode batch: a running sequence's host state."""

    __slots__ = ("index", "req", "pages", "length", "last_token",
                 "reserved", "t_admitted", "t_last_emit")

    def __init__(self, index: int, req: DecodeRequest,
                 pages: List[int], reserved: int):
        self.index = index
        self.req = req
        self.pages = pages            # physical page ids, in order
        self.length = 0               # cached tokens (prompt + generated)
        self.last_token: int = 0      # feeds the next decode step
        self.reserved = reserved      # worst-case pages not yet allocated
        self.t_admitted = time.monotonic()
        self.t_last_emit: Optional[float] = None   # inter_token_ms anchor

    @property
    def generated(self) -> int:
        return self.req.generated


class Scheduler:
    """Slot table + page budget. Single-threaded by contract (the
    engine's worker); submit-side code never touches it."""

    def __init__(self, *, max_slots: int, allocator: PageAllocator,
                 page_len: int, max_context: int,
                 prefill_buckets: Sequence[int],
                 page_buckets: Sequence[int],
                 batch_buckets: Sequence[int],
                 admission: str = "worst_case"):
        if admission not in ("worst_case", "prefill"):
            raise ValueError(
                f"admission must be 'worst_case' or 'prefill', "
                f"got {admission!r}")
        self.max_slots = int(max_slots)
        self.allocator = allocator
        self.page_len = int(page_len)
        self.max_context = int(max_context)
        self.prefill_buckets = sorted(prefill_buckets)
        self.page_buckets = sorted(page_buckets)
        self.batch_buckets = sorted(batch_buckets)
        self.admission = admission
        self.slots: List[Optional[Slot]] = [None] * self.max_slots
        self._reserved_total = 0

    # -- derived -----------------------------------------------------------
    def active(self) -> List[Slot]:
        return [s for s in self.slots if s is not None]

    def active_count(self) -> int:
        """Occupancy sample safe to read from OUTSIDE the worker thread:
        one pass over the fixed-size slot list (entries flip atomically
        between None and a Slot), no shared mutable state touched."""
        return sum(1 for s in self.slots if s is not None)

    def _free_index(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def prefill_bucket(self, req: DecodeRequest) -> int:
        return next_bucket_strict(len(req.effective_prompt),
                                  self.prefill_buckets, "prompt length")

    def _worst_pages(self, req: DecodeRequest, prefill_len: int) -> int:
        final = min(max(prefill_len,
                        len(req.effective_prompt) + req.remaining_new),
                    self.max_context)
        return pages_for(final, self.page_len)

    @property
    def usable_pages(self) -> int:
        """Pages a single sequence could ever hold (page 0 is the
        reserved scratch row)."""
        return self.allocator.num_pages - 1

    def admission_pages(self, req: DecodeRequest) -> int:
        """Pages admission will budget for ``req`` under the current
        policy (worst case for ``"worst_case"``, prefill-only for
        ``"prefill"``). May raise BucketOverflow."""
        sb = self.prefill_bucket(req)
        if self.admission == "worst_case":
            return self._worst_pages(req, sb)
        return pages_for(sb, self.page_len)

    # -- admission ---------------------------------------------------------
    def try_admit(self, req: DecodeRequest) -> Optional[Slot]:
        """Place ``req`` in a free slot if the page budget allows;
        returns the Slot (prefill still to be run by the engine) or None
        when no slot/pages are available right now. Raises
        BucketOverflow for a prompt over every prefill bucket and
        PagesExhausted for one whose budget exceeds the whole pool (it
        could never be admitted: requeueing it would wedge the queue
        head forever)."""
        sb = self.prefill_bucket(req)   # may raise BucketOverflow
        need_now = pages_for(sb, self.page_len)
        worst = self._worst_pages(req, sb)
        need_budget = worst if self.admission == "worst_case" else need_now
        if need_budget > self.usable_pages:
            raise PagesExhausted(
                f"request needs {need_budget} pages under "
                f"{self.admission!r} admission but the pool only has "
                f"{self.usable_pages} usable pages")
        idx = self._free_index()
        if idx is None:
            return None
        budget = self.allocator.available() - self._reserved_total
        if budget < need_budget:
            return None
        pages = self.allocator.alloc(need_now)
        reserved = (worst - need_now) if self.admission == "worst_case" \
            else 0
        self._reserved_total += reserved
        slot = Slot(idx, req, pages, reserved)
        self.slots[idx] = slot
        return slot

    # -- growth / preemption ----------------------------------------------
    def ensure_capacity(self, slot: Slot) -> List[DecodeRequest]:
        """Make sure ``slot`` can write one more cache row; returns the
        requests preempted to free pages (already requeued by the
        caller's queue via the returned list)."""
        preempted: List[DecodeRequest] = []
        while slot.length >= len(slot.pages) * self.page_len:
            if len(slot.pages) >= max(self.page_buckets):
                raise ServingError(
                    f"sequence needs page {len(slot.pages) + 1} > largest "
                    f"page bucket {max(self.page_buckets)}")
            try:
                slot.pages += self.allocator.alloc(1)
                if slot.reserved > 0:
                    slot.reserved -= 1
                    self._reserved_total -= 1
            except PagesExhausted:
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    raise
                preempted.append(self.preempt(victim))
        return preempted

    def _pick_victim(self, exclude: Slot) -> Optional[Slot]:
        cands = [s for s in self.active() if s is not exclude]
        if not cands:
            return None
        # fewest generated tokens = least sunk decode work to redo
        return min(cands, key=lambda s: (s.generated, -s.t_admitted))

    def preempt(self, slot: Slot) -> DecodeRequest:
        """Evict a RUNNING sequence; its generated tokens live in the
        stream, so ``effective_prompt`` already covers them when the
        request re-enters the queue."""
        req = slot.req
        self.release(slot)
        return req

    def release(self, slot: Slot):
        """Free a slot's pages and reservation; stream settling is the
        engine's job (it owns metrics)."""
        self.allocator.free(slot.pages)
        slot.pages = []
        self._reserved_total -= slot.reserved
        slot.reserved = 0
        self.slots[slot.index] = None

    # -- step shaping ------------------------------------------------------
    def decode_shape(self) -> Tuple[int, int]:
        """(batch bucket, page bucket) for the current active set."""
        act = self.active()
        bb = next_bucket_strict(len(act), self.batch_buckets,
                                "active slot count")
        pb = next_bucket_strict(max(len(s.pages) for s in act),
                                self.page_buckets, "per-slot page count")
        return bb, pb

"""Shared server lifecycle: drain / close / context manager / __del__
(counterpart of paddle_tpu/serving/lifecycle.py; ``drain`` records the
``serving::drain`` span in the flight recorder).

``DecodeServer`` (and, once ported, ``Server`` and ``Router``) settle
every accepted request into exactly one of completed / expired /
failed, so the drain invariant (settled == submitted), the
close-idempotence entry points, and the GC-time worker reclaim are
identical — this mixin keeps them in ONE place. Hosts provide ``self._lock`` guarding ``self._closed``, a
``self._metrics`` MetricsBase, and an idempotent
``shutdown(drain=..., timeout=...)``.

Interpreter-shutdown contract: ``__del__`` may run while the host is
half-constructed (``__init__`` raised before ``_lock`` existed), after
an explicit ``close()``, or during interpreter teardown when module
globals are already None. It must never raise from any of those, and a
``__del__`` after ``close()`` must not double-release the host's
profiler-registry entry — closedness is re-checked through ``getattr``
so a missing attribute reads as "already closed", and every teardown
path is wrapped (``BaseException``: teardown can surface oddities like
``SystemExit`` from daemon-thread machinery that an ``Exception`` net
would miss).
"""
from __future__ import annotations

import time
from typing import Optional

from ..profiler import tracing

__all__ = ["ServerLifecycleMixin"]


class ServerLifecycleMixin:
    """Drain/close/context-manager/__del__ shared by the serving hosts."""

    def _is_closed(self) -> bool:
        # getattr, not attribute access: a host whose __init__ raised
        # before _lock/_closed were bound is "closed" (nothing to
        # release), and __del__ must see that instead of raising
        lock = getattr(self, "_lock", None)
        if lock is None:
            return True
        with lock:
            return getattr(self, "_closed", True)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted request has settled (completed,
        expired, or failed) — does not close the server. Returns False
        on timeout."""
        m = getattr(self, "_metrics", None)
        if m is None:       # half-constructed host: nothing in flight
            return True
        end = None if timeout is None else time.monotonic() + timeout
        with tracing.trace_span("serving::drain", cat="serving",
                                host=getattr(self, "name", None)):
            while (m["completed"] + m["expired"] + m["failed"]
                   < m["submitted"]):
                if end is not None and time.monotonic() > end:
                    return False
                time.sleep(0.002)
        return True

    def close(self):
        """Drain and shut down. Idempotent: a second close(), or a
        later __del__, is a no-op."""
        self.shutdown(drain=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    def __del__(self):  # best-effort: never leak the worker thread
        try:
            if not self._is_closed():
                self.shutdown(drain=False, timeout=1.0)
        except BaseException:   # noqa: BLE001 — interpreter teardown:
            pass                # modules/attrs may already be gone

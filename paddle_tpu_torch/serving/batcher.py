"""Serving error types (the exception classes of
paddle_tpu/serving/batcher.py; its batch server is not ported yet)."""
from __future__ import annotations

__all__ = ["ServingError", "ServerOverloaded", "DeadlineExceeded",
           "ServerClosed"]


class ServingError(RuntimeError):
    """Base class for serving-path failures."""


class ServerOverloaded(ServingError):
    """Typed rejection: the bounded request queue is full. Callers should
    back off and retry; the server sheds load instead of queueing
    unboundedly."""


class DeadlineExceeded(ServingError, TimeoutError):
    """The request's deadline passed before a result was produced."""


class ServerClosed(ServingError):
    """submit() after shutdown began (or the request was aborted by a
    non-draining shutdown)."""

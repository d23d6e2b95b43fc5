"""Device selection and the device API for the PyTorch port (counterpart
of paddle_tpu/device.py).

Every entry point takes an explicit ``device`` and runs on ``cuda``
unless the caller asks for something else (the CPU tests pass
``device="cpu"``). ``set_device`` changes what ``device=None`` means for
the whole process. Nothing here probes for a GPU and quietly moves to
the CPU: a CUDA call on a machine without a card fails where it is made.

Where the reference's ``Event`` and ``Stream`` are stubs timed on
``perf_counter`` (XLA owns its scheduling), the port's are CUDA's own:
``Event`` is a ``torch.cuda.Event`` and ``Stream`` a
``torch.cuda.Stream``. ``memory_stats`` reads the caching allocator
(``torch.cuda.memory_stats``) under the reference's keys. Device names
take Paddle's spelling (``"gpu"``, ``"gpu:1"``) beside PyTorch's
(``"cuda:1"``); ``get_device`` answers in Paddle's.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "get_all_devices",
           "get_device", "set_device", "get_device_count", "device_count",
           "is_compiled_with_cuda", "memory_stats", "cuda",
           "get_cudnn_version", "XPUPlace", "IPUPlace", "is_compiled_with_xpu",
           "is_compiled_with_ipu", "is_compiled_with_cinn",
           "is_compiled_with_rocm", "is_compiled_with_distribute",
           "is_compiled_with_custom_device", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device", "Event", "Stream",
           "current_stream", "set_stream", "stream_guard", "synchronize"]

DEFAULT_DEVICE = "cuda"
_current: list = [None]         # set_device's choice; None: DEFAULT_DEVICE


def _torch_device(device) -> torch.device:
    """A ``torch.device`` from a torch device, a torch name, Paddle's name
    (``"gpu"``, ``"gpu:N"``) or a card index."""
    if isinstance(device, torch.device):
        return device
    if isinstance(device, int):
        return torch.device("cuda", device)
    name = str(device)
    if name == "gpu" or name.startswith("gpu:"):
        name = "cuda" + name[3:]
    return torch.device(name)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the device
    ``set_device`` chose, ``cuda`` unless it was called."""
    if device is None:
        device = _current[0] if _current[0] is not None else DEFAULT_DEVICE
    return _torch_device(device)


def set_device(device: Union[str, int, torch.device]):
    """Make ``device`` what ``device=None`` means from now on, for every
    entry point of the process (parity: paddle.device.set_device).
    Returns it as a ``torch.device``."""
    _current[0] = _torch_device(device)
    return _current[0]


def _paddle_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"gpu:{dev.index or 0}"
    return dev.type if dev.index is None else f"{dev.type}:{dev.index}"


def get_device() -> str:
    """The current device in Paddle's spelling (``"gpu:0"``, ``"cpu"``)."""
    return _paddle_name(resolve_device(None))


def get_device_count() -> int:
    return torch.cuda.device_count()


def device_count() -> int:
    return torch.cuda.device_count()


def get_all_devices() -> list:
    """Every CUDA device, as ``"gpu:N"``."""
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_device() -> list:
    """The devices entry points can run on besides the CPU: the cards."""
    return get_all_devices()


def get_all_device_type() -> list:
    """(parity: paddle.device.get_all_device_type)"""
    return ["cpu"] + (["gpu"] if torch.cuda.device_count() else [])


def get_all_custom_device_type() -> list:
    return []


def get_available_custom_device() -> list:
    return []


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return torch.distributed.is_available()


def is_compiled_with_custom_device(device_type="gpu") -> bool:
    del device_type
    return False


def get_cudnn_version():
    """(parity: paddle.device.get_cudnn_version) None without cuDNN."""
    return torch.backends.cudnn.version()


class XPUPlace:
    """(parity stub: paddle.device.XPUPlace; no XPU backend)"""

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"Place(xpu:{self.device_id})"


class IPUPlace:
    """(parity stub: paddle.device.IPUPlace)"""

    def __repr__(self):
        return "Place(ipu)"


def _card(device) -> torch.device:
    """``device`` (None: the current one) as a CUDA device; a CPU device
    raises: the call names a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"{dev} is not a CUDA device")
    if not torch.cuda.is_available():
        # torch's allocator queries answer 0 without a card; the port's
        # fail where they are made
        raise RuntimeError(f"{dev}: this machine has no CUDA device")
    return dev


def memory_stats(device=None) -> dict:
    """The caching allocator's statistics under the reference's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (allocated bytes, now and
    at their peak since the last ``reset_peak_memory_stats``),
    ``bytes_limit`` (the card's memory) and ``num_allocs`` (allocations
    made). ``{}`` for a CPU device: the caller asked for the CPU."""
    if resolve_device(device).type == "cpu":
        return {}
    dev = _card(device)
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
            "num_allocs": s.get("allocation.all.allocated", 0)}


class cuda:
    """Namespace parity: paddle.device.cuda.*, over ``torch.cuda``."""

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def max_memory_allocated(device=None):
        return torch.cuda.max_memory_allocated(_card(device))

    @staticmethod
    def memory_allocated(device=None):
        return torch.cuda.memory_allocated(_card(device))

    @staticmethod
    def max_memory_reserved(device=None):
        return torch.cuda.max_memory_reserved(_card(device))

    @staticmethod
    def memory_reserved(device=None):
        return torch.cuda.memory_reserved(_card(device))

    @staticmethod
    def empty_cache():
        torch.cuda.empty_cache()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)


class Event(torch.cuda.Event):
    """A CUDA event (parity: paddle.device.Event): ``record(stream)``,
    ``query()``, ``synchronize()`` and ``elapsed_time(end)`` in ms (with
    ``enable_timing``). ``device`` is accepted for the reference's
    signature; an event belongs to the stream it is recorded on."""

    def __new__(cls, device=None, enable_timing=False, blocking=False,
                interprocess=False):
        del device
        return super().__new__(cls, enable_timing=enable_timing,
                               blocking=blocking, interprocess=interprocess)


class Stream(torch.cuda.Stream):
    """A CUDA stream on ``device`` (default: the current device) (parity:
    paddle.device.Stream). Paddle's ``priority`` 1 is high and 2 normal;
    they map to CUDA's -1 and 0."""

    def __new__(cls, device=None, priority=2):
        if priority not in (1, 2):
            raise ValueError(f"priority must be 1 (high) or 2 (normal), got "
                             f"{priority}")
        return super().__new__(cls, device=_card(device),
                               priority=-1 if priority == 1 else 0)



def current_stream(device=None) -> torch.cuda.Stream:
    return torch.cuda.current_stream(_card(device))


def set_stream(stream: torch.cuda.Stream) -> torch.cuda.Stream:
    """Make ``stream`` current on its device; returns the stream it
    replaced."""
    prev = torch.cuda.current_stream(stream.device)
    torch.cuda.set_stream(stream)
    return prev


def stream_guard(stream: Optional[torch.cuda.Stream]):
    """Context manager: ``stream`` is current inside (parity:
    paddle.device.stream_guard); None changes nothing."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def synchronize(device=None) -> None:
    """Wait for the card's queued work (parity: paddle.device.synchronize);
    on a CPU device there is nothing queued."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

"""Device selection for the PyTorch port.

Every entry point takes an explicit ``device`` and runs on ``cuda``
unless the caller asks for something else (the CPU tests pass
``device="cpu"``). Nothing here probes for a GPU and quietly moves to
the CPU: a CUDA call on a machine without a card fails where it is made.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``."""
    return torch.device(DEFAULT_DEVICE if device is None else device)

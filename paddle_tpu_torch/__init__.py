"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The package keeps paddle_tpu's module layout and parameter names, so a
reader finds each counterpart at the same path. Plain tensor code is
PyTorch; each Pallas TPU kernel on a ported path becomes a hand-written
CUDA kernel under ``ops/kernels/csrc/``, built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.py``). Importing the package builds nothing and touches no
GPU.
"""
from __future__ import annotations

from .core.flags import get_flags, set_flags
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device", "get_flags", "set_flags"]

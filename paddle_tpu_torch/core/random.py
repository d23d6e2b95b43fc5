"""Random streams for the port: explicit ``torch.Generator``s.

paddle_tpu threads one stateful key stream (``core/random.py``
``Generator.next_key``) through initialisers and samplers. Here each
consumer is handed its own ``torch.Generator`` instead: the model's
initialiser and the decode server's temperature sampler each take one,
so no module-level state couples two callers. A generator lives on the
device of the tensors it fills (CUDA generators cannot fill CPU tensors
and the reverse).

The two frameworks draw different numbers from the same seed, so tests
never match weights through the RNG: they make inputs with numpy and
carry weights across with ``models.convert``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device

__all__ = ["DEFAULT_SEED", "make_generator"]

DEFAULT_SEED = 0


def make_generator(seed: int = DEFAULT_SEED,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.Generator:
    """A fresh generator on ``device`` (default ``cuda``) seeded with
    ``seed``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))

"""Fleet (counterpart of paddle_tpu/distributed/fleet); only
``recompute`` is ported."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]

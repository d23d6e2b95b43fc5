"""Activation recomputation (counterpart of
paddle_tpu/distributed/fleet/recompute/__init__.py).

``recompute(function, *args)`` runs ``function`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps only the segment's inputs (and, by ``policy``, some outputs), and
the backward replays the segment to rebuild what it needs.

Policies are the reference's ``_POLICIES`` table:

- ``None``, ``"full"``, ``"nothing_saveable"``: replay the whole
  segment.
- ``"dots_saveable"`` (alias ``"selective"``): keep every matmul output
  (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``) and replay the rest.
- ``"dots_with_no_batch_dims_saveable"``: keep ``mm`` and ``addmm``
  outputs only.
- ``"everything_saveable"``: keep every output (nothing is replayed).

A callable is taken as a selective-checkpoint policy
``fn(ctx, op, *args, **kwargs) -> CheckpointPolicy``. The hand-written
kernels run inside ``torch.autograd.Function``s whose launches no
policy sees, so they are replayed, as the reference replays its
``pallas_call`` under ``dots_saveable``.

The RNG replay contract: a replayed segment draws the same dropout masks
as its forward did. The port's dropout draws from explicit
``torch.Generator``s, which ``checkpoint``'s ``preserve_rng_state`` does
not cover (it restores only the default generators), so ``recompute``
snapshots every generator the segment draws from before the forward
(the ``_generator`` of each module in ``function`` and in the tensor
arguments, and any given as ``generators=``), restores them for the
replay, and puts back the states they had reached afterwards.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["recompute", "recompute_sequential"]

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default)
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)

_POLICIES = {
    None: None, "full": None, "nothing_saveable": None,
    "dots_saveable": "dots_saveable",
    "selective": "dots_saveable",
    "dots_with_no_batch_dims_saveable": "dots_with_no_batch_dims_saveable",
    "everything_saveable": "everything_saveable",
}


def _saving(ops: Optional[Sequence]):
    """A selective-checkpoint policy keeping the outputs of ``ops``
    (every op's with None) and replaying the rest."""
    kept = None if ops is None else frozenset(ops)

    def policy(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        if kept is None or op in kept:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


_SAC = {"dots_saveable": _saving(_DOTS),
        "dots_with_no_batch_dims_saveable": _saving(_DOTS_NO_BATCH),
        "everything_saveable": _saving(None)}


def _resolve_policy(policy):
    """None (replay everything) or a selective-checkpoint policy
    function; an unknown name raises ``ValueError``."""
    if callable(policy):
        return policy
    if policy not in _POLICIES:
        raise ValueError(
            f"unknown recompute policy {policy!r}; one of "
            f"{sorted(k for k in _POLICIES if isinstance(k, str))}")
    name = _POLICIES[policy]
    return _SAC[name] if name else None


def _module_generators(objs: Iterable) -> List[torch.Generator]:
    """The distinct ``_generator``s of every module in ``objs`` (a bound
    method stands for its module)."""
    found = {}
    for o in objs:
        o = getattr(o, "__self__", o)
        if isinstance(o, nn.Module):
            for m in o.modules():
                g = getattr(m, "_generator", None)
                if isinstance(g, torch.Generator):
                    found[id(g)] = g
    return list(found.values())


class _GeneratorReplay:
    """Around a replay (and ``inner``, a context entered inside it): set
    ``generators`` to the states they had when this was made, before the
    forward, then back to the states they had reached."""

    def __init__(self, generators: List[torch.Generator], inner=None):
        self._gens = generators
        self._before = [g.get_state() for g in generators]
        self._reached = None
        self._inner = inner or contextlib.nullcontext()

    def __enter__(self):
        self._reached = [g.get_state() for g in self._gens]
        for g, s in zip(self._gens, self._before):
            g.set_state(s)
        self._inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self._inner.__exit__(*exc)
        finally:
            for g, s in zip(self._gens, self._reached):
                g.set_state(s)


def recompute(function, *args, policy=None, preserve_rng_state: bool = True,
              generators: Optional[Sequence[torch.Generator]] = None,
              use_reentrant=None, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (paddle's ``fleet.utils.recompute``). ``policy`` picks what
    the forward keeps (module docstring). With ``preserve_rng_state``
    the replay draws what the forward drew, from the default generators
    and from the explicit ones: the modules' own and ``generators``.
    ``use_reentrant`` is accepted and ignored (one behaviour, as in the
    reference). Without grad mode the call just runs."""
    del use_reentrant
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    sac = _resolve_policy(policy)
    gens = []
    if preserve_rng_state:
        gens = _module_generators([function, *args])
        for g in generators or ():
            if all(g is not h for h in gens):
                gens.append(g)

    fwd, rec = (create_selective_checkpoint_contexts(sac) if sac
                else (contextlib.nullcontext(), None))
    replay = _GeneratorReplay(gens, rec)    # the states before the forward

    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=lambda: (fwd, replay), **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a sequence of layers in ``ctx["segments"]`` segments
    (default 1), each through ``recompute`` with the keyword arguments
    given (``policy``, ``preserve_rng_state``)."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(len(layers) // segments, 1)
    out = args[0]
    for i in range(0, len(layers), per):
        chunk = layers[i:i + per]

        def seg(x, _chunk=chunk):
            for layer in _chunk:
                x = layer(x)
            return x
        out = recompute(seg, out, generators=_module_generators(chunk),
                        **kwargs)
    return out

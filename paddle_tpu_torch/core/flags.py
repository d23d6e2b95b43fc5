"""Runtime flag registry (counterpart of paddle_tpu/core/flags.py).

The reference's exported-flag system: each flag starts from its
``FLAGS_<name>`` environment variable when set, else its default, and
can be changed at run time with ``set_flags``. Only the flags the port
reads are defined here, under the reference's names and defaults.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "get_flag"]

_REGISTRY: Dict[str, Any] = {}


def _env_cast(raw: str, default):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default, help_str: str = "") -> None:
    """Register ``name`` with ``default`` (overridden by ``FLAGS_<name>``
    in the environment)."""
    del help_str
    env = os.environ.get("FLAGS_" + name)
    _REGISTRY[name] = _env_cast(env, default) if env is not None else default


def _key(k: str) -> str:
    return k[6:] if k.startswith("FLAGS_") else k


def set_flags(flags: Dict[str, Any]) -> None:
    """Set each ``{name or FLAGS_name: value}``; an unknown name raises
    ``KeyError`` and nothing is set unless every entry is valid."""
    staged = {}
    for k, v in flags.items():
        kk = _key(k)
        if kk not in _REGISTRY:
            raise KeyError(f"flag {kk!r} is not defined")
        staged[kk] = v
    _REGISTRY.update(staged)


def get_flags(flags) -> Dict[str, Any]:
    """``{name: value}`` for a name or a list of names, keyed as given."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        kk = _key(k)
        if kk not in _REGISTRY:
            raise KeyError(f"flag {kk!r} is not defined")
        out[k] = _REGISTRY[kk]
    return out


def get_flag(name: str):
    return _REGISTRY[name]


define_flag("check_index_bounds", False,
            "eager range-check of embedding indices (one host sync per "
            "call); off, out-of-range ids clamp to [0, V)")
define_flag("use_fused_optimizer", True,
            "Adam/AdamW step as multi-tensor (torch._foreach_*) updates, one "
            "per group of parameters sharing device, dtype, weight decay "
            "and step count; off, one update per parameter")

"""Build and bind the hand-written CUDA kernels (counterpart of
``paddle_tpu/ops/pallas/common.py``).

Each ``csrc/<name>.cu`` is compiled on its own, at first use, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``; ``BUILD_LOGS[name]`` keeps what the compiler
printed (ptxas's registers, spills and warnings per kernel). The sources
export plain C functions: every pointer and the CUDA stream cross as
``ctypes.c_void_p`` (a bare Python int would be cut to 32 bits), and each
launch returns the ``cudaGetLastError()`` code, which ``check`` turns
into an exception.
No PyTorch header is compiled, so a build takes seconds, not minutes.

The library name carries a hash of the sources, so an edited kernel is
never served from a stale build. Nothing happens at import time: the CPU
path never needs ``nvcc``. ``build_all`` starts one ``nvcc`` per source
at once, for callers that want every kernel ready up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "BUILD_LOGS", "KernelBuildError",
           "KernelLaunchError", "DTYPE_CODES", "sources", "nvcc_path",
           "nvcc_command", "library_path", "load", "build_all", "check",
           "ptr", "stream", "dispatch"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# <repo>/build/kernels (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the flash entries' scalars (B, Sq, Sk, Hq, Hk, D, scale, causal,
# dropout_on, threshold, keep_scale, seed) and mask arguments (bias, its
# strides over B, H, Sq, Sk, q / k segment words, seg_causal)
_FLASH_SCALARS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p]
_FLASH_MASK = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
               + [ctypes.c_void_p] * 2 + [ctypes.c_int])

# C signature of every exported entry point, per source
_SIGNATURES: Dict[str, Dict[str, Tuple[list, object]]] = {
    "rms_norm": {
        # (x, w or NULL, y, inv, rows, n, eps, x_dtype, w_dtype, stream)
        "rms_norm_fwd": ([ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                         ctypes.c_int),
        # (rows, pdl, stream): an empty kernel, the launch's floor
        "rms_norm_floor": ([ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p], ctypes.c_int),
        "ptk_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "layer_norm": {
        # (x, w or NULL, b or NULL, y, mu, rstd, rows, n, eps, x_dtype,
        #  w_dtype, stream)
        "layer_norm_fwd": ([ctypes.c_void_p] * 6
                           + [ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p], ctypes.c_int),
        "ptk_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "cross_entropy": {
        # (x, labels int64, loss, lse, rows, v, x_dtype, stream)
        "softmax_xent_fwd": ([ctypes.c_void_p] * 4
                             + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
        # (x, labels int64, lse, g, dx, rows, v, x_dtype, stream)
        "softmax_xent_bwd": ([ctypes.c_void_p] * 5
                             + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
        "ptk_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "flash_attention": {
        # (tensors..., B, Sq, Sk, Hq, Hk, D, scale, causal, dropout_on,
        #  threshold, keep_scale, seed or NULL, bias or NULL, its four
        #  element strides, q / k segment words or NULL, seg_causal,
        #  [dq: dbias or NULL], dtype, stream)
        **{fn: ([ctypes.c_void_p] * n + _FLASH_SCALARS + _FLASH_MASK
                + [ctypes.c_void_p] * (fn == "flash_dq")
                + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
           for fn, n in (("flash_fwd", 5), ("flash_dq", 7),
                         ("flash_dkv", 8))},
        "ptk_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "flash_attention_sm90": {
        # bf16 only: as "flash_attention" without the dtype code; each
        # also takes the bias class (1 "keys", 0 "plane") before the stream
        **{fn: ([ctypes.c_void_p] * n + _FLASH_SCALARS + _FLASH_MASK
                + [ctypes.c_void_p] * (fn == "flash_dq_sm90")
                + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
           for fn, n in (("flash_fwd_sm90", 5), ("flash_dq_sm90", 7),
                         ("flash_dkv_sm90", 8))},
        "ptk_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}

# dtype codes shared with csrc/common.cuh (ptk::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of each source built by this process
BUILD_LOGS: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    (final path, temp path, process) or None when already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(name: str, started) -> None:
    lib, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{out}")
    os.replace(tmp, lib)      # atomic: a concurrent loader sees all or none
    BUILD_LOGS[name] = out


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def build_all(names: Sequence[str] = ()) -> List[str]:
    """Build (in parallel) and bind every named kernel source, default
    all of them. Returns the names that had to be compiled."""
    names = list(names) or sources()
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = {n: _start(n) for n in todo}
        try:
            for n, s in started.items():
                if s is not None:
                    _finish(n, s)
        finally:
            for s in started.values():
                if s is not None and s[2].poll() is None:
                    s[2].kill()
                    s[2].wait()
        for n in todo:
            _libs[n] = _bind(n)
    return [n for n, s in started.items() if s is not None]


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise ``KernelLaunchError`` for a non-zero CUDA error code."""
    if rc != 0:
        msg = lib.ptk_error_string(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    """A tensor's device address for a C entry (None stays NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s card, for a C entry."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dispatch(plain, launch, x: torch.Tensor, *args):
    """``plain(x, *args)`` for a CPU tensor; ``launch(x, *args)`` with
    ``x``'s card current for a CUDA tensor. Nothing falls back from one
    to the other; any other device raises."""
    if x.device.type == "cpu":
        return plain(x, *args)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.device.index == torch.cuda.current_device():
        return launch(x, *args)
    with torch.cuda.device(x.device):
        return launch(x, *args)

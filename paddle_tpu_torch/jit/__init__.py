"""The compiled-step layer as CUDA graphs (counterpart of
paddle_tpu/jit/__init__.py).

paddle_tpu runs a no-grad call as one XLA program per input signature
(``jax.jit``), and ``compile_for`` builds such a program ahead of time.
The port records the same call as one CUDA graph per (shape, dtype)
signature and replays it: every kernel of the call, cuBLAS's, PyTorch's
and the port's own, leaves in one ``cudaGraphLaunch`` instead of one
Python op at a time. On CPU tensors every call runs eagerly: the CPU has
no graphs, and that is the device rule, not a fallback.

What a capture (``Graphs.capture``) keeps to:

- Warm-up first. A signature's first capture follows one eager run on
  the capture stream, so that what the libraries set up lazily (cuBLAS
  handles and workspaces, lazily loaded kernels, the port's kernel
  libraries) is set up outside the capture. ``StaticFunction`` runs it
  on zero-filled inputs and puts the layer's buffers and the generators
  back as they were (parameters are not written under no-grad); a train
  step's warm-up is the step the caller asked for
  (``models/trainer.py``).
- ``capture_error_mode="thread_local"``: CUDA calls of other threads (a
  server's clients) cannot break a capture.
- One memory pool (``torch.cuda.graph_pool_handle()``) for all graphs of
  one owner (one ``StaticFunction``, one train step). One capture stream
  per device for the whole process, on which every owner warms up and
  captures, one at a time: cuBLAS keeps a workspace for each stream it
  ran on (and each thread) for the life of the process, which a stream
  of each owner's own would leave behind with every owner dropped.
- Weight updates between calls are picked up. An update in place is
  read by the graph at the address it was captured against. A rebinding
  (``p.data = t``, ``write_back``, ``load_state_dict(assign=True)``)
  moves the address: each graph keeps the addresses of the tensors it
  reads in place (``watch``) and is captured again, counted as a
  compile, before a call that finds one moved. It never replays against
  an old address.
- An explicit ``torch.Generator`` the warm-up drew from is registered
  with the graph (``CUDAGraph.register_generator_state``), so that each
  replay draws what the eager call would have drawn; where the installed
  PyTorch lacks that call, such a capture raises. PyTorch registers its
  default generators itself.
- Kernel launches. A port kernel's wrapper adds one to its count when
  its Python runs, which under capture records the launch and does not
  make it: the counts a capture added are taken back and added again at
  every replay (``ops.kernels.launch_counters``).
- No fallback: a capture that fails raises ``CaptureError``; nothing
  runs the call eagerly on the card instead.

``save``, ``load`` and ``TranslatedLayer`` are not ported yet.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

__all__ = ["InputSpec", "StaticFunction", "Graphs", "CaptureError",
           "to_static", "not_to_static", "ignore_module", "set_code_level",
           "set_verbosity", "enable_to_static", "is_capturing",
           "captures_on", "signature"]

_local = threading.local()
_capture_lock = threading.RLock()   # one warm-up or capture at a time
_streams: dict = {}                 # the capture stream of each device


class CaptureError(RuntimeError):
    """A capture failed; the call did not run."""


def is_capturing() -> bool:
    """True while this thread captures a CUDA graph (through this module
    or on the current stream)."""
    if getattr(_local, "capturing", False):
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def captures_on(device: torch.device) -> bool:
    """The device rule: calls on the card are captured, calls on the CPU
    run eagerly."""
    return device.type == "cuda"


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"float32"``,
    ``"bfloat16"``) or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


class InputSpec:
    """Parity: paddle.static.InputSpec(shape, dtype, name), the dtype
    read as a torch dtype. A ``None`` (or negative) dim is accepted, but a
    capture needs every dim."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name=None):
        self.shape = list(shape)
        self.dtype = _torch_dtype(dtype)
        self.name = name

    def concrete(self) -> tuple:
        if any(d is None or d < 0 for d in self.shape):
            raise ValueError(
                f"InputSpec {self.name or ''} has dynamic dims "
                f"{self.shape}: a capture needs concrete shapes")
        return tuple(int(d) for d in self.shape)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _spec(a) -> tuple:
    """(shape, torch dtype) of an InputSpec, a tensor, a numpy array or a
    (shape, dtype) pair."""
    if isinstance(a, InputSpec):
        return a.concrete(), a.dtype
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype
    if isinstance(a, np.ndarray):
        return tuple(a.shape), _torch_dtype(a.dtype)
    if isinstance(a, tuple) and len(a) == 2:
        shape, dtype = a
        return tuple(int(d) for d in shape), _torch_dtype(dtype)
    raise TypeError(f"cannot read a shape and dtype from {type(a).__name__}")


def signature(args) -> tuple:
    """The key of a call's graph: each argument's (shape, dtype)."""
    return tuple(_spec(a) for a in args)


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return torch.as_tensor(a)


def _module_generators(module: Optional[nn.Module]) -> list:
    """The distinct ``_generator``s of ``module``'s submodules."""
    if module is None:
        return []
    from ..distributed.fleet.recompute import _module_generators as found
    return found([module])


def _launch_counters() -> dict:
    from ..ops.kernels import launch_counters
    return launch_counters()


class _Graph:
    """One captured signature: the graph, its static inputs and outputs,
    the kernel launches it makes, the addresses it was captured against
    and the host-side counts each replay advances."""

    def __init__(self, graph, inputs, outputs, launched, addresses, host):
        self.graph = graph
        self.inputs = list(inputs)
        self.outputs = outputs
        self.launched = launched            # [(counter, launches)]
        self.addresses = addresses
        self.host = host                    # (add, delta) or None

    def replay(self) -> None:
        self.graph.replay()
        for counter, n in self.launched:
            counter.launches += n
        if self.host is not None:
            add, delta = self.host
            add(delta)

    def run(self, args):
        """Copy ``args`` into the static inputs (an argument that is its
        static input itself is not copied), replay, and return the
        outputs: a static input comes back as itself, every other output
        as a clone, which a later replay cannot overwrite."""
        for buf, a in zip(self.inputs, args):
            if a is not buf:
                buf.copy_(_as_tensor(a))
        self.replay()
        return _map_outputs(self.outputs, self.inputs, torch.Tensor.clone)


def _map_outputs(out, keep, fn):
    def one(t):
        if not isinstance(t, torch.Tensor) or any(t is k for k in keep):
            return t
        return fn(t)
    if isinstance(out, (tuple, list)):
        return tuple(one(t) for t in out)
    return one(out)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The process's capture stream on ``device`` (module docstring)."""
    key = (device.type, device.index)
    with _capture_lock:
        if key not in _streams:
            _streams[key] = torch.cuda.Stream(device)
        return _streams[key]


class Graphs:
    """What all graphs of one owner share: the memory pool, the
    generators the graphs may draw from, the tensors they read in place
    (``watch()``, checked for rebinding) and ``compile_count``, the
    captures made. The owner serialises its captures and replays; warm-ups
    and captures of all owners take turns on the device's capture
    stream."""

    def __init__(self, device, generators: Sequence[torch.Generator] = (),
                 watch: Optional[Callable[[], Sequence[torch.Tensor]]] = None,
                 name: str = "graph"):
        self.device = resolve_device(device)
        self.name = name
        self.compile_count = 0
        self._generators = list(generators)
        self._drawn: list = []      # generators a warm-up drew from
        self._watch = watch or (lambda: ())
        self._pool = None

    @property
    def stream(self) -> torch.cuda.Stream:
        return _capture_stream(self.device)

    def addresses(self) -> tuple:
        return tuple(t.data_ptr() for t in self._watch())

    def stale(self, g: _Graph) -> bool:
        """True when a tensor ``g`` reads in place has moved since its
        capture."""
        return g.addresses != self.addresses()

    def warm_up(self, fn: Callable, args, restore: bool):
        """``fn(*args)`` once, eagerly, on the capture stream; returns its
        output. Notes the generators it drew from (they are registered
        with every later capture); with ``restore`` puts them back to the
        states they had."""
        states = [g.get_state() for g in self._generators]
        cur = torch.cuda.current_stream(self.device)
        with _capture_lock:
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = fn(*args)
            cur.wait_stream(self.stream)
        for g, s in zip(self._generators, states):
            if not torch.equal(g.get_state(), s):
                if all(g is not h for h in self._drawn):
                    self._drawn.append(g)
                if restore:
                    g.set_state(s)
        return out

    def capture(self, fn: Callable, inputs, host=None) -> _Graph:
        """Capture ``fn(*inputs)`` (``inputs``: the static input tensors)
        as one graph. ``host``, a pair ``(read, add)`` of host-side counts
        that ``fn`` advances (an optimizer's step counts): the capture's
        advance is taken back and ``add``ed again at each replay. Raises
        ``CaptureError`` when the capture fails."""
        counters = _launch_counters()
        before = {k: c.launches for k, c in counters.items()}
        host0 = host[0]() if host is not None else None
        graph = torch.cuda.CUDAGraph()
        if self._drawn:
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise CaptureError(
                    f"{self.name}: the call draws from an explicit "
                    f"torch.Generator and this PyTorch "
                    f"({torch.__version__}) has no "
                    f"CUDAGraph.register_generator_state: a capture would "
                    f"replay one draw forever")
            for g in self._drawn:
                register(g)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with _capture_lock:
            _local.capturing = True
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self.stream,
                                      capture_error_mode="thread_local"):
                    out = fn(*inputs)
            except Exception as e:  # noqa: BLE001 — re-raised
                raise CaptureError(
                    f"capturing {self.name} failed: {e}") from e
            finally:
                _local.capturing = False
                launched = [(c, c.launches - before[k])
                            for k, c in counters.items()
                            if c.launches != before[k]]
                for c, n in launched:
                    c.launches -= n
                delta = None
                if host is not None:
                    delta = [b - a for a, b in zip(host0, host[0]())]
                    host[1]([-d for d in delta])
        self.compile_count += 1
        return _Graph(graph, inputs, out, launched, self.addresses(),
                      None if host is None else (host[1], delta))


class _Eager:
    """``compile_for``'s product on the CPU: the call, run eagerly under
    no-grad each time."""

    def __init__(self, fn: Callable):
        self._fn = fn           # the layer or function, never its owner

    def __call__(self, *args):
        with torch.no_grad():
            return self._fn(*[_as_tensor(a) for a in args])


class _Executable:
    """``compile_for``'s product on the card: one signature's graph over
    its static inputs, captured again when a tensor it reads in place has
    been rebound."""

    def __init__(self, sf: "StaticFunction", graph: _Graph):
        self._sf = sf
        self._graph = graph

    @property
    def inputs(self) -> list:
        return self._graph.inputs

    def __call__(self, *args):
        with self._sf._lock:
            self._graph = self._sf._fresh(self._graph)
            return self._graph.run(args)


class StaticFunction:
    """A Layer (or function) whose no-grad calls run as CUDA graphs.

    Calls with grad enabled or with keyword arguments run eagerly, so
    autograd and hooks keep working (the captured training path is
    ``models.create_train_step``). A no-grad call on CUDA tensors replays
    the graph of its signature, captured at its first call over static
    inputs of its own; on CPU tensors it runs eagerly. The explicit
    generators the call may draw from are the layer's modules'
    ``_generator``s."""

    def __init__(self, obj, input_spec=None, full_graph=True):
        del full_graph
        self._input_spec = input_spec
        if isinstance(obj, nn.Module):
            self._layer: Optional[nn.Module] = obj
            self._fn = None
        else:
            self._layer = None
            self._fn = obj
        self._graphs: Optional[Graphs] = None
        self._live: dict = {}
        self._lock = threading.RLock()

    # -- bookkeeping -------------------------------------------------------
    def _target(self):
        return self._layer if self._layer is not None else self._fn

    def _state_tensors(self) -> list:
        if self._layer is None:
            return []
        return [*self._layer.parameters(), *self._layer.buffers()]

    def _device(self, specs) -> torch.device:
        for s in specs:
            if isinstance(s, torch.Tensor):
                return s.device
        for t in self._state_tensors():
            return t.device
        return resolve_device(None)

    @property
    def compile_count(self) -> int:
        """Graphs captured, re-captures after a rebinding included."""
        return 0 if self._graphs is None else self._graphs.compile_count

    def cache_size(self) -> int:
        """Number of signatures the no-grad call path has seen."""
        return len(self._live)

    # -- capture -----------------------------------------------------------
    def _run(self, *args):
        with torch.no_grad():
            return self._target()(*args)

    def _capture(self, inputs, warm: bool = True) -> _Graph:
        with self._lock:
            if self._graphs is None:
                target = self._target()
                layer = self._layer
                # the watch closes over the layer, not over this object:
                # no reference cycle keeps a dropped model alive
                watch = None if layer is None else (
                    lambda: [*layer.parameters(), *layer.buffers()])
                self._graphs = Graphs(
                    inputs[0].device if inputs else self._device(()),
                    _module_generators(self._layer), watch,
                    getattr(target, "__name__", type(target).__name__))
            if warm:
                bufs = [b.detach().clone() for b in (
                    self._layer.buffers() if self._layer is not None
                    else ())]
                self._graphs.warm_up(self._run, inputs, restore=True)
                if bufs:
                    with torch.no_grad():
                        for b, s in zip(self._layer.buffers(), bufs):
                            b.copy_(s)
            return self._graphs.capture(self._run, inputs)

    def _fresh(self, g: _Graph) -> _Graph:
        """``g``, or its capture again when a tensor it reads in place has
        been rebound."""
        if self._graphs.stale(g):
            g = self._capture(g.inputs, warm=False)
        return g

    def _compile(self, specs, adopt: bool):
        """An ``_Eager`` on the CPU, else a captured ``_Graph``."""
        device = self._device(specs)
        if not captures_on(device):
            return _Eager(self._target())
        inputs = []
        for s in specs:
            if adopt and isinstance(s, torch.Tensor) and s.device == device:
                inputs.append(s)
            else:
                shape, dtype = _spec(s)
                inputs.append(torch.zeros(shape, dtype=dtype, device=device))
        return self._capture(inputs)

    def compile_for(self, *arg_specs):
        """Capture the no-grad call for ONE input signature and return the
        executable: ``compiled(*args)`` copies ``args`` into the graph's
        static inputs, replays, and returns the outputs (clones, but for
        a static input returned, which comes back as itself). Weight
        updates between calls are picked up, as in the reference.

        ``arg_specs``: InputSpecs, (shape, dtype) pairs or tensors
        (default: ``input_spec``). A tensor on the card becomes its
        argument's static input itself: the graph reads and writes it in
        place and a call that passes it copies nothing (how the decode
        server's KV pools stay its own); other arguments get zero-filled
        buffers of their own. On the CPU the executable runs the call
        eagerly."""
        specs = arg_specs or tuple(self._input_spec or ())
        exe = self._compile(specs, adopt=True)
        return exe if isinstance(exe, _Eager) else _Executable(self, exe)

    def __call__(self, *args, **kwargs):
        target = self._target()
        if kwargs or torch.is_grad_enabled() or not _TO_STATIC_ENABLED:
            return target(*args, **kwargs)
        key = signature(args)
        with self._lock:
            exe = self._live.get(key)
            if exe is None:
                exe = self._live[key] = self._compile(args, adopt=False)
            if isinstance(exe, _Graph):
                exe = self._live[key] = self._fresh(exe)
                return exe.run(args)
        return exe(*args)

    # Layer-protocol passthrough so to_static(layer) drops into model code
    def __getattr__(self, name):
        target = object.__getattribute__(self, "_layer")
        if target is None:
            target = object.__getattribute__(self, "_fn")
        return getattr(target, name)

    @property
    def forward(self):
        return self.__call__


def to_static(obj=None, input_spec=None, full_graph=True, backend=None,
              **kwargs):
    """Parity: paddle.jit.to_static, as a decorator or a direct call;
    with to_static disabled (``enable_to_static(False)``) it returns
    ``obj`` itself."""
    del backend, kwargs

    def wrap(o):
        if not _TO_STATIC_ENABLED:
            return o
        return StaticFunction(o, input_spec, full_graph)

    if obj is None:
        return wrap
    return wrap(obj)


def not_to_static(fn):
    """Parity: paddle.jit.not_to_static, a marker passthrough."""
    return fn


_IGNORED_MODULES = []
_CODE_LEVEL = 0
_VERBOSITY = 0
_TO_STATIC_ENABLED = True


def ignore_module(modules):
    """Parity: paddle.jit.ignore_module (the SOT skip list). A capture
    records whatever a call launches, so the list is only kept."""
    _IGNORED_MODULES.extend(modules)


def set_code_level(level=100, also_to_stdout=False):
    """Parity: paddle.jit.set_code_level (kept; nothing is transformed)."""
    global _CODE_LEVEL
    _CODE_LEVEL = level


def set_verbosity(level=0, also_to_stdout=False):
    """Parity: paddle.jit.set_verbosity."""
    global _VERBOSITY
    _VERBOSITY = level


def enable_to_static(enable=True):
    """Globally toggle to_static (parity: paddle.jit.enable_to_static):
    off, ``to_static`` returns its argument and a StaticFunction's calls
    run eagerly."""
    global _TO_STATIC_ENABLED
    _TO_STATIC_ENABLED = bool(enable)

"""PyTorch port: the device API (paddle_tpu_torch/device.py) against
paddle_tpu.device.

- Every public name of the reference's module is there.
- ``set_device`` changes what ``device=None`` means for the entry points
  and what ``get_device`` answers; Paddle's names (``"gpu:1"``) and card
  indices read as CUDA devices.
- ``memory_stats`` maps ``torch.cuda.memory_stats`` onto the reference's
  keys (checked over a patched ``torch.cuda``) and is ``{}`` for the CPU,
  where the reference's CPU client also reports nothing.
- No fallback: ``Event`` and ``Stream`` are ``torch.cuda``'s own, and
  they, the ``cuda`` namespace's memory queries and ``memory_stats`` on a
  card raise on this CPU-only build.
"""
import inspect

import pytest
import torch

import paddle_tpu.device as rdev
from paddle_tpu_torch import device as dev
from paddle_tpu_torch.core.random import make_generator
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny


@pytest.fixture(autouse=True)
def _restore_device():
    saved = dev._current[0]
    yield
    dev._current[0] = saved


def test_every_public_name_of_the_reference_is_there():
    names = {n for n, v in vars(rdev).items()
             if not n.startswith("_") and not inspect.ismodule(v)
             and getattr(v, "__module__", rdev.__name__) == rdev.__name__}
    assert names <= set(dev.__all__)
    for n in dev.__all__:
        assert hasattr(dev, n), n
    assert issubclass(dev.Event, torch.cuda.Event)
    assert issubclass(dev.Stream, torch.cuda.Stream)
    ref_cuda = {n for n in vars(rdev.cuda) if not n.startswith("_")}
    assert ref_cuda <= {n for n in vars(dev.cuda) if not n.startswith("_")}


def test_set_device_moves_what_none_means():
    assert dev.resolve_device(None) == torch.device("cuda")
    assert dev.get_device() == "gpu:0"
    assert dev.set_device("cpu") == torch.device("cpu")
    assert dev.resolve_device(None) == torch.device("cpu")
    assert dev.get_device() == "cpu"
    # entry points with device=None follow it
    assert make_generator(0).device == torch.device("cpu")
    m = LlamaForCausalLM(llama_tiny())
    assert next(m.parameters()).device == torch.device("cpu")
    dev.set_device("gpu:1")
    assert dev.resolve_device(None) == torch.device("cuda", 1)
    assert dev.get_device() == "gpu:1"
    assert dev.resolve_device(2) == torch.device("cuda", 2)
    assert dev.resolve_device("gpu") == torch.device("cuda")
    assert dev.resolve_device("cpu") == torch.device("cpu")


def test_memory_stats_keys_and_the_cpu():
    assert dev.memory_stats("cpu") == {}
    dev.set_device("cpu")
    assert dev.memory_stats() == {}
    dev.synchronize()                   # nothing queued on the CPU
    assert dev.get_all_device_type()[0] == "cpu"
    assert dev.is_compiled_with_xpu() is False
    assert dev.get_available_custom_device() == []


def test_memory_stats_maps_the_allocators_counters(monkeypatch):
    stats = {"allocated_bytes.all.current": 1024,
             "allocated_bytes.all.peak": 4096,
             "allocation.all.allocated": 7,
             "reserved_bytes.all.current": 8192}

    class Props:
        total_memory = 80 * 2**30

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: seen.append(d) or stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: Props())
    got = dev.memory_stats("gpu:0")
    assert got == {"bytes_in_use": 1024, "peak_bytes_in_use": 4096,
                   "bytes_limit": 80 * 2**30, "num_allocs": 7}
    assert seen == [torch.device("cuda", 0)]


def test_cuda_calls_fail_where_they_are_made():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: dev.Event(enable_timing=True), dev.Stream,
                 dev.memory_stats, dev.current_stream,
                 dev.cuda.max_memory_allocated, dev.cuda.memory_reserved,
                 dev.synchronize):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    with pytest.raises(ValueError, match="not a CUDA device"):
        dev.cuda.memory_allocated("cpu")
    with pytest.raises(ValueError, match="priority"):
        dev.Stream(priority=3)
    assert dev.get_all_devices() == dev.get_available_device() == []
    assert dev.device_count() == dev.get_device_count() == 0
    with dev.stream_guard(None):        # no stream asked for: no CUDA call
        pass

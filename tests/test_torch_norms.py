"""PyTorch port: RMSNorm (paddle_tpu_torch/ops/kernels/norms.py) against
paddle_tpu's Pallas kernel (interpret mode) and its XLA reference.

On the CPU the port's ``rms_norm`` runs its plain version; the CUDA
kernel (csrc/rms_norm.cu) is held against that plain version on the
card by chip_smoke.py. Tolerance: fp32 at rtol=atol=1e-5, the tolerance
paddle_tpu's own tests/test_pallas_norms.py uses for the kernel against
XLA; bf16 at 1e-2, one bf16 ulp near 1.
"""
import ctypes
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.norm import _rms_norm_xla
from paddle_tpu.ops.pallas.norms import rms_norm_pallas
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import _build, norms

EPS = 1e-6
TOL = dict(rtol=1e-5, atol=1e-5)


def _mk(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# (4,128), (2,7,256), (300,128): tests/test_pallas_norms.py; (13,256):
# the padded-tail case of tests/test_kernel_hygiene_fixes.py; (1,4096),
# (8,4096): Llama-2 7B decode's rows, the kernel's small-row route on the
# card
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (300, 128),
                                   (13, 256), (1, 4096), (8, 4096)])
def test_rms_norm_matches_pallas_and_xla(shape):
    x = _mk(shape, 0)
    w = _mk(shape[-1:], 1) + 1.0
    got = TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w), EPS).numpy()
    pallas = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), EPS,
                                        True))
    xla = np.asarray(_rms_norm_xla(jnp.asarray(x), jnp.asarray(w), EPS))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


@pytest.mark.parametrize("shape", [(4, 128), (3, 1000)])
def test_rms_norm_without_weight_matches_xla(shape):
    x = _mk(shape, 2)
    got = TF.rms_norm(torch.from_numpy(x), None, EPS).numpy()
    ref = np.asarray(_rms_norm_xla(jnp.asarray(x), None, EPS))
    np.testing.assert_allclose(got, ref, **TOL)


def test_rms_norm_inv_is_the_saved_statistic():
    x = _mk((13, 256), 3)
    y, inv = norms.rms_norm(torch.from_numpy(x), None, EPS)
    ref = 1.0 / np.sqrt(np.mean(x.astype(np.float64) ** 2, axis=-1) + EPS)
    assert inv.dtype == torch.float32 and tuple(inv.shape) == (13,)
    np.testing.assert_allclose(inv.numpy(), ref, **TOL)
    np.testing.assert_allclose(y.numpy(), x * ref[:, None], **TOL)


def test_rms_norm_bf16_matches_xla():
    x = _mk((8, 256), 4)
    w = _mk((256,), 5) + 1.0
    got = TF.rms_norm(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(w).bfloat16(), EPS)
    assert got.dtype == torch.bfloat16
    ref = _rms_norm_xla(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16), EPS)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_rms_norm_layer_matches_jax_layer():
    from paddle_tpu import nn as pnn
    from paddle_tpu import to_tensor
    from paddle_tpu.core import flags as _flags
    x = _mk((4, 128), 6)
    w = _mk((128,), 7) + 1.0
    prev = _flags.get_flag("pallas_force_interpret")
    _flags.set_flags({"pallas_force_interpret": True})
    try:
        ref_layer = pnn.RMSNorm(128, 1e-5)
        ref_layer.weight._data = jnp.asarray(w)
        ref = ref_layer(to_tensor(x)).numpy()
    finally:
        _flags.set_flags({"pallas_force_interpret": prev})
    layer = RMSNorm(128, 1e-5, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_rms_norm_is_differentiable_on_the_card_branch(monkeypatch):
    """The card branch (dispatch always takes the launch, which fills
    fresh tensors with no autograd node, as the kernel does) keeps the
    graph: x.grad and w.grad exist and match jax.grad of
    rms_norm_pallas in interpret mode."""
    import jax

    def launch(x, w, eps):
        with torch.no_grad():
            y, inv = norms.rms_norm_plain(x, w, eps)
        return y.clone(), inv.clone()
    monkeypatch.setattr(_build, "dispatch",
                        lambda plain, launch_, *a: launch_(*a))
    monkeypatch.setattr(norms, "_launch", launch)
    x, w, g = _mk((2, 7, 256), 9), _mk((256,), 10) + 1.0, _mk((2, 7, 256),
                                                                11)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (TF.rms_norm(tx, tw, EPS) * torch.from_numpy(g)).sum().backward()
    ref = jax.grad(lambda a, b: (rms_norm_pallas(a, b, EPS, True)
                                 * jnp.asarray(g)).sum(), (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    assert tx.grad is not None and tw.grad is not None
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[1]),
                               rtol=1e-4, atol=1e-4)


def test_cpu_call_never_reaches_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version: no build, no launch, no
    count."""
    def boom(*a, **k):
        raise AssertionError("CUDA branch reached for a CPU tensor")
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(norms, "_launch", boom)
    before = norms.rms_norm.launches
    x = torch.from_numpy(_mk((4, 128), 8))
    norms.rms_norm(x, torch.ones(128), EPS)
    TF.rms_norm(x, None, EPS)
    RMSNorm(128, device="cpu")(x)
    assert norms.rms_norm.launches == before


def test_kernel_wrapper_validates_before_building(monkeypatch):
    """The wrapper's checks (dtype, contiguity, weight shape/dtype) raise
    before any build or launch is attempted."""
    def boom(*a, **k):
        raise AssertionError("reached the build")
    monkeypatch.setattr(_build, "load", boom)
    x = torch.zeros(4, 128)
    with pytest.raises(TypeError):
        norms._launch(x.half(), None, EPS)
    with pytest.raises(ValueError):
        norms._launch(torch.zeros(128, 4).t(), None, EPS)
    with pytest.raises(ValueError):
        norms._launch(x, torch.ones(64), EPS)
    with pytest.raises(TypeError):
        norms._launch(x, torch.ones(128, dtype=torch.float64), EPS)


def _fake_library():
    """A stand-in for the built library: each C entry is a ctypes function
    of the declared signature that records its call and returns 0."""
    lib = type("Lib", (), {})()
    lib.calls = []
    for fn, (argtypes, restype) in _build._SIGNATURES["rms_norm"].items():
        def record(*args, fn=fn):
            lib.calls.append((fn, args))
            return 0
        setattr(lib, fn, ctypes.CFUNCTYPE(restype, *argtypes)(record))
    return lib


@pytest.mark.parametrize("rows,with_w", [(8, True), (1, False),
                                         (512, True)])
def test_launch_hands_the_c_entry_its_arguments(monkeypatch, rows, with_w):
    """On the card branch (the library replaced by one that records its
    calls) a launch reaches ``rms_norm_fwd`` once, with (x, w or NULL, y,
    inv, rows, n, eps, x dtype code, w dtype code, stream): the C entry
    picks the small-row or the many-row route from rows and n itself,
    so decode's rows and a prompt bucket pass the same arguments."""
    lib = _fake_library()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    x = torch.zeros(rows, 4096)
    w = torch.ones(4096, dtype=torch.bfloat16) if with_w else None
    before = norms.rms_norm.launches
    y, inv = norms._launch(x, w, 1e-5)
    assert norms.rms_norm.launches == before + 1
    [(fn, args)] = lib.calls
    assert fn == "rms_norm_fwd"
    assert args[0] == x.data_ptr() and args[2] == y.data_ptr()
    assert args[1] == (w.data_ptr() if with_w else None)
    assert args[3] == inv.data_ptr() and tuple(inv.shape) == (rows,)
    assert args[4:6] == (rows, 4096) and args[6] == pytest.approx(1e-5)
    assert args[7:9] == (0, 1 if with_w else 0)


def test_launch_floor_entry_is_declared():
    """The library also exports ``rms_norm_floor(rows, pdl, stream)``, an
    empty kernel launched as either route launches, which chip_smoke.py
    times beside the kernel; it counts on no wrapper."""
    argtypes, restype = _build._SIGNATURES["rms_norm"]["rms_norm_floor"]
    assert argtypes == [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    assert restype is ctypes.c_int


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::rms_norm_fwd_kernel<float, float, 4, 4>"
    "(...)",
    "void (anonymous namespace)::rms_norm_small_kernel<float, float, 4, 4>"
    "(...)"])
def test_profiles_class_both_routes_as_the_rms_norm_kernel(name):
    """chip_smoke.py's decode and train breakdowns put either route's
    kernel in the RMSNorm class."""
    cs = _chip_smoke()
    assert cs._kernel_class(name) == "rms_norm kernel"
    assert cs._train_kernel_class(name) == "rms_norm kernel"


def test_build_command_targets_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    assert "rms_norm" in _build.sources()
    cmd = _build.nvcc_command("rms_norm", tmp_path / "lib.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-O3", "-shared", "-fPIC", "-std=c++17"):
        assert flag in cmd
    assert cmd[-1].endswith("csrc/rms_norm.cu")
    lib = _build.library_path("rms_norm")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("librms_norm-") and lib.suffix == ".so"


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(_build.KernelBuildError):
        _build.nvcc_path()

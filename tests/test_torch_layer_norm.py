"""PyTorch port: LayerNorm (paddle_tpu_torch/ops/kernels/norms.py) against
paddle_tpu's Pallas kernel in interpret mode and its XLA reference.

On the CPU the port's ``layer_norm`` runs its plain version; the CUDA
kernel (csrc/layer_norm.cu) is held against that plain version on the
card by chip_smoke.py. Tolerances: fp32 forward and statistics at
rtol=atol=1e-5 (paddle_tpu's own norm tests hold its kernel to XLA at
that); gradients at 1e-5 (both sides evaluate the same fp32 formulas of
``_ln_bwd``, summed in another order); bf16 at 1e-2, one bf16 ulp near 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.norm import _layer_norm_xla
from paddle_tpu.ops.pallas.norms import _ln_fwd, layer_norm_pallas
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import _build, norms

EPS = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _mk(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


# widths 13 (odd, under one lane tile) and 768 (GPT-2); (13, 256) is the
# padded-tail case of tests/test_kernel_hygiene_fixes.py
@pytest.mark.parametrize("shape", [(6, 13), (2, 5, 768), (13, 256)])
def test_layer_norm_fwd_stats_and_grads_match_pallas(shape):
    x = _mk(shape, 0, 2.0, 0.5)
    w = _mk(shape[-1:], 1) + 1.0
    b = _mk(shape[-1:], 2)
    dy = _mk(shape, 3)
    n = shape[-1]
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    y_ref, (_, _, _, mu_ref, rstd_ref) = _ln_fwd(jx, jw, jb, EPS, True)
    _, vjp = jax.vjp(lambda a, ww, bb: layer_norm_pallas(a, ww, bb, EPS,
                                                         True), jx, jw, jb)
    gx_ref, gw_ref, gb_ref = vjp(jnp.asarray(dy))

    y, mu, rstd = norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), EPS)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), **TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_ref), **TOL)

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = TF.layer_norm(tx, n, tw, tb, EPS)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y_ref), **TOL)
    for got, ref in ((tx.grad, gx_ref), (tw.grad, gw_ref), (tb.grad, gb_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_w,with_b", [(False, True), (True, False),
                                           (False, False)])
def test_layer_norm_without_affine_matches_xla(with_w, with_b):
    x = _mk((4, 100), 4)
    w = _mk((100,), 5) + 1.0 if with_w else None
    b = _mk((100,), 6) if with_b else None
    got = TF.layer_norm(torch.from_numpy(x), 100,
                        None if w is None else torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), EPS)
    ref = _layer_norm_xla(jnp.asarray(x), None if w is None else
                          jnp.asarray(w), None if b is None else
                          jnp.asarray(b), EPS, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_layer_norm_bf16_matches_xla_and_keeps_param_dtypes():
    x = _mk((8, 768), 7)
    w = _mk((768,), 8) + 1.0
    b = _mk((768,), 9)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    tb = torch.from_numpy(b).bfloat16().requires_grad_()
    got = TF.layer_norm(tx, 768, tw, tb, EPS)
    assert got.dtype == torch.bfloat16
    ref = _layer_norm_xla(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16), EPS, 1)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    got.float().sum().backward()
    assert (tx.grad.dtype, tw.grad.dtype, tb.grad.dtype) == (torch.bfloat16,
                                                             ) * 3


def test_layer_norm_layer_matches_jax_layer():
    from paddle_tpu import nn as pnn
    from paddle_tpu import to_tensor
    from paddle_tpu.core import flags as _flags
    x = _mk((4, 128), 10)
    w = _mk((128,), 11) + 1.0
    b = _mk((128,), 12)
    prev = _flags.get_flag("pallas_force_interpret")
    _flags.set_flags({"pallas_force_interpret": True})
    try:
        ref_layer = pnn.LayerNorm(128, epsilon=EPS)
        ref_layer.weight._data = jnp.asarray(w)
        ref_layer.bias._data = jnp.asarray(b)
        ref = ref_layer(to_tensor(x)).numpy()
    finally:
        _flags.set_flags({"pallas_force_interpret": prev})
    layer = LayerNorm(128, epsilon=EPS, device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_call_never_reaches_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA branch reached for a CPU tensor")
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(norms, "_ln_launch", boom)
    before = norms.layer_norm.launches
    x = torch.from_numpy(_mk((4, 128), 13)).requires_grad_()
    LayerNorm(128, device="cpu")(x).sum().backward()
    norms.layer_norm(x.detach(), None, None, EPS)
    assert norms.layer_norm.launches == before


def test_kernel_wrapper_validates_before_building(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("reached the build")
    monkeypatch.setattr(_build, "load", boom)
    x = torch.zeros(4, 128)
    w = torch.ones(128)
    with pytest.raises(TypeError):
        norms._ln_launch(x.half(), None, None, EPS)
    with pytest.raises(ValueError):
        norms._ln_launch(torch.zeros(128, 4).t(), None, None, EPS)
    with pytest.raises(ValueError):
        norms._ln_launch(x, w, torch.zeros(64), EPS)
    with pytest.raises(TypeError):
        norms._ln_launch(x, w, torch.zeros(128, dtype=torch.bfloat16), EPS)
    with pytest.raises(ValueError):
        TF.layer_norm(x, 64, None, None, EPS)


@pytest.mark.parametrize("name", ["layer_norm", "flash_attention"])
def test_new_sources_build_for_sm90a(monkeypatch, tmp_path, name):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    assert name in _build.sources()
    cmd = _build.nvcc_command(name, tmp_path / "lib.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert cmd[-1].endswith(f"csrc/{name}.cu")
    assert set(_build._SIGNATURES[name]) >= {"ptk_error_string"}
    assert _build.library_path(name).name.startswith(f"lib{name}-")

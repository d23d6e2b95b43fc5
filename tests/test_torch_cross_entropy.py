"""PyTorch port: the softmax cross-entropy kernels' module
(paddle_tpu_torch/ops/kernels/cross_entropy.py), F.cross_entropy and the
flag registry, against paddle_tpu on the CPU.

On the CPU the port's wrappers run their plain versions; paddle_tpu's
``softmax_xent_pallas`` runs its Pallas kernels in interpret mode. The
CUDA kernels (csrc/cross_entropy.cu) are held against the plain versions
on the card by chip_smoke.py. Tolerances: rtol 1e-5 / atol 1e-6, those
of paddle_tpu's own CE kernel tests (tests/test_fused_ops.py,
tests/test_kernel_hygiene_fixes.py): both sides compute the same fp32
formulas, summed in another order. The bf16 case casts both fp32 results
to bf16 the same way.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import cross_entropy as jce
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import cross_entropy as ce

TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's two backwards: plain XLA from the saved lse, and its
# backward kernel; the port's one backward must match both
REF_BWDS = ["xla", "pallas"]


@pytest.fixture(autouse=True)
def _restore_flags():
    """Every test leaves both packages' flags as it found them."""
    port = get_flags("check_index_bounds")
    ref = jflags.get_flags(["check_index_bounds", "pallas_force_interpret"])
    try:
        yield
    finally:
        set_flags(port)
        jflags.set_flags(ref)


def _inputs(r, v, labels=None, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((r, v)) * scale).astype(np.float32)
    lab = (rng.randint(0, v, r) if labels is None
           else np.asarray(labels)).astype(np.int64)
    return x, lab


def _ref_fwd(x, lab, dtype=jnp.float32):
    loss, (_, _, lse) = jce._fwd(jnp.asarray(x, dtype), jnp.asarray(lab),
                                 True)
    return np.asarray(loss), np.asarray(lse)


def _ref_grad(x, lab, ct, bwd, dtype=jnp.float32):
    labj = jnp.asarray(lab)
    return np.asarray(jax.grad(lambda a: jnp.sum(jce.softmax_xent_pallas(
        a, labj, True, bwd) * jnp.asarray(ct)))(jnp.asarray(x, dtype))
        .astype(jnp.float32))


def _port_grad(x, lab, ct, dtype=torch.float32):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    loss = ce.softmax_xent(tx, torch.from_numpy(lab))
    (loss * torch.from_numpy(ct)).sum().backward()
    return loss.detach().numpy(), tx.grad


# 13 x 257 and 13 x 200: odd vocabularies and a ragged row block
# (tests/test_fused_ops.py, tests/test_kernel_hygiene_fixes.py)
@pytest.mark.parametrize("shape", [(13, 257), (13, 200)])
def test_forward_loss_and_lse_match_pallas(shape):
    x, lab = _inputs(*shape, seed=shape[1])
    loss_ref, lse_ref = _ref_fwd(x, lab)
    loss, lse = ce.softmax_xent_fwd(torch.from_numpy(x), torch.from_numpy(lab))
    np.testing.assert_allclose(loss.numpy(), loss_ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_vocabulary_matches_pallas_kernels(dtype):
    """BERT's vocabulary, V = 30522 (not a multiple of 8: on the card its
    rows do not start 16-byte aligned and the forward kernel reads each
    as head, vector body and tail), 8 rows with an invalid label: the
    loss and the gradient against the reference's forward and backward
    kernels in interpret mode."""
    x, lab = _inputs(8, 30522, seed=21, scale=2.0)
    lab[5] = -1
    ct = np.random.RandomState(22).standard_normal(8).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    xs = torch.from_numpy(x).to(tdt).float().numpy()   # the dtype's values
    loss, grad = _port_grad(xs, lab, ct, dtype=tdt)
    assert grad.dtype == tdt and loss[5] == 0.0
    np.testing.assert_allclose(loss, _ref_fwd(xs, lab, jdt)[0], **TOL)
    np.testing.assert_allclose(grad.float().numpy(),
                               _ref_grad(xs, lab, ct, "pallas", jdt), **TOL)


@pytest.mark.parametrize("ref_bwd", REF_BWDS)
def test_both_backwards_match_pallas_with_a_cotangent(ref_bwd):
    """6 x 130 with labels [0, 5, 129, -1, 200, 64] and a random cotangent
    (tests/test_fused_ops.py::test_ce_xla_bwd_matches_pallas_bwd)."""
    x, lab = _inputs(6, 130, labels=[0, 5, 129, -1, 200, 64], seed=3)
    ct = np.random.RandomState(4).standard_normal(6).astype(np.float32)
    loss, grad = _port_grad(x, lab, ct)
    np.testing.assert_allclose(loss, _ref_fwd(x, lab)[0], **TOL)
    np.testing.assert_allclose(grad.numpy(), _ref_grad(x, lab, ct, ref_bwd),
                               **TOL)


def test_plain_backward_matches_pallas_backward_kernel():
    x, lab = _inputs(13, 257, labels=None, seed=9, scale=4.0)
    g = np.random.RandomState(10).standard_normal(13).astype(np.float32)
    _, lse = _ref_fwd(x, lab)
    dx_ref, _ = jce._bwd_rule(True, "pallas", (jnp.asarray(x),
                                               jnp.asarray(lab),
                                               jnp.asarray(lse)),
                              jnp.asarray(g))
    dx = ce.softmax_xent_bwd(torch.from_numpy(x), torch.from_numpy(lab),
                             torch.from_numpy(lse.copy()), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), **TOL)


@pytest.mark.parametrize("bwd", REF_BWDS)
def test_invalid_labels_give_zero_loss_and_gradient(bwd):
    x, lab = _inputs(4, 130, labels=[2, -1, 130, 500], seed=5)
    ct = np.ones(4, np.float32)
    loss, grad = _port_grad(x, lab, ct)
    assert loss[1] == loss[2] == loss[3] == 0.0 and loss[0] > 0
    assert torch.all(grad[1:] == 0) and not torch.all(grad[0] == 0)
    np.testing.assert_allclose(grad.numpy(), _ref_grad(x, lab, ct, bwd),
                               **TOL)


@pytest.mark.parametrize("bwd", REF_BWDS)
def test_bf16_logits_upcast_and_give_bf16_gradients(bwd):
    x, lab = _inputs(13, 256, seed=7, scale=3.0)
    lab[4] = -1
    xb = torch.from_numpy(x).bfloat16()
    xs = xb.float().numpy()                        # the bf16 values, exactly
    ct = np.random.RandomState(8).standard_normal(13).astype(np.float32)
    loss, grad = _port_grad(xs, lab, ct, dtype=torch.bfloat16)
    assert grad.dtype == torch.bfloat16
    loss_ref, _ = _ref_fwd(xs, lab, jnp.bfloat16)
    np.testing.assert_allclose(loss, loss_ref, **TOL)
    np.testing.assert_allclose(grad.float().numpy(),
                               _ref_grad(xs, lab, ct, bwd, jnp.bfloat16),
                               **TOL)


def test_scaled_logits_and_minus_inf_entries():
    """Logits x100 need the max subtraction; a masked (-inf) column adds
    nothing to the row's sum."""
    x, lab = _inputs(5, 64, seed=11, scale=100.0)
    x[:, 7] = -np.inf
    lab[0] = 9
    loss_ref, lse_ref = _ref_fwd(x, lab)
    loss, lse = ce.softmax_xent_fwd_plain(torch.from_numpy(x),
                                          torch.from_numpy(lab))
    assert np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(loss.numpy(), loss_ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)


def test_cross_entropy_mean_with_ignore_index_matches_reference():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((4, 7, 50)).astype(np.float32)
    lab = rng.randint(0, 50, (4, 7)).astype(np.int64)
    lab[0, 3] = lab[2, 6] = -100
    jx = paddle.to_tensor(x, stop_gradient=False)
    ref = JF.cross_entropy(jx, paddle.to_tensor(lab))
    ref.backward()
    tx = torch.from_numpy(x).requires_grad_()
    got = TF.cross_entropy(tx, torch.from_numpy(lab))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref.numpy()),
                               **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)


@pytest.mark.parametrize("reduction,label_shape", [
    ("sum", (4, 7)), ("none", (4, 7)), ("mean", (4, 7, 1))])
def test_cross_entropy_reductions_match_reference(reduction, label_shape):
    rng = np.random.RandomState(6)
    x = rng.standard_normal((4, 7, 50)).astype(np.float32)
    lab = rng.randint(0, 50, label_shape).astype(np.int64)
    lab.reshape(-1)[[1, 20]] = -100
    jx = paddle.to_tensor(x, stop_gradient=False)
    ref = JF.cross_entropy(jx, paddle.to_tensor(lab), reduction=reduction)
    ref.sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    got = TF.cross_entropy(tx, torch.from_numpy(lab), reduction=reduction)
    got.sum().backward()
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)


def test_cross_entropy_takes_both_kernel_wrappers(monkeypatch):
    """F.cross_entropy's forward is softmax_xent_fwd and its backward
    softmax_xent_bwd: the wrappers that launch the kernels on the card."""
    calls = []

    def spy(name, fn):
        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped
    monkeypatch.setattr(ce, "softmax_xent_fwd",
                        spy("fwd", ce.softmax_xent_fwd))
    monkeypatch.setattr(ce, "softmax_xent_bwd",
                        spy("bwd", ce.softmax_xent_bwd))
    x, lab = _inputs(6, 130, seed=13)
    tx = torch.from_numpy(x).requires_grad_()
    TF.cross_entropy(tx, torch.from_numpy(lab)).backward()
    assert calls == ["fwd", "bwd"]


def test_flags_registry_sets_by_either_name_and_all_or_nothing():
    assert get_flags("FLAGS_check_index_bounds") == {
        "FLAGS_check_index_bounds": False}
    set_flags({"FLAGS_check_index_bounds": True})
    assert get_flags(["check_index_bounds"]) == {"check_index_bounds": True}
    with pytest.raises(KeyError):
        set_flags({"check_index_bounds": False, "pallas_prefer_ce": True})
    assert flags.get_flag("check_index_bounds") is True
    with pytest.raises(KeyError):
        get_flags("use_autotune")


@pytest.mark.parametrize("default,raw,want", [
    (False, "on", True), (3, "7", 7), (0.5, "0.25", 0.25), ("a", "b", "b")])
def test_flag_starts_from_its_environment_variable(default, raw, want,
                                                   monkeypatch):
    monkeypatch.setenv("FLAGS_test_only_flag", raw)
    try:
        flags.define_flag("test_only_flag", default)
        assert flags.get_flag("test_only_flag") == want
    finally:
        flags._REGISTRY.pop("test_only_flag", None)


def test_cpu_call_never_reaches_the_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA branch reached for a CPU tensor")
    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(ce, "_fwd_launch", boom)
    monkeypatch.setattr(ce, "_bwd_launch", boom)
    before = (ce.softmax_xent_fwd.launches, ce.softmax_xent_bwd.launches)
    x, lab = _inputs(6, 130, seed=12)
    tx = torch.from_numpy(x).requires_grad_()
    TF.cross_entropy(tx, torch.from_numpy(lab)).backward()
    assert (ce.softmax_xent_fwd.launches,
            ce.softmax_xent_bwd.launches) == before


def test_kernel_wrappers_validate_before_building(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("reached the build")
    monkeypatch.setattr(_build, "load", boom)
    x, lab = torch.zeros(4, 130), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        ce._fwd_launch(x.half(), lab)
    with pytest.raises(ValueError):
        ce._fwd_launch(torch.zeros(130, 4).t(), lab)
    with pytest.raises(ValueError):
        ce._fwd_launch(x, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        ce._bwd_launch(x, lab, torch.zeros(4), torch.zeros(5))


def _fake_library():
    """A stand-in for the built library: each C entry is a ctypes function
    of the declared signature (so the arguments are converted exactly as
    for the real one) that records its call and returns 0."""
    lib = type("Lib", (), {})()
    lib.calls = []
    for fn, (argtypes, restype) in _build._SIGNATURES["cross_entropy"].items():
        def record(*args, fn=fn):
            lib.calls.append((fn, args))
            return 0
        setattr(lib, fn, ctypes.CFUNCTYPE(restype, *argtypes)(record))
    return lib


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1),
                                          (torch.float32, 3)])
def test_view_at_a_storage_offset_reaches_the_kernel_uncopied(
        monkeypatch, dtype, offset):
    """On the card branch (the library replaced by one that records its
    calls), a contiguous [R, V] view at a storage offset, whose rows start
    off any 16-byte boundary, reaches ``softmax_xent_fwd`` at its own
    address, not a copy's, with its shape and dtype code; the launch is
    counted once, through ``_fwd_launch`` and through the dispatching
    wrapper alike."""
    lib = _fake_library()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "dispatch",
                        lambda plain, launch, *a: launch(*a))
    flat = torch.zeros(7 * 30522 + offset, dtype=dtype)
    x = flat[offset:].view(7, 30522)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    lab = torch.arange(7)
    for call in (ce._fwd_launch, ce.softmax_xent_fwd):
        lib.calls.clear()
        before = ce.softmax_xent_fwd.launches
        call(x, lab)
        assert ce.softmax_xent_fwd.launches == before + 1
        [(fn, args)] = lib.calls
        assert fn == "softmax_xent_fwd"
        assert args[0] == x.data_ptr() == flat.data_ptr() + offset * (
            flat.element_size())
        assert args[4:7] == (7, 30522, _build.DTYPE_CODES[dtype])


def test_source_builds_for_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    assert "cross_entropy" in _build.sources()
    cmd = _build.nvcc_command("cross_entropy", tmp_path / "lib.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert set(_build._SIGNATURES["cross_entropy"]) == {
        "softmax_xent_fwd", "softmax_xent_bwd", "ptk_error_string"}

"""PyTorch port: gradient clipping (paddle_tpu_torch/nn/clip.py) against
paddle_tpu/nn/clip.py on the same numpy gradients.

Every clip class and both functions, on fp32 and bf16 gradients, with
one parameter marked ``need_clip=False`` (the classes pass it through
and leave it out of the global norm). fp32 results agree at rtol 1e-6
(sums in another order); bf16 ones within one bf16 ulp of the
reference's (both scale an fp32 copy and round once, so a different
last fp32 bit can move the rounding by one step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch.nn import clip as tclip

SHAPES = [(4, 6), (6,), (3, 5, 2), (1,)]
NO_CLIP = 2                     # index of the need_clip=False parameter


def _grads(scale, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _pairs(arrays, dtype):
    """(reference pairs, port pairs) of parameters and their grads."""
    jd, td = ("float32", torch.float32) if dtype == "fp32" else \
        ("bfloat16", torch.bfloat16)
    jp, tp = [], []
    for i, a in enumerate(arrays):
        p = paddle.create_parameter(list(a.shape), jd)
        q = torch.nn.Parameter(torch.zeros(a.shape, dtype=td))
        p.need_clip = q.need_clip = i != NO_CLIP
        jp.append((p, paddle.to_tensor(a).astype(jd)))
        tp.append((q, torch.from_numpy(a).to(td)))
    return jp, tp


def _as32(x):
    return np.asarray(x).astype(np.float32)


def _hold(got, ref, dtype):
    got, ref = _as32(got), _as32(ref)
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
        return
    # one bf16 ulp of the reference's value: 2^(exponent - 7)
    ulp = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 8).astype(np.float32)
    assert np.all(np.abs(got - ref) <= ulp), np.max(np.abs(got - ref) / ulp)


CLIPS = {"value": ("ClipGradByValue", (0.7,), {}),
         "value_min": ("ClipGradByValue", (0.7,), {"min": -0.2}),
         "norm": ("ClipGradByNorm", (1.5,), {}),
         "global_norm": ("ClipGradByGlobalNorm", (2.0,), {})}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", sorted(CLIPS))
@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_clip_classes_match_the_reference(kind, dtype, scale):
    """Small gradients (no clipping engages) and large ones."""
    name, args, kw = CLIPS[kind]
    jp, tp = _pairs(_grads(scale), dtype)
    ref = getattr(jclip, name)(*args, **kw)(jp)
    got = getattr(tclip, name)(*args, **kw)(tp)
    assert len(got) == len(ref) == len(SHAPES)
    for i, ((_, g), (_, r)) in enumerate(zip(got, ref)):
        assert g.dtype == tp[i][1].dtype
        _hold(g.float().numpy(), r.numpy(), dtype)
        if i == NO_CLIP:
            assert g is tp[i][1]           # passed through untouched


def test_global_norm_skips_need_clip_false_and_none():
    arrays = _grads(3.0)
    _, tp = _pairs(arrays, "fp32")
    tp[1] = (tp[1][0], None)
    out = tclip.ClipGradByGlobalNorm(1.0)(tp)
    assert out[1][1] is None
    norm = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2))
                       for i, a in enumerate(arrays) if i not in (1, NO_CLIP)))
    for i in (0, 3):
        np.testing.assert_allclose(out[i][1].numpy(), arrays[i] / norm,
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("norm_type", [2.0, 3.0, float("inf")])
def test_clip_grad_norm_matches_the_reference(dtype, norm_type):
    jp, tp = _pairs(_grads(2.0, seed=1), dtype)
    for (p, g), (q, h) in zip(jp, tp):
        p.grad, q.grad = g, h
    ref = jclip.clip_grad_norm_([p for p, _ in jp], 1.0, norm_type)
    got = tclip.clip_grad_norm_([q for q, _ in tp], 1.0, norm_type)
    _hold(got.float().numpy(), ref.numpy(), dtype)
    for (p, _), (q, _) in zip(jp, tp):
        assert q.grad.dtype == tp[0][1].dtype
        _hold(q.grad.float().numpy(), p.grad.numpy(), dtype)


def test_clip_grad_norm_raises_on_a_nonfinite_norm_when_asked():
    q = torch.nn.Parameter(torch.zeros(3))
    q.grad = torch.tensor([1.0, float("inf"), 0.0])
    with pytest.raises(RuntimeError):
        tclip.clip_grad_norm_(q, 1.0, error_if_nonfinite=True)
    assert tclip.clip_grad_norm_([], 1.0).item() == 0.0


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_clip_grad_value_matches_the_reference(dtype):
    jp, tp = _pairs(_grads(2.0, seed=2), dtype)
    for (p, g), (q, h) in zip(jp, tp):
        p.grad, q.grad = g, h
    jclip.clip_grad_value_([p for p, _ in jp], 0.5)
    tclip.clip_grad_value_([q for q, _ in tp], 0.5)
    for (p, _), (q, _) in zip(jp, tp):
        np.testing.assert_array_equal(q.grad.float().numpy(),
                                      _as32(p.grad.numpy()))

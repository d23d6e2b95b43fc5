"""PyTorch port: the fused LM-head + CE (paddle_tpu_torch/ops/fused_ce.py)
against paddle_tpu.ops.fused_ce on the CPU.

Both packages get the same numpy inputs. Tolerances are those of the
reference's own tests (tests/test_fused_ops.py): fp32 loss at rtol 1e-5,
gradients at atol 1e-5 (sums in another order); bf16 at rtol 2e-2 for
the loss and 1.6e-2 of the gradient's max-abs (the two sides sum in
another order and round dlogits to bf16 at other values). Both sides
take every LM-head product's result in fp32, unrounded: the bf16 tests
at [512 tokens, V 4096, hidden 512] hold the port's error against an
fp64 truth to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_ce as jce
from paddle_tpu_torch.ops import fused_ce as tce


def _inputs(seed, n, v, d, scale, ignore=False):
    rng = np.random.RandomState(seed)
    h = (rng.randn(n, d) * scale).astype(np.float32)
    w = (rng.randn(v, d) * scale).astype(np.float32)
    y = rng.randint(0, v, (n,)).astype(np.int64)
    if ignore:
        y[::3] = -100
    return h, w, y


def _ref(fn, h, w, y, dtype=jnp.float32, **kw):
    hj, wj = jnp.asarray(h, dtype), jnp.asarray(w, dtype)
    yj = jnp.asarray(y, jnp.int32)
    loss, (gh, gw) = jax.value_and_grad(
        lambda a, b: fn(a, b, yj, **kw), argnums=(0, 1))(hj, wj)
    return (float(loss), np.asarray(gh.astype(jnp.float32)),
            np.asarray(gw.astype(jnp.float32)))


def _port(fn, h, w, y, dtype=torch.float32, **kw):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = fn(ht, wt, torch.from_numpy(y), **kw)
    loss.backward()
    assert ht.grad.dtype == dtype and wt.grad.dtype == dtype
    return (float(loss.detach()), ht.grad.float().numpy(),
            wt.grad.float().numpy())


@pytest.mark.parametrize("ignore", [False, True])
def test_fused_matches_reference(ignore):
    h, w, y = _inputs(0, 64, 100, 32, 0.1, ignore)
    kw = {"ignore_index": -100} if ignore else {}
    ref = _ref(jce.fused_linear_cross_entropy, h, w, y, **kw)
    got = _port(tce.fused_linear_cross_entropy, h, w, y, **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("num_blocks", [2, 4, 8])
@pytest.mark.parametrize("ignore", [False, True])
def test_blockwise_matches_reference(num_blocks, ignore):
    h, w, y = _inputs(1, 48, 96, 32, 0.3, ignore)
    kw = {"num_blocks": num_blocks}
    if ignore:
        kw["ignore_index"] = -100
    ref = _ref(jce.blockwise_linear_cross_entropy, h, w, y, **kw)
    got = _port(tce.blockwise_linear_cross_entropy, h, w, y, **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-5)


def test_blockwise_equals_fused_and_plain_ce():
    """The streamed loss is the one-matmul loss and F.cross_entropy's."""
    h, w, y = _inputs(2, 40, 64, 16, 0.5, ignore=True)
    ht, wt, yt = (torch.from_numpy(a) for a in (h, w, y))
    plain = torch.nn.functional.cross_entropy(ht @ wt.t(), yt,
                                              ignore_index=-100)
    for loss in (tce.fused_linear_cross_entropy(ht, wt, yt, -100),
                 tce.blockwise_linear_cross_entropy(ht, wt, yt, 4, -100)):
        np.testing.assert_allclose(float(loss), float(plain), rtol=1e-6)


def test_blockwise_bf16_with_ignore_index():
    h, w, y = _inputs(3, 8, 32, 16, 1.0)
    y[[2, 4]] = -100
    kw = {"num_blocks": 4, "ignore_index": -100}
    ref = _ref(jce.blockwise_linear_cross_entropy, h, w, y, jnp.bfloat16,
               **kw)
    got = _port(tce.blockwise_linear_cross_entropy, h, w, y, torch.bfloat16,
                **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-2)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1.6e-2 * np.abs(r).max())
    # rows with the ignored label get no gradient
    np.testing.assert_array_equal(got[1][[2, 4]], 0.0)


def test_transposed_head_weight():
    """An untied [hidden, vocab] head passed as its transposed view gets
    its gradient in its own layout."""
    h, w, y = _inputs(4, 24, 32, 8, 0.5)
    head = torch.from_numpy(w.T.copy()).requires_grad_()
    loss = tce.blockwise_linear_cross_entropy(
        torch.from_numpy(h), head.t(), torch.from_numpy(y), 4)
    loss.backward()
    ref = _ref(jce.blockwise_linear_cross_entropy, h, w, y, num_blocks=4)
    assert head.grad.shape == (8, 32)
    np.testing.assert_allclose(head.grad.numpy().T, ref[2], rtol=0,
                               atol=1e-5)


def test_indivisible_vocab_is_refused():
    h, w, y = _inputs(5, 8, 30, 8, 1.0)
    with pytest.raises(ValueError, match="not divisible"):
        tce.blockwise_linear_cross_entropy(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y), 4)
    with pytest.raises(ValueError, match="not divisible"):
        jce.blockwise_linear_cross_entropy(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), num_blocks=4)


# [tokens, vocab, hidden] where a bf16 rounding of the products shows
# (before the fp32 results, the port's blockwise dh was 0.50 % of its
# max-abs from the truth against the reference's 0.33 %, and its loss
# 8.6e-7 relative against 1.3e-8)
BF16_SHAPE = (512, 4096, 512)
FORMS = {
    "fused": (jce.fused_linear_cross_entropy, tce.fused_linear_cross_entropy,
              {}),
    "blockwise": (jce.blockwise_linear_cross_entropy,
                  tce.blockwise_linear_cross_entropy, {"num_blocks": 8}),
}


def _bf16_case():
    n, v, d = BF16_SHAPE
    rng = np.random.RandomState(11)
    h = torch.from_numpy(rng.randn(n, d).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.randn(v, d) * 0.05).astype(np.float32)
                         ).bfloat16()
    return h, w, rng.randint(0, v, (n,)).astype(np.int64)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_bf16_error_against_the_truth_is_the_references(form):
    """bf16 operands: the port's loss, dh and dw are no further from the
    truth (fp64 on the same bf16 operands) than the reference's, which
    takes the products' results in fp32. Allowed: 10 % above the
    reference's error plus an fp32 floor (1e-7 of the loss, 1e-4 of a
    gradient's max-abs; a bf16 ulp is 3.9e-3)."""
    jfn, tfn, kw = FORMS[form]
    hb, wb, y = _bf16_case()
    h64, w64 = hb.double().requires_grad_(), wb.double().requires_grad_()
    loss = torch.nn.functional.cross_entropy(h64 @ w64.t(),
                                             torch.from_numpy(y))
    loss.backward()
    truth = (float(loss.detach()), h64.grad.numpy(), w64.grad.numpy())
    h, w = hb.float().numpy(), wb.float().numpy()
    ref = _ref(jfn, h, w, y, jnp.bfloat16, **kw)
    got = _port(tfn, h, w, y, torch.bfloat16, **kw)

    def errs(r):
        return [abs(r[0] - truth[0]) / abs(truth[0])] + [
            np.abs(g - t).max() / np.abs(t).max()
            for g, t in zip(r[1:], truth[1:])]
    for name, e_got, e_ref, floor in zip(("loss", "dh", "dw"), errs(got),
                                         errs(ref), (1e-7, 1e-4, 1e-4)):
        assert e_got <= 1.1 * e_ref + floor, (name, e_got, e_ref)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_card_branch_asks_for_fp32_results(monkeypatch, form):
    """On the card branch (the device check patched, ``torch.mm``
    recording), every LM-head product of the forward and backward is one
    ``torch.mm`` of the bf16 operands with ``out_dtype=torch.float32``:
    none rounds to bf16 and is cast up after, none upcasts its operands,
    and nothing goes through ``torch.matmul``. The results are the CPU
    branch's."""
    _, tfn, kw = FORMS[form]
    h, w, y = _inputs(6, 16, 64, 8, 1.0)
    cpu = _port(tfn, h, w, y, torch.bfloat16, **kw)
    real_mm, seen = torch.mm, []

    def mm(a, b, *, out_dtype=None):
        seen.append((a.dtype, b.dtype, out_dtype))
        return real_mm(a.float(), b.float()).to(out_dtype or a.dtype)

    def matmul(*a, **k):
        raise AssertionError("an LM-head product went through matmul")
    monkeypatch.setattr(tce, "_on_card", lambda t: True)
    monkeypatch.setattr(torch, "mm", mm)
    monkeypatch.setattr(torch, "matmul", matmul)
    card = _port(tfn, h, w, y, torch.bfloat16, **kw)
    blocks = kw.get("num_blocks", 1)
    # per block: the forward's logits, the backward's logits, dh, dw
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.float32)
                    ] * (4 * blocks)
    assert card[0] == cpu[0]
    for g, c in zip(card[1:], cpu[1:]):
        np.testing.assert_array_equal(g, c)

"""PyTorch port: flash attention (paddle_tpu_torch/ops/kernels/
flash_attention.py) against paddle_tpu's Pallas kernels in interpret mode.

The same numpy inputs go through ``flash_chunk_fwd`` / ``flash_chunk_bwd``
(the Pallas forward, dq and dkv kernels, fed one lse and delta) and the
``jax.vjp`` of ``flash_attention_ext`` (dropout included), and through
the port's plain versions, which are what its CUDA kernels
(csrc/flash_attention.cu) are held against on the card by chip_smoke.py.
Tolerance 2e-5 in fp32, as tests/test_kernel_hygiene_fixes.py holds the
Pallas kernels to XLA (tiles sum in another order); gradients at 1e-4
(one more product of rounded values). The dropout keep-mask must equal
``dropout_keep_mask`` bit for bit. One test holds chip_smoke.py's own
entry-wise check to account: the kernel's rounding passes it, planted
faults do not. The additive bias (with dbias), segment ids,
``flash_attn_unpadded`` and the chunk entries are held against the
reference's ``flash_attention_ext`` / ``flash_chunk_*`` at its own
tolerances: outputs 3e-5, gradients 3e-4 (tests/test_pallas_flash_
attention.py holds the Pallas kernels to a dense oracle there).
"""
import ctypes
import importlib.util
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

FWD = dict(rtol=2e-5, atol=2e-5)
BWD = dict(rtol=1e-4, atol=1e-4)

# (B, Sq, Sk, Hq, Hk, D, causal): one tile; Sq < Sk with a padded key
# tail and GQA 4/2; Sq > Sk with a padded query tail (causal: the first
# Sq - Sk rows see no key, out = 0 and lse = -inf); non-causal GQA; a
# head dim that is not a multiple of 4 (the rows of chip_smoke.py's
# "d50-ragged-fp32", which no 16-byte copy can take); the head dims of
# the FMA route's bf16 forward at its edges, 256 (GQA) and odd 45
CASES = [
    (2, 64, 64, 2, 2, 32, True),
    (1, 72, 200, 4, 2, 32, True),
    (1, 130, 70, 2, 2, 16, True),
    (1, 130, 70, 4, 2, 16, False),
    (1, 72, 200, 4, 2, 50, True),
    (1, 40, 72, 4, 2, 256, True),
    (1, 72, 100, 2, 2, 45, True),
]


def _inputs(case, seed=0):
    b, sq, sk, hq, hk, d, _ = case
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (mk(b, sq, hq, d), mk(b, sk, hk, d), mk(b, sk, hk, d),
            mk(b, sq, hq, d))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fwd_dq_dkv_match_pallas_chunk_kernels(case):
    q, k, v, do = _inputs(case)
    causal = case[-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    out_ref, lse_ref = jfa.flash_chunk_fwd(q, k, v, causal, scale,
                                           interpret=True)
    out, lse = tfa.flash_fwd(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **FWD)
    if case == CASES[2]:
        assert np.isneginf(lse.numpy()[..., :60]).all()
        assert (out.numpy()[:, :60] == 0).all()

    # both backward passes are fed the same lse and delta
    delta = np.einsum("bshd,bshd->bhs", do, np.asarray(out_ref))
    dq_ref, dk_ref, dv_ref = jfa.flash_chunk_bwd(
        q, k, v, do, lse_ref, delta, causal, scale, interpret=True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    tlse = torch.from_numpy(np.array(lse_ref))
    tdelta = torch.from_numpy(delta)
    dq = tfa.flash_dq(tq, tk, tv, tdo, tlse, tdelta, causal, scale)
    dk, dv = tfa.flash_dkv(tq, tk, tv, tdo, tlse, tdelta, causal, scale)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BWD)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("case", [CASES[1], (1, 40, 40, 2, 1, 16, False)],
                         ids=lambda c: "-".join(map(str, c)))
def test_autograd_matches_vjp_of_flash_attention_ext(case, rate):
    q, k, v, do = _inputs(case, seed=1)
    causal = case[-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    seed = np.asarray([-123456789], np.int32)
    out_ref, vjp = jax.vjp(
        lambda a, b_, c: jfa.flash_attention_ext(
            a, b_, c, None, jnp.asarray(seed), None, None, causal, scale,
            rate, 128, 128, True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    grads_ref = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention_ext(tq, tk, tv, seed=torch.from_numpy(seed),
                                  causal=causal, scale=scale,
                                  dropout_rate=rate)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **FWD)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BWD)


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (-7, 0.5), (2 ** 31 - 1,
                                                             0.9)])
def test_dropout_mask_is_bit_exact(seed, rate):
    ref = np.asarray(jfa.dropout_keep_mask(jnp.asarray([seed], jnp.int32),
                                           6, 33, 47, rate))
    got = tfa.dropout_keep_mask(torch.tensor([seed], dtype=torch.int32), 6,
                                33, 47, rate).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tfa.dropout_threshold(rate) == int(jfa._dropout_thresh(rate))
    assert abs(1.0 - got.mean() - rate) < 0.02


def test_functionals_match_reference_attention():
    """sdpa / flash_attention (bottom-right causal diagonal, GQA) against
    paddle_tpu's XLA attention, Sq < Sk so every row sees a key."""
    from paddle_tpu.nn.functional.flash_attention import _attention_xla
    q, k, v, _ = _inputs((2, 24, 40, 4, 2, 16, True), seed=2)
    ref = np.asarray(_attention_xla(q, k, v, None, True, 0.25, 0.0, None))
    got = TF.scaled_dot_product_attention(*_t(q, k, v), is_causal=True)
    np.testing.assert_allclose(got.numpy(), ref, **FWD)
    out, sm = TF.flash_attention(*_t(q, k, v), causal=True)
    assert sm is None
    np.testing.assert_allclose(out.numpy(), ref, **FWD)


def test_dropout_seed_comes_from_the_generator():
    q, k, v, _ = _t(*_inputs((1, 16, 16, 2, 2, 16, True), seed=3))
    with pytest.raises(ValueError):
        TF.scaled_dot_product_attention(q, k, v, dropout_p=0.1)
    a = TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, generator=torch.Generator().manual_seed(1))
    b = TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, generator=torch.Generator().manual_seed(1))
    c = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                        training=False)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bias_segments_and_float_attn_mask_run_bool_mask_is_refused():
    """Once refused with NotImplementedError, a bias, segment ids and an
    sdpa attn_mask now run: each call matches the plain version it
    reaches, and a bool attn_mask is refused (it is not additive)."""
    q, k, v, _ = _t(*_inputs((1, 8, 8, 2, 2, 16, False)))
    bias = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    out = tfa.flash_attention_ext(q, k, v, bias=bias)
    ref, _ = tfa.flash_fwd_plain(q, k, v, False, 0.25, bias=bias)
    assert torch.equal(out, ref)
    seg = torch.tensor([[0, 0, 0, 1, 1, 2, 2, 2]])
    out = tfa.flash_attention_ext(q, k, v, q_seg=seg, k_seg=seg)
    words = tfa.encode_segments(seg)
    ref, _ = tfa.flash_fwd_plain(q, k, v, False, 0.25,
                                 seg=tfa.Segments(words, words, False))
    assert torch.equal(out, ref)
    out = TF.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    assert torch.equal(out, tfa.flash_fwd_plain(q, k, v, False, 0.25,
                                                bias=bias)[0])
    with pytest.raises(TypeError):
        TF.scaled_dot_product_attention(q, k, v, attn_mask=bias > 0)


def test_cpu_call_never_reaches_the_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA branch reached for a CPU tensor")
    monkeypatch.setattr(_build, "load", boom)
    for name in ("_fwd_launch", "_dq_launch", "_dkv_launch"):
        monkeypatch.setattr(tfa, name, boom)
    counts = (tfa.flash_fwd.launches, tfa.flash_dq.launches,
              tfa.flash_dkv.launches)
    q, k, v, _ = (t.requires_grad_() for t in _t(*_inputs(CASES[0])))
    TF.scaled_dot_product_attention(q, k, v, is_causal=True).sum().backward()
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches,
            tfa.flash_dkv.launches) == counts


def test_kernel_wrappers_validate_before_building(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("reached the build")
    monkeypatch.setattr(_build, "load", boom)
    q, k, v, do = _t(*_inputs((1, 8, 8, 4, 2, 16, False)))
    with pytest.raises(TypeError):
        tfa._fwd_launch(q.half(), k.half(), v.half(), True, 1.0, 0.0, None)
    with pytest.raises(TypeError):
        tfa._fwd_launch(q, k.bfloat16(), v, True, 1.0, 0.0, None)
    with pytest.raises(ValueError):          # Hq % Hk != 0
        tfa._fwd_launch(q[:, :, :3].contiguous(), k, v, True, 1.0, 0.0,
                        None)
    with pytest.raises(ValueError):          # head_dim above 256
        big = torch.zeros(1, 8, 2, 264)
        tfa._fwd_launch(big, big, big, True, 1.0, 0.0, None)
    with pytest.raises(ValueError):          # dropout without a seed
        tfa._fwd_launch(q, k, v, True, 1.0, 0.1, None)
    with pytest.raises(ValueError):          # lse of the wrong shape
        tfa._dq_launch(q, k, v, do, torch.zeros(1, 4, 7), torch.zeros(
            1, 4, 8), True, 1.0, 0.0, None)


def _chip_smoke():
    """chip_smoke.py as a module (only its CPU-safe helpers are used)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _online_softmax_fwd(q, k, v, scale, block=64, rescale=True):
    """The forward kernel's order of work, causal, in torch: k tiles of
    ``block`` keys, p rounded to v's dtype against the running max, the
    accumulator rescaled by alpha = exp(m_old - m_new) (left out when
    ``rescale`` is False: a planted fault)."""
    b, s, h, _ = q.shape
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                        float("-inf"))
    vt = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, s, 1), float("-inf"))
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, q.shape[-1])
    for k0 in range(0, s, block):
        st = sc[..., k0:k0 + block]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - m_safe)
        p = torch.exp(st - m_safe)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = (acc * alpha if rescale else acc) + \
            p.to(v.dtype).float() @ vt[:, :, k0:k0 + block]
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


def test_chip_check_passes_kernel_rounding_and_rejects_planted_faults():
    """chip_smoke.py's entry-wise check at its bf16 flash tolerance: the
    forward's online-softmax rounding passes against flash_fwd_plain,
    while three faults of the kind a kernel could carry fail it: the
    forward without the alpha rescale, dkv missing the last q tile, and
    dq missing key tile 0 for the later half of the rows."""
    cs = _chip_smoke()
    rtol_fwd = cs.FLASH_RTOL["fwd"][torch.bfloat16]
    rtol = cs.FLASH_RTOL["bwd"][torch.bfloat16]
    b, s, h, d = 1, 512, 2, 64
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = tfa.flash_fwd_plain(q, k, v, True, scale)
    cs.check_close("out", _online_softmax_fwd(q, k, v, scale), out,
                   rtol_fwd, quiet=True)
    with pytest.raises(AssertionError):
        cs.check_close("out", _online_softmax_fwd(q, k, v, scale,
                                                  rescale=False),
                       out, rtol_fwd, quiet=True)

    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = tfa.flash_dkv_plain(q, k, v, do, lse, delta, True, scale)
    do_cut, delta_cut = do.clone(), delta.clone()
    do_cut[:, -64:] = 0                 # the last q tile's rows add nothing
    delta_cut[..., -64:] = 0
    dk_cut, dv_cut = tfa.flash_dkv_plain(q, k, v, do_cut, lse, delta_cut,
                                         True, scale)
    for got, ref in ((dk_cut, dk), (dv_cut, dv)):
        with pytest.raises(AssertionError):
            cs.check_close("dkv", got, ref, rtol, quiet=True)

    dq = tfa.flash_dq_plain(q, k, v, do, lse, delta, True, scale)
    # key tile 0's share of dq (every row >= 63 sees all of it)
    dq_tile0 = tfa.flash_dq_plain(q, k[:, :64].contiguous(),
                                  v[:, :64].contiguous(), do, lse, delta,
                                  False, scale)
    dq_cut = dq.float()
    dq_cut[:, s // 2:] -= dq_tile0[:, s // 2:].float()
    with pytest.raises(AssertionError):
        cs.check_close("dq", dq_cut.bfloat16(), dq, rtol, quiet=True)


def _dq_other_rounding(q, k, v, do, lse, delta, scale):
    """Causal dq at Sq = Sk with the plain version's roundings in another
    order, as a kernel may do it: p in the exp2 domain, ds as
    p dP - p delta, so some ds entries round to the other bf16 neighbour."""
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    n = q.shape[1]
    p = torch.exp2((qf @ kf.transpose(-1, -2) * scale - lse[..., None])
                   * math.log2(math.e))
    p = p.masked_fill(torch.arange(n)[None, :] > torch.arange(n)[:, None],
                      0.0)
    ds = p * (dof @ vf.transpose(-1, -2)) - p * delta[..., None]
    return ((ds.bfloat16().float() @ kf) * scale).transpose(1, 2).bfloat16()


def test_exact_check_passes_another_rounding_and_rejects_planted_faults():
    """chip_smoke.py's check_exact (the bf16 backward at Llama's shape
    against fp64, relative to the plain version's own distance): dq with
    the plain roundings in another order passes, while dq missing key
    tile 0 for the later half of the rows, and dk and dv missing the last
    q tile, fail."""
    cs = _chip_smoke()
    b, s, h, d = 1, 512, 2, 64
    rng = np.random.RandomState(6)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = tfa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = tfa.flash_dq_plain(q, k, v, do, lse, delta, True, scale)
    dk, dv = tfa.flash_dkv_plain(q, k, v, do, lse, delta, True, scale)
    edq, edk, edv = cs.exact_bwd(q, k, v, do, lse, delta, True, scale)
    ratio = cs.BWD_EXACT_RATIO
    other = _dq_other_rounding(q, k, v, do, lse, delta, scale)
    assert not torch.equal(other, dq)
    cs.check_exact("dq", other, dq, edq, ratio, quiet=True)
    for got, ex in ((dq, edq), (dk, edk), (dv, edv)):
        cs.check_exact("plain", got, got, ex, ratio, quiet=True)

    dq_tile0 = tfa.flash_dq_plain(q, k[:, :64].contiguous(),
                                  v[:, :64].contiguous(), do, lse, delta,
                                  False, scale)
    dq_cut = dq.float()
    dq_cut[:, s // 2:] -= dq_tile0[:, s // 2:].float()
    with pytest.raises(AssertionError):
        cs.check_exact("dq", dq_cut.bfloat16(), dq, edq, ratio, quiet=True)
    do_cut, delta_cut = do.clone(), delta.clone()
    do_cut[:, -64:] = 0
    delta_cut[..., -64:] = 0
    dk_cut, dv_cut = tfa.flash_dkv_plain(q, k, v, do_cut, lse, delta_cut,
                                         True, scale)
    for got, ref, ex in ((dk_cut, dk, edk), (dv_cut, dv, edv)):
        with pytest.raises(AssertionError):
            cs.check_exact("dkv", got, ref, ex, ratio, quiet=True)


def test_exact_backward_takes_the_bias_and_dropout():
    """chip_smoke.py's fp64 backward, which check_exact holds BERT-large's
    bf16 backward to, adds a key bias to the scaled scores and applies the
    dropout keep-mask to dP and to the p of dV: on fp32 inputs it agrees
    with the plain dq / dkv (fp32 sums) to 2e-5; on bf16 inputs the
    plain version passes check_exact against it, and a dv left undropped
    fails."""
    cs = _chip_smoke()
    b, s, h, d, rate = 1, 128, 2, 32, 0.1
    rng = np.random.RandomState(7)
    mk = lambda: torch.from_numpy(rng.standard_normal(  # noqa: E731
        (b, s, h, d)).astype(np.float32))
    q, k, v, do = mk(), mk(), mk(), mk()
    bias = torch.where(torch.arange(s) < 100, 0.0, -1e9).reshape(1, 1, 1, s)
    seed = torch.tensor([31337], dtype=torch.int32)
    scale = 1.0 / math.sqrt(d)
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv, dd = (t.to(dtype) for t in (q, k, v, do))
        args = (False, scale, rate, seed, bias)
        out, lse = tfa.flash_fwd_plain(qq, kk, vv, *args)
        delta = (dd.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        got = (tfa.flash_dq_plain(qq, kk, vv, dd, lse, delta, *args),
               *tfa.flash_dkv_plain(qq, kk, vv, dd, lse, delta, *args))
        ex = cs.exact_bwd(qq, kk, vv, dd, lse, delta, False, scale, rate,
                          seed, bias)
        if dtype == torch.float32:
            for g, e in zip(got, ex):
                np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=2e-5,
                                           atol=2e-5)
            continue
        for g, e in zip(got, ex):
            cs.check_exact("plain", g, g, e, cs.BWD_EXACT_RATIO, quiet=True)
        _, dv_undropped = tfa.flash_dkv_plain(qq, kk, vv, dd, lse, delta,
                                              False, scale, 0.0, None, bias)
        with pytest.raises(AssertionError):
            cs.check_exact("dv", dv_undropped, got[2], ex[2],
                           cs.BWD_EXACT_RATIO, quiet=True)


def test_llama_forward_matches_reference():
    """Llama's full-context forward now attends through the flash
    functional: llama_tiny (GQA 4/2) against paddle_tpu's forward."""
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import llama_tiny as jax_llama_tiny
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                         state_dict_from_numpy)
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    assert (tm.cfg.num_heads, tm.cfg.num_kv_heads) == (4, 2)
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(8).randint(0, 256, (2, 19))
    ref = jm(paddle.to_tensor(ids.astype(np.int64))).numpy()
    got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-4)
    got.sum().backward()             # differentiable through the kernels'
    assert tm.model.layers[0].self_attn.q_proj.weight.grad is not None


# ---------------------------------------------------------------------------
# the two kernel routes: wgmma (csrc/flash_attention_sm90.cu) and FMA
# (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

def _operands(dtype, d, hq, hk, misaligned):
    """q, k, v of [1, 8, H, d]; ``misaligned`` starts each one element
    past a 16-byte boundary (contiguous all the same)."""
    def mk(h):
        n = 8 * h * d
        flat = torch.zeros(n + 1, dtype=dtype)
        return (flat[1:] if misaligned else flat[:n]).view(1, 8, h, d)
    return mk(hq), mk(hk), mk(hk)


@pytest.mark.parametrize("gqa", [(4, 4), (4, 2)], ids=lambda g: f"H{g[0]}/{g[1]}")
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("d", [8, 36, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_route(dtype, d, misaligned, gqa):
    """bf16 with a head dim that is a multiple of 8 (so the head and row
    strides are multiples of 16 bytes) up to 128, 16-byte aligned, takes
    the wgmma kernels; fp32, head dims above 128, strides and addresses
    TMA cannot take the FMA kernels. fp32 stays off the tensor cores:
    its products sum in fp32 in the plain version's order (at head dims up
    to 128 in the register-blocked dq_fp32_kernel / dkv_fp32_kernel),
    which TF32 products, even as 3xTF32, do not match within the fp32
    tolerance (test_tf32_products_miss_the_fp32_backward_check)."""
    q, k, v = _operands(dtype, d, *gqa, misaligned)
    want = ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and d <= 128
            and not misaligned else "fma")
    assert tfa._route(q, k, v) == want
    assert tfa.flash_route(dtype, d, [t.data_ptr() for t in (q, k, v)]) \
        == want
    if dtype == torch.float32 or d > tfa.WGMMA_MAX_HEAD_DIM:
        assert want == "fma"


def _fake_library(name):
    """A stand-in for the built library: each C entry is a ctypes function
    of the declared signature (so the arguments are converted exactly as
    for the real one) that records its call and returns 0."""
    lib = type("Lib", (), {})()
    lib.calls = []
    for fn, (argtypes, restype) in _build._SIGNATURES[name].items():
        def record(*args, fn=fn):
            lib.calls.append((fn, args))
            return 0
        setattr(lib, fn, ctypes.CFUNCTYPE(restype, *argtypes)(record))
    return lib


@pytest.mark.parametrize("dtype,d,misaligned,entry", [
    (torch.bfloat16, 64, False, "sm90"), (torch.bfloat16, 96, False, "sm90"),
    (torch.bfloat16, 64, True, "fma"), (torch.bfloat16, 160, False, "fma"),
    (torch.bfloat16, 256, False, "fma"), (torch.bfloat16, 45, False, "fma"),
    (torch.float32, 64, False, "fma"), (torch.float32, 128, False, "fma"),
    (torch.float32, 160, False, "fma")])
def test_launches_follow_the_route_with_the_c_signatures(monkeypatch, dtype,
                                                         d, misaligned,
                                                         entry):
    """Each launch takes its route's C entry with the arity and types of
    ``_build._SIGNATURES`` (the wgmma entries without a dtype code, with
    the bias class before the stream: 0 without a bias) and counts on its
    own kernel's counter; dq follows the route like the forward and
    dkv. fp32 reaches ``flash_dq`` / ``flash_dkv`` with the fp32 code at
    every head dim: the C entry picks the register-blocked kernels up to
    128 (D = 64, 128) and the one-tile FFMA ones above (D = 160). A bf16
    forward, dq and dkv on the FMA route (misaligned, D = 160, 256, 45)
    reach ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` with the bf16
    code, whose C entries launch fwd_mma_kernel, dq_mma_kernel and
    dkv_mma_kernel, and count on ``.mma``, not on the wrappers' own
    (FFMA) counters."""
    libs = {n: _fake_library(n)
            for n in ("flash_attention", "flash_attention_sm90")}
    monkeypatch.setattr(_build, "load", libs.__getitem__)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    q, k, v = _operands(dtype, d, 4, 2, misaligned)
    do = q.clone() if not misaligned else q
    lse = torch.zeros(1, 4, 8)
    counters = (tfa.flash_fwd, tfa.flash_fwd.wgmma, tfa.flash_fwd.mma,
                tfa.flash_dq, tfa.flash_dq.wgmma, tfa.flash_dq.mma,
                tfa.flash_dkv, tfa.flash_dkv.wgmma, tfa.flash_dkv.mma)
    before = [c.launches for c in counters]
    tfa._fwd_launch(q, k, v, True, 0.125, 0.0, None)
    tfa._dq_launch(q, k, v, do, lse, lse, True, 0.125, 0.0, None)
    tfa._dkv_launch(q, k, v, do, lse, lse, True, 0.125, 0.0, None)
    moved = [c.launches - b for c, b in zip(counters, before)]
    sm90 = [fn for fn, _ in libs["flash_attention_sm90"].calls]
    fma = [fn for fn, args in libs["flash_attention"].calls]
    if entry == "sm90":
        assert moved == [0, 1, 0, 0, 1, 0, 0, 1, 0]
        assert (sm90, fma) == (["flash_fwd_sm90", "flash_dq_sm90",
                                "flash_dkv_sm90"], [])
        for fn, args in libs["flash_attention_sm90"].calls:
            assert _build._SIGNATURES["flash_attention_sm90"][fn][0][-2] \
                is ctypes.c_int
            assert args[-2] == 0
    else:
        mma = int(dtype == torch.bfloat16)
        assert moved == [1 - mma, 0, mma] * 3
        assert (sm90, fma) == ([], ["flash_fwd", "flash_dq", "flash_dkv"])
        codes = {args[-2] for _, args in libs["flash_attention"].calls}
        assert codes == {_build.DTYPE_CODES[dtype]}


def _all_counters():
    return [c for w in (tfa.flash_fwd, tfa.flash_dq, tfa.flash_dkv)
            for c in (w, w.wgmma, w.bias, w.wgmma_bias, w.wgmma_keybias,
                      w.mma, w.mma_bias)]


def test_cpu_call_counts_no_launch_on_either_route():
    counters = _all_counters()
    before = [c.launches for c in counters]
    q, k, v, _ = (t.bfloat16().requires_grad_()
                  for t in _t(*_inputs(CASES[1])))
    TF.scaled_dot_product_attention(q, k, v, is_causal=True).float().sum() \
        .backward()
    mask = torch.zeros(q.shape[0], 1, 1, k.shape[1], dtype=q.dtype)
    TF.scaled_dot_product_attention(q, k, v, attn_mask=mask).float().sum() \
        .backward()
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "fma")])
def test_bias_launches_count_on_their_own_instantiation(monkeypatch, dtype,
                                                        entry):
    """A launch with a bias counts on its route's bias counter
    (``.wgmma_bias`` or ``.bias``) and on no other; on the wgmma route a
    forward, dq or dkv launch of the "keys" bias class (a [1,1,1,Sk] key
    bias) counts on ``.wgmma_keybias`` instead, and one of the "plane"
    class (a [1,1,Sq,Sk] bias, or a key bias with segments) on
    ``.wgmma_bias``; a launch with segment words and no bias counts on the
    bias-free counter."""
    libs = {n: _fake_library(n)
            for n in ("flash_attention", "flash_attention_sm90")}
    monkeypatch.setattr(_build, "load", libs.__getitem__)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    q, k, v = _operands(dtype, 64, 4, 2, False)
    do = q.clone()
    lse = torch.zeros(1, 4, 8)
    bias = torch.zeros(1, 1, 1, 8)
    plane = torch.zeros(1, 1, 8, 8)
    words = tfa.encode_segments(torch.zeros(1, 8, dtype=torch.int32))
    seg = tfa.Segments(words, words, False)
    wrappers = (tfa.flash_fwd, tfa.flash_dq, tfa.flash_dkv)
    base = [w.wgmma if entry == "sm90" else w for w in wrappers]
    own = [w.wgmma_bias if entry == "sm90" else w.bias for w in wrappers]
    keys = own if entry != "sm90" else [w.wgmma_keybias for w in wrappers]
    for mask, moves in (((bias, None), keys), ((plane, None), own),
                        ((bias, seg), own), ((None, seg), base)):
        counters = _all_counters()
        before = [c.launches for c in counters]
        tfa._fwd_launch(q, k, v, False, 0.125, 0.0, None, *mask)
        tfa._dq_launch(q, k, v, do, lse, lse, False, 0.125, 0.0, None, *mask)
        tfa._dkv_launch(q, k, v, do, lse, lse, False, 0.125, 0.0, None,
                        *mask)
        moved = [c.launches - b for c, b in zip(counters, before)]
        assert moved == [1 if any(c is m for m in moves) else 0
                         for c in counters]


@pytest.mark.parametrize("d,misaligned", [(64, True), (160, False),
                                          (256, False), (45, False)])
def test_fma_route_bf16_forward_counts_its_bias_instantiation(monkeypatch, d,
                                                              misaligned):
    """On the FMA route a bf16 forward, dq or dkv with a bias (the Mask
    instantiations of fwd_mma_kernel, dq_mma_kernel and dkv_mma_kernel)
    counts on ``.mma_bias``, one with segment words alone on ``.mma``,
    at every head dim and alignment that takes the route; never on the
    FFMA kernels' ``flash_dq`` / ``flash_dkv`` / ``.bias``."""
    libs = {n: _fake_library(n)
            for n in ("flash_attention", "flash_attention_sm90")}
    monkeypatch.setattr(_build, "load", libs.__getitem__)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    q, k, v = _operands(torch.bfloat16, d, 4, 2, misaligned)
    lse = torch.zeros(1, 4, 8)
    words = tfa.encode_segments(torch.zeros(1, 8, dtype=torch.int32))
    seg = tfa.Segments(words, words, False)
    fwd, dq, dkv = tfa.flash_fwd, tfa.flash_dq, tfa.flash_dkv
    for mask, moves in (((torch.zeros(1, 1, 1, 8), None),
                         (fwd.mma_bias, dq.mma_bias, dkv.mma_bias)),
                        ((None, seg), (fwd.mma, dq.mma, dkv.mma))):
        counters = _all_counters()
        before = [c.launches for c in counters]
        tfa._fwd_launch(q, k, v, False, 0.125, 0.0, None, *mask)
        tfa._dq_launch(q, k, v, q, lse, lse, False, 0.125, 0.0, None, *mask)
        tfa._dkv_launch(q, k, v, q, lse, lse, False, 0.125, 0.0, None, *mask)
        moved = [c.launches - b for c, b in zip(counters, before)]
        assert moved == [1 if any(c is m for m in moves) else 0
                         for c in counters]
    assert [fn for fn, _ in libs["flash_attention"].calls] == [
        "flash_fwd", "flash_dq", "flash_dkv"] * 2


def _mma_fwd(q, k, v, scale, causal, block=64, log2_lse=False):
    """fwd_mma_kernel's order of work, in torch: key tiles of ``block``,
    every fp32 sum of a product taken over 16-wide chunks of its
    reduction (d for S, keys for P V), each chunk exact and added to the
    fp32 accumulator, as m16n8k16 adds; the max of each tile taken on the
    raw products and the scale c = fp32(scale * log2 e) joined in the
    exponent as one rounding, p = 2^(s c - m) flushed below 2^-126,
    rounded to bf16 against the running max before P V; the row sum from
    the unrounded p; out = O * (1 / l), lse = m ln 2 + log l
    (``log2_lse`` leaves the max in log2 units: a planted fault)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    c = float(np.float32(np.float32(scale) * np.float32(math.log2(math.e))))
    qd = q.double().permute(0, 2, 1, 3)
    kd = k.double().permute(0, 2, 1, 3).repeat_interleave(rep, 1)
    vd = v.double().permute(0, 2, 1, 3).repeat_interleave(rep, 1)

    def chunked(a, bt):
        acc = torch.zeros(a.shape[:-1] + bt.shape[-1:], dtype=torch.float32)
        for c0 in range(0, a.shape[-1], 16):
            acc = (acc.double() + a[..., c0:c0 + 16] @ bt[..., c0:c0 + 16, :]
                   ).float()
        return acc
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros(b, h, sq, 1)
    o = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block):
        s = chunked(qd, kd[:, :, k0:k0 + block].transpose(-1, -2))
        cols = torch.arange(k0, min(k0 + block, sk))[None, :]
        if causal:
            s = s.masked_fill(cols > rows + (sk - sq), float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - m_safe)
        x = (s.double() * c - m_safe.double()).float()       # one FFMA
        p = torch.exp2(x)
        p = torch.where(p < 2.0 ** -126, 0.0, p)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = chunked(p.bfloat16().double(), vd[:, :, k0:k0 + block])
        o = o * alpha + pv
        m = m_new
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    out = (o * inv).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l > 0, (m if log2_lse else m * math.log(2))
                      + torch.log(torch.where(l > 0, l, 1.0)),
                      float("-inf"))
    return out, lse[..., 0]


@pytest.mark.parametrize("d,sq,sk,hq,hk", [(256, 130, 200, 4, 2),
                                           (45, 200, 130, 2, 2)])
def test_mma_forward_order_passes_the_chip_check(d, sq, sk, hq, hk):
    """fwd_mma_kernel's order of work (64-key tiles, 16-wide fp32 chunks
    of every product, the scale in the exponent's FFMA, p rounded to bf16
    against the running max) stays inside chip_smoke.py's unchanged bf16
    FLASH_RTOL and LSE_RTOL against flash_fwd_plain at D = 256 and odd
    D = 45, causal with a ragged key tail (and, at Sq > Sk, rows that see
    no key); an lse left in log2 units fails."""
    cs = _chip_smoke()
    rng = np.random.RandomState(12)
    mk = lambda s, h: torch.from_numpy(rng.standard_normal(  # noqa: E731
        (1, s, h, d)).astype(np.float32)).bfloat16()
    q, k, v = mk(sq, hq), mk(sk, hk), mk(sk, hk)
    scale = 1.0 / math.sqrt(d)
    out_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, True, scale)
    out, lse = _mma_fwd(q, k, v, scale, True)
    cs.check_close("out", out, out_ref, cs.FLASH_RTOL["fwd"][torch.bfloat16],
                   quiet=True)
    cs.check_close("lse", lse, lse_ref, cs.LSE_RTOL, quiet=True)
    _, lse_bad = _mma_fwd(q, k, v, scale, True, log2_lse=True)
    with pytest.raises(AssertionError):
        cs.check_close("lse", lse_bad, lse_ref, cs.LSE_RTOL, quiet=True)


def _chunked(a, bt):
    """a @ bt summed as m16n8k16 adds: each 16-wide chunk of the
    reduction exact (fp64), added to the fp32 accumulator in order."""
    acc = torch.zeros(a.shape[:-1] + bt.shape[-1:], dtype=torch.float32)
    for c0 in range(0, a.shape[-1], 16):
        acc = (acc.double() + a[..., c0:c0 + 16].double()
               @ bt[..., c0:c0 + 16, :].double()).float()
    return acc


def _mma_probs(s, lse, scale, hidden):
    """p as dq_mma_kernel / dkv_mma_kernel take it: one FFMA of the fp32
    product by c = fp32(scale log2 e) and -log2(e) lse (an lse of -inf
    read as 0), then 2^x flushed below 2^-126; 0 where ``hidden``."""
    c = float(np.float32(np.float32(scale) * np.float32(math.log2(math.e))))
    lse = torch.where(lse == float("-inf"), 0.0, lse)
    neg = (-(lse * np.float32(math.log2(math.e)))).float()
    p = torch.exp2((s.double() * c + neg.double()).float())
    return torch.where(hidden | (p < 2.0 ** -126), 0.0, p)


def _mma_dq(q, k, v, do, lse, delta, scale, causal, rate=0.0, seed=None,
            block=64, sub_delta=True):
    """dq_mma_kernel's order of work, in torch: key tiles of ``block``;
    S and dP as 16-wide chunked fp32 sums; p in the exp2 domain
    (``_mma_probs``); dP dropped by the keep-mask and keep scale; ds =
    p (dP - delta) in fp32, rounded to bf16 before dQ += ds K (chunked
    over keys); dQ scaled at the end (``sub_delta`` False: a planted
    fault)."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = hq // hk
    qd, dod = (x.float().permute(0, 2, 1, 3) for x in (q, do))
    kd, vd = (x.float().permute(0, 2, 1, 3).repeat_interleave(rep, 1)
              for x in (k, v))
    keep = (tfa.dropout_keep_mask(seed, b * hq, sq, sk, rate).reshape(
        b, hq, sq, sk) if rate else None)
    rows = torch.arange(sq)[:, None]
    acc = torch.zeros(b, hq, sq, d)
    for k0 in range(0, sk, block):
        kt, vt = kd[:, :, k0:k0 + block], vd[:, :, k0:k0 + block]
        s = _chunked(qd, kt.transpose(-1, -2))
        dp = _chunked(dod, vt.transpose(-1, -2))
        cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
        hidden = (cols >= sk) | (causal & (cols > rows + (sk - sq)))
        p = _mma_probs(s, lse[..., None], scale, hidden)
        if keep is not None:
            dp = torch.where(keep[..., k0:k0 + block],
                             dp * tfa._keep_scale(rate), 0.0)
        ds = p * (dp - delta[..., None]) if sub_delta else p * dp
        acc = acc + _chunked(ds.bfloat16(), kt)
    return (acc * scale).permute(0, 2, 1, 3).to(q.dtype)


def _mma_dkv(q, k, v, do, lse, delta, scale, causal, rate=0.0, seed=None,
             block=64, heads=None):
    """dkv_mma_kernel's order of work, in torch: for each kv head, the
    group's q heads in turn (``heads``: how many; fewer is a planted
    fault), q tiles of ``block`` rows; S^T and dP^T as 16-wide chunked
    fp32 sums; p in the exp2 domain; the dropped p and ds^T rounded to
    bf16 before dV += P^T dO and dK += ds^T Q (chunked over queries);
    dK scaled at the end."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = hq // hk
    qd, dod = (x.float().permute(0, 2, 1, 3) for x in (q, do))
    kd, vd = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    keep = (tfa.dropout_keep_mask(seed, b * hq, sq, sk, rate).reshape(
        b, hq, sq, sk) if rate else None)
    keys = torch.arange(sk)[:, None]
    dk = torch.zeros(b, hk, sk, d)
    dv = torch.zeros(b, hk, sk, d)
    for g in range(rep if heads is None else heads):
        h = torch.arange(hk) * rep + g
        for q0 in range(0, sq, block):
            qt, dot = qd[:, h, q0:q0 + block], dod[:, h, q0:q0 + block]
            st = _chunked(kd, qt.transpose(-1, -2))
            dpt = _chunked(vd, dot.transpose(-1, -2))
            qrows = torch.arange(q0, q0 + qt.shape[2])[None, :]
            hidden = causal & (keys > qrows + (sk - sq))
            p = _mma_probs(st, lse[:, h, None, q0:q0 + block], scale,
                           hidden)
            pd = p
            if keep is not None:
                kp = keep[:, h, q0:q0 + block].transpose(-1, -2)
                pd = torch.where(kp, p * tfa._keep_scale(rate), 0.0)
                dpt = torch.where(kp, dpt * tfa._keep_scale(rate), 0.0)
            dst = p * (dpt - delta[:, h, None, q0:q0 + block])
            dv = dv + _chunked(pd.bfloat16(), dot)
            dk = dk + _chunked(dst.bfloat16(), qt)
    return ((dk * scale).permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


@pytest.mark.parametrize("d,sq,sk,hq,hk,rate", [
    (256, 72, 100, 2, 1, 0.0), (45, 100, 130, 2, 1, 0.1),
    (45, 130, 100, 2, 2, 0.0)])
def test_mma_backward_order_passes_the_chip_check(d, sq, sk, hq, hk, rate):
    """dq_mma_kernel's and dkv_mma_kernel's order of work (16-wide fp32
    chunks of every product, p in the exp2 domain, ds and the dropped p
    rounded to bf16 before their products, dQ and dK scaled at the end)
    stays inside chip_smoke.py's unchanged bf16 FLASH_RTOL["bwd"]
    against flash_dq_plain / flash_dkv_plain at D = 256 and odd D = 45,
    causal with a ragged key tail (and rows that see no key at Sq > Sk),
    GQA 2/1 (the dkv group sum), with dropout 0.1; delta not subtracted
    (dq) and one q head of the group summed (dkv) fail it."""
    cs = _chip_smoke()
    rng = np.random.RandomState(13)
    mk = lambda s, h: torch.from_numpy(rng.standard_normal(  # noqa: E731
        (1, s, h, d)).astype(np.float32)).bfloat16()
    q, k, v, do = mk(sq, hq), mk(sk, hk), mk(sk, hk), mk(sq, hq)
    scale = 1.0 / math.sqrt(d)
    seed = torch.tensor([2024], dtype=torch.int32)
    args = (True, scale, rate, seed)
    out, lse = tfa.flash_fwd_plain(q, k, v, *args)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq_ref = tfa.flash_dq_plain(q, k, v, do, lse, delta, *args)
    dk_ref, dv_ref = tfa.flash_dkv_plain(q, k, v, do, lse, delta, *args)
    tol = cs.FLASH_RTOL["bwd"][torch.bfloat16]
    mine = (q, k, v, do, lse, delta, scale, True, rate, seed)
    cs.check_close("dq", _mma_dq(*mine), dq_ref, tol, quiet=True)
    dk, dv = _mma_dkv(*mine)
    cs.check_close("dk", dk, dk_ref, tol, quiet=True)
    cs.check_close("dv", dv, dv_ref, tol, quiet=True)
    with pytest.raises(AssertionError):
        cs.check_close("dq", _mma_dq(*mine, sub_delta=False), dq_ref, tol,
                       quiet=True)
    if hq > hk:
        dk1, dv1 = _mma_dkv(*mine, heads=1)
        with pytest.raises(AssertionError):
            cs.check_close("dk", dk1, dk_ref, tol, quiet=True)
        with pytest.raises(AssertionError):
            cs.check_close("dv", dv1, dv_ref, tol, quiet=True)


def _wgmma_fwd(q, k, v, scale, causal, block=128, ln2=True):
    """The wgmma forward's arithmetic, in torch: scores times
    fp32(scale * log2 e) (the exp2 domain), k tiles of ``block`` keys,
    p = exp2(x - m) rounded to bf16 against the tile's running max before
    P V, the row sum from the unrounded p, O / l as O * (1 / l), and
    lse = m ln 2 + log l (``ln2`` False leaves the max in log2 units: a
    planted fault)."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    c = np.float32(np.float32(scale) * np.float32(math.log2(math.e)))
    x = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * float(c)
    if causal:
        hidden = (torch.arange(sk)[None, :]
                  > torch.arange(sq)[:, None] + (sk - sq))
        x = x.masked_fill(hidden, float("-inf"))
    vt = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, q.shape[-1])
    for k0 in range(0, sk, block):
        xt = x[..., k0:k0 + block]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp2(m - m_safe)
        p = torch.exp2(xt - m_safe)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vt[:, :, k0:k0 + block]
        m = m_new
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    out = (acc * inv).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l > 0, (m * math.log(2) if ln2 else m)
                      + torch.log(torch.where(l > 0, l, 1.0)),
                      float("-inf"))
    return out, lse[..., 0]


@pytest.mark.parametrize("sq,sk,causal", [(512, 512, True), (333, 200, True),
                                          (200, 333, False)])
def test_wgmma_tiling_passes_the_chip_check(sq, sk, causal):
    """The wgmma forward's tiling (128-key tiles, exp2 domain, p rounded
    to bf16 against each tile's running max) stays inside chip_smoke.py's
    unchanged bf16 FLASH_RTOL and LSE_RTOL against flash_fwd_plain, rows
    that see no key included; an lse left in log2 units fails."""
    cs = _chip_smoke()
    rng = np.random.RandomState(11)
    mk = lambda s: torch.from_numpy(rng.standard_normal(  # noqa: E731
        (1, s, 2, 64)).astype(np.float32)).bfloat16()
    q, k, v = mk(sq), mk(sk), mk(sk)
    scale = 0.125
    out_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    out, lse = _wgmma_fwd(q, k, v, scale, causal)
    cs.check_close("out", out, out_ref, cs.FLASH_RTOL["fwd"][torch.bfloat16],
                   quiet=True)
    cs.check_close("lse", lse, lse_ref, cs.LSE_RTOL, quiet=True)
    _, lse_bad = _wgmma_fwd(q, k, v, scale, causal, ln2=False)
    with pytest.raises(AssertionError):
        cs.check_close("lse", lse_bad, lse_ref, cs.LSE_RTOL, quiet=True)


def _tf32(x):
    """fp32 rounded to TF32 (10 stored mantissa bits; to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``), in fp32."""
    u = x.contiguous().view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    return (torch.where(finite, u + 0x1000, u) & -0x2000).view(torch.float32)


def _matmul_tf32(passes):
    """torch.matmul on TF32 operands, each product exact and summed in
    fp32: one pass (big.big), or the 3xTF32 split, x = big + small with
    both rounded to TF32, as small.big + big.small + big.big."""
    mm = torch.matmul

    def matmul(a, b):
        ab, bb = _tf32(a), _tf32(b)
        if passes == 1:
            return mm(ab, bb)
        return mm(_tf32(a - ab), bb) + mm(ab, _tf32(b - bb)) + mm(ab, bb)
    return matmul


def _matmul_fma_chain(a, b):
    """torch.matmul as one chain of fp32 FMAs per output along the
    reduction index, ascending from 0 (each step exact in fp64, rounded
    once to fp32): the order of dq_fp32_kernel / dkv_fp32_kernel."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i in range(a.shape[-1]):
        acc = (acc.double() + a64[..., :, i:i + 1] * b64[..., i:i + 1, :]
               ).float()
    return acc


_ROUNDING_CASES = {
    "causal": dict(hq=2, hk=2, causal=True),
    "key-bias": dict(hq=2, hk=2, causal=False, bias="keys"),
    "gqa-4/2": dict(hq=4, hk=2, causal=True),
    "dropout": dict(hq=2, hk=2, causal=True, rate=0.1),
    "full-bias-dbias": dict(hq=2, hk=1, causal=True, bias="full")}


@pytest.mark.parametrize("name", list(_ROUNDING_CASES))
def test_tf32_products_miss_the_fp32_backward_check(monkeypatch, name):
    """chip_smoke.py's fp32 backward check (FLASH_RTOL["bwd"][fp32] and
    DBIAS_RTOL[fp32], unchanged) against the plain dq / dkv with every
    product emulated three ways on the same fp32 inputs (B1 S128 D64):
    as the chain of fp32 FMAs, ascending, that dq_fp32_kernel /
    dkv_fp32_kernel run, dq, dk, dv and dbias pass (here bit for bit);
    with one TF32 pass each fails by orders of magnitude; split as
    3xTF32, the worst of dq, dk and dv uses a quarter of the tolerance or
    more (0.50-1.49 here) even with exact products and fp32 sums, and
    dbias (ds itself, where dP - delta cancels) fails. On an H100 the
    3xTF32 kernels read several times the tolerance (chip_ab.py): so fp32
    dq and dkv stay on FFMA."""
    cs = _chip_smoke()
    c = _ROUNDING_CASES[name]
    rng = np.random.RandomState(0)
    b, s, d = 1, 128, 64
    mk = lambda h: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, s, h, d)).astype(np.float32))
    q, do, k, v = mk(c["hq"]), mk(c["hq"]), mk(c["hk"]), mk(c["hk"])
    bias = None
    if c.get("bias") == "keys":
        bias = torch.where(torch.arange(s) < 100, 0.0, -1e9).reshape(
            1, 1, 1, s)
    elif c.get("bias") == "full":
        bias = torch.from_numpy(0.5 * rng.standard_normal(
            (b, c["hq"], s, s)).astype(np.float32))
    dbias = c.get("bias") == "full"
    args = (c["causal"], 1.0 / math.sqrt(d), c.get("rate", 0.0),
            torch.tensor([1234], dtype=torch.int32), bias, None)
    out, lse = tfa.flash_fwd_plain(q, k, v, *args)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()

    def backward():
        dq = tfa.flash_dq_plain(q, k, v, do, lse, delta, *args, dbias)
        dq, db = dq if dbias else (dq, None)
        dk, dv = tfa.flash_dkv_plain(q, k, v, do, lse, delta, *args)
        return dict(dq=dq, dk=dk, dv=dv, **({"dbias": db} if dbias else {}))

    ref = backward()
    rtol = dict(dq=cs.FLASH_RTOL["bwd"][torch.float32],
                dk=cs.FLASH_RTOL["bwd"][torch.float32],
                dv=cs.FLASH_RTOL["bwd"][torch.float32],
                dbias=cs.DBIAS_RTOL[torch.float32])
    got = {}
    for way, matmul in (("fma", _matmul_fma_chain), ("tf32", _matmul_tf32(1)),
                        ("3xtf32", _matmul_tf32(3))):
        with monkeypatch.context() as m:
            m.setattr(torch, "matmul", matmul)
            got[way] = backward()
    for key, want in ref.items():
        cs.check_close(key, got["fma"][key], want, rtol[key], quiet=True)
        with pytest.raises(AssertionError):
            cs.check_close(key, got["tf32"][key], want, rtol[key],
                           quiet=True)
    used = {key: cs._tolerance_share(key, got["3xtf32"][key], want,
                                     rtol[key])[1]
            for key, want in ref.items()}
    assert max(used["dq"], used["dk"], used["dv"]) > 0.25, used
    if dbias:
        with pytest.raises(AssertionError):
            cs.check_close("dbias", got["3xtf32"]["dbias"], ref["dbias"],
                           rtol["dbias"], quiet=True)


def _wgmma_dq(q, k, v, do, lse, delta, scale, causal, block=64,
              mask_tail=True, scaled=True):
    """The wgmma dq's arithmetic, in torch: k tiles of ``block`` keys, K
    and V zero-filled past Sk (as TMA fills them), kv head h // rep;
    p = exp(fp32(s * scale) - lse) with an lse of -inf read as 0, zero
    past the diagonal and at keys >= Sk (``mask_tail`` False leaves the
    latter: a planted fault); ds = p (dp - delta) rounded to bf16; dQ
    summed in fp32 tile by tile, times the scale at the end (``scaled``
    False leaves it off: a planted fault)."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    pad = -sk % block

    def tiles(x):                        # [B, Sk + pad, Hq, D], fp32
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.repeat_interleave(hq // hk, dim=2)

    kp, vp = tiles(k), tiles(v)
    lse_safe = torch.where(lse == float("-inf"), 0.0, lse)[..., None]
    rows = torch.arange(sq)[:, None]
    acc = torch.zeros(b, hq, sq, d)
    for k0 in range(0, sk + pad, block):
        kt, vt = kp[:, k0:k0 + block], vp[:, k0:k0 + block]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kt)
        p = torch.exp(s * scale - lse_safe)
        cols = torch.arange(k0, k0 + block)[None, :]
        hidden = cols >= sk if mask_tail else torch.zeros(1, block,
                                                          dtype=torch.bool)
        if causal:
            hidden = hidden | (cols > rows + (sk - sq))
        p = p.masked_fill(hidden, 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vt)
        ds = (p * (dp - delta[..., None])).bfloat16().float()
        acc = acc + ds @ kt.permute(0, 2, 1, 3)
    return (acc * scale if scaled else acc).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("sq,sk,causal", [(512, 512, True), (333, 200, True),
                                          (200, 333, False)])
def test_wgmma_dq_tiling_passes_the_chip_check(sq, sk, causal):
    """The wgmma dq's tiling (64-key tiles, exp in the plain version's
    order, ds rounded to bf16, the fp32 sum tile by tile, the scale at the
    end) stays inside chip_smoke.py's unchanged bf16 bwd FLASH_RTOL
    against flash_dq_plain, at ragged Sk, at Sq > Sk (rows that see no
    key) and with GQA 2/1. Leaving the scale off dQ fails. Keys past Sk
    are zero-filled, so an unmasked p there adds p x 0 to dQ: harmless
    until exp(-lse) overflows, as it does for query row 0 (its scores lie
    near -200), and then inf x 0 poisons dQ with NaN: without the tail
    mask the non-causal ragged case fails."""
    cs = _chip_smoke()
    rtol = cs.FLASH_RTOL["bwd"][torch.bfloat16]
    rng = np.random.RandomState(12)
    mk = lambda s, h: torch.from_numpy(rng.standard_normal(  # noqa: E731
        (1, s, h, 64)).astype(np.float32))
    q, do = mk(sq, 2), mk(sq, 2)
    k, v = mk(sk, 1) + 1.0, mk(sk, 1)
    q[:, 0] = -25.0
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    scale = 0.125
    out, lse = tfa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = tfa.flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    got = _wgmma_dq(q, k, v, do, lse, delta, scale, causal)
    cs.check_close("dq", got, ref, rtol, quiet=True)
    with pytest.raises(AssertionError):
        cs.check_close("dq", _wgmma_dq(q, k, v, do, lse, delta, scale, causal,
                                       scaled=False), ref, rtol, quiet=True)
    if not causal and sk % 64:
        assert float(lse[0, :, 0].max()) < -88.0
        with pytest.raises(AssertionError):
            cs.check_close("dq", _wgmma_dq(q, k, v, do, lse, delta, scale,
                                           causal, mask_tail=False),
                           ref, rtol, quiet=True)


def test_ptxas_report_reads_registers_spills_and_wgmma_waits():
    """chip_smoke.py's build report: ptxas's registers and spills per
    wgmma kernel under a short name, and from the SASS its HGMMAs and the
    wgmma waits among them (one per HGMMA: serialised products)."""
    cs = _chip_smoke()
    dq = ("_ZN12_GLOBAL__N_114dq_sm90_kernelILi64ELb0EEEv14CUtensorMap_st"
          "PKfS3_N3ptk4DimsEfiNS5_7DropoutE")
    fwd = "_ZN12_GLOBAL__N_115fwd_sm90_kernelILi128EEEv14CUtensorMap_st"
    log = (f"ptxas info    : Compiling entry function '{dq}' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\nptxas info    : Used 168 registers, used 1 barriers\n"
           f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 154 registers\n"
           f"ptxas warning : (C7512) wgmma serialized in '{fwd}'\n")
    sass = (f"\t\tFunction : {dq}\n HGMMA.64x64x16 ;\n WARPGROUP.DEPBAR.LE "
            "gsb0, 0x0 ;\n HGMMA.64x64x16 ;\n WARPGROUP.DEPBAR.LE gsb0, 0x0"
            f" ;\n\t\tFunction : {fwd}\n HGMMA.64x128x16 ;\n HGMMA.64x128x16"
            " ;\n WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n")
    rep = cs.ptxas_report(log, sass)
    assert rep["kernels"] == [
        {"kernel": "dq_sm90_kernel<64,0>", "spill_stores": 8,
         "spill_loads": 12, "registers": 168, "hgmma": 2, "wgmma_waits": 2},
        {"kernel": "fwd_sm90_kernel<128>", "spill_stores": 0,
         "spill_loads": 0, "registers": 154, "hgmma": 2, "wgmma_waits": 1}]
    assert rep["warnings"] == [
        "ptxas warning : (C7512) wgmma serialized in "
        "'fwd_sm90_kernel<128>'"]


def test_ptxas_report_reads_the_highest_register_of_each_kernel():
    """The build report's ``max_register``: the highest register each
    kernel's SASS names (uniform registers, URn, are not counted), above
    ptxas's launch count where a branch was given more by setmaxnreg."""
    cs = _chip_smoke()
    dkv = ("_ZN12_GLOBAL__N_115dkv_sm90_kernelILi128ELb0ELi0ELb0EEEv14CUtens"
           "orMap_st")
    fwd = "_ZN12_GLOBAL__N_115fwd_sm90_kernelILi64ELi0ELb0EEEv14CUtensorMap_st"
    sass = (f"\t\tFunction : {dkv}\n MOV R1, c[0x0][0x28] ;\n"
            " HGMMA.64x128x16.F32.BF16 R24, gdesc[UR16], R24 ;\n"
            " FADD R231, R7, UR40 ;\n"
            f"\t\tFunction : {fwd}\n IADD3 R2, R9, R17, RZ ;\n")
    rep = cs.ptxas_report("", sass)
    assert rep["max_register"] == {"dkv_sm90_kernel<128,0,0,0>": 231,
                                   "fwd_sm90_kernel<64,0,0>": 17}
    # the anonymous namespace's hash ends in letters and digits
    dkv128 = ("_ZN56_GLOBAL__N__984e6f69_23_flash_attention_sm90_cu_21afe64018"
              "dkv128_sm90_kernelILb0ELi0ELb0EEEv14CUtensorMap_st")
    assert cs._short_kernel(dkv128) == "dkv128_sm90_kernel<0,0,0>"
    assert cs._short_kernel(dkv128.replace("18dkv128", "15dkv").replace(
        "ILb0", "ILi64ELb0")) == "dkv_sm90_kernel<64,0,0,0>"
    fwd = ("_ZN56_GLOBAL__N__984e6f69_23_flash_attention_sm90_cu_21afe64023"
           "fwd_overlap_sm90_kernelILi128EEEv14CUtensorMap_st")
    assert cs._short_kernel(fwd) == "fwd_overlap_sm90_kernel<128>"
    # the train cells' bias-free kernels, reported on lines of their own
    assert sorted(cs.MAIN_PATH_KERNELS) == [
        "dkv128_sm90_kernel<0,0,0>", "dq_sm90_kernel<128,0,0,0>",
        "fwd_overlap_sm90_kernel<128>", "fwd_overlap_sm90_kernel<64>"]


def test_ptxas_report_counts_the_fp32_kernels_instructions():
    """The build report names the FMA route's fp32 forward, dq and dkv by
    head dim and Mask, and counts from their SASS the HMMA, FFMA and
    shared-load instructions (LDS of any width; LDSM, a matrix load,
    apart). The one-tile FFMA kernels, templated on a type, keep their
    mangled name."""
    cs = _chip_smoke()
    ns = "_ZN51_GLOBAL__N__e00e0efa_18_flash_attention_cu_21afe640"
    dq = f"{ns}14dq_fp32_kernelILi64ELb1EEEvPKfS2_S2_"
    dkv = f"{ns}15dkv_fp32_kernelILi128ELb0EEEvPKfS2_S2_"
    fwd32 = f"{ns}15fwd_fp32_kernelILi128ELb1EEEvPKfS2_S2_PfS3_"
    log = (f"ptxas info    : Compiling entry function '{fwd32}' for "
           "'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
           "spill loads\nptxas info    : Used 232 registers, used 1 barriers\n"
           f"ptxas info    : Compiling entry function '{dq}' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 238 registers, used 1 barriers\n"
           f"ptxas info    : Compiling entry function '{dkv}' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 244 registers, used 1 barriers\n")
    sass = (f"\t\tFunction : {dq}\n FFMA R1, R2, R3, R1 ;\n LDS.128 R4, "
            "[R2+0x10] ;\n LDSM.16.M88.4 R8, [R3] ;\n FFMA R5, R6, R7, R5 ;"
            f"\n\t\tFunction : {dkv}\n LDS R1, [R2] ;\n LDS.64 R2, [R3] "
            ";\n FFMA R9, R10, R11, R9 ;\n"
            f"\t\tFunction : {fwd32}\n LDS.128 R4, [R2] ;\n FFMA R1, R2, "
            "R3, R1 ;\n FFMA R5, R6, R7, R5 ;\n FFMA R8, R6, R7, R8 ;\n")
    rep = cs.ptxas_report(log, sass)
    assert [(r["kernel"], r["registers"], r["spill_stores"])
            for r in rep["kernels"]] == [("fwd_fp32_kernel<128,1>", 232, 0),
                                         ("dq_fp32_kernel<64,1>", 238, 0),
                                         ("dkv_fp32_kernel<128,0>", 244, 0)]
    assert rep["ops"] == {
        "dq_fp32_kernel<64,1>": {"HMMA": 0, "FFMA": 2, "LDS": 1},
        "dkv_fp32_kernel<128,0>": {"HMMA": 0, "FFMA": 1, "LDS": 2},
        "fwd_fp32_kernel<128,1>": {"HMMA": 0, "FFMA": 3, "LDS": 1}}
    fwd = f"{ns}10fwd_kernelIfLi64ELi64ELi64ELb0EEEvPKT_"
    assert cs._short_kernel(fwd) == fwd
    # the FMA route's bf16 backward on the tensor cores, by head dim and Mask
    for mangled, short in (
            (f"{ns}13dq_mma_kernelILi256ELb1EEEvPK13__nv_bfloat16S3_S3_S3_"
             "PKfS5_PS1_N3ptk4DimsEfiNS7_7DropoutENS7_4MaskE",
             "dq_mma_kernel<256,1>"),
            (f"{ns}14dkv_mma_kernelILi64ELb0EEEvPK13__nv_bfloat16S3_S3_S3_"
             "PKfS5_PS1_S6_N3ptk4DimsEfiNS7_7DropoutENS7_4MaskE",
             "dkv_mma_kernel<64,0>")):
        assert cs._short_kernel(mangled) == short


def test_fp32_flash_bound_takes_products_at_3xtf32_beside_ffma():
    """chip_smoke.py's flash bound takes fp32 products at 3xTF32's
    495 / 3 TFLOP/s, the fastest product of fp32 operands the card has (and
    sdpa's), so no fp32 kernel can read above 100 % of it; the FMA
    kernels' own ceiling, FFMA's 67 TFLOP/s, on request. At the BERT
    oracle's shape (B2 S512 H16 D64 fp32, its [2, 1, 1, 512] key bias) dq
    does 6 D flops a pair, 3.22 GFLOP: 0.0195 ms at 165 TFLOP/s, 0.0481 at
    67, both bound by operations."""
    cs = _chip_smoke()
    shape = ("dq", 2, 512, 512, 16, 16, 64, torch.float32, False, 2 * 512 * 4)
    flops = 6 * 64 * 2 * 16 * 512 * 512
    ms, by = cs.flash_bound(*shape)
    assert by == "operations"
    assert ms == pytest.approx(flops / (495e12 / 3) * 1e3)
    ms_ffma, by_ffma = cs.flash_bound(*shape, peak=cs.FP32_FLOPS)
    assert by_ffma == "operations"
    assert ms_ffma == pytest.approx(flops / 67e12 * 1e3)
    assert (round(ms, 4), round(ms_ffma, 4)) == (0.0195, 0.0481)


def test_fp32_oracle_attention_is_checked_and_timed():
    """chip_smoke.py holds and times the FMA route at the attention of the
    GPT-2 and Llama fp32 oracles, beside BERT's: one causal row of 1024
    tokens with GPT-2 small's heads (12 of 64) and the 0.7B Llama's (16 of
    128, no GQA), the shapes their dq and dkv launches run at."""
    from paddle_tpu_torch.models import gpt2_small
    cs = _chip_smoke()
    gpt, llama = gpt2_small(), cs._llama_cfg(num_layers=2)
    cases = {c[0]: c[:10] for c in cs.FLASH_CASES}
    assert cases["gpt2-oracle-fp32"] == (
        "gpt2-oracle-fp32", 1, gpt.max_position_embeddings,
        gpt.max_position_embeddings, gpt.num_heads, gpt.num_heads,
        gpt.hidden_size // gpt.num_heads, torch.float32, True, 0.0)
    assert cases["llama-oracle-fp32"] == (
        "llama-oracle-fp32", 1, 1024, 1024, llama.num_heads,
        llama.num_kv_heads, llama.hidden_size // llama.num_heads,
        torch.float32, True, 0.0)
    timed = {t[0]: t[1:] for t in cs.FLASH_TIMED}
    for key, case in (("bert_oracle_fp32", "bert-oracle-keymask-fp32"),
                      ("gpt2_oracle_fp32", "gpt2-oracle-fp32"),
                      ("llama_oracle_fp32", "llama-oracle-fp32")):
        assert timed[key] == (case, cs.FMA_KINDS)
        assert tfa.flash_route(torch.float32, cases[case][6]) == "fma"


def test_bf16_fma_route_backward_is_counted_checked_and_timed():
    """chip_smoke.py counts the FMA route's bf16 dq and dkv
    (dq_mma_kernel, dkv_mma_kernel) on their own counters, beside the
    forward's, and puts them on the kernels line; it times them at
    Gemma-7B's attention (D = 256) and at BERT's with its key mask and
    dropout (their Mask instantiations); its last flash case takes their
    Mask instantiations at D = 256 with a dbias, so that the earlier
    cases keep their draws. No main path expects a launch of them."""
    cs = _chip_smoke()
    wrappers = cs._wrappers()
    for kind in ("fwd", "dq", "dkv"):
        w = getattr(tfa, "flash_" + kind)
        assert wrappers[f"flash_{kind}_mma"] is w.mma
        assert wrappers[f"flash_{kind}_mma_bias"] is w.mma_bias
    timed = {t[0]: t[1:] for t in cs.FLASH_TIMED}
    assert timed["gemma7b_d256"] == ("gemma7b-d256", cs.FMA_KINDS)
    assert set(cs.FMA_KINDS) <= set(timed["bert"][1])
    last = cs.FLASH_CASES[-1]
    assert last[0] == "d256-full-bias-dbias-bf16" and last[6] == 256
    assert last[7] == torch.bfloat16 and last[10] == {"bias": "full"}
    assert tfa.flash_route(torch.bfloat16, last[6]) == "fma"
    expect = cs._expected_counts(2, 3, "wgmma")
    assert all(expect[f"flash_{kind}_mma{sfx}"] == 0 for kind in
               ("fwd", "dq", "dkv") for sfx in ("", "_bias"))


def test_fp32_case_with_rows_off_16_bytes_is_checked():
    """chip_smoke.py holds the FMA route's fp32 forward, dq and dkv at a
    head dim that is not a multiple of 4: no row of q, k or v then starts
    on a 16-byte boundary, so ``rows16`` cannot hold and the register-
    blocked fp32 kernels copy their tiles by 4-byte cp.async. The case
    has ragged q and k tiles, causal and GQA, and takes DP = 64."""
    cs = _chip_smoke()
    cases = {c[0]: c for c in cs.FLASH_CASES}
    name, b, sq, sk, hq, hk, d, dtype, causal, rate = cases["d50-ragged-fp32"]
    assert dtype == torch.float32 and d % 4 != 0 and 64 < d * 2 <= 128
    assert sq % 64 and sk % 64 and causal and hq != hk and rate == 0.0
    assert tfa.flash_route(dtype, d) == "fma"


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::fwd_sm90_kernel<128, 0, false>(...)",
     "flash fwd wgmma kernel"),
    ("void (anonymous namespace)::fwd_fp32_kernel<64, true>(...)",
     "flash fwd kernel"),
    ("void (anonymous namespace)::fwd_kernel<float, 256, 32, 32, false>"
     "(...)", "flash fwd kernel"),
    ("void (anonymous namespace)::fwd_overlap_sm90_kernel<128>(...)",
     "flash fwd wgmma kernel"),
    ("void (anonymous namespace)::dq_sm90_kernel<128, false, 0, false>(...)",
     "flash dq wgmma kernel"),
    ("void (anonymous namespace)::dkv_sm90_kernel<64, false, 0, false>(...)",
     "flash dkv wgmma kernel"),
    ("void (anonymous namespace)::dkv128_sm90_kernel<false, 0, false>(...)",
     "flash dkv wgmma kernel"),
    ("void (anonymous namespace)::softmax_xent_fwd_kernel<1>(...)",
     "CE fwd kernel"),
    ("void (anonymous namespace)::dkv_kernel<float, 0>(...)",
     "flash dkv kernel"),
    ("void (anonymous namespace)::dq_fp32_kernel<64, true>(...)",
     "flash dq kernel"),
    ("void (anonymous namespace)::dkv_fp32_kernel<128, false>(...)",
     "flash dkv kernel")])
def test_train_profile_class_of_each_kernel(name, cls):
    """chip_smoke.py's train-step breakdown puts each flash kernel, the
    D = 128 dkv's own name included, in its class (not elementwise)."""
    assert _chip_smoke()._train_kernel_class(name) == cls


# ---------------------------------------------------------------------------
# additive bias, dbias and segment ids, against the reference's
# flash_attention_ext in interpret mode (tests/test_pallas_flash_attention.py
# holds those Pallas kernels to a dense oracle at the same tolerances)
# ---------------------------------------------------------------------------

REF_FWD = dict(rtol=3e-5, atol=3e-5)
REF_BWD = dict(rtol=3e-4, atol=3e-4)
_SEED0 = np.zeros((1,), np.int32)


def _ref_ext(q, k, v, do, bias=None, seed=_SEED0, seg=None, causal=True,
             scale=None, rate=0.0):
    """The reference's out and (dq, dk, dv[, dbias])."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    qs, ks = (None, None) if seg is None else (jnp.asarray(seg[0]),
                                               jnp.asarray(seg[1]))
    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    def f(*a):
        return jfa.flash_attention_ext(
            a[0], a[1], a[2], a[3] if bias is not None else None,
            jnp.asarray(seed), qs, ks, causal, scale, rate, 128, 128, True)
    out, vjp = jax.vjp(f, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_ext(q, k, v, do, bias=None, seed=_SEED0, seg=None, causal=True,
              scale=None, rate=0.0):
    """The port's out and (dq, dk, dv[, dbias]) through autograd."""
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    qs, ks = (None, None) if seg is None else map(torch.from_numpy, seg)
    out = tfa.flash_attention_ext(*ts, bias=tb, seed=torch.from_numpy(seed),
                                  q_seg=qs, k_seg=ks, causal=causal,
                                  scale=scale, dropout_rate=rate)
    out.backward(torch.from_numpy(do))
    grads = [t.grad for t in ts] + ([tb.grad] if tb is not None else [])
    return out.detach().numpy(), [g.numpy() for g in grads]


def _hold(got, ref):
    np.testing.assert_allclose(got[0], ref[0], **REF_FWD)
    assert len(got[1]) == len(ref[1])
    for i, (g, r) in enumerate(zip(got[1], ref[1])):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, err_msg=f"grad {i}", **REF_BWD)


def _qkvdo(b, sq, sk, hq, hk, d, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.standard_normal(s) * scale).astype(  # noqa: E731
        np.float32)
    return mk(b, sq, hq, d), mk(b, sk, hk, d), mk(b, sk, hk, d), \
        mk(b, sq, hq, d)


@pytest.mark.parametrize("bshape", [(2, 4, 256, 256), (1, 4, 256, 256),
                                    (2, 1, 1, 256), (256, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bias_matches_reference(bshape):
    """test_bias_in_kernel's four bias shapes (full, broadcast batch, the
    additive key mask's [B,1,1,S], 2-D): out, dq, dk, dv and dbias, the
    full one from the dq pass and the others summed by
    flash_dbias_broadcast."""
    q, k, v, do = _qkvdo(2, 256, 256, 4, 2, 64, seed=3)
    bias = (np.random.RandomState(4).standard_normal(bshape) * 0.5).astype(
        np.float32)
    _hold(_port_ext(q, k, v, do, bias), _ref_ext(q, k, v, do, bias))


@pytest.mark.parametrize("bshape", [(2, 2, 128, 128), (1, 2, 128, 128)],
                         ids=["full", "broadcast"])
def test_bias_with_dropout_matches_reference(bshape):
    """Dropout under a bias: the same keep-mask bit for bit, in the
    forward, the dq and dkv passes and both dbias paths."""
    q, k, v, do = _qkvdo(2, 128, 128, 2, 2, 32, seed=8)
    bias = (np.random.RandomState(9).standard_normal(bshape) * 0.5).astype(
        np.float32)
    seed = np.asarray([-987654], np.int32)
    _hold(_port_ext(q, k, v, do, bias, seed=seed, causal=False, rate=0.2),
          _ref_ext(q, k, v, do, bias, seed=seed, causal=False, rate=0.2))


def _packed_segments(lens, h, d=64, seed=11):
    total = sum(lens)
    q, k, v, do = _qkvdo(1, total, total, h, h, d, seed, scale=0.3)
    seg = np.repeat(np.arange(len(lens), dtype=np.int32), lens)[None, :]
    return q, k, v, do, seg


@pytest.mark.parametrize("hq,hk,causal", [(2, 2, False), (2, 2, True),
                                          (4, 2, True)])
def test_segments_match_reference(hq, hk, causal):
    """TestVarlenSegments's packing (lengths 5, 9, 2), MHA and GQA,
    causal (each segment's own diagonal) and not: out, dq, dk, dv."""
    q, k, v, do, seg = _packed_segments([5, 9, 2], hq)
    k, v = np.ascontiguousarray(k[:, :, :hk]), np.ascontiguousarray(
        v[:, :, :hk])
    _hold(_port_ext(q, k, v, do, seg=(seg, seg), causal=causal),
          _ref_ext(q, k, v, do, seg=(seg, seg), causal=causal))


def test_varlen_causal_ragged_qk_lengths_match_reference():
    """test_varlen_causal_ragged_qk_lengths: q segments of 2 and 4 over k
    segments of 4 and 4, so each segment has its own (Lk - Lq) diagonal,
    which one global diagonal would get wrong for the second."""
    q, _, _, do = _qkvdo(1, 6, 6, 2, 2, 64, seed=13, scale=0.3)
    _, k, v, _ = _qkvdo(1, 8, 8, 2, 2, 64, seed=14, scale=0.3)
    seg_q = np.repeat(np.arange(2, dtype=np.int32), [2, 4])[None, :]
    seg_k = np.repeat(np.arange(2, dtype=np.int32), [4, 4])[None, :]
    _hold(_port_ext(q, k, v, do, seg=(seg_q, seg_k)),
          _ref_ext(q, k, v, do, seg=(seg_q, seg_k)))


def test_encode_segments_matches_reference():
    seg = np.array([[0, 0, 0, 1, 4, 4, 7, 7, 7, 7],
                    [2, 2, 2, 2, 2, 2, 2, 2, 2, 3]], np.int32)
    ref = np.asarray(jfa._encode_seg(jnp.asarray(seg)))
    np.testing.assert_array_equal(
        tfa.encode_segments(torch.from_numpy(seg)).numpy(), ref)


@pytest.mark.parametrize("cover", [10, 7], ids=["all", "tail-uncovered"])
def test_flash_attn_unpadded_matches_reference(cover):
    """The packed API ([total, H, D] + cu_seqlens) against the
    reference's, per-segment causal; with ``cover`` < 10 the last q
    tokens lie past cu_seqlens[-1] and k/v hold only the covered ones:
    those rows see no key and give 0."""
    from paddle_tpu.nn.functional.flash_attention import \
        flash_attn_unpadded as jax_unpadded
    rng = np.random.RandomState(15)
    q, k, v = (rng.standard_normal((10, 2, 32)).astype(np.float32)
               for _ in range(3))
    k, v = k[:cover], v[:cover]
    cu = np.array([0, 3, cover], np.int32)
    scale = 1.0 / math.sqrt(32)
    ref, _ = jax_unpadded(*(paddle.to_tensor(x) for x in (q, k, v, cu, cu)),
                          cover, cover, scale, causal=True)
    got, sm = TF.flash_attn_unpadded(*(torch.from_numpy(x)
                                       for x in (q, k, v, cu, cu)),
                                     cover, cover, scale, causal=True)
    assert sm is None
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **REF_FWD)
    if cover < 10:
        assert (got.numpy()[cover:] == 0).all()


def test_rows_masked_by_an_infinite_bias_give_zero_and_finite_grads():
    """A bias whose chosen rows are all -inf: those rows see no key, so
    out = 0 and lse = -inf, and no gradient (dbias included) is NaN; the
    rest matches the reference."""
    q, k, v, do = _qkvdo(1, 64, 80, 2, 2, 32, seed=16)
    bias = (np.random.RandomState(17).standard_normal((1, 2, 64, 80))
            * 0.5).astype(np.float32)
    dead = [3, 40]
    bias[:, :, dead] = -np.inf
    got = _port_ext(q, k, v, do, bias, causal=False)
    _hold(got, _ref_ext(q, k, v, do, bias, causal=False))
    assert (got[0][:, dead] == 0).all()
    assert all(np.isfinite(g).all() for g in got[1])
    assert (got[1][0][:, dead] == 0).all() and (got[1][3][:, :, dead] == 0).all()
    _, lse = tfa.flash_fwd_plain(*_t(q, k, v), False, 1 / math.sqrt(32),
                                 bias=torch.from_numpy(bias))
    assert torch.isneginf(lse[:, :, dead]).all()


def _card_branch_on_the_cpu(monkeypatch, planted):
    """Run the wrappers' card branch on CPU tensors: dispatch always takes
    the launch function, and the launches run the plain versions; a dq
    launch asked for dbias plants ``planted`` into it (a fault a wrong
    kernel could carry). Returns the dbias flags the dq launches got."""
    asked = []

    def dq_launch(q, k, v, do, lse, delta, causal, scale, rate, seed,
                  bias=None, seg=None, dbias=False):
        asked.append(dbias)
        out = tfa.flash_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                 rate, seed, bias, seg, dbias)
        return (out[0], out[1] + planted) if dbias else out
    monkeypatch.setattr(_build, "dispatch",
                        lambda plain, launch, *a: launch(*a))
    monkeypatch.setattr(tfa, "_fwd_launch", tfa.flash_fwd_plain)
    monkeypatch.setattr(tfa, "_dq_launch", dq_launch)
    monkeypatch.setattr(tfa, "_dkv_launch", tfa.flash_dkv_plain)
    return asked


def test_forward_bias_class_reaches_the_c_entry_from_the_ext(monkeypatch):
    """On the card branch (dispatch takes the launch, the library records
    its calls), ``flash_attention_ext``'s forward hands ``flash_fwd_sm90``
    the bias class ``flash_bias_class`` picks: 1 ("keys") for BERT's
    [B,1,1,S] mask, counted on ``flash_fwd.wgmma_keybias``; 0 ("plane")
    for a bias that varies along queries and for a key mask with
    segments, counted on ``flash_fwd.wgmma_bias``."""
    libs = {n: _fake_library(n)
            for n in ("flash_attention", "flash_attention_sm90")}
    monkeypatch.setattr(_build, "load", libs.__getitem__)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "dispatch",
                        lambda plain, launch, *a: launch(*a))
    q, k, v = _operands(torch.bfloat16, 64, 4, 2, False)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    fwd = tfa.flash_fwd
    for bias, kw, want, counter in (
            (torch.zeros(1, 1, 1, 8), {}, 1, fwd.wgmma_keybias),
            (torch.zeros(1, 1, 8, 8), {}, 0, fwd.wgmma_bias),
            (torch.zeros(1, 1, 1, 8), {"q_seg": seg, "k_seg": seg}, 0,
             fwd.wgmma_bias)):
        calls = libs["flash_attention_sm90"].calls
        calls.clear()
        counters = _all_counters()
        before = [c.launches for c in counters]
        tfa.flash_attention_ext(q, k, v, bias=bias, **kw)
        assert [fn for fn, _ in calls] == ["flash_fwd_sm90"]
        assert calls[0][1][-2] == want
        moved = [c.launches - b for c, b in zip(counters, before)]
        assert moved == [int(c is counter) for c in counters]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no-dropout", "dropout"])
def test_llama_d128_backward_takes_the_wgmma_dq_and_dkv(monkeypatch, rate):
    """On the card branch (dispatch takes the launch, the library records
    its calls), the Llama train cell's attention (bf16, D = 128, causal,
    Hq = Hk, no bias) goes by ``flash_route`` to the wgmma kernels: the
    forward, dq and dkv C entries once each, with D = 128 (their DP = 128
    instantiations), causal, bias class 0 and no bias pointer (the
    bias-free instantiations), and dropout off, or on with its threshold
    and keep scale (the DROP instantiations); each wgmma counter ticks
    once and no other counter moves."""
    libs = {n: _fake_library(n)
            for n in ("flash_attention", "flash_attention_sm90")}
    monkeypatch.setattr(_build, "load", libs.__getitem__)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "dispatch",
                        lambda plain, launch, *a: launch(*a))
    q, k, v = (torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    assert tfa.flash_route(q.dtype, 128, [t.data_ptr() for t in (q, k, v)]) \
        == "wgmma"
    seed = torch.tensor([7], dtype=torch.int32)
    counters = _all_counters()
    before = [c.launches for c in counters]
    out = tfa.flash_attention_ext(q, k, v, seed=seed if rate else None,
                                  causal=True, dropout_rate=rate)
    out.backward(torch.zeros_like(out))
    calls = libs["flash_attention_sm90"].calls
    assert [fn for fn, _ in calls] == ["flash_fwd_sm90", "flash_dq_sm90",
                                       "flash_dkv_sm90"]
    assert libs["flash_attention"].calls == []
    for fn, args in calls:
        n = {"flash_fwd_sm90": 5, "flash_dq_sm90": 7, "flash_dkv_sm90": 8}[fn]
        assert args[n:n + 6] == (1, 16, 16, 2, 2, 128), fn     # B..D
        assert args[n + 7] == 1, fn                             # causal
        assert args[n + 8] == int(rate > 0), fn                 # dropout on
        if rate:
            assert args[n + 9] == tfa.dropout_threshold(rate), fn
            assert args[n + 10] == pytest.approx(1 / (1 - rate)), fn
            assert args[n + 11] == seed.data_ptr(), fn
        assert args[n + 12] is None, fn                         # no bias
        assert args[-2] == 0, fn                                # class
    moved = [c.launches - b for c, b in zip(counters, before)]
    ticked = (tfa.flash_fwd.wgmma, tfa.flash_dq.wgmma, tfa.flash_dkv.wgmma)
    assert moved == [int(any(c is t for t in ticked)) for c in counters]


@pytest.mark.parametrize("d,rate,bias", [
    (128, 0.0, None), (128, 0.1, None), (64, 0.0, None), (64, 0.1, None),
    (64, 0.1, "keys")], ids=["llama-d128", "llama-d128-dropout", "gpt2-d64",
                             "gpt2-d64-dropout", "bert-keys-d64-dropout"])
def test_bias_free_forward_reaches_the_overlap_instantiation(monkeypatch, d,
                                                             rate, bias):
    """On the card branch (dispatch takes the launch, the library records
    its calls), a bias-free bf16 causal forward, the Llama cell's at D =
    128 and GPT-2's at D = 64, with dropout and without, hands
    ``flash_fwd_sm90`` its D, no bias pointer, no segment words and bias
    class 0: the arguments on which ``launch_fwd``
    (``csrc/flash_attention_sm90.cu``) takes ``fwd_overlap_sm90_kernel<DP>``
    (DP = 64 or 128 by D), dropout on with its threshold, keep scale and
    seed, or off; it counts on ``flash_fwd.wgmma`` alone. BERT's key mask
    ([B,1,1,S]) still reaches the "keys" instantiation
    (``fwd_sm90_kernel<64,2,0>``): its bias pointer and class 1, counted on
    ``flash_fwd.wgmma_keybias``."""
    libs = {n: _fake_library(n)
            for n in ("flash_attention", "flash_attention_sm90")}
    monkeypatch.setattr(_build, "load", libs.__getitem__)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "dispatch",
                        lambda plain, launch, *a: launch(*a))
    q, k, v = (torch.zeros(2, 16, 2, d, dtype=torch.bfloat16)
               for _ in range(3))
    mask = torch.zeros(2, 1, 1, 16) if bias else None
    seed = torch.tensor([7], dtype=torch.int32)
    counters = _all_counters()
    before = [c.launches for c in counters]
    tfa.flash_attention_ext(q, k, v, bias=mask, seed=seed if rate else None,
                            causal=bias is None, dropout_rate=rate)
    calls = libs["flash_attention_sm90"].calls
    assert [fn for fn, _ in calls] == ["flash_fwd_sm90"]
    assert libs["flash_attention"].calls == []
    args = calls[0][1]
    assert args[5:11] == (2, 16, 16, 2, 2, d)                   # B..D
    assert args[12] == int(bias is None)                        # causal
    assert args[13] == int(rate > 0)                            # dropout on
    if rate:
        assert args[14] == tfa.dropout_threshold(rate)
        assert args[15] == pytest.approx(1 / (1 - rate))
        assert args[16] == seed.data_ptr()
    assert (args[17] is None) == (bias is None)                 # bias
    assert args[22:24] == (None, None)                          # segments
    assert args[-2] == int(bias == "keys")                      # class
    moved = [c.launches - b for c, b in zip(counters, before)]
    ticked = (tfa.flash_fwd.wgmma_keybias if bias else tfa.flash_fwd.wgmma)
    assert moved == [int(c is ticked) for c in counters]


def test_dbias_is_computed_only_when_the_bias_requires_grad(monkeypatch):
    """On the card branch a bias that needs no gradient (BERT's mask)
    asks the dq kernel for no dbias, so a fault planted in the kernel's
    dbias cannot show; a full bias that requires grad takes the kernel's
    dbias (the planted fault shows in bias.grad), and a broadcast one the
    plain broadcast sum (it does not)."""
    q, k, v, do = _t(*_qkvdo(1, 32, 32, 2, 2, 16, seed=18))
    asked = _card_branch_on_the_cpu(monkeypatch, planted=1.0)
    for shape, needs, want, planted in [
            ((1, 2, 32, 32), False, [False], False),
            ((1, 2, 32, 32), True, [True], True),
            ((1, 1, 1, 32), True, [False], False)]:
        asked.clear()
        bias = torch.zeros(shape, requires_grad=needs)
        qq = q.clone().requires_grad_()
        tfa.flash_attention_ext(qq, k, v, bias=bias).backward(do)
        assert asked == want
        assert (bias.grad is not None) == needs
        if needs:
            ref = tfa.flash_dbias_broadcast(
                q, k, v, do, *_lse_delta(q, k, v, do), bias.detach(),
                False, 0.25)
            np.testing.assert_allclose(
                bias.grad.numpy(), (ref + float(planted)).numpy(),
                rtol=1e-5, atol=1e-5)


def _lse_delta(q, k, v, do):
    out, lse = tfa.flash_fwd_plain(q, k, v, False, 0.25)
    return lse, tfa._delta(do, out)


def test_chunk_entries_match_reference_and_sum_to_the_full_gradients():
    """flash_chunk_fwd / flash_chunk_bwd against the reference's on one
    chunk; and over two key chunks, merged by log-sum-exp, the chunks'
    (dq, dk, dv) under the global lse and delta sum to the full
    gradients."""
    q, k, v, do = _qkvdo(1, 96, 160, 4, 2, 32, seed=19)
    scale = 1.0 / math.sqrt(32)
    out_ref, lse_ref = jfa.flash_chunk_fwd(q, k, v, True, scale,
                                           interpret=True)
    out, lse = tfa.flash_chunk_fwd(*_t(q, k, v), True, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **REF_FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **REF_FWD)
    delta = np.einsum("bshd,bshd->bhs", do, np.asarray(out_ref))
    ref = jfa.flash_chunk_bwd(q, k, v, do, lse_ref, delta, True, scale,
                              interpret=True)
    got = tfa.flash_chunk_bwd(*_t(q, k, v, do), torch.from_numpy(
        np.array(lse_ref)), torch.from_numpy(delta), True, scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **REF_BWD)

    # two chunks of keys: [0, 100) causal-free for every row (all rows
    # see them: Sk - Sq = 64 >= 99 is false, so keep the global diagonal
    # by passing the chunks as non-causal over a non-causal whole)
    tq, tk, tv, tdo = _t(q, k, v, do)
    full_out, full_lse = tfa.flash_chunk_fwd(tq, tk, tv, False, scale)
    parts = [(tk[:, :100], tv[:, :100]), (tk[:, 100:], tv[:, 100:])]
    lses = [tfa.flash_chunk_fwd(tq, a, b, False, scale)[1]
            for a, b in parts]
    merged = torch.logsumexp(torch.stack(lses), 0)
    torch.testing.assert_close(merged, full_lse, rtol=1e-5, atol=1e-5)
    full_delta = tfa._delta(tdo, full_out)
    grads = [tfa.flash_chunk_bwd(tq, a, b, tdo, merged, full_delta, False,
                                 scale) for a, b in parts]
    dq = grads[0][0] + grads[1][0]
    dk = torch.cat([grads[0][1], grads[1][1]], 1)
    dv = torch.cat([grads[0][2], grads[1][2]], 1)
    want = tfa.flash_chunk_bwd(tq, tk, tv, tdo, full_lse, full_delta, False,
                               scale)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_launches_pass_bias_strides_segment_words_and_dbias(monkeypatch):
    """The mask arguments of each C entry: a [B,1,1,Sk] bias crosses as a
    pointer with element strides (Sk, 0, 0, 1), never expanded; a bf16
    bias is cast to fp32 first; segment words as two pointers with
    seg_causal; dq's dbias pointer only when asked for, into a zeroed fp32
    [B,Hq,Sq,Sk] buffer."""
    libs = {n: _fake_library(n)
            for n in ("flash_attention", "flash_attention_sm90")}
    monkeypatch.setattr(_build, "load", libs.__getitem__)
    monkeypatch.setattr(_build, "stream", lambda t: ctypes.c_void_p(0))
    q, k, v = _operands(torch.bfloat16, 64, 4, 2, False)
    do = q.clone()
    lse = torch.zeros(1, 4, 8)
    bias = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    words = tfa.encode_segments(torch.zeros(1, 8, dtype=torch.int32))
    seg = tfa.Segments(words, words, True)
    tfa._fwd_launch(q, k, v, False, 0.125, 0.0, None, bias, seg)
    _, db = tfa._dq_launch(q, k, v, do, lse, lse, False, 0.125, 0.0, None,
                           bias, seg, True)
    tfa._dq_launch(q, k, v, do, lse, lse, False, 0.125, 0.0, None, bias)
    calls = libs["flash_attention_sm90"].calls
    assert [fn for fn, _ in calls] == ["flash_fwd_sm90", "flash_dq_sm90",
                                       "flash_dq_sm90"]
    for fn, args in calls:
        n = 5 if fn == "flash_fwd_sm90" else 7
        mask = args[n + 12:n + 20]
        assert mask[0] and tuple(mask[1:5]) == (8, 0, 0, 1)
    fwd_mask = calls[0][1][5 + 12:5 + 20]
    assert fwd_mask[5] == words.data_ptr() and fwd_mask[7] == 1
    assert calls[1][1][7 + 20] == db.data_ptr()
    assert calls[2][1][7 + 20] is None and calls[2][1][7 + 17] is None
    assert db.dtype == torch.float32 and tuple(db.shape) == (1, 4, 8, 8)
    assert not db.any()
    # the bias class: a [1,1,1,Sk] bias takes "keys", with segments or
    # dbias "plane"
    assert calls[0][1][5 + 20] == 0
    assert calls[1][1][7 + 21] == 0 and calls[2][1][7 + 21] == 1


# ---------------------------------------------------------------------------
# the wgmma dq and dkv kernels' bias classes
# ---------------------------------------------------------------------------

def _class_of(shape, b=2, hq=4, sq=16, sk=24, **kw):
    b4 = tfa._bias4(torch.zeros(shape), b, hq, sq, sk)
    return tfa.flash_bias_class(b4.shape, b4.stride(), **kw)


@pytest.mark.parametrize("shape,sq,kw,want", [
    ((2, 1, 1, 24), 16, {}, "keys"),            # BERT's padding mask
    ((1, 4, 1, 24), 16, {}, "keys"),
    ((2, 4, 1, 24), 16, {}, "keys"),
    ((24,), 16, {}, "keys"),
    ((2, 1, 1, 24), 1, {}, "keys"),             # Sq = 1, query stride 24
    ((2, 4, 16, 24), 16, {}, "plane"),
    ((2, 1, 16, 24), 16, {}, "plane"),
    ((2, 4, 16, 1), 16, {}, "plane"),           # varies along queries
    ((2, 1, 1, 24), 16, {"segments": True}, "plane"),
    ((2, 4, 1, 24), 1, {"dbias": True}, "plane"),
], ids=["B11S", "1H1S", "BH1S", "S", "one-query", "BHSS", "B1SS", "BHS1",
        "segments", "dbias"])
def test_flash_bias_class(shape, sq, kw, want):
    """"keys" for a bias that does not vary along queries (query stride 0
    or Sq = 1), "plane" for every other bias and for any call with
    segments or a dbias output. The forward, dq and dkv follow this one
    rule (the forward never asks for dbias)."""
    if shape == (2, 1, 1, 24) and sq == 1:
        b4 = tfa._bias4(torch.zeros(shape), 2, 4, 1, 24)
        assert b4.stride()[2] != 0
    assert _class_of(shape, sq=sq, **kw) == want
    with pytest.raises(ValueError):
        tfa.flash_bias_class((2, 24), (24, 1))


_SM90_SRC = os.path.join(os.path.dirname(tfa.__file__), "csrc",
                         "flash_attention_sm90.cu")


def _sm90_source():
    with open(_SM90_SRC) as f:
        return f.read()


def _cu_index_fn(name):
    """The source's ``__device__ int name(int ...) { return expr; }`` as a
    Python function. Its expression uses only *, +, >> and & on
    non-negative ints, whose precedence and values Python shares with C."""
    m = re.search(r"__device__ __forceinline__ int " + name +
                  r"\(([^)]*)\) \{\s*return ([^;]+);\s*\}", _sm90_source())
    assert m, name
    args = [a.split()[-1] for a in m.group(1).split(",")]
    expr = " ".join(m.group(2).split())
    assert re.fullmatch(r"[\w\s*+&>()]+", expr), expr
    return eval("lambda %s: %s" % (", ".join(args), expr))


def _keys_reads(kernel):
    """The "keys" read pattern of the forward's or dq's source: (tile of
    keys BK, stages, the slot function, the value a key past Sk gets, the
    consumer's byte offset per column group l & 3 and per float4 m),
    parsed from its tile struct and its kernel body; the consumer's loads
    must cover its BK / 16 float4 once each."""
    src = _sm90_source()
    tile = {"fwd": "FwdTile", "dq": "DqTile"}[kernel]
    m = re.search(r"struct " + tile + r" \{\s*static constexpr int BQ = \d+, "
                  r"BK = (\d+), STAGES = (\d+)", src)
    assert m, tile
    bk, stages = int(m.group(1)), int(m.group(2))
    body = src.split(f"{kernel}_sm90_kernel(")[1].split("_sm90_kernel(")[0]
    m = re.search(r"kb_addr =[^;]*smem_u32\(kbias \+ s \* BK\) \+ (\d+) \* "
                  r"\(l & 3\)[^;]*;", body)
    assert m, kernel
    group_off = int(m.group(1))
    loops = re.findall(r"for \(int (\w+) = ([^;]+); \1 < ([^;]+); \+\+\1\) "
                       r"kb4\[\1\] = lds_f4\(kb_addr \+ (\d+) \* \1\);", body)
    assert loops, kernel
    read = []
    for _, lo, hi, _ in loops:                # C's / on positive ints
        assert all(re.fullmatch(r"[\w\s/]+", e) for e in (lo, hi))
        read += range(*(eval(e.replace("/", "//"), {"BK": bk})
                        for e in (lo, hi)))
    assert sorted(read) == list(range(bk // 16))
    assert len({off for *_, off in loops}) == 1
    slot_fn = re.search(r"kbias\[s \* BK \+ (\w+)\(", body)
    assert slot_fn, kernel
    pad = (-np.inf if re.search(r"key < dm\.Sk \? key_bias\([^)]*\) : "
                                r"-INFINITY;", body) else 0.0)
    return (bk, stages, _cu_index_fn(slot_fn.group(1)), pad, group_off,
            int(loops[0][3]))


@pytest.mark.parametrize("kernel", ["dq", "fwd"])
@pytest.mark.parametrize("sk", [512, 333, 130])
@pytest.mark.parametrize("shape", ["B11S", "1H1S"])
def test_keys_class_read_pattern_gives_each_key_its_bias(sk, shape, kernel):
    """The "keys" kernels' reads, emulated over the flat fp32 buffer the
    wrapper passes (offsets b*sb + h*sh + key*sk): in dq (the forward) the
    producer warp fills each of the 4 (2) stages with 64 (128) key biases
    (0, in the forward -inf, past Sk), key j = lane + 32 rr at slot(j),
    and a consumer thread
    (w, l) reads its 16 (32) floats as 4 (8) float4 at the byte offset
    the source gives per column group l & 3 and per float4 m, element e
    of column pair i at float4 i >> 1, element 2 (i & 1) + e, for its
    columns frag_col(l, i, e); in dkv each thread holds the biases of its
    keys frag_row(w, l, 0 and 2) of its warpgroup. Every value read
    equals _bias4(...)[b, h, 0, key], and the pad past Sk; the slots of a
    tile
    are a permutation; the forward's four column groups read 64
    neighbouring bytes per float4 (no bank conflict). The slot function,
    frag_col, frag_row, the tile struct and the consumer's byte offsets
    are read from the CUDA source, so a change to a kernel's layout fails
    here."""
    bk, stages, slot, pad, group_off, m_off = _keys_reads(kernel)
    _frag_col = _cu_index_fn("frag_col")
    _frag_row = _cu_index_fn("frag_row")
    assert (bk, stages, pad) == {"dq": (64, 4, 0.0),
                                 "fwd": (128, 2, -np.inf)}[kernel]
    assert sorted(slot(j) for j in range(bk)) == list(range(bk))
    if kernel == "fwd":
        for m in range(bk // 16):
            assert sorted(group_off * g + m_off * m for g in range(4)) == \
                list(range(64 * m, 64 * m + 64, 16))
    b, hq, sq = 2, 4, 7
    rng = np.random.RandomState(sk)
    bshape = (b, 1, 1, sk) if shape == "B11S" else (1, hq, 1, sk)
    bias = torch.from_numpy(rng.standard_normal(bshape).astype(np.float32))
    b4 = tfa._bias4(bias, b, hq, sq, sk)
    assert tfa.flash_bias_class(b4.shape, b4.stride()) == "keys"
    flat = bias.reshape(-1)
    sb, sh, _, skk = b4.stride()

    def key_bias(bi, h, key, past=0.0):
        return float(flat[bi * sb + h * sh + key * skk]) if key < sk else past

    want = lambda bi, h, key, past=0.0: (  # noqa: E731
        float(b4[bi, h, 0, key]) if key < sk else past)
    nk = -(-sk // bk)
    for bi in range(b):
        for h in range(hq):
            stage = np.full((stages, bk), np.nan, np.float32)
            for kt in range(nk):                       # producer, then
                s = kt % stages                        # both consumers
                for lane in range(32):
                    for rr in range(bk // 32):
                        j = lane + 32 * rr
                        stage[s, slot(j)] = key_bias(bi, h, kt * bk + j, pad)
                for w in range(4):
                    for lane in range(32):
                        f4 = [stage[s, o // 4:o // 4 + 4] for o in (
                            group_off * (lane & 3) + m_off * m
                            for m in range(bk // 16))]
                        for i in range(bk // 8):
                            for e in range(2):
                                got = f4[i >> 1][2 * (i & 1) + e]
                                assert got == np.float32(want(
                                    bi, h, kt * bk + _frag_col(lane, i, e),
                                    pad))
            if kernel != "dq":
                continue
            for kt0 in range(0, nk * bk, 128):         # dkv: per CTA of 128
                for cw in range(2):                    # keys, two consumers
                    for w in range(4):
                        for lane in range(32):
                            for r in range(2):
                                key = kt0 + 64 * cw + _frag_row(w, lane, 2 * r)
                                assert key_bias(bi, h, key) == want(bi, h, key)

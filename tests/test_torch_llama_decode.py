"""PyTorch port: Llama decode path (paddle_tpu_torch/models) against
paddle_tpu on the CPU.

llama_tiny widened to hidden_size=128 (4 heads, 2 KV heads: GQA 4:2,
head_dim 32), so paddle_tpu's RMSNorm dispatch takes its Pallas kernel,
run in interpret mode (FLAGS_pallas_force_interpret). Weights carry
across by name through models/convert.py; token inputs are numpy.
Logits agree to atol=1e-4 (fp32; the two frameworks sum in different
orders), the tolerance of paddle_tpu's own decode parity tests.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as _flags
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import decode as jdecode
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import decode as jsdecode
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     state_dict_from_numpy)
from paddle_tpu_torch.models import decode as tdecode
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.serving import decode as tsdecode

ATOL = 1e-4


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


@pytest.fixture(scope="module")
def models():
    prev = _flags.get_flag("pallas_force_interpret")
    _flags.set_flags({"pallas_force_interpret": True})
    try:
        paddle.seed(0)
        cfg = jax_llama_tiny()
        cfg.hidden_size = 128
        jm = JaxLlama(cfg)
        jm.eval()
        tcfg = llama_tiny()
        tcfg.hidden_size = 128
        tm = LlamaForCausalLM(tcfg, device="cpu")
        state_dict_from_numpy(tm, {k: v.numpy()
                                   for k, v in jm.state_dict().items()})
        yield jm, tm
    finally:
        _flags.set_flags({"pallas_force_interpret": prev})


def test_contiguous_prefill_and_six_steps(models):
    jm, tm = models
    prompt = np.random.RandomState(3).randint(0, 256, (7,)).astype(np.int32)
    jc = jm.init_decode_cache(1, 32)
    tc = tm.init_decode_cache(1, 32)
    zero = np.zeros((1,), np.int32)
    jl, jc = jm.decode_step(prompt[None], zero, jc)
    tl, tc = tm.decode_step(prompt[None], zero, tc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    t, pos = int(np.argmax(_np(jl)[0, -1])), len(prompt)
    for _ in range(6):
        tok, p = np.asarray([[t]], np.int32), np.asarray([pos], np.int32)
        jl, jc = jm.decode_step(tok, p, jc)
        tl, tc = tm.decode_step(tok, p, tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
        t, pos = int(np.argmax(_np(jl)[0, 0])), pos + 1


def test_paged_across_page_boundary(models):
    """page_len=4, prompt 6 in prefill bucket 8, then 6 steps: positions
    6..11 cross the page boundary at 8 (a third page is allocated)."""
    jm, tm = models
    meta = tm.decode_meta()
    assert meta == jm.decode_meta()
    prompt = np.random.RandomState(5).randint(0, 256, (6,)).astype(np.int32)
    page_len = 4
    alloc = tsdecode.PageAllocator(8)
    pages = alloc.alloc(2)
    args = (meta["num_layers"], 8, page_len, meta["num_kv_heads"],
            meta["head_dim"])
    jpools = jsdecode.init_paged_cache(*args)
    tpools = tsdecode.init_paged_cache(*args, device="cpu")

    def step(tok, pos):
        nonlocal jpools, tpools
        rows = tsdecode.page_table_array([pages], len(pages))
        p = np.asarray([pos], np.int32)
        jl, jpools = jm.decode_step(tok, p, jpools,
                                    kv_ops=jsdecode.PagedKV(rows, page_len))
        tl, tpools = tm.decode_step(
            tok, p, tpools, kv_ops=tsdecode.PagedKV(rows, page_len, "cpu"))
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
        return _np(jl)

    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = prompt
    t, pos = int(np.argmax(step(toks, 0)[0, 5])), 6
    for _ in range(6):
        if pos >= len(pages) * page_len:
            pages.extend(alloc.alloc(1))
        t, pos = int(np.argmax(step(np.asarray([[t]], np.int32), pos)[0, 0])
                     ), pos + 1
    assert len(pages) == 3


def test_batched_slots_at_different_positions(models):
    """Two slots prefilled together, the shorter right-padded: each
    slot's last real position matches paddle_tpu."""
    jm, tm = models
    rng = np.random.RandomState(4)
    toks = np.zeros((2, 9), np.int32)
    toks[0, :3] = rng.randint(0, 256, (3,))
    toks[1] = rng.randint(0, 256, (9,))
    zero = np.zeros((2,), np.int32)
    jl, _ = jm.decode_step(toks, zero, jm.init_decode_cache(2, 32))
    tl, _ = tm.decode_step(toks, zero, tm.init_decode_cache(2, 32))
    np.testing.assert_allclose(tl.numpy()[0, 2], _np(jl)[0, 2], atol=ATOL)
    np.testing.assert_allclose(tl.numpy()[1, 8], _np(jl)[1, 8], atol=ATOL)


def test_full_context_forward_matches(models):
    jm, tm = models
    ids = np.random.RandomState(6).randint(0, 256, (2, 11))
    ref = jm(paddle.to_tensor(ids.astype(np.int64))).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_rope_and_attention_helpers_match():
    rng = np.random.RandomState(7)
    q = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 5, 2, 32)).astype(np.float32)
    pos = np.asarray([0, 2], np.int32)
    from paddle_tpu.models.llama import _rope_tables as jax_rope_tables
    jcos, jsin = jax_rope_tables(16, 32, 10000.0)
    tcos, tsin = _rope_tables(16, 32, 10000.0, device="cpu")
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))
    jq, jk = jdecode.apply_rope_at(q, k[:, :3], jcos, jsin, pos)
    tq, tk = tdecode.apply_rope_at(torch.from_numpy(q),
                                   torch.from_numpy(k[:, :3]), tcos, tsin,
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), _np(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=1e-6, atol=1e-6)
    ja = jdecode.decode_attention(q, k, v, pos)
    ta = tdecode.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_convert_refuses_mismatched_state(fault):
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    arrays = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    before = tm.lm_head.weight.detach().clone()
    arrays["lm_head.weight"] += 1.0
    if fault == "missing":
        arrays.pop("model.norm.weight")
    elif fault == "unexpected":
        arrays["model.extra.weight"] = np.zeros(3, np.float32)
    else:
        arrays["model.norm.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        state_dict_from_numpy(tm, arrays)
    assert torch.equal(tm.lm_head.weight, before)    # nothing was copied

"""PyTorch port: GPT-2 decode (paddle_tpu_torch/models/gpt.py
``decode_step``) and its serving through DecodeServer, against paddle_tpu
on the CPU; and the embedding's handling of ids outside the table.

gpt2_tiny (2 layers, width 64, 4 heads, vocab 512, 128 positions) with
paddle_tpu's weights carried across by name (models/convert.py). On the
CPU paddle_tpu's GPT takes its XLA LayerNorm (the width is under its
Pallas gate) and the port the plain version of the LayerNorm kernel.
Logits agree to atol 1e-4 (fp32, sums in another order), the tolerance
of paddle_tpu's own decode parity tests; greedy server tokens must be
identical.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.serving import decode as jsdecode
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.models import (GPTForCausalLM, gpt2_tiny,
                                     state_dict_from_numpy)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.serving import decode as tsdecode

ATOL = 1e-4


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt2_tiny())
    jm.eval()
    tm = GPTForCausalLM(gpt2_tiny(), device="cpu")
    tm.eval()
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    return jm, tm


def test_decode_meta_and_cache_match(models):
    jm, tm = models
    assert tm.decode_meta() == jm.decode_meta()
    (k, v), = tm.init_decode_cache(1, 16)[:1]
    jk, _ = jm.init_decode_cache(1, 16)[0]
    assert tuple(k.shape) == tuple(np.shape(jk)) and k.device.type == "cpu"


def test_prefill_and_three_decode_steps(models):
    jm, tm = models
    prompt = np.random.RandomState(3).randint(0, 512, (7,)).astype(np.int32)
    jc, tc = jm.init_decode_cache(1, 32), tm.init_decode_cache(1, 32)
    zero = np.zeros((1,), np.int32)
    jl, jc = jm.decode_step(prompt[None], zero, jc)
    tl, tc = tm.decode_step(prompt[None], zero, tc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    t, pos = int(np.argmax(_np(jl)[0, -1])), len(prompt)
    for _ in range(3):
        tok, p = np.asarray([[t]], np.int32), np.asarray([pos], np.int32)
        jl, jc = jm.decode_step(tok, p, jc)
        tl, tc = tm.decode_step(tok, p, tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
        t, pos = int(np.argmax(_np(jl)[0, 0])), pos + 1


def test_positions_past_the_table_clamp_as_in_reference(models):
    """A prefill bucket that runs past wpe's 128 rows: positions 125..129
    read rows 125, 126, 127, 127, 127 on both sides."""
    jm, tm = models
    toks = np.random.RandomState(4).randint(0, 512, (2, 5)).astype(np.int32)
    pos = np.asarray([125, 0], np.int32)
    jl, _ = jm.decode_step(toks, pos, jm.init_decode_cache(2, 136))
    tl, _ = tm.decode_step(toks, pos, tm.init_decode_cache(2, 136))
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)


def test_greedy_server_tokens_identical_to_paddle_tpu(models):
    jm, tm = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 9, 12, 3)]
    kw = dict(max_slots=2, page_len=8, max_context=32, prefill_buckets=[16])
    with jsdecode.DecodeServer(jm, **kw) as srv:
        streams = [srv.submit(p, max_new_tokens=6) for p in prompts]
        ref = [[int(t) for t in s.result(timeout=120)] for s in streams]
    with tsdecode.DecodeServer(tm, device="cpu", **kw) as srv:
        streams = [srv.submit(p, max_new_tokens=6) for p in prompts]
        got = [[int(t) for t in s.result(timeout=120)] for s in streams]
        st = srv.stats()
    assert got == ref
    assert st["completed"] == 4 and st["tokens_generated"] == 24


@pytest.fixture
def bounds_flags():
    port = get_flags("check_index_bounds")
    ref = jflags.get_flags("check_index_bounds")
    try:
        yield
    finally:
        set_flags(port)
        jflags.set_flags(ref)


@pytest.mark.parametrize("kind", ["2d", "empty"])
def test_embedding_clamps_out_of_range_ids_as_reference(kind, bounds_flags):
    v = 4
    w = np.arange(v * 3, dtype=np.float32).reshape(v, 3)
    ids = (np.asarray([[-1, v, v + 5, 2]], np.int64) if kind == "2d"
           else np.zeros((0,), np.int64))
    ref = JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w)).numpy()
    got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, ref)
    if kind == "2d":
        np.testing.assert_array_equal(got[0], w[[0, 3, 3, 2]])
    set_flags({"check_index_bounds": True})
    jflags.set_flags({"check_index_bounds": True})
    if kind == "empty":
        assert TF.embedding(torch.from_numpy(ids),
                            torch.from_numpy(w)).shape == (0, 3)
        return
    for bad in ([[-1, 0]], [[0, v]]):
        with pytest.raises(ValueError):
            JF.embedding(paddle.to_tensor(np.asarray(bad)),
                         paddle.to_tensor(w))
        with pytest.raises(ValueError, match="out of range"):
            TF.embedding(torch.tensor(bad), torch.from_numpy(w))
    np.testing.assert_array_equal(
        TF.embedding(torch.tensor([1, 3]), torch.from_numpy(w)).numpy(),
        w[[1, 3]])

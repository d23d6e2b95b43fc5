"""PyTorch port: GPT-2 training (paddle_tpu_torch/models/{gpt,trainer}.py,
paddle_tpu_torch/optimizer) against paddle_tpu on the CPU.

gpt2_tiny (2 layers, width 64, 4 heads, vocab 512) with paddle_tpu's
weights carried across by name. On the CPU paddle_tpu's GPT takes its
XLA attention and LayerNorm (the widths are under its Pallas gates) and
the port takes its plain versions of the kernels, so these tests hold
the model and the training step, and tests/test_torch_{flash_attention,
layer_norm}.py the kernels' arithmetic. Tolerances (fp32): loss at rtol
1e-5 and gradients at atol 1e-5 (sums in another order); the 3-step
loss trajectory at rtol 1e-4; AdamW updates fed identical gradients at
atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.models import trainer as jtrainer
from paddle_tpu_torch.models import (GPTForCausalLM, create_train_step,
                                     gpt2_tiny, state_dict_from_numpy,
                                     write_back)
from paddle_tpu_torch.models import trainer as ttrainer
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam, AdamW

LR = 1e-3


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxGPT(jax_gpt2_tiny())
    tm = GPTForCausalLM(gpt2_tiny(), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 33)).astype(np.int32)
    return jm, tm, ids[:, :-1], ids[:, 1:]


def _fresh_port(jm):
    tm = GPTForCausalLM(gpt2_tiny(), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    return tm


def test_names_and_wd_mask_match(pair):
    jm, tm, _, _ = pair
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(jm.state_dict())
    assert ttrainer._wd_mask(names) == jtrainer._wd_mask(names)


def test_positions_past_the_table_clamp_as_in_the_reference(pair):
    """At S = max_position_embeddings + 8 both GPTs read positions past
    the wpe table from its last row (a clipping lookup)."""
    jm, tm, _, _ = pair
    s = gpt2_tiny().max_position_embeddings + 8
    ids = np.random.RandomState(3).randint(0, 512, (1, s))
    ref = jm(paddle.to_tensor(ids.astype(np.int64))).numpy()
    got = tm(torch.from_numpy(ids)).detach().numpy()
    assert got.shape == ref.shape == (1, s, 512)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_loss_and_grads_match_value_and_grad(pair):
    jm, tm, x, y = pair
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 parameters=jm.parameters())
    loss_call, params, _, _ = jtrainer._functional_pieces(jm, opt, None)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_call(p, jnp.asarray(x), jnp.asarray(y),
                            jax.random.key(0))))(params)
    tm.zero_grad(set_to_none=True)
    loss = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grads[n]),
                                   rtol=0, atol=1e-5, err_msg=n)


def test_blockwise_loss_and_grads_match_value_and_grad(pair):
    """lm_ce="blockwise": the vocabulary-streamed LM head through the
    tied wte, against the reference's blockwise loss."""
    jm, _, x, y = pair
    jm.config.lm_ce = "blockwise"
    try:
        opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                     parameters=jm.parameters())
        loss_call, params, _, _ = jtrainer._functional_pieces(jm, opt, None)
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(
            lambda p: loss_call(p, jnp.asarray(x), jnp.asarray(y),
                                jax.random.key(0))))(params)
    finally:
        jm.config.lm_ce = "plain"
    tm = _fresh_port(jm)
    tm.config.lm_ce = "blockwise"
    loss = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grads[n]),
                                   rtol=0, atol=1e-5, err_msg=n)


def _dropout_run(jm, x, y, **cfg):
    """Train-mode loss and gradients of gpt2_tiny at dropout 0.1 with
    ``cfg``, its generator seeded alike on every call."""
    c = dataclasses.replace(gpt2_tiny(), dropout=0.1, **cfg)
    tm = GPTForCausalLM(c, device="cpu",
                        generator=torch.Generator().manual_seed(11))
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    tm.train()
    loss = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    return loss.detach(), [p.grad for p in tm.parameters()]


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
@pytest.mark.parametrize("lm_ce", ["plain", "blockwise"])
def test_recompute_with_dropout_gives_the_same_bits(pair, policy, lm_ce):
    """Every encoder layer recomputed, with dropout 0.1 (attention,
    residual and activation dropout drawn from the model's generator):
    the loss and every gradient equal the run without recompute."""
    jm, _, x, y = pair
    base = _dropout_run(jm, x, y, lm_ce=lm_ce)
    got = _dropout_run(jm, x, y, lm_ce=lm_ce, use_recompute=True,
                       recompute_policy=policy)
    assert torch.equal(got[0], base[0])
    for a, b in zip(got[1], base[1]):
        assert torch.equal(a, b)


def test_three_train_steps_match_create_train_step(pair):
    jm, _, x, y = pair
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 parameters=jm.parameters())
    step, params, opt_state = jtrainer.create_train_step(jm, opt)
    ref = []
    for i in range(3):
        loss, params, opt_state = step(params, opt_state,
                                       jax.random.key(i), jnp.asarray(x),
                                       jnp.asarray(y), LR)
        ref.append(float(loss))
    tm = _fresh_port(jm)
    tstep = create_train_step(tm, AdamW(LR, parameters=tm.parameters(),
                                        weight_decay=0.01))
    got = [float(tstep(x, y, LR)) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[2] < got[0]


@pytest.mark.parametrize("cls,moment_dtype", [
    ("AdamW", None), ("AdamW", "bfloat16"), ("Adam", None)])
def test_adam_updates_match_apply_gradients(cls, moment_dtype):
    rng = np.random.RandomState(1)
    shapes = {"w.weight": (5, 7), "b.bias": (7,), "norm.weight": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    wd_mask = jtrainer._wd_mask(list(shapes))
    jcls = getattr(paddle.optimizer, cls)
    jmd = jnp.bfloat16 if moment_dtype else None
    jopt = jcls(learning_rate=LR, weight_decay=0.01, moment_dtype=jmd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init_state_tree(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    tcls = {"Adam": Adam, "AdamW": AdamW}[cls]
    topt = tcls(LR, parameters=list(tp.values()), weight_decay=0.01,
                moment_dtype=getattr(torch, moment_dtype)
                if moment_dtype else None)
    tmask = {id(tp[k]): v for k, v in wd_mask.items()}
    for g in grads:
        jp, jst = jopt.apply_gradients(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst,
            jnp.float32(LR), wd_mask=wd_mask)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step(lr=LR, wd_mask=tmask)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
        st = topt.state[p]
        np.testing.assert_allclose(st["moment1"].float().numpy(),
                                   np.asarray(jst[k]["moment1"],
                                              np.float32), atol=1e-6)
        assert float(st["beta1_pow"]) == pytest.approx(0.9 ** 3)


def test_bf16_params_keep_their_dtype_through_a_step(pair):
    jm, _, x, y = pair
    tm = _fresh_port(jm)
    write_back(tm, {k: v.detach().bfloat16()
                    for k, v in tm.named_parameters()})
    opt = AdamW(3e-4, parameters=tm.parameters(), weight_decay=0.01)
    step = create_train_step(tm, opt)
    l0 = float(step(x, y, 3e-4))
    assert np.isfinite(l0)
    p = tm.gpt.wte.weight
    assert p.dtype == torch.bfloat16
    assert opt.state[p]["moment1"].dtype == torch.float32


def test_write_back_refuses_unknown_names(pair):
    jm, _, _, _ = pair
    tm = _fresh_port(jm)
    with pytest.raises(KeyError):
        write_back(tm, {"gpt.nope.weight": torch.zeros(1)}, strict=True)
    with pytest.warns(RuntimeWarning):
        write_back(tm, {"gpt.nope.weight": torch.zeros(1)})


def test_functional_pieces_match_reference():
    from paddle_tpu import to_tensor
    from paddle_tpu.nn import functional as JF
    rng = np.random.RandomState(2)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3
    np.testing.assert_allclose(TF.gelu(torch.from_numpy(x)).numpy(),
                               JF.gelu(to_tensor(x)).numpy(), rtol=1e-6,
                               atol=1e-6)
    labels = rng.randint(0, 40, (6,))
    labels[2] = -100                                  # ignore_index
    ref = JF.cross_entropy(to_tensor(x), to_tensor(labels)).numpy()
    got = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_dropout_draws_from_its_generator():
    x = torch.ones(1000)
    with pytest.raises(ValueError):
        TF.dropout(x, 0.5)
    a = TF.dropout(x, 0.5, generator=torch.Generator().manual_seed(3))
    b = TF.dropout(x, 0.5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    assert 400 < int((a == 0).sum()) < 600
    assert torch.equal(TF.dropout(x, 0.5, training=False), x)
    cfg = gpt2_tiny()
    cfg.dropout = 0.1
    m = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(4))
    ids = torch.zeros(1, 8, dtype=torch.long)
    m.train()
    assert not torch.equal(m.loss(ids, ids), m.loss(ids, ids))
    m.eval()
    assert torch.equal(m.loss(ids, ids), m.loss(ids, ids))

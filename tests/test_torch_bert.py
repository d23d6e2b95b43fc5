"""PyTorch port: BERT (paddle_tpu_torch/models/bert.py) against
paddle_tpu's BERT on the CPU.

bert_tiny (2 layers, width 64, 4 heads, vocab 256) with paddle_tpu's
weights carried across by name, a padding mask (valid lengths 11 and
16), token types after a split point, MLM labels on some valid positions
(-100 elsewhere) and NSP labels. paddle_tpu turns the mask into an
additive [B, 1, 1, S] bias and attends through its XLA attention on the
CPU; the port hands the same bias to its flash-attention plain versions
(tests/test_torch_flash_attention.py holds those against the Pallas
kernels). Tolerances (fp32): outputs and loss at rtol 1e-5, gradients at
atol 1e-5 (sums in another order), the 3-step loss trajectory at rtol
1e-4, as tests/test_torch_gpt_train.py holds GPT-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import BertForPretraining as JaxBert
from paddle_tpu.models import \
    BertForSequenceClassification as JaxBertCls
from paddle_tpu.models import bert_tiny as jax_bert_tiny
from paddle_tpu.models import trainer as jtrainer
from paddle_tpu_torch.models import (BertForPretraining,
                                     BertForSequenceClassification,
                                     bert_large, bert_tiny,
                                     create_train_step, state_dict_from_numpy)
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
B, S = 2, 16


def _batch(seed=0):
    """ids, token types, 0/1 mask (lengths 11 and 16), MLM labels on
    valid positions (-100 elsewhere), NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 256, (B, S)).astype(np.int64)
    lens = np.array([11, 16])
    valid = np.arange(S)[None, :] < lens[:, None]
    ids[~valid] = 0
    tt = (np.arange(S)[None, :] >= (lens // 2)[:, None]).astype(np.int64)
    tt[~valid] = 0
    labels = np.where(valid & (rng.rand(B, S) < 0.3), ids, -100)
    labels[:, 1] = ids[:, 1]                   # at least one per row
    return (ids, tt, valid.astype(np.float32), labels.astype(np.int64),
            np.array([0, 1], np.int64))


def _port(jm, cls=BertForPretraining):
    tm = cls(bert_tiny(), device="cpu")
    state_dict_from_numpy(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    return tm


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxBert(jax_bert_tiny())
    jm.eval()
    return jm, _port(jm)


def _jloss_fn(tt, mask, nsp):
    def fn(model, ids, labels):
        return model.loss(ids, labels, paddle.to_tensor(nsp),
                          paddle.to_tensor(tt), paddle.to_tensor(mask))
    return fn


def _tloss_fn(tt, mask, nsp):
    def fn(model, ids, labels):
        return model.loss(ids, labels, torch.from_numpy(nsp),
                          torch.from_numpy(tt), torch.from_numpy(mask))
    return fn


def test_names_match_and_the_decoder_is_tied(pair):
    jm, tm = pair
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert not any("decoder.weight" in n for n in tm.state_dict())
    assert (bert_large().hidden_size, bert_large().num_layers,
            bert_large().num_heads, bert_large().intermediate_size) == \
        (1024, 24, 16, 4096)


def test_forward_with_padding_mask_matches(pair):
    jm, tm = pair
    ids, tt, mask, _, _ = _batch()
    ref_mlm, ref_nsp = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                          paddle.to_tensor(mask))
    mlm, nsp = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                  torch.from_numpy(mask))
    np.testing.assert_allclose(mlm.detach().numpy(), ref_mlm.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nsp.detach().numpy(), ref_nsp.numpy(),
                               rtol=1e-5, atol=1e-5)
    # the mask matters: without it the padded keys change every row
    mlm_nomask, _ = tm(torch.from_numpy(ids), torch.from_numpy(tt))
    assert not np.allclose(mlm_nomask[0].detach().numpy(),
                           mlm[0].detach().numpy(), atol=1e-3)


def test_pretraining_loss_and_grads_match_value_and_grad(pair):
    jm, tm = pair
    ids, tt, mask, labels, nsp = _batch(1)
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 parameters=jm.parameters())
    loss_call, params, _, _ = jtrainer._functional_pieces(
        jm, opt, _jloss_fn(tt, mask, nsp))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: loss_call(p, jnp.asarray(ids), jnp.asarray(labels),
                            jax.random.key(0)))(params)
    tm.zero_grad(set_to_none=True)
    loss = _tloss_fn(tt, mask, nsp)(tm, torch.from_numpy(ids),
                                    torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grads[n]),
                                   rtol=0, atol=1e-5, err_msg=n)


def test_three_train_steps_match_create_train_step(pair):
    jm, _ = pair
    ids, tt, mask, labels, nsp = _batch(2)
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 parameters=jm.parameters())
    step, params, opt_state = jtrainer.create_train_step(
        jm, opt, _jloss_fn(tt, mask, nsp))
    ref = []
    for i in range(3):
        loss, params, opt_state = step(params, opt_state, jax.random.key(i),
                                       jnp.asarray(ids), jnp.asarray(labels),
                                       LR)
        ref.append(float(loss))
    tm = _port(jm)
    tstep = create_train_step(
        tm, AdamW(LR, parameters=tm.parameters(), weight_decay=0.01),
        _tloss_fn(tt, mask, nsp))
    got = [float(tstep(ids, labels, LR)) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[2] < got[0]


def test_mask_needs_no_dbias(pair, monkeypatch):
    """The padding mask's bias needs no gradient: a train step's backward
    asks no dq pass for dbias and never takes the broadcast path."""
    _, tm = pair
    asked = []
    dq = tfa.flash_dq

    def spy(*a, dbias=False):
        asked.append(dbias)
        return dq(*a, dbias=dbias)

    def boom(*a, **k):
        raise AssertionError("broadcast dbias computed for a mask")
    monkeypatch.setattr(tfa, "flash_dq", spy)
    monkeypatch.setattr(tfa, "flash_dbias_broadcast", boom)
    ids, tt, mask, labels, nsp = _batch(3)
    tm.zero_grad(set_to_none=True)
    _tloss_fn(tt, mask, nsp)(tm, torch.from_numpy(ids),
                             torch.from_numpy(labels)).backward()
    assert asked == [False] * bert_tiny().num_layers


def test_sequence_classification_matches():
    paddle.seed(1)
    jm = JaxBertCls(jax_bert_tiny())
    jm.eval()
    tm = _port(jm, BertForSequenceClassification)
    tm.eval()
    ids, tt, mask, _, _ = _batch(4)
    ref = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
             paddle.to_tensor(mask)).numpy()
    got = tm(torch.from_numpy(ids), torch.from_numpy(tt),
             torch.from_numpy(mask))
    assert tuple(got.shape) == (B, 2)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


def test_embeddings_refuse_positions_past_the_table(pair):
    _, tm = pair
    with pytest.raises(ValueError):
        tm(torch.zeros(1, bert_tiny().max_position_embeddings + 1,
                       dtype=torch.long))

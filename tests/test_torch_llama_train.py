"""PyTorch port: Llama training (paddle_tpu_torch/models/llama.py loss,
models/trainer.py, distributed/fleet/recompute) against paddle_tpu on
the CPU.

llama_tiny (2 layers, width 64, 4 heads over 2 KV heads, vocab 256)
with paddle_tpu's weights carried across by name. On the CPU paddle_tpu
takes its XLA attention and RMSNorm (the widths are under its Pallas
gates) and the port its plain versions of the kernels. Tolerances
(fp32): loss at rtol 1e-5 and gradients at atol 1e-5 (sums in another
order), the 3-step loss trajectory at rtol 1e-4, as in
tests/test_torch_gpt_train.py. Recompute is held to the run without it
bit for bit (``torch.equal``): the replay runs the same operations on
the same inputs, dropout masks included. In bf16 (the port rounds RoPE's
q and k to bf16, the reference keeps them fp32) the loss and an
attention output are held at the reference's bf16 tolerance, rtol =
atol = 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models import trainer as jtrainer
from paddle_tpu_torch.distributed.fleet import recompute, recompute_sequential
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     create_train_step, llama_13b,
                                     llama_tiny, state_dict_from_numpy,
                                     write_back)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn.layer import Dropout, Linear
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
LM_CE = ("plain", "blockwise")


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (2, 33)).astype(np.int32)
    labels = ids[:, 1:].copy()
    labels[0, :3] = -100                              # ignore_index
    return jm, sd, ids[:, :-1], labels


def _port(sd, seed=0, **cfg):
    m = LlamaForCausalLM(dataclasses.replace(llama_tiny(), **cfg),
                         device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    state_dict_from_numpy(m, sd)
    return m


def test_bench_config_constructs_in_both():
    """bench_configs.py's single-chip Llama train config."""
    fields = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                  num_layers=12, num_heads=16, num_kv_heads=16,
                  max_position_embeddings=2048, dropout=0.0,
                  lm_ce="blockwise")
    assert (dataclasses.asdict(LlamaConfig(**fields))
            == dataclasses.asdict(JaxLlamaConfig(**fields)))
    assert (dataclasses.asdict(llama_13b())
            == dataclasses.asdict(jllama.llama_13b()))
    assert (dataclasses.asdict(LlamaConfig())
            == dataclasses.asdict(JaxLlamaConfig()))


@pytest.mark.parametrize("tokens,vocab", [
    (64, 256), (16384, 32000), (65536, 32000), (131072, 50304),
    (1 << 20, 32000)])
def test_auto_num_blocks_matches(tokens, vocab):
    assert (tllama._auto_num_blocks(tokens, vocab)
            == jllama._auto_num_blocks(tokens, vocab))


@pytest.mark.parametrize("lm_ce", LM_CE)
def test_loss_and_grads_match_value_and_grad(ref, lm_ce):
    jm, sd, x, y = ref
    jm.cfg.lm_ce = lm_ce
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 parameters=jm.parameters())
    loss_call, params, _, _ = jtrainer._functional_pieces(jm, opt, None)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_call(p, jnp.asarray(x), jnp.asarray(y),
                            jax.random.key(0))))(params)
    tm = _port(sd, lm_ce=lm_ce)
    loss = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grads[n]),
                                   rtol=0, atol=1e-5, err_msg=n)


# the reference's own bf16 tolerance (tests/test_pallas_flash_attention.py
# test_bf16_forward_close: bf16 attention against its fp32 oracle)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def test_bf16_rope_rounding_stays_within_the_bf16_tolerance(ref):
    """The port rounds RoPE's fp32 q and k back to bf16, so the flash
    kernels get one dtype; the reference hands its attention fp32 q and k
    beside bf16 v. A 2-layer llama_tiny in bf16 on both sides (the same
    numpy weights rounded to bf16, the same ids): the loss, and layer 0's
    attention output on the same bf16 input, agree at the reference's
    bf16 tolerance (rtol = atol = 2e-2)."""
    _, sd, x, y = ref
    jm = JaxLlama(jax_llama_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in sd.items()})
    jm.bfloat16()
    tm = _port(sd)
    write_back(tm, {k: p.detach().to(torch.bfloat16)
                    for k, p in tm.named_parameters()})
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    want = float(jm.loss(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
    with torch.no_grad():
        got = float(tm.loss(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, **BF16_TOL)
    h = np.random.RandomState(1).standard_normal((2, 32, 64)).astype(
        np.float32)
    ja = jm.model.layers[0].self_attn(paddle.to_tensor(h).astype("bfloat16"),
                                      jm.model._cos_sin)
    with torch.no_grad():
        ta = tm.model.layers[0].self_attn(torch.from_numpy(h).bfloat16(),
                                          tm.model._cos_sin)
    assert ta.dtype == torch.bfloat16
    ref_attn = np.asarray(ja.numpy(), np.float32)
    np.testing.assert_allclose(ta.float().numpy(), ref_attn, **BF16_TOL)
    # the deviation PERF.md records (shown with pytest -s)
    print(f"bf16 RoPE rounding: loss {got:.6f} against the reference's "
          f"{want:.6f}; attention max |diff| "
          f"{np.abs(ta.float().numpy() - ref_attn).max():.3g} of max "
          f"|ref| {np.abs(ref_attn).max():.3g}")


@pytest.mark.parametrize("lm_ce", LM_CE)
def test_three_train_steps_match_create_train_step(ref, lm_ce):
    jm, sd, x, y = ref
    jm.cfg.lm_ce = lm_ce
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                 parameters=jm.parameters())
    step, params, opt_state = jtrainer.create_train_step(jm, opt)
    want = []
    for i in range(3):
        loss, params, opt_state = step(params, opt_state, jax.random.key(i),
                                       jnp.asarray(x), jnp.asarray(y), LR)
        want.append(float(loss))
    tm = _port(sd, lm_ce=lm_ce)
    tstep = create_train_step(tm, AdamW(LR, parameters=tm.parameters(),
                                        weight_decay=0.01))
    got = [float(tstep(x, y, LR)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def _loss_and_grads(sd, x, y, seed=7, **cfg):
    """One train-mode loss and backward of a fresh model whose generator
    starts at ``seed`` (so its dropout draws repeat across calls)."""
    m = _port(sd, seed=seed, **cfg)
    m.train()
    loss = m.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in m.named_parameters()}


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for n in a[1]:
        assert torch.equal(a[1][n], b[1][n]), n


@pytest.mark.parametrize("policy", ["full", "dots_saveable", "selective",
                                    "nothing_saveable",
                                    "dots_with_no_batch_dims_saveable",
                                    "everything_saveable"])
@pytest.mark.parametrize("lm_ce", LM_CE)
def test_recompute_gives_the_same_bits(ref, policy, lm_ce):
    """With dropout 0.1 in attention, every policy's loss and gradients
    equal the run without recompute (the replay redraws the forward's
    dropout seeds from the model's generator)."""
    _, sd, x, y = ref
    base = _loss_and_grads(sd, x, y, dropout=0.1, lm_ce=lm_ce)
    nodrop = _loss_and_grads(sd, x, y, lm_ce=lm_ce)
    assert not torch.equal(base[0], nodrop[0])        # dropout took part
    _assert_same(_loss_and_grads(sd, x, y, dropout=0.1, lm_ce=lm_ce,
                                 use_recompute=True,
                                 recompute_policy=policy), base)


def test_recompute_replays_each_layer_in_train_mode_only(ref):
    _, sd, x, y = ref
    m = _port(sd, use_recompute=True)
    calls = []
    for layer in m.model.layers:
        layer.register_forward_pre_hook(lambda *a: calls.append(1))
    m.train()
    m.loss(torch.from_numpy(x), torch.from_numpy(y)).backward()
    assert len(calls) == 2 * 2                        # forward + replay
    calls.clear()
    m.eval()
    m.loss(torch.from_numpy(x), torch.from_numpy(y)).backward()
    assert len(calls) == 2


def _dropout_block(seed):
    g = torch.Generator().manual_seed(seed)
    lin = Linear(16, 16, device="cpu", generator=g)
    return torch.nn.Sequential(lin, Dropout(0.5, generator=g))


def test_generator_replay_is_what_makes_the_masks_match():
    """The counterpart of the reference's
    test_recompute_dropout_rng_replay: the gradient through a recomputed
    dropout uses the forward's mask; without the generator replay
    (preserve_rng_state=False) the replay draws a new one."""
    x0 = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    grads = {}
    for mode in ("plain", "replay", "no_replay"):
        block = _dropout_block(3)
        x = x0.clone().requires_grad_()
        if mode == "plain":
            out = block(x)
        else:
            out = recompute(block, x,
                            preserve_rng_state=(mode == "replay"))
        out.sum().backward()
        grads[mode] = (out.detach(), x.grad, block[0].weight.grad)
    for a, b in zip(grads["replay"], grads["plain"]):
        assert torch.equal(a, b)
    assert not torch.equal(grads["no_replay"][1], grads["plain"][1])
    # the generator ends where the forward left it, replay or not
    g_plain, g_re = _dropout_block(3), _dropout_block(3)
    g_plain(x0)
    recompute(g_re, x0.clone().requires_grad_()).sum().backward()
    assert torch.equal(g_plain[1]._generator.get_state(),
                       g_re[1]._generator.get_state())


def test_recompute_sequential_and_explicit_generators():
    x0 = torch.randn(4, 16, generator=torch.Generator().manual_seed(2))
    outs = []
    for seq in (False, True):
        blocks = [_dropout_block(5), _dropout_block(6)]
        x = x0.clone().requires_grad_()
        out = (recompute_sequential({"segments": 2}, blocks, x) if seq
               else blocks[1](blocks[0](x)))
        out.sum().backward()
        outs.append((out.detach(), x.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # a closure hides its modules: their generators are passed explicitly
    block = _dropout_block(7)
    ref_out = _dropout_block(7)(x0)
    out = recompute(lambda t: block(t), x0.clone().requires_grad_(),
                    generators=[block[1]._generator])
    assert torch.equal(out.detach(), ref_out.detach())


def test_unknown_policy_raises_and_no_grad_just_runs():
    block = _dropout_block(8)
    x = torch.randn(2, 16, requires_grad=True)
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(block, x, policy="bogus")
    with torch.no_grad():
        assert recompute(block, x, policy="bogus").shape == (2, 16)

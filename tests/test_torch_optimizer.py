"""PyTorch port: the multi-tensor Adam/AdamW step
(paddle_tpu_torch/optimizer, flag ``use_fused_optimizer``) against the
per-parameter loop it replaces, and against paddle_tpu's fused step.

The ``torch._foreach_*`` step runs the loop's operations in the loop's
order and dtypes, so it must give the same parameters and moments bit
for bit (``torch.equal``), over three steps, for fp32 and bf16
parameters, fp32 and bf16 moments and mixed weight-decay masks.
Against paddle_tpu's fused eager step (``Optimizer.step`` with its flag
on), fp32 parameters agree at atol 1e-6, as in
tests/test_torch_gpt_train.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.optimizer import Adam, AdamW

SHAPES = {"w.weight": (5, 7), "b.bias": (7,), "norm.weight": (7,),
          "emb.weight": (11, 3), "head.weight": (3, 4)}
LR = 1e-3


@pytest.fixture
def fused_flag():
    prev = get_flags("use_fused_optimizer")
    yield lambda on: set_flags({"use_fused_optimizer": on})
    set_flags(prev)


def _run(fused, cls, pdtype, mdtype, set_flag, steps=3, skip=None):
    set_flag(fused)
    rng = np.random.RandomState(0)
    params = {k: torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(pdtype))
        for k, s in SHAPES.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  ).to(pdtype) for k, s in SHAPES.items()}
             for _ in range(steps)]
    # bias and norm parameters skip weight decay; one parameter is
    # decayed at a rate of its own through a second group
    groups = [{"params": [p for k, p in params.items()
                          if k != "head.weight"]},
              {"params": [params["head.weight"]], "weight_decay": 0.1}]
    opt = cls(LR, parameters=groups, weight_decay=0.01, moment_dtype=mdtype)
    mask = {id(p): ("bias" not in k and "norm" not in k)
            for k, p in params.items()}
    for i, g in enumerate(grads):
        for k, p in params.items():
            # ``skip`` has no gradient at step 1: its step count lags
            p.grad = None if (k == skip and i == 1) else g[k].clone()
        opt.step(lr=LR * (i + 1), wd_mask=mask)
    return params, opt


@pytest.mark.parametrize("cls", [AdamW, Adam])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mdtype", [None, torch.bfloat16])
def test_foreach_step_equals_the_loop_bit_for_bit(fused_flag, cls, pdtype,
                                                  mdtype):
    loop, lopt = _run(False, cls, pdtype, mdtype, fused_flag)
    fused, fopt = _run(True, cls, pdtype, mdtype, fused_flag)
    for k in SHAPES:
        assert fused[k].dtype == pdtype
        assert torch.equal(fused[k], loop[k]), k
        ls, fs = lopt.state[loop[k]], fopt.state[fused[k]]
        assert fs["moment1"].dtype == (mdtype or torch.float32)
        for key in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            assert torch.equal(fs[key], ls[key]), (k, key)
        assert fs["step"] == ls["step"] == 3


def test_runs_cut_at_the_chunk_size_equal_the_loop(fused_flag,
                                                  monkeypatch):
    """A group longer than FUSED_CHUNK_ELEMENTS is updated in runs (here
    of at most 40 elements, a larger tensor alone)."""
    from paddle_tpu_torch.optimizer import optimizer as topt
    monkeypatch.setattr(topt, "FUSED_CHUNK_ELEMENTS", 40)
    assert [len(r) for r in topt._chunks(
        [torch.empty(n) for n in (35, 7, 3, 77, 1)], 40)] == [1, 2, 1, 1]
    loop, _ = _run(False, AdamW, torch.bfloat16, torch.bfloat16, fused_flag)
    fused, _ = _run(True, AdamW, torch.bfloat16, torch.bfloat16, fused_flag)
    for k in SHAPES:
        assert torch.equal(fused[k], loop[k]), k


def test_parameters_at_other_step_counts_are_updated_apart(fused_flag):
    """A parameter that missed a step has its own beta powers: the
    fused step groups it apart and still equals the loop."""
    loop, lopt = _run(False, AdamW, torch.float32, None, fused_flag,
                      skip="w.weight")
    fused, fopt = _run(True, AdamW, torch.float32, None, fused_flag,
                       skip="w.weight")
    assert fopt.state[fused["w.weight"]]["step"] == 2
    for k in SHAPES:
        assert torch.equal(fused[k], loop[k]), k
        assert torch.equal(fopt.state[fused[k]]["beta1_pow"],
                           lopt.state[loop[k]]["beta1_pow"])


def test_fused_step_matches_the_reference_fused_step(fused_flag):
    """paddle_tpu's eager AdamW.step with its fused flag on (one jitted
    program over every parameter) against the port's foreach step."""
    fused_flag(True)
    rng = np.random.RandomState(3)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    prev = jflags.get_flag("use_fused_optimizer")
    jflags.set_flags({"use_fused_optimizer": True})
    try:
        jp = {k: paddle.create_parameter(list(v.shape), "float32")
              for k, v in arrays.items()}
        for k, p in jp.items():
            p.set_value(arrays[k])
        jopt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                                      parameters=list(jp.values()))
        for g in grads:
            for k, p in jp.items():
                p.grad = paddle.to_tensor(g[k])
            jopt.step()
    finally:
        jflags.set_flags({"use_fused_optimizer": prev})
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in arrays.items()}
    topt = AdamW(LR, parameters=list(tp.values()), weight_decay=0.01)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), jp[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_flag_is_registered_on_by_default():
    from paddle_tpu_torch.core import flags
    assert flags.get_flag("use_fused_optimizer") is jflags.get_flag(
        "use_fused_optimizer") is True

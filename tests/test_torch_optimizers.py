"""PyTorch port: every optimizer of paddle_tpu_torch/optimizer against
paddle_tpu's eager ``step()`` on the same numpy parameters and gradients.

Each of the ten optimizers runs five steps in two setups:

- "fp32": fp32 parameters with the options of that optimizer (an LR
  schedule stepped after each step, ``grad_clip``, weight decay as a
  float or an ``L2Decay``, AdamW's ``apply_decay_param_fun`` by name,
  Lamb's ``exclude_from_weight_decay_fn``, Adam's ``amsgrad``); the
  parameters and every state entry agree at rtol 1e-6;
- "bf16": bf16 parameters with ``multi_precision``: the fp32 master
  weights agree at rtol 1e-6, and each bf16 parameter equals its own
  master rounded to bf16.

rtol is taken as in chip_smoke.py's ``check_close``: |port - ref| <=
rtol x (|ref| + rms(ref)), entry by entry. A moment that cancels to near
zero (a velocity whose gradients change sign) keeps the absolute
rounding of its addends, which the clip's norm, summed in another order,
moves by an ulp.

The port's run is made with the flag ``use_fused_optimizer`` on and off,
which must agree bit for bit. A reference run's ``state_dict()`` after
three steps, loaded through ``optimizer_state_from_numpy`` into a fresh
port optimizer and with ``set_state_dict`` into a fresh reference one,
continues for two steps on both sides (the reference's
``LinearWarmup`` keeps no state of its inner schedule, so a reload
restarts that schedule on both sides alike).

The reference's ``_wd_coeff`` looks for an attribute ``_coeff`` that
its ``L2Decay`` does not have, so a reference optimizer given
``L2Decay(c)`` applies no decay; the port reads ``coeff``, and an
``L2Decay(c)`` run is held to the reference given the float ``c``.
Likewise an ``L1Decay(c)`` run of SGD, Momentum and Adam (fused and
per-parameter) is held to the reference run without decay and fed each
gradient plus ``jax.grad`` of the reference's ``L1Decay(c)`` penalty at
its current parameter, ``c * sign(p)``; the decoupled rules (AdamW, Lamb)
refuse an ``L1Decay``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import regularizer as jregularizer
from paddle_tpu.core import flags as jflags
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import get_flags, regularizer, set_flags
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import optimizer_state_from_numpy
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = {"w.weight": (5, 7), "b.bias": (7,), "norm.weight": (7,),
          "head.weight": (3, 4)}
STEPS = 5


def _no_bias(name):
    return "bias" not in name and "norm" not in name


# optimizer -> (constructor kwargs as f(side), LR schedule or None,
# parameters passed with their names)
def _config(name, side):
    lr_mod, clip_mod = (jlr, jclip) if side == "ref" else (tlr, tclip)
    sched = None
    kw = {}
    if name == "SGD":
        sched = lr_mod.StepDecay(0.1, step_size=2, gamma=0.5)
        kw = dict(weight_decay=0.01)
    elif name == "Momentum":
        kw = dict(learning_rate=0.05, momentum=0.9, use_nesterov=True,
                  grad_clip=clip_mod.ClipGradByGlobalNorm(1.0))
    elif name == "Adagrad":
        kw = dict(learning_rate=0.1, initial_accumulator_value=0.1,
                  weight_decay=(0.01 if side == "ref"
                                else regularizer.L2Decay(0.01)))
    elif name == "RMSProp":
        kw = dict(learning_rate=0.01, centered=True, momentum=0.9,
                  grad_clip=clip_mod.ClipGradByNorm(0.5))
    elif name == "Adam":
        sched = lr_mod.CosineAnnealingDecay(1e-2, T_max=10)
        kw = dict(amsgrad=True, weight_decay=0.02)
    elif name == "AdamW":
        sched = lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(1e-2, 20),
                                    warmup_steps=2, start_lr=0.0,
                                    end_lr=1e-2)
        kw = dict(weight_decay=0.1, apply_decay_param_fun=_no_bias,
                  grad_clip=clip_mod.ClipGradByGlobalNorm(2.0))
    elif name == "Adamax":
        kw = dict(learning_rate=0.01,
                  grad_clip=clip_mod.ClipGradByValue(0.8))
    elif name == "Adadelta":
        kw = dict(learning_rate=0.5, weight_decay=0.01)
    elif name == "Lamb":
        kw = dict(learning_rate=0.01, lamb_weight_decay=0.05,
                  exclude_from_weight_decay_fn=lambda p: p.ndim == 1)
    elif name == "Rprop":
        kw = dict(learning_rate=0.01, etas=(0.4, 1.3))
    if sched is not None:
        kw["learning_rate"] = sched
    return kw, sched


OPTIMIZERS = ["SGD", "Momentum", "Adagrad", "RMSProp", "Adam", "AdamW",
              "Adamax", "Adadelta", "Lamb", "Rprop"]
NAMED = {"AdamW"}               # state-dict keys by name, else by index


def _data(seed=0, steps=STEPS):
    rng = np.random.RandomState(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


@pytest.fixture(autouse=True)
def reference_loop():
    """The reference's per-parameter loop (its fused step computes the
    same ``_update`` inside one jitted program per optimizer, which costs
    a compile for every optimizer these tests build)."""
    prev = jflags.get_flag("use_fused_optimizer")
    jflags.set_flags({"use_fused_optimizer": False})
    yield
    jflags.set_flags({"use_fused_optimizer": prev})


def _close(got, ref, what, rtol=1e-6):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    bound = rtol * (np.abs(ref) + np.sqrt(np.mean(ref * ref)))
    excess = np.abs(got - ref) - bound
    assert np.all(excess <= 0), (what, float(np.max(excess)))


def _ref_run(name, setup, arrays, grads, stop=None, state=None):
    """paddle_tpu's optimizer over ``grads``, from ``state`` when given;
    returns (params, optimizer, state dict after ``stop`` steps or
    None)."""
    dt = "float32" if setup == "fp32" else "bfloat16"
    ps = {}
    for k, a in arrays.items():
        ps[k] = paddle.create_parameter(
            list(a.shape), dt, name=k if name in NAMED else None)
        ps[k].set_value(a)
    kw, sched = _config(name, "ref")
    opt = getattr(paddle.optimizer, name)(
        parameters=list(ps.values()), multi_precision=setup == "bf16", **kw)
    if state is not None:
        opt.set_state_dict(state)
    saved = None
    for i, g in enumerate(grads):
        for k, p in ps.items():
            p.grad = paddle.to_tensor(g[k]).astype(dt)
        opt.step()
        if sched is not None:
            sched.step()
        if i + 1 == stop:
            saved = {k: (v.numpy() if hasattr(v, "numpy") else v)
                     for k, v in opt.state_dict().items()}
    return ps, opt, saved


def _port_params(arrays, dtype):
    return {k: torch.nn.Parameter(torch.from_numpy(a.copy()).to(dtype))
            for k, a in arrays.items()}


def _port_run(name, setup, arrays, grads, fused, state=None):
    prev = get_flags("use_fused_optimizer")
    set_flags({"use_fused_optimizer": fused})
    try:
        dt = torch.float32 if setup == "fp32" else torch.bfloat16
        ps = _port_params(arrays, dt)
        kw, sched = _config(name, "port")
        params = list(ps.items()) if name in NAMED else list(ps.values())
        opt = getattr(topt, name)(parameters=params,
                                  multi_precision=setup == "bf16", **kw)
        if state is not None:
            optimizer_state_from_numpy(opt, state)
        for g in grads:
            for k, p in ps.items():
                p.grad = torch.from_numpy(g[k]).to(dt)
            opt.step()
            opt.clear_grad()
            if sched is not None:
                sched.step()
        return ps, opt
    finally:
        set_flags(prev)


def _ref_state(opt, p, key):
    return np.asarray(opt._states[id(p)][key]).astype(np.float32)


def _hold(name, setup, ref, ropt, got, gopt):
    for i, k in enumerate(SHAPES):
        p, q = ref[k], got[k]
        if setup == "bf16":
            master = np.asarray(ropt._master_weights[id(p)])
            mine = gopt._master_weights[q]
            _close(mine.numpy(), master, (name, k, "master"))
            assert torch.equal(q.detach(), mine.to(torch.bfloat16)), k
        else:
            _close(q.detach().numpy(), p.numpy(), (name, k))
        for key, v in gopt.state[q].items():
            if key != "step":
                _close(v.float().numpy(), _ref_state(ropt, p, key),
                       (name, k, key))
        assert set(gopt.state[q]) - {"step"} == set(ropt._states[id(p)])


@pytest.mark.parametrize("setup", ["fp32", "bf16"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_the_reference(name, setup):
    arrays, grads = _data()
    ref, ropt, _ = _ref_run(name, setup, arrays, grads)
    got, gopt = _port_run(name, setup, arrays, grads, fused=True)
    _hold(name, setup, ref, ropt, got, gopt)
    loop, lopt = _port_run(name, setup, arrays, grads, fused=False)
    for k in SHAPES:
        assert torch.equal(got[k], loop[k]), (name, k)
        if setup == "bf16":
            assert torch.equal(gopt._master_weights[got[k]],
                               lopt._master_weights[loop[k]])
        for key, v in gopt.state[got[k]].items():
            w = lopt.state[loop[k]][key]
            assert (v == w) if key == "step" else torch.equal(v, w), key
    assert gopt.state_dict()["step"] == ropt.state_dict()["step"] == STEPS


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_reference_state_dict_continues_in_the_port(name):
    """Three reference steps; its state_dict and parameters go into a
    fresh port optimizer and a fresh reference one, which both take two
    more steps."""
    arrays, grads = _data(seed=1)
    mid, _, saved = _ref_run(name, "fp32", arrays, grads[:3], stop=3)
    _, fresh = _port_run(name, "fp32", arrays, [], fused=True)
    assert set(saved) - {"step", "LR_Scheduler"} == \
        set(fresh._expected_state())
    mid = {k: p.numpy() for k, p in mid.items()}
    ref, ropt, _ = _ref_run(name, "fp32", mid, grads[3:], state=saved)
    got, gopt = _port_run(name, "fp32", mid, grads[3:], fused=True,
                          state=saved)
    _hold(name, "fp32", ref, ropt, got, gopt)
    assert gopt.state_dict()["step"] == STEPS


def test_port_state_dict_has_the_reference_keys_and_round_trips():
    arrays, grads = _data()
    _, ropt, _ = _ref_run("AdamW", "fp32", arrays, grads)
    _, gopt = _port_run("AdamW", "fp32", arrays, grads, fused=True)
    rs, gs = ropt.state_dict(), gopt.state_dict()
    assert set(gs) == set(rs)
    assert gs["LR_Scheduler"] == rs["LR_Scheduler"]
    _, again = _port_run("AdamW", "fp32", arrays, [], fused=True)
    again.set_state_dict(gs)
    for k, v in again.state_dict().items():
        assert (v == gs[k]) if not torch.is_tensor(v) else \
            torch.equal(v, gs[k]), k


def test_optimizer_state_from_numpy_checks_names_and_shapes():
    arrays, grads = _data()
    _, _, saved = _ref_run("Adam", "fp32", arrays, grads, stop=1)
    _, fresh = _port_run("Adam", "fp32", arrays, [], fused=True)
    with pytest.raises(KeyError):
        optimizer_state_from_numpy(fresh, {**saved, "9.moment1": 0})
    bad = dict(saved)
    bad["0.moment1"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError):
        optimizer_state_from_numpy(fresh, bad)
    assert not fresh.state               # nothing loaded


def test_l2decay_reads_its_coeff_and_equals_the_float():
    arrays, grads = _data()
    runs = []
    for wd in (0.01, regularizer.L2Decay(0.01)):
        ps = _port_params(arrays, torch.float32)
        opt = topt.Adagrad(0.1, parameters=list(ps.values()),
                           weight_decay=wd)
        for g in grads:
            for k, p in ps.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
        runs.append(ps)
    for k in SHAPES:
        assert torch.equal(runs[0][k], runs[1][k])
    assert regularizer.L1Decay(0.5)(torch.tensor([-2.0, 1.0])) == 1.5
    assert regularizer.L2Decay(0.5)(torch.tensor([-2.0, 1.0])) == 1.25


L1_COEFF = 0.05
L1_SETUPS = {"SGD": dict(learning_rate=0.1),
             "Momentum": dict(learning_rate=0.05, momentum=0.9,
                              use_nesterov=True),
             "Adam": dict(learning_rate=1e-2, amsgrad=True)}


def _l1_penalty_grad(p: np.ndarray) -> np.ndarray:
    """``jax.grad`` of the reference's ``L1Decay(L1_COEFF)`` penalty at
    ``p`` (no entry of the data is 0, where jax and ``sign`` differ)."""
    pen = jregularizer.L1Decay(L1_COEFF)
    return np.asarray(jax.grad(lambda x: pen(JTensor(x))._data)(
        jnp.asarray(p)))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "loop"])
@pytest.mark.parametrize("name", list(L1_SETUPS))
def test_l1decay_adds_the_reference_penalty_gradient(name, fused):
    """``weight_decay=L1Decay(c)`` adds ``c * sign(p)`` (not ``c * p``) to
    every gradient, on the fused and the per-parameter path: held at
    rtol 1e-6, parameters and state, to the reference optimizer without
    decay fed the gradient plus the penalty's gradient at its own current
    parameter."""
    arrays, grads = _data(seed=2)
    ref = {}
    for k, a in arrays.items():
        ref[k] = paddle.create_parameter(list(a.shape), "float32")
        ref[k].set_value(a)
    ropt = getattr(paddle.optimizer, name)(parameters=list(ref.values()),
                                           **L1_SETUPS[name])
    for g in grads:
        for k, p in ref.items():
            p.grad = paddle.to_tensor(g[k] + _l1_penalty_grad(p.numpy()))
        ropt.step()
    prev = get_flags("use_fused_optimizer")
    set_flags({"use_fused_optimizer": fused})
    try:
        got = _port_params(arrays, torch.float32)
        opt = getattr(topt, name)(
            parameters=list(got.values()),
            weight_decay=regularizer.L1Decay(L1_COEFF), **L1_SETUPS[name])
        for g in grads:
            for k, p in got.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
    finally:
        set_flags(prev)
    _hold(name, "fp32", ref, ropt, got, opt)


@pytest.mark.parametrize("setup", ["fp32", "bf16"])
def test_l1decay_fused_step_equals_the_loop(setup):
    """Adam with ``L1Decay`` (the sign taken on the fp32 master weight
    under ``multi_precision``) gives the same bits with the flag
    ``use_fused_optimizer`` on and off, and differs from ``L2Decay`` of
    the same coefficient."""
    arrays, grads = _data(seed=3)
    dt = torch.float32 if setup == "fp32" else torch.bfloat16
    runs = {}
    for key, wd, fused in (("fused", regularizer.L1Decay(L1_COEFF), True),
                           ("loop", regularizer.L1Decay(L1_COEFF), False),
                           ("l2", regularizer.L2Decay(L1_COEFF), True)):
        prev = get_flags("use_fused_optimizer")
        set_flags({"use_fused_optimizer": fused})
        try:
            ps = _port_params(arrays, dt)
            opt = topt.Adam(1e-2, parameters=list(ps.values()),
                            weight_decay=wd, multi_precision=setup == "bf16")
            for g in grads:
                for k, p in ps.items():
                    p.grad = torch.from_numpy(g[k]).to(dt)
                opt.step()
        finally:
            set_flags(prev)
        runs[key] = (ps, opt)
    (fp, fo), (lp, lo), (l2p, _) = runs["fused"], runs["loop"], runs["l2"]
    for k in SHAPES:
        assert torch.equal(fp[k], lp[k]), k
        for key, v in fo.state[fp[k]].items():
            w = lo.state[lp[k]][key]
            assert (v == w) if key == "step" else torch.equal(v, w), key
        if setup == "bf16":
            assert torch.equal(fo._master_weights[fp[k]],
                               lo._master_weights[lp[k]])
    assert not all(torch.equal(fp[k], l2p[k]) for k in SHAPES)


@pytest.mark.parametrize("name,kw", [("AdamW", "weight_decay"),
                                     ("Lamb", "lamb_weight_decay")])
def test_decoupled_rules_refuse_l1decay(name, kw):
    """AdamW and Lamb decay decoupled from the gradient, by a float: an
    ``L1Decay`` raises and names the class; an ``L2Decay`` is taken by its
    coefficient as before."""
    arrays, _ = _data()
    ps = list(_port_params(arrays, torch.float32).values())
    with pytest.raises(ValueError, match=name):
        getattr(topt, name)(parameters=ps,
                            **{kw: regularizer.L1Decay(L1_COEFF)})
    opt = getattr(topt, name)(parameters=ps,
                              **{kw: regularizer.L2Decay(L1_COEFF)})
    assert opt.param_groups[0]["weight_decay"] == L1_COEFF


def test_step_lr_and_wd_mask_override_and_apply_gradients_skips_clip():
    """``step(lr=)`` and ``apply_gradients`` update at the given rate;
    only ``step`` clips."""
    arrays, grads = _data()
    outs = {}
    for how in ("step", "apply"):
        ps = _port_params(arrays, torch.float32)
        opt = topt.SGD(tlr.StepDecay(5.0, 1), parameters=list(ps.values()),
                       grad_clip=tclip.ClipGradByValue(1e-3))
        for k, p in ps.items():
            p.grad = torch.from_numpy(grads[0][k])
        if how == "step":
            opt.step(lr=0.1)
        else:
            opt.apply_gradients(0.1)
        outs[how] = ps
    k = "w.weight"
    w0, g0 = arrays[k], grads[0][k]
    np.testing.assert_allclose(outs["step"][k].detach().numpy(),
                               w0 - 0.1 * np.clip(g0, -1e-3, 1e-3),
                               rtol=1e-6)
    np.testing.assert_allclose(outs["apply"][k].detach().numpy(),
                               w0 - 0.1 * g0, rtol=1e-6)


def test_minimize_and_get_set_lr():
    lin = Linear(3, 2, device="cpu")
    opt = topt.SGD(0.5, parameters=lin.parameters())
    assert opt.get_lr() == 0.5
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    w0 = lin.weight.detach().clone()
    loss = lin(torch.ones(1, 3)).sum()
    opt.minimize(loss)
    assert lin.weight.grad is None
    torch.testing.assert_close(lin.weight.detach(), w0 - 0.25, rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("master_weight", [None, False])
def test_amp_decorate_matches_the_reference(master_weight):
    rl = paddle.nn.Linear(4, 3)
    ropt = paddle.optimizer.AdamW(parameters=rl.parameters())
    tl = Linear(4, 3, device="cpu")
    tlopt = topt.AdamW(parameters=tl.parameters())
    rm, ro = paddle.amp.decorate(rl, ropt, level="O2", dtype="bfloat16",
                                 master_weight=master_weight)
    tm, to = tamp.decorate(tl, tlopt, level="O2", dtype="bfloat16",
                           master_weight=master_weight)
    assert tm is tl and to is tlopt and rm is rl and ro is ropt
    assert [str(p.dtype) for p in rl.parameters()] == ["bfloat16"] * 2
    assert [p.dtype for p in tl.parameters()] == [torch.bfloat16] * 2
    assert to._multi_precision == ro._multi_precision == \
        (master_weight is not False)
    assert tamp.amp_decorate(tl, level="O1") is tl

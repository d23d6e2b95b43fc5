"""PyTorch port: the LR schedules (paddle_tpu_torch/optimizer/lr.py)
against paddle_tpu's, value by value.

Every scheduler runs 30 steps on both sides; the values agree at rtol
1e-12 (the same float arithmetic). Midway each is saved with
``state_dict``, loaded into a fresh scheduler with ``set_state_dict``
and continued on both sides, the reference's quirks included
(``LinearWarmup`` keeps no state of its inner schedule).
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30
SPLIT = 13

# name -> (class name, args, kwargs); lambdas are the same functions on
# both sides
CASES = {
    "noam": ("NoamDecay", (64, 10), {"learning_rate": 2.0}),
    "piecewise": ("PiecewiseDecay", ([5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
                  {}),
    "natural_exp": ("NaturalExpDecay", (0.5, 0.1), {}),
    "inverse_time": ("InverseTimeDecay", (0.5, 0.2), {}),
    "polynomial": ("PolynomialDecay", (0.5, 12), {"end_lr": 0.01,
                                                  "power": 2.0}),
    "polynomial_cycle": ("PolynomialDecay", (0.5, 7),
                         {"end_lr": 0.01, "cycle": True}),
    "linear_warmup_float": ("LinearWarmup", (0.3, 5, 0.0, 0.3), {}),
    "exponential": ("ExponentialDecay", (0.5, 0.9), {}),
    "multistep": ("MultiStepDecay", (0.5, [4, 9, 17]), {"gamma": 0.5}),
    "step": ("StepDecay", (0.5, 6), {"gamma": 0.3}),
    "lambda": ("LambdaDecay", (0.5, lambda e: 0.95 ** e), {}),
    "multiplicative": ("MultiplicativeDecay", (0.5, lambda e: 0.9), {}),
    "cosine": ("CosineAnnealingDecay", (3e-4, 20), {"eta_min": 1e-6}),
    "cosine_restarts": ("CosineAnnealingWarmRestarts", (0.1, 5),
                        {"T_mult": 2, "eta_min": 1e-3}),
    "linear_lr": ("LinearLR", (0.5, 18), {"start_factor": 0.2}),
    "one_cycle": ("OneCycleLR", (0.1, 30), {}),
    "one_cycle_linear": ("OneCycleLR", (0.1, 25),
                         {"anneal_strategy": "linear"}),
    "cyclic": ("CyclicLR", (0.01, 0.1, 4), {"step_size_down": 6}),
    "cyclic_tri2": ("CyclicLR", (0.01, 0.1, 5), {"mode": "triangular2"}),
    "cyclic_exp": ("CyclicLR", (0.01, 0.1, 5), {"mode": "exp_range",
                                                "exp_gamma": 0.97}),
}


def _make(mod, case):
    cls, args, kw = CASES[case]
    return getattr(mod, cls)(*args, **kw)


def _warmup_cosine(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-4, T_max=20),
                            warmup_steps=2, start_lr=0.0, end_lr=3e-4)


def _run(make, mod):
    """30 values, the schedule saved and reloaded at step SPLIT."""
    s = make(mod)
    out = []
    for i in range(STEPS):
        out.append(s())
        s.step()
        if i == SPLIT:
            state = s.state_dict()
            s = make(mod)
            s.set_state_dict(state)
    return out


def test_every_scheduler_of_the_reference_is_ported():
    assert set(tlr.__all__) == set(jlr.__all__)
    assert {c for c, _, _ in CASES.values()} | {"LRScheduler",
                                               "ReduceOnPlateau"} == \
        set(jlr.__all__)


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_values_equal_the_reference(case):
    ref = _run(lambda m: _make(m, case), jlr)
    got = _run(lambda m: _make(m, case), tlr)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_warmup_steps_its_inner_schedule_inside_get_lr():
    """The train loop's schedule: 2 warmup steps, then the cosine from
    its epoch 1 (``LinearWarmup.get_lr`` steps it), as the reference."""
    ref = _run(_warmup_cosine, jlr)
    got = _run(_warmup_cosine, tlr)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    s = _warmup_cosine(tlr)
    vals = [s()] + [s.step() or s() for _ in range(3)]
    assert vals[:2] == [0.0, 1.5e-4]
    assert vals[2] == pytest.approx(
        3e-4 * (1 + math.cos(math.pi / 20)) / 2, rel=1e-15)


def test_reduce_on_plateau_takes_floats_and_0d_tensors():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.61, 0.62,
               0.7, 0.7, 0.7, 0.7]
    kw = dict(factor=0.5, patience=2, cooldown=1, min_lr=0.01)
    ref = jlr.ReduceOnPlateau(0.4, **kw)
    got = tlr.ReduceOnPlateau(0.4, **kw)
    got_t = tlr.ReduceOnPlateau(0.4, **kw)
    jlr_vals, vals, vals_t = [], [], []
    for i, m in enumerate(metrics):
        ref.step(m)
        got.step(m)
        got_t.step(torch.tensor(m, dtype=torch.float64))
        jlr_vals.append(ref())
        vals.append(got())
        vals_t.append(got_t())
        if i == 6:
            state = got.state_dict()
            got = tlr.ReduceOnPlateau(0.4, **kw)
            got.set_state_dict(state)
    assert vals == jlr_vals == vals_t
    assert min(vals) < 0.4

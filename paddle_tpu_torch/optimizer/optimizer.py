"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

``torch.optim.Optimizer`` subclasses running paddle_tpu's update rules,
not ``torch.optim``'s. Each optimizer defines ``_update(p32, g32, state,
lr, wd)``, the reference's ``_update``: the fp32 parameter and gradient
in, the new fp32 parameter out, its state dict updated in place. The
shared ``Optimizer`` base does the rest as the reference's eager
``step()`` does:

- the gradients pass through ``grad_clip`` (``nn/clip.py``);
- the learning rate is ``get_lr()``: a float, or an ``LRScheduler``'s
  current value (the user steps the schedule);
- weight decay ``_wd_coeff()`` (a float or an ``L1Decay``/``L2Decay``'s
  ``coeff``) is added to the fp32 gradient: ``decay * p`` (p as stored,
  cast to fp32) for a float or an ``L2Decay``, ``decay * sign(p)`` (the
  gradient of the penalty ``coeff * sum(|p|)``, p the fp32 master where
  there is one) for an ``L1Decay``; the decoupled rules (AdamW, Lamb)
  take a float (or an ``L2Decay``) as ``wd`` of ``_update`` and refuse
  an ``L1Decay``;
- with ``multi_precision`` a parameter that is not fp32 is updated
  through an fp32 master copy (``_master_weights``), then rounded back
  once per step; without it the update still runs in fp32 and is cast
  back;
- ``state_dict``/``set_state_dict`` use the reference's format: ``step``,
  ``LR_Scheduler`` and ``"{name or index}.{state}"``; master weights are
  not in it.

A parameter's name is ``""`` unless the optimizer was given ``(name,
parameter)`` pairs (``parameters=model.named_parameters()``); AdamW's
``apply_decay_param_fun`` and the state-dict keys read it.

``step(lr=..., wd_mask=...)`` overrides this step's rate and masks
weight decay per parameter (``{id(param): bool}``; False skips it).
``apply_gradients(lr, wd_mask=, grads=)`` is the functional trainer's
update, the counterpart of the reference's ``apply_gradients``: it
neither clips nor reads the schedule, and takes the gradients from
``grads`` (``{id(param): tensor}``) when given instead of ``.grad``.
Parameters are updated in place.

With the flag ``use_fused_optimizer`` (default on, as the reference's)
Adam and AdamW step multi-tensor, the counterpart of the reference's
fused step (``_try_fused_step``/``_fused_step_group``: one jitted
program over every parameter): parameters sharing a device, dtypes,
weight decay and step count form a group (cut into runs
of ``FUSED_CHUNK_ELEMENTS``), and each operation of ``_update`` runs once
per run as a ``torch._foreach_*`` call, in the same order and dtypes, so
the result equals the per-parameter loop's bit for bit. Off, the loop
runs. The other optimizers always run the loop.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core.flags import get_flag
from ..regularizer import L1Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "RMSProp", "Adam",
           "AdamW", "Adamax", "Adadelta", "Lamb", "Rprop"]

# elements updated by one multi-tensor call: its fp32 temporaries (the
# parameters', gradients' and moments' fp32 copies and the update's
# intermediates, about seven per element) stay near 3.5 GB
FUSED_CHUNK_ELEMENTS = 1 << 27


def _named_groups(parameters):
    """``parameters`` (tensors, ``(name, tensor)`` pairs, or group dicts
    of either) as torch param groups, and ``{id(param): name}``."""
    items = list(parameters)
    names: Dict[int, str] = {}

    def strip(ps):
        out = []
        for p in ps:
            if isinstance(p, tuple):
                names[id(p[1])] = p[0]
                p = p[1]
            out.append(p)
        return out

    if items and isinstance(items[0], dict):
        groups = [dict(g, params=strip(g["params"])) for g in items]
    else:
        groups = [{"params": strip(items)}]
    return groups, names


class Optimizer(torch.optim.Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError(f"{type(self).__name__}: parameters are "
                             f"required")
        if isinstance(weight_decay, L1Decay) and \
                self._decoupled_weight_decay():
            raise ValueError(f"{type(self).__name__}: decoupled weight "
                             f"decay takes a float, not an L1Decay")
        groups, self._names = _named_groups(parameters)
        self._lr = learning_rate
        self._weight_decay = weight_decay
        # an L1Decay adds decay * sign(p) to the gradient, else decay * p
        self._l1 = isinstance(weight_decay, L1Decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._master_weights: Dict[torch.Tensor, torch.Tensor] = {}
        self._step_count = 0
        super().__init__(groups, {"weight_decay": self._wd_coeff()})
        self._parameter_list = [p for g in self.param_groups
                                for p in g["params"]]

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        self._lr = value

    def _wd_coeff(self) -> float:
        wd = self._weight_decay
        if not wd:
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        return float(getattr(wd, "coeff", 0.0))

    def _name(self, p) -> str:
        return self._names.get(id(p), "")

    # -- per-optimizer rule ------------------------------------------------
    def _init_state(self, p: torch.Tensor) -> dict:
        return {}

    def _update(self, p32, g32, state, lr, wd):
        raise NotImplementedError

    def _decoupled_weight_decay(self) -> bool:
        return False

    def _decay_of(self, p, group) -> float:
        """The weight-decay coefficient of ``p`` (AdamW and Lamb drop it
        for the parameters their functions exclude)."""
        return group["weight_decay"]

    def _state_of(self, p) -> dict:
        state = self.state[p]
        if not state:
            state.update(self._init_state(p))
            state["step"] = 0
        return state

    def _uses_master(self, p) -> bool:
        return self._multi_precision and p.dtype != torch.float32

    def _master(self, p) -> torch.Tensor:
        mw = self._master_weights.get(p)
        if mw is None:
            mw = self._master_weights[p] = p.detach().float()
        return mw

    # -- the eager step ------------------------------------------------------
    def _params_grads(self, grads=None):
        out = []
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if grads is None else grads.get(id(p))
                if g is not None and p.requires_grad:
                    out.append((p, g))
        return out

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[float] = None,
             wd_mask: Optional[Mapping[int, bool]] = None):
        """One update of every parameter that has a gradient: clipped by
        ``grad_clip``, at ``get_lr()`` unless ``lr`` is given."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params_grads = self._params_grads()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._apply(params_grads, self.get_lr() if lr is None else lr,
                    wd_mask)
        return loss

    @torch.no_grad()
    def apply_gradients(self, lr: float,
                        wd_mask: Optional[Mapping[int, bool]] = None,
                        grads: Optional[Mapping[int, torch.Tensor]] = None):
        """The functional trainer's update: every parameter with a
        gradient at rate ``lr``; no clipping, no schedule. Profiled under
        the range ``step()`` gets from ``torch.optim``."""
        with torch.profiler.record_function(
                f"Optimizer.step#{type(self).__name__}.step"):
            self._apply(self._params_grads(grads), lr, wd_mask)

    def _apply(self, params_grads, lr, wd_mask):
        lr = float(lr)
        self._step_count += 1
        grad_of = {id(p): g for p, g in params_grads}
        fused = get_flag("use_fused_optimizer") and self._fusable()
        decoupled = self._decoupled_weight_decay()
        for group in self.param_groups:
            batches = {}
            for p in group["params"]:
                g = grad_of.get(id(p))
                if g is None:
                    continue
                decay = self._decay_of(p, group)
                if wd_mask is not None and not wd_mask.get(id(p), True):
                    decay = 0.0
                state = self._state_of(p)
                if fused:
                    key = (p.device, p.dtype, g.dtype, decay, state["step"])
                    batches.setdefault(key, []).append((p, g))
                    continue
                g32 = g.float()
                p32 = self._master(p) if self._uses_master(p) else p.float()
                if decay and not decoupled:
                    g32 = g32 + decay * (torch.sign(p32) if self._l1
                                         else p.float())
                wd = decay if decoupled else 0.0
                new = self._update(p32, g32, state, lr, wd)
                if self._uses_master(p):
                    self._master_weights[p] = new
                p.copy_(new)
                state["step"] += 1
            for (*_, decay, _), pairs in batches.items():
                for chunk in _chunks(pairs, FUSED_CHUNK_ELEMENTS):
                    self._fused_update(chunk, lr, decay)

    def _fusable(self) -> bool:
        return False

    def _fused_update(self, pairs, lr, decay):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Drop every parameter's gradient (as the reference, whatever
        ``set_to_zero`` says)."""
        self.zero_grad(set_to_none=True)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Eager: ``loss.backward()``, ``step()``, ``clear_grad()``."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -- checkpoint ----------------------------------------------------------
    def state_dict(self) -> dict:
        out = {"step": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for i, p in enumerate(self._parameter_list):
            for k, v in self.state.get(p, {}).items():
                if k != "step":
                    out[f"{self._name(p) or i}.{k}"] = v.detach().clone()
        return out

    def _expected_state(self) -> Dict[str, tuple]:
        """``{state-dict key: shape}`` of every entry this optimizer keeps
        for its parameters (made without touching its state)."""
        out = {}
        for i, p in enumerate(self._parameter_list):
            meta = torch.empty_like(p, device="meta")
            for k, v in self._init_state(meta).items():
                out[f"{self._name(p) or i}.{k}"] = tuple(v.shape)
        return out

    def set_state_dict(self, state_dict: Mapping) -> None:
        """Load a state dict in the reference's format (entries as
        tensors, numpy arrays or numbers), each entry cast to the dtype
        and device of the state it replaces."""
        self._step_count = int(state_dict.get("step", 0))
        if isinstance(self._lr, LRScheduler) and \
                "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        with torch.no_grad():
            for i, p in enumerate(self._parameter_list):
                st = self._state_of(p)
                st["step"] = self._step_count
                for k in list(st):
                    key = f"{self._name(p) or i}.{k}"
                    if k != "step" and key in state_dict:
                        v = state_dict[key]
                        if not isinstance(v, torch.Tensor):
                            v = torch.from_numpy(np.array(v))
                        st[k] = v.to(device=st[k].device,
                                     dtype=st[k].dtype).clone()

    load_state_dict = set_state_dict


def _chunks(params: list, cap: int):
    """``params`` (tensors or ``(tensor, grad)`` pairs) in order, cut into
    runs of at most ``cap`` elements (a larger tensor alone): the fp32
    temporaries of one multi-tensor update stay a few times ``cap`` x 4
    bytes."""
    run, n = [], 0
    for item in params:
        size = (item[0] if isinstance(item, tuple) else item).numel()
        if run and n + size > cap:
            yield run
            run, n = [], 0
        run.append(item)
        n += size
    if run:
        yield run


def _fp32(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """``[t.float() for t in ts]`` of one dtype: the tensors themselves
    when fp32, else fp32 copies made by one ``_foreach_copy_``."""
    if ts[0].dtype == torch.float32:
        return list(ts)
    out = [torch.empty_like(t, dtype=torch.float32) for t in ts]
    torch._foreach_copy_(out, ts)
    return out


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, p32, g32, state, lr, wd):
        return p32 - lr * g32


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p32, g32, state, lr, wd):
        v = self._momentum * state["velocity"] + g32
        upd = g32 + self._momentum * v if self._nesterov else v
        state["velocity"] = v
        return p32 - lr * upd


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _update(self, p32, g32, state, lr, wd):
        m = state["moment"] + torch.square(g32)
        state["moment"] = m
        return p32 - lr * g32 / (torch.sqrt(m) + self._epsilon)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, p):
        s = {"mean_square": torch.zeros_like(p, dtype=torch.float32),
             "momentum": torch.zeros_like(p, dtype=torch.float32)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def _update(self, p32, g32, state, lr, wd):
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * torch.square(g32)
        state["mean_square"] = ms
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g32
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
            state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * state["momentum"] + lr * g32 / denom
        state["momentum"] = mom
        return p32 - mom


class Adam(Optimizer):
    """Adam: moments stored in ``moment_dtype`` (default fp32; the
    arithmetic is fp32 either way), beta powers as fp32 scalars, ``eps``
    added to ``sqrt(v_hat)``; ``amsgrad`` keeps the running maximum of
    the second moment in fp32 (``moment2_max``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None, *,
                 moment_dtype: Optional[torch.dtype] = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = amsgrad
        self._moment_dtype = moment_dtype or torch.float32

    def _init_state(self, p):
        s = {"moment1": torch.zeros_like(p, dtype=self._moment_dtype),
             "moment2": torch.zeros_like(p, dtype=self._moment_dtype),
             "beta1_pow": torch.ones((), dtype=torch.float32,
                                     device=p.device),
             "beta2_pow": torch.ones((), dtype=torch.float32,
                                     device=p.device)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    def _update(self, p32, g32, state, lr, wd):
        b1, b2 = self._beta1, self._beta2
        m1 = b1 * state["moment1"].float() + (1 - b1) * g32
        m2 = b2 * state["moment2"].float() + (1 - b2) * (g32 * g32)
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        mhat = m1 / (1 - b1p)
        if self._amsgrad:
            m2max = torch.maximum(state["moment2_max"], m2)
            vhat = m2max / (1 - b2p)
            state["moment2_max"] = m2max
        else:
            vhat = m2 / (1 - b2p)
        if wd:
            p32 = p32 * (1.0 - lr * wd)
        p32 = p32 - lr * mhat / (torch.sqrt(vhat) + self._epsilon)
        state["moment1"] = m1.to(self._moment_dtype)
        state["moment2"] = m2.to(self._moment_dtype)
        state["beta1_pow"] = b1p
        state["beta2_pow"] = b2p
        return p32

    def _fusable(self) -> bool:
        return True

    def _fused_update(self, pairs, lr: float, decay: float) -> None:
        """``_update`` of every ``(param, grad)`` in ``pairs`` (one
        device, dtypes, decay and step count, hence one pair of beta
        powers and one master-weight choice), each operation one
        ``torch._foreach_*`` call over the group."""
        b1, b2 = self._beta1, self._beta2
        decoupled = self._decoupled_weight_decay()
        params = [p for p, _ in pairs]
        states = [self.state[p] for p in params]
        master = self._uses_master(params[0])
        g = _fp32([g for _, g in pairs])
        if master:
            p32 = [self._master(p) for p in params]
        else:
            p32 = _fp32(params)
        if decay and not decoupled:
            g = torch._foreach_add(g, torch._foreach_mul(
                torch._foreach_sign(p32) if self._l1 else _fp32(params),
                decay))
        m1 = torch._foreach_mul(_fp32([s["moment1"] for s in states]), b1)
        torch._foreach_add_(m1, torch._foreach_mul(g, 1 - b1))
        m2 = torch._foreach_mul(_fp32([s["moment2"] for s in states]), b2)
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - b2)
        torch._foreach_add_(m2, gg)
        del g, gg
        b1p = states[0]["beta1_pow"] * b1
        b2p = states[0]["beta2_pow"] * b2
        step = torch._foreach_div(m1, 1 - b1p)               # mhat
        if self._amsgrad:
            m2max = torch._foreach_maximum(
                [s["moment2_max"] for s in states], m2)
            den = torch._foreach_div(m2max, 1 - b2p)         # vhat
        else:
            den = torch._foreach_div(m2, 1 - b2p)            # vhat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_mul_(step, lr)
        torch._foreach_div_(step, den)
        del den
        if decay and decoupled:
            p32 = torch._foreach_mul(p32, 1.0 - lr * decay)
        torch._foreach_sub_(p32, step)
        if master:
            for p, new in zip(params, p32):
                self._master_weights[p] = new
        if p32[0] is not params[0]:     # else fp32 p32 is the parameters
            torch._foreach_copy_(params, p32)
        for key, new in (("moment1", m1), ("moment2", m2)):
            olds = [s[key] for s in states]
            if olds[0].dtype == torch.float32:
                for s, t in zip(states, new):
                    s[key] = t
            else:
                torch._foreach_copy_(olds, new)
        for i, s in enumerate(states):
            if self._amsgrad:
                s["moment2_max"] = m2max[i]
            s["beta1_pow"] = b1p
            s["beta2_pow"] = b2p
            s["step"] += 1


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01); a parameter whose
    name ``apply_decay_param_fun`` rejects is not decayed."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None, *, moment_dtype: Optional[torch.dtype] = None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name,
                         moment_dtype=moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_weight_decay(self) -> bool:
        return True

    def _decay_of(self, p, group) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._name(p)):
            return 0.0
        return group["weight_decay"]


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update(self, p32, g32, state, lr, wd):
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * state["inf_norm"], torch.abs(g32))
        b1p = state["beta1_pow"] * self._beta1
        state.update(moment=m, inf_norm=u, beta1_pow=b1p)
        return p32 - lr / (1 - b1p) * m / (u + self._epsilon)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(p,
                                                       dtype=torch.float32)}

    def _update(self, p32, g32, state, lr, wd):
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * torch.square(g32)
        upd = g32 * torch.sqrt(state["avg_squared_update"] + eps) / \
            torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + \
            (1 - rho) * torch.square(upd)
        state.update(avg_squared_grad=asg, avg_squared_update=asu)
        return p32 - lr * upd


class Lamb(Optimizer):
    """LAMB: the Adam direction plus decoupled decay, scaled by the trust
    ratio ``|p| / |r|``; a parameter for which
    ``exclude_from_weight_decay_fn(param)`` is true is not decayed."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decoupled_weight_decay(self) -> bool:
        return True

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device),
                "beta2_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _decay_of(self, p, group) -> float:
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return group["weight_decay"]

    def _update(self, p32, g32, state, lr, wd):
        b1, b2 = self._beta1, self._beta2
        m1 = b1 * state["moment1"] + (1 - b1) * g32
        m2 = b2 * state["moment2"] + (1 - b2) * torch.square(g32)
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        r = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + self._epsilon) \
            + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        state.update(moment1=m1, moment2=m2, beta1_pow=b1p, beta2_pow=b2p)
        return p32 - lr * ratio * r


class Rprop(Optimizer):
    """Resilient backprop: per-entry step sizes (``lr`` in the state,
    starting at the learning rate) grown by ``etas[1]`` where the
    gradient keeps its sign and shrunk by ``etas[0]`` where it flips,
    clamped to ``learning_rate_range``; a flip skips that entry's step."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name, multi_precision)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _init_state(self, p):
        return {"prev_grad": torch.zeros_like(p, dtype=torch.float32),
                "lr": torch.full_like(p, self.get_lr(),
                                      dtype=torch.float32)}

    def _update(self, p32, g32, state, lr, wd):
        eta_neg, eta_pos = self._etas
        lo, hi = self._lr_range
        sign = torch.sign(g32 * state["prev_grad"])
        one = torch.ones_like(sign)
        factor = torch.where(sign > 0, eta_pos * one,
                             torch.where(sign < 0, eta_neg * one, one))
        new_lr = torch.clamp(state["lr"] * factor, lo, hi)
        step_grad = torch.where(sign < 0, torch.zeros_like(g32), g32)
        state.update(prev_grad=step_grad, lr=new_lr)
        return p32 - torch.sign(step_grad) * new_lr

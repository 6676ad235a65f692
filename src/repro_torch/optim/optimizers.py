"""Optimizers in plain PyTorch: SGD (+momentum, Nesterov) and AdamW.

The reference's functional API, on nested dicts of tensors::

    opt = sgd(lr=0.01, momentum=0.9)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The reference returns new trees.  The port works in place, so that a
full model's training fits one card's memory (params, grads and the
state, and no second copy of any): ``update`` writes the new state into
``state``'s tensors and the updates into the grads' storage (the grads
are consumed), and ``apply_updates`` adds each update to its parameter
in place; each returns the tree it was given.  The step counter is an
int32 tensor on the parameters' device; sgd evaluates its learning rate
at the step before the update, adamw at the step after, as the reference
does.  ``momentum_dtype``/``moment_dtype`` keep the state in another
type (bf16), with the arithmetic in f32.  Learning rates may be floats
or ``f(step) -> f32 tensor`` schedules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Union

import torch

from repro_torch.core.estimator import tree_leaves, tree_map

PyTree = Any
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]  # (grads, state, params) -> (updates, state)
    name: str = "custom"


def sgd(lr: Schedule, momentum: float = 0.0, nesterov: bool = False,
        momentum_dtype=None) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=momentum_dtype or p.dtype), params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        eta = _lr_at(lr, state["step"])
        state["step"].add_(1)
        if momentum == 0.0:
            for g in tree_leaves(grads):
                g.copy_(-eta * g)
            return grads, state
        for m, g in zip(tree_leaves(state["mu"]), tree_leaves(grads)):
            m.copy_(momentum * m.float() + g)
            eff = momentum * m.float() + g if nesterov else m.float()
            g.copy_(-eta * eff)
        return grads, state

    return Optimizer(init, update, "sgd")


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, moment_dtype=None) -> Optimizer:
    def init(params):
        def mk(p):
            return torch.zeros_like(p, dtype=moment_dtype or torch.float32)
        return {"step": _step0(params), "mu": tree_map(mk, params),
                "nu": tree_map(mk, params)}

    @torch.no_grad()
    def update(grads, state, params):
        s = state["step"].add_(1)
        eta = _lr_at(lr, s)
        bc1 = 1 - b1 ** s.float()
        bc2 = 1 - b2 ** s.float()
        for m, v, g, p in zip(tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), tree_leaves(grads),
                              tree_leaves(params)):
            gf = g.float()
            m.copy_(b1 * m.float() + (1 - b1) * gf)
            v.copy_(b2 * v.float() + (1 - b2) * torch.square(gf))
            step_ = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            g.copy_(-eta * step_)
        return grads, state

    return Optimizer(init, update, "adamw")


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


# ---------------------------------------------------------------------------
# schedules (f32, on the step's device)
# ---------------------------------------------------------------------------


def linear_warmup(base: float, warmup_steps: int) -> Callable:
    def f(step):
        s = torch.as_tensor(step).float()
        return base * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    return f


def cosine_schedule(base: float, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1) -> Callable:
    def f(step):
        s = torch.as_tensor(step).float()
        warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return base * warm * cos
    return f


def make_optimizer(name: str, lr: Schedule, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "sgdm":
        kw.setdefault("momentum", 0.9)
        return sgd(lr, **kw)
    if name == "sgdm_bf16":
        kw.setdefault("momentum", 0.9)
        kw.setdefault("momentum_dtype", torch.bfloat16)
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name}")

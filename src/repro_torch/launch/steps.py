"""Step functions the launchers run.

  train_step  — forward + backward (autograd) + optimizer update
                (``launch/train.py``)
  prefill     — full-sequence forward, without a graph (an enc-dec
                model's ``model.prefill`` without a cache: the encoder,
                then the decoder)
  serve_step  — one token against a cache, without a graph
                (``launch/serve.py``)

As :mod:`repro_torch.optim` does, ``train_step`` works in place: the
parameters and the optimizer state it is given are updated and returned.

On a device mesh the params, the optimizer state, the batch and the cache
are DTensors laid out by :mod:`repro_torch.sharding.rules` (the launcher
installs the activation context, :mod:`repro_torch.sharding.context`):
each step runs under :func:`repro_torch.sharding.context.on_mesh`, so a
tensor the model makes itself (positions, masks, the step counter) is
taken as replicated and a reshape DTensor cannot express gathers first;
the optimizer state keeps its placements (it is updated in place).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.kernels import is_dtensor
from repro_torch.models import model
from repro_torch.optim import apply_updates


def _on_mesh(tree):
    """:func:`repro_torch.sharding.context.on_mesh` where ``tree`` holds
    DTensors, else nothing."""
    if not is_dtensor(tree_leaves(tree)[0]):
        return contextlib.nullcontext()
    from repro_torch.sharding.context import on_mesh
    return on_mesh()


def _sq_norm(g: torch.Tensor) -> torch.Tensor:
    gf = g.float()
    if is_dtensor(g):  # a sum of local partial sums, never gathered
        return (gf * gf).sum()
    return torch.vdot(gf.reshape(-1), gf.reshape(-1))


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter (partial sums
    reduced), so that the optimizer state keeps the parameter's
    placements; a plain one as it is."""
    if hasattr(g, "placements") and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg, optimizer, skip_blocks: bool = False) -> Callable:
    def train_step(params, opt_state, batch):
        with _on_mesh(params):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss, metrics = model.loss_fn(params, cfg, batch, skip_blocks)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a parameter the loss does not read (ln2 under parallel_block)
        # has a zero gradient, as jax.grad gives it
        grads = [torch.zeros_like(t) if g is None else _like(g, t)
                 for t, g in zip(leaves, grads)]
        grad_norm = torch.sqrt(sum(_sq_norm(g) for g in grads))
        it = iter(grads)
        updates, opt_state = optimizer.update(
            tree_map(lambda _: next(it), params), opt_state, params)
        params = apply_updates(params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        return params, opt_state, metrics

    return train_step


def make_prefill(cfg, skip_blocks: bool = False) -> Callable:
    @torch.no_grad()
    def prefill(params, batch):
        with _on_mesh(params):
            return _prefill(params, batch)

    def _prefill(params, batch):
        if cfg.family == "audio" or cfg.encdec is not None:
            logits, _ = model.prefill(params, cfg, batch, cache=None)
        else:
            logits, _ = model.forward(params, cfg, batch, skip_blocks)
        return logits

    return prefill


def make_serve_step(cfg) -> Callable:
    @torch.no_grad()
    def serve_step(params, batch, cache, cache_len):
        with _on_mesh(params):
            return model.serve_step(params, cfg, batch, cache, cache_len)

    return serve_step

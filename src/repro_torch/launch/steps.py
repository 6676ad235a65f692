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
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.models import model
from repro_torch.optim import apply_updates


def make_train_step(cfg, optimizer, skip_blocks: bool = False) -> Callable:
    def train_step(params, opt_state, batch):
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss, metrics = model.loss_fn(params, cfg, batch, skip_blocks)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a parameter the loss does not read (ln2 under parallel_block)
        # has a zero gradient, as jax.grad gives it
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        grad_norm = torch.sqrt(sum(torch.vdot(g.reshape(-1).float(),
                                              g.reshape(-1).float())
                                   for g in grads))
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
        if cfg.family == "audio" or cfg.encdec is not None:
            logits, _ = model.prefill(params, cfg, batch, cache=None)
        else:
            logits, _ = model.forward(params, cfg, batch, skip_blocks)
        return logits

    return prefill


def make_serve_step(cfg) -> Callable:
    @torch.no_grad()
    def serve_step(params, batch, cache, cache_len):
        return model.serve_step(params, cfg, batch, cache, cache_len)

    return serve_step

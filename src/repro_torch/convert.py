"""Carry parameter trees between the JAX package and this port.

The JAX package keeps its parameters as pytrees of arrays, and both
packages use the same layouts, so converting is a copy:

* the FL models: nested dicts of ``{"basis", "coeff"}`` factors per layer,
  or dense ``(ksq, I, O)`` weights (the CNN's, the residual net's, the
  RNN's and the composed transformer's alike, keyed by layer name), with
  HWIO-ordered ``(ksq, I, O)`` weights, ``(ksq, I, R)`` bases and
  ``(blocks, R, O)`` coefficients; the RNN's embedding is a
  ``(1, vocab, R)`` basis or a ``(1, vocab, pE)`` weight, gathered by
  row;
* the model zoo (``repro.models.model.init``): ``{"embed", "unembed",
  "final_norm", "stack"}``, where the hybrid stack holds ``"mamba"`` and
  ``"mamba_norms"`` with every leaf stacked ``(nsuper, attn_every, ...)``
  (``A_log``, ``D`` and ``dt_bias`` f32 whatever the param type) and one
  ``"shared"`` attention+MLP block; linears are ``{"w": (d_in, d_out)}``
  or ``{"basis": (I, R), "coeff": (m, R, O)}``.

Every leaf comes over as float32, the ``param_dtype`` of every zoo config.
The caller turns the pytree into numpy first (``jax.device_get``), which
keeps this module free of JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_jax_params(tree: Any, device) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of float32 tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, np.float32), device=device)


def to_numpy(tree: Any) -> Any:
    """The inverse of :func:`from_jax_params`: nested dicts of tensors ->
    the same dicts of numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()

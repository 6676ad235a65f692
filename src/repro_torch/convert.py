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
  ``"shared"`` attention+MLP block; the MoE stack holds ``"dense_layers"``
  (``first_k_dense`` of them) and ``"moe_layers"``, whose ``"moe"`` holds
  ``"router": {"w"}`` (f32 whatever the param type), the expert tensors
  ``"gate"``/``"up"`` (L, E, d, d_expert) and ``"down"``, and with a
  shared expert ``"shared"``; the xLSTM stack holds ``"mlstm"`` stacked
  ``(nsuper, slstm_every - 1, ...)`` (``"wif": {"w"}`` f32) and
  ``"slstm"`` (``"r"``, and ``"bias"`` f32); the enc-dec stack holds
  ``"encoder"`` and ``"decoder"``, every leaf stacked ``(L, ...)`` (a
  decoder layer's ``"self_attn"``, ``"ln_x"`` and ``"cross_attn"`` beside
  its norms and MLP); linears are ``{"w": (d_in, d_out)}`` or
  ``{"basis": (I, R), "coeff": (m, R, O)}``.

Every leaf keeps its type: float32, or bfloat16 (kimi-k2's
``param_dtype``), which comes through float32 exactly.  The caller
turns the pytree into numpy first (``jax.device_get``), which keeps this
module free of JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_jax_params(tree: Any, device) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``: bfloat16 leaves (numpy's ``ml_dtypes`` type) stay
    bfloat16, every other leaf becomes float32."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    t = torch.as_tensor(np.array(tree, np.float32), device=device)
    if getattr(tree, "dtype", None) is not None and \
            tree.dtype.name == "bfloat16":
        return t.to(torch.bfloat16)
    return t


def to_numpy(tree: Any) -> Any:
    """The inverse of :func:`from_jax_params`: nested dicts of tensors ->
    the same dicts of numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()

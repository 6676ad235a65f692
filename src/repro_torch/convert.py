"""Carry parameter trees between the JAX package and this port.

The JAX package keeps its parameters as pytrees of arrays: nested dicts of
``{"basis", "coeff"}`` factors per layer, or dense ``(ksq, I, O)`` weights
(the CNN's and the composed transformer's alike, keyed by layer name).
Both packages use the same layouts (HWIO-ordered ``(ksq, I, O)`` weights,
``(ksq, I, R)`` bases, ``(blocks, R, O)`` coefficients), so converting is a
copy.  The caller turns the pytree into numpy first (``jax.device_get``),
which keeps this module free of JAX.
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

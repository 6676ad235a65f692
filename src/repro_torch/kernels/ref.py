"""Plain PyTorch oracles for the ported kernels (the allclose targets).

Deliberately naive — the simplest correct formulation of each op — for
the parity tests and ``chip_smoke.py``.  Layouts follow the JAX package:
NHWC activations and HWIO-ordered ``(ksq, I, O)`` weights.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv_rank import _same_conv


def compose_ref(basis: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Neural-composition product (paper Eq. 4, pre-reshape).

    basis (ksq, I, R) x coeff (m, R, O) -> (ksq, I, m*O), with an optional
    leading client axis on both operands.
    """
    inter = torch.einsum("...kir,...mro->...kimo", basis, coeff)
    return inter.reshape(inter.shape[:-2] + (-1,))


def _composed_weight(basis: torch.Tensor, coeff: torch.Tensor, p: int,
                     mode: str) -> torch.Tensor:
    """Composed weight with the paper's block reshape: (ksq, gI, D)."""
    inter = torch.einsum("kir,mro->kimo", basis, coeff)
    ksq, I, m, O = inter.shape
    if mode == "grow_out":
        return inter.reshape(ksq, I, m * O)
    if mode == "grow_in":
        return inter.permute(0, 2, 1, 3).reshape(ksq, p * I, O)
    inter = inter.reshape(ksq, I, p, p, O)
    return inter.permute(0, 2, 1, 3, 4).reshape(ksq, p * I, p * O)


def conv_rank_ref(x: torch.Tensor, basis: torch.Tensor, coeff: torch.Tensor,
                  p: int, mode: str = "square", stride: int = 1
                  ) -> torch.Tensor:
    """Oracle for the fused conv rank path: compose, then one SAME conv.

    x (N, H, W, gI) x basis (ksq, I, R) x coeff (m, R, O) -> (N, Ho, Wo, D).
    """
    return _same_conv(x, _composed_weight(basis, coeff, p, mode), stride)


def compose_apply_ref(x: torch.Tensor, basis: torch.Tensor,
                      coeff: torch.Tensor, p: int, mode: str = "square"
                      ) -> torch.Tensor:
    """Oracle for both fused dense paths: compose, then matmul.

    x (..., gI) x basis (1, I, R) x coeff (m, R, O) -> (..., D).
    """
    return x @ _composed_weight(basis, coeff, p, mode)[0]

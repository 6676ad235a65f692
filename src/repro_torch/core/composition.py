"""Enhanced neural composition (Heroes, Sec. II-B / III), in PyTorch.

Every layer weight ``w_p`` of width multiplier ``p`` is approximated as the
product of a shared *neural basis* ``v`` and a per-width *coefficient*
``u_p`` (Eq. 4 of the paper)::

    w_p ~= v . u_p       v in R^{k^2 x I x R},  u_p in R^{R x (p * pO)}

The *complete* coefficient is stored as ``(P^2, R, O)`` so blocks are a
leading index: selection is a gather, block-wise aggregation (Eq. 5) a
segment mean.  A ``p``-width model takes the ``p^2`` least-trained blocks,
composes them with the basis and reshapes to ``k^2 x pI x pO`` (Fig. 1).

``compose`` routes through the autograd Function of
:mod:`repro_torch.kernels.compose`: its CUDA kernel for tensors on the
card, its plain version on the CPU, and one launch for a cohort under
``torch.func.vmap``.  Training operates directly on the factors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompositionSpec:
    """Static description of one factorized weight.

    Attributes:
      max_width: ``P`` — the maximum width multiplier.  The complete
        coefficient holds ``P**2`` blocks (``P`` for anchored modes).
      rank: ``R`` — the low-rank dimension shared by basis and coefficient.
      base_in: ``I`` — input channels of the width-1 weight.
      base_out: ``O`` — output channels of the width-1 weight.
      ksq: ``k^2`` — spatial size for convolutions; 1 for dense layers.
      mode: how the weight scales with width p —
        "square"   hidden weight, (pI x pO), p^2 blocks (paper Fig. 1);
        "grow_out" input-anchored (first conv / embedding): (I x pO);
        "grow_in"  output-anchored (classifier): (pI x O), p blocks.
    """

    max_width: int
    rank: int
    base_in: int
    base_out: int
    ksq: int = 1
    mode: str = "square"

    @property
    def num_blocks(self) -> int:
        p = self.max_width
        return p * p if self.mode == "square" else p

    def blocks_for_width(self, p: int) -> int:
        if not 1 <= p <= self.max_width:
            raise ValueError(f"width {p} outside [1, {self.max_width}]")
        return p * p if self.mode == "square" else p

    def basis_shape(self) -> Tuple[int, int, int]:
        return (self.ksq, self.base_in, self.rank)

    def coefficient_shape(self) -> Tuple[int, int, int]:
        return (self.num_blocks, self.rank, self.base_out)

    def weight_shape(self, p: int) -> Tuple[int, int, int]:
        pi = p if self.mode in ("square", "grow_in") else 1
        po = p if self.mode in ("square", "grow_out") else 1
        return (self.ksq, pi * self.base_in, po * self.base_out)

    def params_factorized(self, p: int) -> int:
        """Parameter count shipped to a width-``p`` client (basis + blocks)."""
        basis = self.ksq * self.base_in * self.rank
        coeff = self.blocks_for_width(p) * self.rank * self.base_out
        return basis + coeff

    def params_materialized(self, p: int) -> int:
        _, pi, po = self.weight_shape(p)
        return self.ksq * pi * po


def init_factors(gen: torch.Generator, spec: CompositionSpec,
                 device=None) -> Tuple[Tensor, Tensor]:
    """Initialise (basis, coefficient) so the composed weight has
    fan-in-scaled variance (LeCun-style) at every width:
    var(v) = var(u) = sqrt(target_var / R).

    Draws from ``gen`` on its device (a CPU generator gives the same
    factors whatever ``device``), then moves to ``device``.
    """
    fan_in = spec.ksq * spec.base_in
    factor_std = (1.0 / float(fan_in) / spec.rank) ** 0.25
    basis = factor_std * torch.randn(spec.basis_shape(), generator=gen,
                                     device=gen.device)
    coeff = factor_std * torch.randn(spec.coefficient_shape(), generator=gen,
                                     device=gen.device)
    return basis.to(device), coeff.to(device)


def select_blocks(counters, p: int, spec: CompositionSpec) -> np.ndarray:
    """Indices of the ``p^2`` *least trained* blocks (paper Sec. II-B).

    ``counters[i]`` is the number of local iterations block ``i`` has
    received; ties break on the lower index (stable sort).  Host-side.
    """
    c = np.asarray(counters)
    if c.shape != (spec.num_blocks,):
        raise ValueError(f"counters shape {c.shape} != ({spec.num_blocks},)")
    k = spec.blocks_for_width(p)
    order = np.argsort(c, kind="stable")
    return np.sort(order[:k])


def gather_blocks(coefficient: Tensor, block_ids) -> Tensor:
    """Reduced coefficient ``û``: gather ``(m, R, O)`` from ``(P^2, R, O)``.

    ``block_ids`` are host-side control indices, validated eagerly so an
    id-bookkeeping bug raises instead of gathering the wrong block.
    """
    ids = np.asarray(block_ids)
    n = coefficient.shape[0]
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(
            f"block ids out of range: got ids in [{ids.min()}, {ids.max()}] "
            f"for a coefficient with {n} blocks")
    idx = torch.as_tensor(ids.astype(np.int64), device=coefficient.device)
    return coefficient.index_select(0, idx)


def compose(basis: Tensor, reduced_coeff: Tensor, p: int,
            spec: CompositionSpec, *, backend: Optional[str] = None
            ) -> Tensor:
    """Compose the p-width weight:  v · û  →  reshape  (Fig. 1).

    Args:
      basis: ``(ksq, I, R)``; reduced_coeff: ``(m, R, O)`` gathered blocks.
      p: target width.
      backend: ``"einsum"`` (reference) or ``"kernel"`` (the default,
        also for None: the :mod:`repro_torch.kernels.compose` autograd
        Function, the CUDA kernel on the card, its plain version on the
        CPU).

    Returns the ``spec.weight_shape(p)`` weight.  For "square" the
    intermediate ``(ksq, I, p^2·O)`` is viewed as ``(ksq, I, p, p·O)`` and
    the first ``p`` axis merges with ``I`` (the paper's reshape).
    """
    m = spec.blocks_for_width(p)
    if reduced_coeff.shape[0] != m:
        raise ValueError(f"expected {m} blocks, got {reduced_coeff.shape[0]}")
    if backend in (None, "kernel"):
        from repro_torch.kernels.compose import compose as compose_fn

        flat = compose_fn(basis, reduced_coeff)  # (ksq, I, m*O)
        inter = flat.reshape(flat.shape[0], flat.shape[1], m, -1)
    elif backend == "einsum":
        inter = torch.einsum("kir,mro->kimo", basis, reduced_coeff)
    else:
        raise ValueError(f"unknown compose backend {backend!r}")
    ksq, I, _, O = inter.shape
    if spec.mode == "grow_out":
        return inter.reshape(ksq, I, m * O)
    if spec.mode == "grow_in":
        return inter.permute(0, 2, 1, 3).reshape(ksq, m * I, O)
    inter = inter.reshape(ksq, I, p, p, O)
    return inter.permute(0, 2, 1, 3, 4).reshape(ksq, p * I, p * O)


def compose_flops(p: int, spec: CompositionSpec) -> int:
    """MACs*2 for the compose contraction at width p."""
    m = spec.blocks_for_width(p)
    return 2 * spec.ksq * spec.base_in * spec.rank * m * spec.base_out


# ---------------------------------------------------------------------------
# Rank-space application: y = x · (v·û) computed as (x·v)·û
# ---------------------------------------------------------------------------


def _coeff_blocks(reduced_coeff: Tensor, p: int,
                  spec: CompositionSpec) -> Tensor:
    m = spec.blocks_for_width(p)
    if reduced_coeff.shape[-3] != m:
        raise ValueError(f"expected {m} blocks, got {reduced_coeff.shape[-3]}")
    if spec.mode == "square":
        # block a*p+b: a = input group, b = output group -> (p, p, R, O)
        return reduced_coeff.reshape(
            reduced_coeff.shape[:-3] + (p, p) + reduced_coeff.shape[-2:])
    return reduced_coeff


def apply_factors(x: Tensor, basis: Tensor, reduced_coeff: Tensor, p: int,
                  spec: CompositionSpec, mode: str = "dense", *,
                  stride: int = 1, fused: bool = True) -> Tensor:
    """Apply the factorized weight to ``x`` *without materialising it*.

    The input is projected into rank space through the basis (I → R per
    input group) and the coefficient contraction finishes (R → pO).

    Args:
      x: ``mode="dense"``: ``(..., pI_total)`` rows; ``mode="conv"``:
        ``(N, H, W, C)`` NHWC activations with ``C = weight_shape(p)[1]``.
      basis: ``(ksq, I, R)``; reduced_coeff: ``(m, R, O)`` gathered blocks.
      p: target width; spec: the layer's :class:`CompositionSpec`.
      mode: ``"dense"`` (matmul, ``spec.ksq == 1``) or ``"conv"`` (k×k
        SAME conv).
      stride: conv stride.
      fused: ``mode="conv"`` only — route through the fused
        :func:`repro_torch.kernels.conv_rank.conv_rank_apply` primitive;
        ``False`` keeps the unfused separate-ops body below.

    Returns what ``x @ compose(...)`` / ``conv(x, compose(...))`` returns,
    up to float re-association.
    """
    if mode == "dense":
        if spec.ksq != 1:
            raise ValueError("dense apply requires ksq == 1")
        _coeff_blocks(reduced_coeff, p, spec)  # validates the block count
        from repro_torch.kernels.compose import rank_dense_apply

        return rank_dense_apply(x, basis, reduced_coeff, p, spec.mode)
    if mode != "conv":
        raise ValueError(f"unknown apply mode {mode!r}")
    k = int(round(spec.ksq ** 0.5))
    if k * k != spec.ksq:
        raise ValueError(f"conv apply needs square ksq, got {spec.ksq}")
    from repro_torch.kernels.conv_rank import _same_conv, conv_rank_apply

    if fused:
        _coeff_blocks(reduced_coeff, p, spec)  # validates the block count
        return conv_rank_apply(x, basis, reduced_coeff, p, spec.mode,
                               stride=stride)
    # Unfused separate-ops body: basis conv, then an einsum contraction
    # over the (N, g, Ho, Wo, R) rank intermediate.
    u = _coeff_blocks(reduced_coeff, p, spec)
    if spec.mode == "grow_out":
        t = _same_conv(x, basis, stride)
        y = torch.einsum("nhwr,bro->nhwbo", t, u)
        return y.reshape(y.shape[:-2] + (p * spec.base_out,))
    # square / grow_in: the p input groups share the basis — fold the
    # group axis into the batch so one conv serves every group
    N, H, W, _ = x.shape
    xg = x.reshape(N, H, W, p, spec.base_in).permute(0, 3, 1, 2, 4)
    t = _same_conv(xg.reshape(N * p, H, W, spec.base_in), basis, stride)
    Ho, Wo = t.shape[1], t.shape[2]
    t = t.reshape(N, p, Ho, Wo, spec.rank)
    if spec.mode == "grow_in":
        return torch.einsum("nahwr,aro->nhwo", t, u)
    y = torch.einsum("nahwr,abro->nhwbo", t, u)
    return y.reshape(N, Ho, Wo, p * spec.base_out)


def apply_flops(p: int, spec: CompositionSpec, *, applications: int = 1,
                basis_is_gather: bool = False) -> int:
    """MACs*2 of the *rank-space* application per ``applications`` output
    positions: every input group pays ``ksq·I·R`` (none when the basis
    projection is a gather), every block ``R·O``."""
    groups = 1 if spec.mode == "grow_out" else p
    basis = 0 if basis_is_gather else (
        spec.ksq * groups * spec.base_in * spec.rank)
    coeff = spec.blocks_for_width(p) * spec.rank * spec.base_out
    return 2 * applications * (basis + coeff)


def dense_apply_flops(p: int, spec: CompositionSpec, *,
                      applications: int = 1) -> int:
    """MACs*2 of applying the *materialised* p-width weight per
    ``applications`` output positions."""
    _, pi, po = spec.weight_shape(p)
    return 2 * applications * spec.ksq * pi * po


def rank_space_wins(p: int, spec: CompositionSpec, *, applications: int,
                    dense_apply_free: bool = False,
                    basis_is_gather: bool = False,
                    overhead: float = 1.0) -> bool:
    """Static FLOPs decision: does rank-space application beat
    materialise-then-apply for one evaluation of the layer?

    ``applications`` is the total application count per evaluation;
    ``overhead`` scales the rank-space side with measured costs the FLOPs
    model cannot see (``conv_rank_overhead``).
    """
    dense = 0 if dense_apply_free else dense_apply_flops(
        p, spec, applications=applications)
    rank = apply_flops(p, spec, applications=applications,
                       basis_is_gather=basis_is_gather)
    return overhead * rank < compose_flops(p, spec) + dense


def conv_rank_overhead(calibration=None, device=None) -> float:
    """Effective cost multiplier of the conv rank path on this device: the
    ``calibration`` handed in (an ``FLConfig`` pin), else the
    per-process measurement of :mod:`repro_torch.core.calibration` on
    ``device`` (the CUDA card when none is given; raises without one)."""
    if calibration is not None:
        return float(calibration.conv_rank_overhead)
    from repro_torch.core.calibration import get_calibration

    return float(get_calibration(device).conv_rank_overhead)

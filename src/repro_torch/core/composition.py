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
from typing import Dict, Optional, Tuple

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
    id-bookkeeping bug raises instead of gathering the wrong block.  A
    coefficient split over a cohort's shards (one with a ``take_blocks``
    method, the engine's split server state) gathers from the shards that
    hold the blocks.
    """
    ids = np.asarray(block_ids)
    n = coefficient.shape[0]
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(
            f"block ids out of range: got ids in [{ids.min()}, {ids.max()}] "
            f"for a coefficient with {n} blocks")
    if hasattr(coefficient, "take_blocks"):
        return coefficient.take_blocks(ids)
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


def decompose(weight: Tensor, basis: Tensor, p: int,
              spec: CompositionSpec) -> Tensor:
    """Least-squares projection of a materialised p-width weight back onto
    the span of ``basis``:  û* = argmin_û ‖v·û − w‖²  (per ksq slice).

    Used only by parity experiments / materialised baselines: the
    factorized training path never needs it (paper Alg. 2 line 10 is an
    identity there because the factors are the parameters).

    The system ``A û = B`` has ``A`` the ``(ksq·I, R)`` flattened basis.
    It is solved with ``torch.linalg.lstsq``, whose only CUDA driver
    (``gels``) assumes ``A`` of full column rank; the reference's
    ``jnp.linalg.lstsq`` returns the minimum-norm solution, which is the
    same solution there.  A spec with ``ksq·I < R`` cannot have full
    column rank, so it raises instead.

    Returns ``(p^2, R, O)`` reduced-coefficient blocks.
    """
    ksq, pI, pO = weight.shape
    I, O = spec.base_in, spec.base_out
    if (pI, pO) != (p * I, p * O):
        raise ValueError("weight shape inconsistent with width/spec")
    if ksq * I < spec.rank:
        raise ValueError(
            f"decompose needs a basis of full column rank: ksq*I = "
            f"{ksq * I} < rank {spec.rank}")
    # invert the compose reshape: (ksq, p, I, p, O) -> (ksq, I, p*p, O)
    w = weight.reshape(ksq, p, I, p, O).permute(0, 2, 1, 3, 4)
    # flatten basis over (ksq, I): A (ksq*I, R), B (ksq*I, m*O)
    A = basis.reshape(ksq * I, spec.rank)
    B = w.reshape(ksq * I, p * p * O)
    sol = torch.linalg.lstsq(A, B, driver="gels").solution
    # (R, p*p*O) -> (p*p, R, O)
    return sol.reshape(spec.rank, p * p, O).permute(1, 0, 2)


# ---------------------------------------------------------------------------
# Model-level composition plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One factorized weight inside a model: its spec and parameter names."""

    name: str
    spec: CompositionSpec


class CompositionPlan:
    """The set of factorized weights in a model plus shared block counters.

    Heroes tracks one update-times counter vector per factorized weight; all
    weights in a model share the same width assignment ``p_n`` per client,
    so one global counter (the paper's ``c_i``) of size ``P^2`` serves, and
    the block indices are reused for every layer (Fig. 1/3).
    """

    def __init__(self, layers: Dict[str, CompositionSpec], max_width: int):
        ps = {s.max_width for s in layers.values()}
        if ps != {max_width}:
            raise ValueError(
                f"all layer specs must share max_width={max_width}, got {ps}")
        self.layers = dict(layers)
        self.max_width = max_width
        self.num_blocks = max_width * max_width

    def init(self, gen: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32
             ) -> Dict[str, Dict[str, Tensor]]:
        """Random factors for every layer, drawn from ``gen`` in sorted
        layer order, on ``device`` (the CUDA card unless the caller asks
        for the CPU).  The port's generator is not JAX's, so the draws
        differ from the reference's ``init`` by construction."""
        from repro_torch import resolve_device

        device = resolve_device(device)
        params = {}
        for name, spec in sorted(self.layers.items()):
            v, u = init_factors(gen, spec, device)
            params[name] = {"basis": v.to(dtype), "coeff": u.to(dtype)}
        return params

    def reduce(self, params, block_ids) -> Dict[str, Dict[str, Tensor]]:
        """Ship-to-client view: full basis + gathered coefficient blocks.

        ``block_ids`` come from the shared ``P^2`` counter, so they are
        only valid for "square" layers; anchored-mode layers hold ``P``
        blocks and need their own id set.  Ids are validated against each
        layer's ``spec.num_blocks``.
        """
        ids = np.asarray(block_ids)
        out = {}
        for name, spec in self.layers.items():
            if ids.size and (ids.min() < 0 or ids.max() >= spec.num_blocks):
                raise ValueError(
                    f"layer {name!r} ({spec.mode}) has {spec.num_blocks} "
                    f"blocks but got ids in [{ids.min()}, {ids.max()}] — "
                    "anchored layers need their own id set, not the "
                    "shared P^2-counter ids")
            out[name] = {
                "basis": params[name]["basis"],
                "coeff": gather_blocks(params[name]["coeff"], ids),
            }
        return out

    def compose_all(self, reduced_params, p: int) -> Dict[str, Tensor]:
        """Materialise every layer weight at width p from reduced factors."""
        return {
            name: compose(reduced_params[name]["basis"],
                          reduced_params[name]["coeff"], p, spec)
            for name, spec in self.layers.items()
        }

    def traffic_bytes(self, p: int, bytes_per_param: int = 4) -> int:
        """Upload/download payload for a width-p client (basis + blocks)."""
        return bytes_per_param * sum(
            spec.params_factorized(p) for spec in self.layers.values())

    def materialized_bytes(self, p: int, bytes_per_param: int = 4) -> int:
        return bytes_per_param * sum(
            spec.params_materialized(p) for spec in self.layers.values())

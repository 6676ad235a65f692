"""Measured one-shot calibration of the rank-path dispatch model.

The ``auto`` forward-impl choice compares FLOPs (``apply_flops`` vs
``compose_flops + dense_apply_flops``), but FLOPs alone mispredict where
per-op costs dominate: the conv rank path splits one conv into a basis
conv plus a contraction, and a launch-bound device pays per launch what
the FLOPs model cannot see.  Once per process and device (cached), two
micro-benchmarks time the port's own production primitives at
representative engine shapes and turn the ratios into the two numbers the
cost model consumes:

``conv_rank_overhead``
    ``(t_rank / t_mat) / (f_rank / f_mat)`` at the square hidden-conv
    shape, so ``overhead * rank_flops < compose + mat_flops`` reduces to
    *measured-faster at the calibration shape* and extrapolates by FLOPs.

``fused_compose_gain``
    ``t_fused / t_separate`` for the fused compose+apply dense kernel vs
    compose-then-matmul at the classifier-head shape; below 1.0 ``auto``
    routes weight-shaped dense layers through the fused primitive.

Both are pinned through ``FLConfig`` (``conv_rank_overhead`` /
``fused_compose_gain`` > 0, see :func:`from_config`); a fully pinned
config never runs the micro-benchmarks.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from repro_torch import resolve_device

__all__ = ["RankPathCalibration", "measure", "get_calibration",
           "from_config", "for_dispatch"]


@dataclasses.dataclass(frozen=True)
class RankPathCalibration:
    """The two measured knobs the auto cost model consumes (hashable)."""

    conv_rank_overhead: float
    fused_compose_gain: float
    platform: str = "cpu"
    measured: bool = False


# Representative engine shapes: the square hidden conv (cnn conv2) and the
# grow_in classifier head.
_CONV_SHAPE = dict(p=2, n=16, hw=8, base=8, rank=8, k=3, stride=1)
_DENSE_SHAPE = dict(p=2, m=32, base_in=8, base_out=10, rank=8)

# sanity clips: a skewed measurement degrades to a conservative gate
_OVERHEAD_CLIP = (0.25, 32.0)
_GAIN_CLIP = (0.25, 4.0)


def _best_times(fns, args, device, reps: int = 30,
                warmup: int = 5) -> list[float]:
    """Min-of-reps wall time per fn, legs interleaved within each rep; each
    timed call ends in a device synchronise."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    with torch.no_grad():
        for fn in fns:
            for _ in range(warmup):
                fn(*args)
        sync()
        best = [float("inf")] * len(fns)
        for _ in range(reps):
            for i, fn in enumerate(fns):
                t0 = time.perf_counter()
                fn(*args)
                sync()
                best[i] = min(best[i], time.perf_counter() - t0)
    return best


def _measure_conv_overhead(device: torch.device) -> float:
    from repro_torch.core.composition import (CompositionSpec, apply_factors,
                                              apply_flops, compose,
                                              compose_flops,
                                              dense_apply_flops)
    from repro_torch.kernels.conv_rank import _same_conv

    c = _CONV_SHAPE
    p, n, hw, base, rank, stride = (c["p"], c["n"], c["hw"], c["base"],
                                    c["rank"], c["stride"])
    spec = CompositionSpec(p, rank, base, base, ksq=c["k"] ** 2,
                           mode="square")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n, hw, hw, p * base), generator=gen).to(device)
    v = (0.1 * torch.randn(spec.basis_shape(), generator=gen)).to(device)
    u = (0.1 * torch.randn(spec.coefficient_shape(), generator=gen)).to(device)

    def rank_fn(x, v, u):
        return apply_factors(x, v, u, p, spec, "conv", stride=stride)

    def mat_fn(x, v, u):
        return _same_conv(x, compose(v, u, p, spec), stride)

    t_rank, t_mat = _best_times([rank_fn, mat_fn], (x, v, u), device)
    apps = n * hw * hw  # stride-1 SAME conv: every pixel is an application
    f_rank = apply_flops(p, spec, applications=apps)
    f_mat = compose_flops(p, spec) + dense_apply_flops(
        p, spec, applications=apps)
    overhead = (t_rank / t_mat) / (f_rank / f_mat)
    return float(min(max(overhead, _OVERHEAD_CLIP[0]), _OVERHEAD_CLIP[1]))


def _measure_fused_compose_gain(device: torch.device) -> float:
    from repro_torch.core.composition import CompositionSpec, compose
    from repro_torch.kernels.compose import compose_dense_apply

    d = _DENSE_SHAPE
    p, m, bi, bo, rank = (d["p"], d["m"], d["base_in"], d["base_out"],
                          d["rank"])
    spec = CompositionSpec(p, rank, bi, bo, ksq=1, mode="grow_in")
    gen = torch.Generator().manual_seed(1)
    # a cohort of K independent (x, v, u) triples per timed call, as the
    # ops run inside a round: a single head apply is launch-latency sized
    K = 32
    x = torch.randn((K, m, p * bi), generator=gen).to(device)
    v = (0.1 * torch.randn((K,) + spec.basis_shape(), generator=gen)
         ).to(device)
    u = (0.1 * torch.randn((K,) + spec.coefficient_shape(), generator=gen)
         ).to(device)

    def sep_fn(x, v, u):
        return [x[j] @ compose(v[j], u[j], p, spec)[0] for j in range(K)]

    def fus_fn(x, v, u):
        return [compose_dense_apply(x[j], v[j], u[j], p, "grow_in")
                for j in range(K)]

    t_sep, t_fus = _best_times([sep_fn, fus_fn], (x, v, u), device)
    gain = t_fus / t_sep
    return float(min(max(gain, _GAIN_CLIP[0]), _GAIN_CLIP[1]))


def measure(device=None) -> RankPathCalibration:
    """Run both micro-benchmarks on ``device`` (uncached — callers want
    :func:`get_calibration`).  No device means the CUDA card, as for every
    entry point (:func:`repro_torch.resolve_device`)."""
    device = resolve_device(device)
    return RankPathCalibration(
        conv_rank_overhead=_measure_conv_overhead(device),
        fused_compose_gain=_measure_fused_compose_gain(device),
        platform=device.type,
        measured=True,
    )


@functools.lru_cache(maxsize=None)
def _cached(device: str) -> RankPathCalibration:
    return measure(device)


def get_calibration(device=None) -> RankPathCalibration:
    """The per-process calibration of ``device`` (measured once, then
    cached, so every step in the process takes the same impl choices)."""
    return _cached(str(resolve_device(device)))


def from_config(cfg, device=None) -> RankPathCalibration:
    """Resolve a calibration from ``FLConfig`` pins: each knob > 0 pins
    it, 0 (the default) means *measure* on ``device``."""
    ovh = float(getattr(cfg, "conv_rank_overhead", 0.0) or 0.0)
    gain = float(getattr(cfg, "fused_compose_gain", 0.0) or 0.0)
    platform = resolve_device(device).type
    if ovh > 0.0 and gain > 0.0:
        return RankPathCalibration(ovh, gain, platform, measured=False)
    base = get_calibration(device)
    if ovh <= 0.0 and gain <= 0.0:
        return base
    return dataclasses.replace(
        base,
        conv_rank_overhead=ovh if ovh > 0.0 else base.conv_rank_overhead,
        fused_compose_gain=gain if gain > 0.0 else base.fused_compose_gain,
    )


def for_dispatch(cfg, device=None):
    """The calibration an engine threads through, or ``None`` when the
    config's dispatch never consults the cost model (non-``auto``
    ``forward_impl``): materialize / rank_space runs never measure."""
    if getattr(cfg, "forward_impl", "auto") != "auto":
        return None
    return from_config(cfg, device)

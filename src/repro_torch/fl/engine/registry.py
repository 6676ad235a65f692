"""Scheme registry: a paper scheme is a policy bundle, not a subclass.

``@register_scheme("name")`` registers a factory returning a
:class:`SchemeBundle`; ``build_engine`` instantiates the bundle into an
:class:`~repro_torch.fl.engine.runner.EngineRunner`, picking the trainer
and round loop from ``FLConfig`` (``cfg.trainer`` / ``cfg.round_mode``)
unless the bundle owns its trainer (FedProx).

This port registers the paper's five schemes (Sec. VI-B) and FedProx,
and both trainers: ``"sequential"`` and the batched ``"cohort"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.fl.engine.aggregators import (Aggregator,
                                               DenseMeanAggregator,
                                               FlancAggregator,
                                               HeroesAggregator,
                                               MaskedDenseAggregator)
from repro_torch.fl.engine.base import (AssignmentPolicy, LocalTrainer,
                                        ParticipationScheduler, PayloadModel,
                                        RoundLoop)
from repro_torch.fl.engine.loops import SemiAsyncRoundLoop, SyncRoundLoop
from repro_torch.fl.engine.payload import DensePayload, FactorizedPayload
from repro_torch.fl.engine.policies import (FullWidthAssignment,
                                            HeroesAssignment,
                                            TierWidthAssignment)
from repro_torch.fl.engine.runner import EngineRunner
from repro_torch.fl.engine.trainers import (CohortTrainer, ProximalTrainer,
                                            SequentialTrainer)
from repro_torch.fl.types import FLConfig


@dataclasses.dataclass(frozen=True)
class SchemeBundle:
    """Per-scheme component recipe (factories, so bundles are reusable)."""

    name: str
    assignment: Callable[[], AssignmentPolicy]
    payload: Callable[[], PayloadModel]
    aggregator: Callable[[], Aggregator]
    factorized: bool  # clients train (basis, coeff) factors vs dense weights
    estimate: Callable[[FLConfig], bool]  # ship (L, sigma^2, G^2) estimates?
    # Optional scheme-owned local solver (FedProx's proximal SGD).  When
    # set it overrides ``cfg.trainer``.
    trainer: Optional[Callable[[], LocalTrainer]] = None


SCHEMES: Dict[str, Callable[[], SchemeBundle]] = {}


def register_scheme(name: str):
    """Decorator registering a ``() -> SchemeBundle`` factory."""

    def deco(factory: Callable[[], SchemeBundle]):
        SCHEMES[name] = factory
        return factory

    return deco


TRAINERS: Dict[str, Callable[[], LocalTrainer]] = {
    "sequential": SequentialTrainer,
    "cohort": CohortTrainer,
}

ROUND_MODES: Dict[str, Callable[[], RoundLoop]] = {
    "sync": SyncRoundLoop,
    "semi_async": SemiAsyncRoundLoop,
}


def _lookup(table, key, what):
    if key not in table:
        raise ValueError(f"unknown {what} {key!r}; have {sorted(table)}")
    return table[key]


def build_engine(scheme: str, model, parts_x, parts_y, test_batch, het,
                 cfg: FLConfig, eval_width: Optional[int] = None, *,
                 device=None,
                 sampler: Optional[ParticipationScheduler] = None
                 ) -> EngineRunner:
    """Instantiate a registered scheme into a ready-to-run engine on
    ``device`` (the CUDA device by default).  ``sampler`` overrides the
    participation scheduler the runner would build from
    ``cfg.participation`` (:mod:`repro_torch.fl.population.schedulers`),
    e.g. a ``TraceParticipation`` holding its trace."""
    bundle = _lookup(SCHEMES, scheme, "scheme")()
    if bundle.trainer is not None:
        trainer = bundle.trainer()
    else:
        trainer = _lookup(TRAINERS, cfg.trainer, "trainer")()
    loop = _lookup(ROUND_MODES, cfg.round_mode, "round_mode")()
    if eval_width is None:
        eval_width = next(iter(model.specs.values())).max_width
    return EngineRunner(
        bundle.name, model, parts_x, parts_y, test_batch, het, cfg,
        eval_width,
        assignment=bundle.assignment(),
        payload=bundle.payload(),
        aggregator=bundle.aggregator(),
        trainer=trainer,
        loop=loop,
        factorized=bundle.factorized,
        estimate=bundle.estimate(cfg),
        device=device,
        sampler=sampler,
    )


# --------------------------------------------------------------------------
# The paper's five schemes as policy bundles (Sec. VI-B), and FedProx
# --------------------------------------------------------------------------


@register_scheme("fedavg")
def _fedavg() -> SchemeBundle:
    return SchemeBundle(
        name="fedavg",
        assignment=lambda: FullWidthAssignment(adaptive_tau=False),
        payload=lambda: DensePayload(sliced=False),
        aggregator=DenseMeanAggregator,
        factorized=False,
        estimate=lambda cfg: False,
    )


@register_scheme("adp")
def _adp() -> SchemeBundle:
    return SchemeBundle(
        name="adp",
        assignment=lambda: FullWidthAssignment(adaptive_tau=True),
        payload=lambda: DensePayload(sliced=False),
        aggregator=DenseMeanAggregator,
        factorized=False,
        estimate=lambda cfg: True,
    )


@register_scheme("heterofl")
def _heterofl() -> SchemeBundle:
    return SchemeBundle(
        name="heterofl",
        assignment=TierWidthAssignment,
        payload=lambda: DensePayload(sliced=True),
        aggregator=MaskedDenseAggregator,
        factorized=False,
        estimate=lambda cfg: False,
    )


@register_scheme("flanc")
def _flanc() -> SchemeBundle:
    return SchemeBundle(
        name="flanc",
        assignment=TierWidthAssignment,
        payload=FactorizedPayload,
        aggregator=FlancAggregator,
        factorized=True,
        estimate=lambda cfg: False,
    )


@register_scheme("fedprox")
def _fedprox() -> SchemeBundle:
    """FedProx (Li et al.): FedAvg's assignment, payload and merge with a
    proximal local solver; ``FLConfig.prox_mu`` sets its coefficient."""
    return SchemeBundle(
        name="fedprox",
        assignment=lambda: FullWidthAssignment(adaptive_tau=False),
        payload=lambda: DensePayload(sliced=False),
        aggregator=DenseMeanAggregator,
        factorized=False,
        estimate=lambda cfg: False,
        trainer=ProximalTrainer,
    )


@register_scheme("heroes")
def _heroes() -> SchemeBundle:
    return SchemeBundle(
        name="heroes",
        assignment=HeroesAssignment,
        payload=FactorizedPayload,
        aggregator=HeroesAggregator,
        factorized=True,
        estimate=lambda cfg: cfg.estimate,
    )

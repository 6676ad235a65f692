"""Scheme registry: a paper scheme is a policy bundle, not a subclass.

``@register_scheme("name")`` registers a factory returning a
:class:`SchemeBundle`; ``build_engine`` instantiates the bundle into an
:class:`~repro_torch.fl.engine.runner.EngineRunner`, picking the trainer
and round loop from ``FLConfig`` (``cfg.trainer`` / ``cfg.round_mode``).

This port registers ``heroes`` and its baseline ``fedavg``.  The other
schemes of the JAX package, the cohort trainer and the semi-async loop
raise ``NotImplementedError`` naming the ROADMAP step that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.fl.engine.aggregators import (Aggregator,
                                               DenseMeanAggregator,
                                               HeroesAggregator)
from repro_torch.fl.engine.base import (AssignmentPolicy, LocalTrainer,
                                        PayloadModel, RoundLoop)
from repro_torch.fl.engine.loops import SyncRoundLoop
from repro_torch.fl.engine.payload import DensePayload, FactorizedPayload
from repro_torch.fl.engine.policies import (FullWidthAssignment,
                                            HeroesAssignment)
from repro_torch.fl.engine.runner import EngineRunner
from repro_torch.fl.engine.trainers import SequentialTrainer
from repro_torch.fl.types import FLConfig

# what later slices bring in, with the ROADMAP queue A step
LATER_SCHEMES = {name: "ROADMAP queue A step 7"
                 for name in ("adp", "heterofl", "flanc", "fedprox")}
LATER_TRAINERS = {"cohort": "ROADMAP queue A step 7"}
LATER_ROUND_MODES = {"semi_async": "ROADMAP queue A step 7"}


@dataclasses.dataclass(frozen=True)
class SchemeBundle:
    """Per-scheme component recipe (factories, so bundles are reusable)."""

    name: str
    assignment: Callable[[], AssignmentPolicy]
    payload: Callable[[], PayloadModel]
    aggregator: Callable[[], Aggregator]
    factorized: bool  # clients train (basis, coeff) factors vs dense weights
    estimate: Callable[[FLConfig], bool]  # ship (L, sigma^2, G^2) estimates?


SCHEMES: Dict[str, Callable[[], SchemeBundle]] = {}


def register_scheme(name: str):
    """Decorator registering a ``() -> SchemeBundle`` factory."""

    def deco(factory: Callable[[], SchemeBundle]):
        SCHEMES[name] = factory
        return factory

    return deco


TRAINERS: Dict[str, Callable[[], LocalTrainer]] = {
    "sequential": SequentialTrainer,
}

ROUND_MODES: Dict[str, Callable[[], RoundLoop]] = {
    "sync": SyncRoundLoop,
}


def _lookup(table, later, key, what):
    if key in later and key not in table:
        raise NotImplementedError(f"{what}={key!r} is not ported yet "
                                  f"({later[key]})")
    if key not in table:
        raise ValueError(f"unknown {what} {key!r}; have {sorted(table)}")
    return table[key]


def build_engine(scheme: str, model, parts_x, parts_y, test_batch, het,
                 cfg: FLConfig, eval_width: Optional[int] = None, *,
                 device=None) -> EngineRunner:
    """Instantiate a registered scheme into a ready-to-run engine on
    ``device`` (the CUDA device by default)."""
    bundle = _lookup(SCHEMES, LATER_SCHEMES, scheme, "scheme")()
    trainer = _lookup(TRAINERS, LATER_TRAINERS, cfg.trainer, "trainer")()
    loop = _lookup(ROUND_MODES, LATER_ROUND_MODES, cfg.round_mode,
                   "round_mode")()
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
    )


@register_scheme("fedavg")
def _fedavg() -> SchemeBundle:
    return SchemeBundle(
        name="fedavg",
        assignment=FullWidthAssignment,
        payload=DensePayload,
        aggregator=DenseMeanAggregator,
        factorized=False,
        estimate=lambda cfg: False,
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

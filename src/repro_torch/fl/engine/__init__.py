"""Layered FL engine: schemes as policy bundles over a shared core.

See :mod:`repro_torch.fl.engine.base` for the component contracts and
:mod:`repro_torch.fl.engine.registry` for the schemes expressed as
bundles.  ``build_engine`` is the main entry point; ``run_scheme`` in
:mod:`repro_torch.fl.simulation` routes through it.
"""

from repro_torch.fl.engine.aggregators import (DenseMeanAggregator,
                                               HeroesAggregator)
from repro_torch.fl.engine.base import (Aggregator, AssignmentPolicy,
                                        LocalTrainer, ParticipationScheduler,
                                        PayloadModel, RoundLoop)
from repro_torch.fl.engine.loops import SyncRoundLoop
from repro_torch.fl.engine.payload import DensePayload, FactorizedPayload
from repro_torch.fl.engine.policies import (FullWidthAssignment,
                                            HeroesAssignment)
from repro_torch.fl.engine.registry import (SCHEMES, SchemeBundle,
                                            build_engine, register_scheme)
from repro_torch.fl.engine.runner import EngineRunner
from repro_torch.fl.engine.trainers import SequentialTrainer
from repro_torch.fl.types import SchedState, ServerState

__all__ = [
    "Aggregator", "AssignmentPolicy", "LocalTrainer",
    "ParticipationScheduler", "PayloadModel", "RoundLoop",
    "DenseMeanAggregator", "HeroesAggregator",
    "SyncRoundLoop", "DensePayload", "FactorizedPayload",
    "FullWidthAssignment", "HeroesAssignment",
    "SCHEMES", "SchemeBundle", "build_engine", "register_scheme",
    "EngineRunner", "SchedState", "ServerState", "SequentialTrainer",
]

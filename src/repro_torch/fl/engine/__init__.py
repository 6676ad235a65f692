"""Layered FL engine: schemes as policy bundles over a shared core.

See :mod:`repro_torch.fl.engine.base` for the component contracts and
:mod:`repro_torch.fl.engine.registry` for the schemes expressed as
bundles.  ``build_engine`` is the main entry point; ``run_scheme`` in
:mod:`repro_torch.fl.simulation` routes through it.
"""

from repro_torch.fl.engine.aggregators import (DenseMeanAggregator,
                                               FlancAggregator,
                                               HeroesAggregator,
                                               MaskedDenseAggregator)
from repro_torch.fl.engine.base import (Aggregator, AssignmentPolicy,
                                        LocalTrainer, ParticipationScheduler,
                                        PayloadModel, RoundLoop)
from repro_torch.fl.engine.collective import (CohortSlice, CohortStack,
                                              CollectiveMerger, build_merger)
from repro_torch.fl.engine.loops import SemiAsyncRoundLoop, SyncRoundLoop
from repro_torch.fl.engine.payload import DensePayload, FactorizedPayload
from repro_torch.fl.engine.policies import (FullWidthAssignment,
                                            HeroesAssignment,
                                            TierWidthAssignment, tier_width)
from repro_torch.fl.engine.registry import (SCHEMES, SchemeBundle,
                                            build_engine, register_scheme)
from repro_torch.fl.engine.runner import EngineRunner
from repro_torch.fl.engine.state import payload_to_state, state_to_payload
from repro_torch.fl.engine.trainers import (CohortTrainer, ProximalTrainer,
                                            SequentialTrainer)
from repro_torch.fl.types import InFlight, SchedState, ServerState

__all__ = [
    "Aggregator", "AssignmentPolicy", "LocalTrainer",
    "ParticipationScheduler", "PayloadModel", "RoundLoop",
    "DenseMeanAggregator", "FlancAggregator", "HeroesAggregator",
    "MaskedDenseAggregator",
    "CohortSlice", "CohortStack", "CollectiveMerger", "build_merger",
    "SemiAsyncRoundLoop", "SyncRoundLoop",
    "DensePayload", "FactorizedPayload",
    "FullWidthAssignment", "HeroesAssignment", "TierWidthAssignment",
    "tier_width",
    "SCHEMES", "SchemeBundle", "build_engine", "register_scheme",
    "EngineRunner",
    "payload_to_state", "state_to_payload",
    "InFlight", "SchedState", "ServerState",
    "CohortTrainer", "ProximalTrainer", "SequentialTrainer",
]

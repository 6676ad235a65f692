"""Population-scale client simulation: 10^4–10^6 clients, O(cohort) rounds.

Four pieces, as in the JAX package's ``fl/population``:

  * registry    — :class:`PopulationRegistry`: per-client state (RNG
                  stream, shard indices, capability profile, last
                  participation) derived on demand from
                  ``(seed, client_id, round)``; nothing resident.
  * partition   — :class:`VirtualPartition`: the Γ/φ/iid/natural
                  partitions as pure index functions, consumed lazily
                  through ``make_shards`` →
                  :class:`~repro_torch.data.streaming.VirtualShardList`.
  * schedulers  — :class:`~repro_torch.fl.engine.base.ParticipationScheduler`
                  implementations (uniform / availability /
                  resource_gated / trace) + the ``SCHEDULERS`` registry
                  feeding cohorts to the round loops via
                  ``FLConfig.participation``.
  * hierarchy   — :class:`HierarchicalMerger`: the edge groups' partial
                  folds (``FLConfig.edge_groups``) beside the flat merge,
                  on one device.
"""

from repro_torch.fl.population.hierarchy import (HierarchicalMerger,
                                                 assign_edge_groups,
                                                 grouped_ordered_fold)
from repro_torch.fl.population.partition import VirtualPartition
from repro_torch.fl.population.registry import (DEFAULT_TIER_WEIGHTS,
                                                PopulationRegistry,
                                                VirtualClientState)
from repro_torch.fl.population.schedulers import (SCHEDULERS,
                                                  AvailabilityParticipation,
                                                  ResourceGatedParticipation,
                                                  TraceParticipation,
                                                  UniformParticipation,
                                                  build_scheduler,
                                                  register_scheduler)

__all__ = [
    "HierarchicalMerger", "assign_edge_groups", "grouped_ordered_fold",
    "VirtualPartition",
    "DEFAULT_TIER_WEIGHTS", "PopulationRegistry", "VirtualClientState",
    "SCHEDULERS", "AvailabilityParticipation", "ResourceGatedParticipation",
    "TraceParticipation", "UniformParticipation", "build_scheduler",
    "register_scheduler",
]

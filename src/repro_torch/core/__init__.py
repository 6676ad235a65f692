"""Heroes core: enhanced neural composition + adaptive local update."""

from repro_torch.core.aggregation import (  # noqa: F401
    aggregate_basis,
    aggregate_coefficient,
    aggregate_factorized,
    blend,
    fold_shards,
    masked_block_mean,
    masked_block_merge,
    ordered_sum,
    scatter_contribution,
    scatter_contributions_host,
    zero_pad,
)
from repro_torch.core.composition import (  # noqa: F401
    CompositionPlan,
    CompositionSpec,
    apply_factors,
    apply_flops,
    compose,
    compose_flops,
    decompose,
    dense_apply_flops,
    gather_blocks,
    init_factors,
    rank_space_wins,
    select_blocks,
)
from repro_torch.core.convergence import (  # noqa: F401
    BoundState,
    bound,
    solve_rounds,
    tau_star,
    total_time,
)
from repro_torch.core.scheduler import (  # noqa: F401
    ClientAssignment,
    HeroesScheduler,
    RoundPlan,
    SchedulerConfig,
)

"""Heroes core: enhanced neural composition + adaptive local update."""

from repro_torch.core.aggregation import (  # noqa: F401
    aggregate_basis,
    aggregate_coefficient,
)
from repro_torch.core.composition import (  # noqa: F401
    CompositionSpec,
    apply_factors,
    apply_flops,
    compose,
    compose_flops,
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

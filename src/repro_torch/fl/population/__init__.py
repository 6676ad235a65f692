"""Population layer: participation schedulers (only ``uniform`` so far)."""

from repro_torch.fl.population.schedulers import (  # noqa: F401
    SCHEDULERS,
    UniformParticipation,
    build_scheduler,
)

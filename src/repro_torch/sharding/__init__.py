"""Sharding of the FL engine's cohort over an ordered list of devices
(:mod:`repro_torch.sharding.fl`).  The JAX package's model-zoo sharding
rules and context are not part of the port (ROADMAP A.2)."""

from repro_torch.sharding.fl import (  # noqa: F401
    COHORT_AXIS,
    CohortMesh,
    SplitBlocks,
    assemble,
    assemble_from_host_shards,
    can_shard_blocks,
    cohort_mesh,
    local_devices,
    logical_devices,
    pad_cohort,
    split_rows,
)

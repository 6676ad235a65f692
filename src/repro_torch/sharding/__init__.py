"""Sharding of the port (the reference: ``repro/sharding``).

* :mod:`repro_torch.sharding.rules`: the model zoo's param-tree paths ->
  specs (the reference's ``PartitionSpec``), the batch's and the decode
  cache's, and specs -> DTensor placements on a ``DeviceMesh``;
* :mod:`repro_torch.sharding.context`: the activation-sharding context
  the launchers install (the residual stream's layout, context-parallel
  attention, the expert-parallel MoE);
* :mod:`repro_torch.sharding.fl`: the FL engine's cohort over an ordered
  list of devices.
"""

from repro_torch.sharding.rules import (  # noqa: F401
    batch_specs,
    cache_specs,
    param_specs,
)
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

"""Federated dataset subsystem: the dataset and partitioner registries
and the client data pipeline (numpy host arrays, tensors on the device).

Only the ``synthetic_image`` dataset is registered in this port so far.
"""

from repro_torch.data.base import (  # noqa: F401
    DATASETS,
    FederatedDataset,
    load_dataset,
    register_dataset,
)
from repro_torch.data.partition import (  # noqa: F401
    PARTITIONERS,
    class_skew_partition,
    dirichlet_partition,
    iid_partition,
    natural_partition,
    partition_dataset,
    register_partitioner,
)
from repro_torch.data.streaming import (  # noqa: F401
    ClientDataLoader,
    ShardView,
    make_shards,
    round_batch_indices,
    to_batch,
)
from repro_torch.data.synthetic import SyntheticImageTask  # noqa: F401

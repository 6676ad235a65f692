"""Federated dataset subsystem: the dataset and partitioner registries
and the client data pipeline (numpy host arrays, tensors on the device).

Registered datasets: the ``synthetic_image`` and ``synthetic_text``
stand-ins, and the CIFAR-10 (binary batches or npz) and Shakespeare (text)
loaders, which read local files under ``data_root`` or fall back to a
deterministic synthetic set, cached as npz (:mod:`repro_torch.data.cache`).
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
    VirtualShardList,
    make_shards,
    round_batch_indices,
    stack_client_shards,
    to_batch,
)
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticImageTask,
    SyntheticTextTask,
    lm_batches,
)
from repro_torch.data import cifar10 as _cifar10  # noqa: F401  (registers "cifar10")
from repro_torch.data import shakespeare as _shakespeare  # noqa: F401  ("shakespeare")

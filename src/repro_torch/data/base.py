"""FederatedDataset API + dataset registry.

Every task is served behind one container: named ``(x, y)`` numpy splits
(at least ``train`` and ``test``) plus a metadata dict describing the
modality and how to partition/model it.  Loaders are registered with
``@register_dataset("name")`` and looked up with :func:`load_dataset`.

Metadata keys the rest of the system reads:

  modality          "image" | "text"
  num_classes       image tasks: label count (model output dim)
  partition_labels  optional (N,) labels the label-based partitioners
                    split on; defaults to ``y`` for image tasks
  source            "synthetic" for the generated stand-ins
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

# datasets of the JAX package that later slices of the port bring in
_LATER = {"synthetic_text": "ROADMAP queue A step 7 (rnn)",
          "cifar10": "ROADMAP queue A step 7",
          "shakespeare": "ROADMAP queue A step 7 (rnn)"}


@dataclasses.dataclass
class FederatedDataset:
    """A task as named splits + metadata.

    ``splits[name] = (inputs, targets)``: for image tasks inputs are
    ``(N, H, W, C)`` float32 and targets ``(N,)`` int labels.
    """

    name: str
    splits: Dict[str, Tuple[np.ndarray, np.ndarray]]
    metadata: Dict[str, Any]

    def __post_init__(self):
        for required in ("train", "test"):
            if required not in self.splits:
                raise ValueError(
                    f"dataset {self.name!r} is missing the {required!r} split")
        for split, (x, y) in self.splits.items():
            if len(x) != len(y):
                raise ValueError(
                    f"{self.name}/{split}: {len(x)} inputs vs {len(y)} targets")

    @property
    def x(self) -> np.ndarray:
        return self.splits["train"][0]

    @property
    def y(self) -> np.ndarray:
        return self.splits["train"][1]

    @property
    def modality(self) -> str:
        return self.metadata["modality"]

    @property
    def partition_labels(self) -> np.ndarray:
        """1-D labels the label-based partitioners operate on."""
        labels = self.metadata.get("partition_labels")
        if labels is not None:
            return np.asarray(labels)
        return self.y

    def test_batch(self, device) -> Dict[str, torch.Tensor]:
        """The full test split as the batch dict the FL models consume,
        on ``device``."""
        tx, ty = self.splits["test"]
        key = "tokens" if self.modality == "text" else "x"
        return {key: torch.as_tensor(tx, device=device),
                "labels": torch.as_tensor(ty, dtype=torch.long,
                                          device=device)}


DATASETS: Dict[str, Callable[..., FederatedDataset]] = {}


def register_dataset(name: str):
    """Decorator registering a ``(**kwargs) -> FederatedDataset`` loader."""

    def deco(loader: Callable[..., FederatedDataset]):
        DATASETS[name] = loader
        return loader

    return deco


def load_dataset(name: str, **kwargs) -> FederatedDataset:
    """Look up and invoke a registered loader (``seed`` and the loader's
    own keywords pass through)."""
    if name in _LATER and name not in DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet ({_LATER[name]})")
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](**kwargs)

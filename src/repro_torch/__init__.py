"""Heroes on PyTorch and CUDA: the port of the ``repro`` JAX package.

Lightweight federated learning with neural composition and adaptive local
update (Yan et al., 2023).  The module tree mirrors ``repro``; the
composition hot path runs through hand-written Hopper kernels
(:mod:`repro_torch.kernels`).  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card by default.

    With no CUDA device and no explicit request this raises instead of
    running on the CPU; pass ``device="cpu"`` to ask for the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")

"""Checkpoints: the npz format of :mod:`repro_torch.checkpoint.npz_ckpt`."""

from repro_torch.checkpoint.npz_ckpt import (  # noqa: F401
    load_checkpoint,
    restore_latest,
    save_checkpoint,
)

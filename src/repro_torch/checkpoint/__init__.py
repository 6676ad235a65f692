"""Checkpoints: the JAX package's msgpack format
(:mod:`repro_torch.checkpoint.msgpack_ckpt`, the engine's and the
training launcher's), and :mod:`repro_torch.checkpoint.npz_ckpt`, the
reader and writer of the npz checkpoints earlier versions of the port
wrote."""

from repro_torch.checkpoint.msgpack_ckpt import (  # noqa: F401
    load_checkpoint,
    restore_latest,
    save_checkpoint,
)

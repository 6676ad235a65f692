"""Input specs for every (architecture x input shape), in PyTorch.

``input_specs(cfg, shape)`` returns the tree a step function of
:mod:`repro_torch.launch.steps` consumes at that shape, as tensors on the
``meta`` device: shapes and types, never allocated.  Train and prefill
shapes give token batches (stub embeddings and M-RoPE positions for the
vlm family, stub frame embeddings and their mask for the audio family);
decode shapes give a one-token batch, the cache populated to
``seq_len`` (``model.init_cache`` on ``meta``) and a ``cache_len``.

``params_shape(cfg)`` is ``model.init`` on ``meta`` and
``opt_state_shape(cfg, optimizer)`` the optimizer's state for it, also on
``meta``: the trees :mod:`repro_torch.sharding.rules` lays out and the
dry run (:mod:`repro_torch.launch.dryrun`) materialises one shard of.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.estimator import tree_map
from repro_torch.models import model

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_batch(cfg: ModelConfig, B: int, S: int,
                 with_labels: bool) -> Dict[str, Any]:
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        batch["embeddings"] = _spec((B, S, cfg.d_model), cfg.cdtype)
        batch["positions"] = _spec((B, 3, S), torch.int32)
        if with_labels:
            batch["labels"] = _spec((B, S), torch.int32)
        return batch
    batch["tokens"] = _spec((B, S), torch.int32)
    if cfg.family == "audio":
        Se = cfg.encdec.encoder_seq
        batch["enc_embeddings"] = _spec((B, Se, cfg.d_model), cfg.cdtype)
        batch["enc_mask"] = _spec((B, Se), torch.bool)
    if with_labels:
        batch["labels"] = _spec((B, S), torch.int32)
    return batch


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": _token_batch(cfg, B, S, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": _token_batch(cfg, B, S, with_labels=False)}
    # decode: one token + the cache populated to seq_len
    batch: Dict[str, Any] = {"tokens": _spec((B, 1), torch.int32)}
    if cfg.rope_type == "mrope":
        batch["positions"] = _spec((B, 3, 1), torch.int32)
    return {"batch": batch,
            "cache": model.init_cache(cfg, B, S, META),
            "cache_len": _spec((), torch.int32)}


def params_shape(cfg: ModelConfig):
    """``model.init``'s tree on ``meta``: every leaf's shape and type, never
    allocated (kimi-k2's 1T parameters included).  ``init`` runs under a
    fake-tensor mode, which draws nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = model.init(0, cfg, "cpu")
    return tree_map(lambda t: _spec(t.shape, t.dtype), fake)


def opt_state_shape(cfg: ModelConfig, optimizer):
    """``optimizer.init`` of :func:`params_shape`, on ``meta``."""
    return optimizer.init(params_shape(cfg))

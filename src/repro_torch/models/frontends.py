"""Stub modality frontends ([vlm]/[audio] carve-out), in PyTorch.

These produce *precomputed embeddings* of the right shape: they stand in
for a ViT/SigLIP vision tower (qwen2-vl) or a mel+conv audio codec
(seamless-m4t), as the reference's ``repro.models.frontends`` does.  The
backbone consumes their output; the towers themselves are out of scope.

The draws come from an explicit :class:`torch.Generator`, on its device,
so they differ from the reference's ``jax.random`` draws by construction
(ROADMAP C.3); the positions and masks are the reference's exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.module import normal

Tensor = torch.Tensor


def vision_patch_embeddings(gen: torch.Generator, batch: int,
                            num_patches: int, d_model: int,
                            grid: Optional[Tuple[int, int]] = None,
                            dtype=torch.float32) -> Dict[str, Tensor]:
    """Stub ViT output (0.02 N(0, 1) draws) and the M-RoPE (t, h, w)
    position ids of qwen2-vl, on ``gen``'s device.

    ``grid``: (h, w) patch grid; defaults to a near-square factorisation.
    """
    if grid is None:
        h = int(num_patches ** 0.5)
        while num_patches % h:
            h -= 1
        grid = (h, num_patches // h)
    h, w = grid
    dev = gen.device
    emb = normal(gen, (batch, num_patches, d_model), dtype, 0.02)
    hh, ww = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    pos = torch.stack([torch.zeros(num_patches, dtype=torch.int32,
                                   device=dev),
                       hh.reshape(-1).to(torch.int32),
                       ww.reshape(-1).to(torch.int32)])
    return {"embeddings": emb,
            "positions": pos[None].expand(batch, 3, num_patches)}


def interleave_text(vis: Dict[str, Tensor], text_tokens: Tensor,
                    embed_table: Tensor,
                    dtype=torch.float32) -> Dict[str, Tensor]:
    """Concatenate stub vision embeddings with embedded text tokens and
    extend the M-RoPE positions along the temporal axis (text ids 1..S in
    all three).  The reference's first argument, a key it does not use,
    is left out."""
    B = vis["embeddings"].shape[0]
    S = text_tokens.shape[1]
    t_emb = embed_table[text_tokens.long()].to(dtype)
    t_pos = torch.arange(1, S + 1, dtype=torch.int32,
                         device=text_tokens.device).expand(B, 3, S)
    return {
        "embeddings": torch.cat([vis["embeddings"].to(dtype), t_emb], 1),
        "positions": torch.cat([vis["positions"], t_pos], 2),
    }


def audio_frame_embeddings(gen: torch.Generator, batch: int,
                           num_frames: int, d_model: int,
                           valid_frames: Optional[Tensor] = None,
                           dtype=torch.float32) -> Dict[str, Tensor]:
    """Stub conv-codec output for seamless-m4t, on ``gen``'s device:
    frame embeddings (0.02 N(0, 1) draws) and a (batch, num_frames) bool
    mask, all True, or True on the first ``valid_frames[b]`` frames of
    row ``b``."""
    dev = gen.device
    emb = normal(gen, (batch, num_frames, d_model), dtype, 0.02)
    if valid_frames is None:
        mask = torch.ones((batch, num_frames), dtype=torch.bool, device=dev)
    else:
        mask = (torch.arange(num_frames, device=dev)[None, :]
                < valid_frames.to(dev)[:, None])
    return {"enc_embeddings": emb, "enc_mask": mask}

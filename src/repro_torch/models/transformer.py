"""Stack assembly for the zoo's hybrid family (zamba2), in PyTorch.

The reference scans its stacks with ``lax.scan`` over layer-stacked
params; the port keeps the same stacked parameter tree and walks it with
Python loops.

  hybrid (zamba2)    superblocks of ``attn_every`` Mamba2 layers, each
                     followed by one *shared* attention+MLP block (the same
                     params at every application — the sharing is the
                     point of the architecture)

Mamba2 params are stacked ``(nsuper, attn_every, ...)`` as in the
reference.  The reference's ``constrain_residual`` (a sharding constraint
on the residual stream) is a no-op without a device mesh and is left out.
The dense, MoE and xLSTM stacks are not ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.estimator import tree_map
from repro_torch.models import attention, layers, module, ssm

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_kv_cache(cfg, batch: int, max_len: int,
                  num_layers: Optional[int] = None,
                  device=None) -> Dict[str, Tensor]:
    n = num_layers if num_layers is not None else cfg.num_layers
    if cfg.kv_cache_quant == "int8":
        raise NotImplementedError("the int8 KV cache is not ported "
                                  "(ROADMAP A11)")
    shape = (n, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


# ---------------------------------------------------------------------------
# hybrid (zamba2): mamba superblocks + shared attention block
# ---------------------------------------------------------------------------


def init_shared_block(gen, cfg) -> Params:
    hb = cfg.hybrid
    d_ff = hb.shared_d_ff or 4 * cfg.d_model
    dev = gen.device
    return {
        "ln1": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "attn": attention.init_attention(gen, cfg),
        "ln2": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "mlp": layers.init_mlp(gen, cfg.d_model, d_ff, cfg.activation, cfg,
                               cfg.pdtype),
    }


def init_hybrid_stack(gen, cfg) -> Params:
    hb = cfg.hybrid
    if cfg.num_layers % hb.attn_every:
        raise ValueError("layers must tile into superblocks")
    nsuper = cfg.num_layers // hb.attn_every

    def by_superblock(a):  # (L, ...) -> (nsuper, attn_every, ...)
        return a.reshape(nsuper, hb.attn_every, *a.shape[1:])

    mamba = module.stacked_init(
        lambda g: ssm.init_mamba2(g, cfg, cfg.pdtype), gen, cfg.num_layers)
    norms = module.stacked_init(
        lambda g: layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype,
                                   g.device), gen, cfg.num_layers)
    return {
        "mamba": tree_map(by_superblock, mamba),
        "mamba_norms": tree_map(by_superblock, norms),
        "shared": init_shared_block(gen, cfg),
    }


def _layer(tree, *idx):
    return tree_map(lambda a: a[idx], tree)


def _shared_block(shared: Params, cfg, h: Tensor, attn_fn) -> Tensor:
    hs = layers.apply_norm(shared["ln1"], h, cfg.norm)
    h = h + attn_fn(shared["attn"], hs)
    hm = layers.apply_norm(shared["ln2"], h, cfg.norm)
    return h + layers.apply_mlp(shared["mlp"], hm, cfg.activation)


def apply_hybrid(params: Params, cfg, x: Tensor, cos,
                 sin) -> Tuple[Tensor, Tensor]:
    """Full-sequence hybrid stack.  Returns (x, aux loss = 0)."""
    shared = params["shared"]
    nsuper, per = params["mamba"]["A_log"].shape[:2]
    for s in range(nsuper):
        for i in range(per):
            norm_p = _layer(params["mamba_norms"], s, i)
            mp = _layer(params["mamba"], s, i)
            x = x + ssm.apply_mamba2(mp, cfg,
                                     layers.apply_norm(norm_p, x, cfg.norm))
        x = _shared_block(shared, cfg, x, lambda p, hs: attention.
                          self_attention(p, cfg, hs, cos, sin))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_hybrid_cache(cfg, batch: int, max_len: int,
                      device=None) -> Dict[str, Any]:
    hb = cfg.hybrid
    nsuper = cfg.num_layers // hb.attn_every
    one = ssm.init_mamba2_cache(cfg, batch, cfg.cdtype, device)
    # stacked (nsuper, attn_every, ...), real storage: decode writes it
    mcache = {k: torch.zeros((nsuper, hb.attn_every, *a.shape),
                             dtype=a.dtype, device=device)
              for k, a in one.items()}
    kv = init_kv_cache(cfg, batch, max_len, num_layers=nsuper,
                       device=device)
    return {"mamba": mcache, "kv": kv}


def decode_hybrid(params: Params, cfg, x: Tensor, cache, cache_len, cos,
                  sin):
    """One token through the hybrid stack.  The cache is updated in place
    (each layer's conv history and state, each superblock's KV slot
    ``cache_len``) and returned."""
    shared = params["shared"]
    mc = cache["mamba"]
    nsuper, per = params["mamba"]["A_log"].shape[:2]
    for s in range(nsuper):
        for i in range(per):
            norm_p = _layer(params["mamba_norms"], s, i)
            mp = _layer(params["mamba"], s, i)
            out, new = ssm.apply_mamba2_decode(
                mp, cfg, layers.apply_norm(norm_p, x, cfg.norm),
                {"conv": mc["conv"][s, i], "state": mc["state"][s, i]})
            mc["conv"][s, i] = new["conv"]
            mc["state"][s, i] = new["state"]
            x = x + out
        ck, cv = cache["kv"]["k"][s], cache["kv"]["v"][s]
        x = _shared_block(shared, cfg, x, lambda p, hs: attention.
                          decode_self_attention(p, cfg, hs, ck, cv,
                                                cache_len, cos, sin)[0])
    return x, cache

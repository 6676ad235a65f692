"""Stack assembly for the zoo's families, in PyTorch.

The reference scans its stacks with ``lax.scan`` over layer-stacked
params; the port keeps the same stacked parameter tree and walks it with
Python loops.

  dense / vlm        identical decoder layers (attention + MLP, sequential
                     or ``parallel_block``), params stacked ``(L, ...)``
  moe                ``first_k_dense`` dense layers (``dense_layers``)
                     then MoE layers (``moe_layers``); the aux loss is
                     summed over both
  hybrid (zamba2)    superblocks of ``attn_every`` Mamba2 layers, each
                     followed by one *shared* attention+MLP block (the same
                     params at every application — the sharing is the
                     point of the architecture)
  ssm (xlstm)        superblocks of ``slstm_every - 1`` mLSTM layers and
                     one sLSTM layer

With ``cfg.remat`` and a gradient being recorded, each decoder layer and
each mLSTM layer runs under ``torch.utils.checkpoint`` (non-reentrant),
the reference's ``jax.checkpoint`` around its scan body: activations
are recomputed in the backward, and the numbers do not change.  While a
torch profiler records, each such layer runs in the span ``model.layer``,
and its replay in the backward in ``model.layer.recompute``
(:mod:`repro_torch.obs.spans`).  Mamba2
params are stacked ``(nsuper, attn_every, ...)`` and mLSTM params
``(nsuper, slstm_every - 1, ...)`` as in the reference.  The decode
caches have real storage and are written in place (the reference
broadcasts its initial caches and returns updated copies).  Each layer
and each superblock ends with ``constrain_residual`` where the
reference's does (:mod:`repro_torch.sharding.context`: the residual
stream's layout on a device mesh, a no-op without one).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled
from torch.utils.checkpoint import checkpoint

from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.models import attention, layers, module, ssm, xlstm
from repro_torch.models import moe as moe_lib
from repro_torch.obs.spans import span
from repro_torch.sharding.context import constrain_residual, in_mesh_context

Tensor = torch.Tensor
Params = Dict[str, Any]


def _layer(tree, *idx):
    return tree_map(lambda a: a[idx], tree)


def _unstack(tree) -> list:
    """The per-layer trees of a ``(L, ...)``-stacked tree, as views made
    by one ``unbind`` per leaf: its backward stacks the layers' gradients
    once, where indexing layer by layer would add a full-size gradient of
    the stack per layer."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


# ---------------------------------------------------------------------------
# dense decoder layer
# ---------------------------------------------------------------------------


def init_decoder_layer(gen, cfg, use_moe: bool = False) -> Params:
    dev = gen.device
    p = {
        "ln1": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
        "attn": attention.init_attention(gen, cfg),
        "ln2": layers.init_norm(cfg.d_model, cfg.norm, cfg.pdtype, dev),
    }
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, cfg.pdtype)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                   cfg.activation, cfg, cfg.pdtype)
    return p


def _ffn(params: Params, cfg, h: Tensor):
    """The layer's FFN on ``h``: (out, aux loss, or None for a dense
    MLP)."""
    if "moe" in params:
        return moe_lib.apply_moe(params["moe"], cfg, h)
    return layers.apply_mlp(params["mlp"], h, cfg.activation), None


def decoder_layer(params: Params, cfg, x: Tensor, cos, sin,
                  skip_blocks: bool = False):
    """Returns (x, aux loss: None for a dense layer)."""
    h = layers.apply_norm(params["ln1"], x, cfg.norm)
    attn_out = attention.self_attention(params["attn"], cfg, h, cos, sin,
                                        skip_masked_blocks=skip_blocks)
    if cfg.parallel_block:
        ffn_out, aux = _ffn(params, cfg, h)
        return x + attn_out + ffn_out, aux
    x = x + attn_out
    h2 = layers.apply_norm(params["ln2"], x, cfg.norm)
    ffn_out, aux = _ffn(params, cfg, h2)
    return x + ffn_out, aux


def decoder_layer_decode(params: Params, cfg, x: Tensor, ck, cv, cache_len,
                         cos, sin, scales=None):
    """One token through a decoder layer; the caches (and, for the int8
    cache, ``scales``) are written in place.  Returns (out, ck, cv[,
    scales])."""
    h = layers.apply_norm(params["ln1"], x, cfg.norm)
    res = attention.decode_self_attention(params["attn"], cfg, h, ck, cv,
                                          cache_len, cos, sin,
                                          cache_scales=scales)
    attn_out = res[0]
    if cfg.parallel_block:
        out = x + attn_out + _ffn(params, cfg, h)[0]
    else:
        x = x + attn_out
        h2 = layers.apply_norm(params["ln2"], x, cfg.norm)
        out = x + _ffn(params, cfg, h2)[0]
    return (out, *res[1:])


# ---------------------------------------------------------------------------
# dense / moe stacks
# ---------------------------------------------------------------------------


def init_stack(gen, cfg) -> Params:
    if cfg.moe is not None:
        fkd = cfg.moe.first_k_dense
        p: Params = {}
        if fkd:
            p["dense_layers"] = module.stacked_init(
                lambda g: init_decoder_layer(g, cfg, use_moe=False), gen,
                fkd)
        p["moe_layers"] = module.stacked_init(
            lambda g: init_decoder_layer(g, cfg, use_moe=True), gen,
            cfg.num_layers - fkd)
        return p
    return {"layers": module.stacked_init(
        lambda g: init_decoder_layer(g, cfg), gen, cfg.num_layers)}


def _parts(params: Params, cfg) -> list:
    """The stack's layer-stacked parts in stack order (dense first)."""
    if cfg.moe is None:
        return [params["layers"]]
    return [params[k] for k in ("dense_layers", "moe_layers")
            if k in params]


def _recording(params) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))


def _spanned(fn, *args):
    """``fn(*args)`` inside the span ``model.layer``, or
    ``model.layer.recompute`` where autograd's backward replays it
    (remat), timed on the device of its first tensor argument."""
    if not _profiler_enabled():
        return fn(*args)
    name = ("model.layer" if torch._C._current_graph_task_id() == -1
            else "model.layer.recompute")
    dev = next((a.device for a in args if isinstance(a, Tensor)), None)
    with span(name, dev):
        return fn(*args)


def _run(remat: bool, fn, *args):
    if remat:
        # the backward replays fn, on the card in autograd's own thread:
        # a device mesh's context goes with it
        return checkpoint(functools.partial(_spanned, in_mesh_context(fn)),
                          *args, use_reentrant=False)
    return _spanned(fn, *args)


def apply_stack(params: Params, cfg, x: Tensor, cos, sin,
                skip_blocks: bool = False) -> Tuple[Tensor, Tensor]:
    """Full-sequence dense or MoE stack.  Returns (x, aux loss summed
    over the layers; 0 for a dense stack)."""
    remat = cfg.remat and _recording(params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for part in _parts(params, cfg):
        for lp in _unstack(part):
            x, a = _run(remat, decoder_layer, lp, cfg, x, cos, sin,
                        skip_blocks)
            x = constrain_residual(x)
            if a is not None:
                aux = aux + a
    return x, aux


def decode_stack(params: Params, cfg, x: Tensor, cache: Dict[str, Tensor],
                 cache_len, cos, sin) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One token through the dense or MoE stack.  cache: {"k":
    (L,B,S,KV,D), "v": same} stacked over *all* layers in stack order
    (dense first), and for the int8 cache "k_scale"/"v_scale" (L,B,S,KV);
    each layer's slot is written in place and the cache returned."""
    quant = "k_scale" in cache
    i = 0
    for part in _parts(params, cfg):
        for lp in _unstack(part):
            scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quant
                      else None)
            x = decoder_layer_decode(lp, cfg, x, cache["k"][i],
                                     cache["v"][i], cache_len, cos, sin,
                                     scales)[0]
            i += 1
    return x, cache


def init_kv_cache(cfg, batch: int, max_len: int,
                  num_layers: Optional[int] = None,
                  device=None) -> Dict[str, Tensor]:
    n = num_layers if num_layers is not None else cfg.num_layers
    shape = (n, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_quant == "int8":
        sshape = shape[:-1]
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device)}
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


def _shared_block(shared: Params, cfg, h: Tensor, attn_fn) -> Tensor:
    hs = layers.apply_norm(shared["ln1"], h, cfg.norm)
    h = h + attn_fn(shared["attn"], hs)
    hm = layers.apply_norm(shared["ln2"], h, cfg.norm)
    return h + layers.apply_mlp(shared["mlp"], hm, cfg.activation)


def apply_hybrid(params: Params, cfg, x: Tensor, cos, sin,
                 skip_blocks: bool = False) -> Tuple[Tensor, Tensor]:
    """Full-sequence hybrid stack.  Returns (x, aux loss = 0)."""
    shared = params["shared"]
    nsuper, per = params["mamba"]["A_log"].shape[:2]
    for s in range(nsuper):
        for i in range(per):
            norm_p = _layer(params["mamba_norms"], s, i)
            mp = _layer(params["mamba"], s, i)
            x = constrain_residual(x + ssm.apply_mamba2(
                mp, cfg, layers.apply_norm(norm_p, x, cfg.norm)))
        x = constrain_residual(_shared_block(
            shared, cfg, x, lambda p, hs: attention.self_attention(
                p, cfg, hs, cos, sin, skip_masked_blocks=skip_blocks)))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_hybrid_cache(cfg, batch: int, max_len: int,
                      device=None) -> Dict[str, Any]:
    if cfg.kv_cache_quant == "int8":
        # the reference's decode_hybrid writes compute-type keys into the
        # int8 cache and fails (a dtype error in dynamic_update_slice)
        raise TypeError("the hybrid stack's decode takes no int8 KV cache")
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


# ---------------------------------------------------------------------------
# xlstm stack
# ---------------------------------------------------------------------------


def init_xlstm_stack(gen, cfg) -> Params:
    per = cfg.xlstm.slstm_every
    if cfg.num_layers % per:
        raise ValueError("layers must tile into superblocks")
    nsuper = cfg.num_layers // per
    m = module.stacked_init(lambda g: xlstm.init_mlstm(g, cfg, cfg.pdtype),
                            gen, nsuper * (per - 1))
    s = module.stacked_init(lambda g: xlstm.init_slstm(g, cfg, cfg.pdtype),
                            gen, nsuper)
    return {"mlstm": tree_map(
        lambda a: a.reshape(nsuper, per - 1, *a.shape[1:]), m), "slstm": s}


def apply_xlstm(params: Params, cfg, x: Tensor) -> Tuple[Tensor, Tensor]:
    """Full-sequence xLSTM stack.  Returns (x, aux loss = 0)."""
    remat = cfg.remat and _recording(params)
    per = params["mlstm"]["conv_w"].shape[1]
    mlstm = _unstack(tree_map(lambda a: a.flatten(0, 1), params["mlstm"]))
    for s, sp in enumerate(_unstack(params["slstm"])):
        for mp in mlstm[s * per:(s + 1) * per]:
            x = constrain_residual(_run(remat, xlstm.apply_mlstm, mp, cfg,
                                        x))
        x = constrain_residual(xlstm.apply_slstm(sp, cfg, x))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_xlstm_cache(cfg, batch: int, device=None) -> Dict[str, Any]:
    """The mLSTM states stacked (nsuper, slstm_every - 1, ...) and the
    sLSTM states (nsuper, ...), each with its own storage (decode writes
    them in place)."""
    per = cfg.xlstm.slstm_every
    nsuper = cfg.num_layers // per
    mc = xlstm.init_mlstm_cache(cfg, batch, cfg.cdtype, device)
    sc = xlstm.init_slstm_state(cfg, batch, cfg.cdtype, device)
    return {"mlstm": {k: a.expand(nsuper, per - 1, *a.shape).clone()
                      for k, a in mc.items()},
            "slstm": {k: a.expand(nsuper, *a.shape).clone()
                      for k, a in sc.items()}}


def decode_xlstm(params: Params, cfg, x: Tensor, cache):
    """One token through the xLSTM stack; every layer's state is written
    in place and the cache returned."""
    mc, sc = cache["mlstm"], cache["slstm"]
    nsuper, per = params["mlstm"]["conv_w"].shape[:2]
    for s in range(nsuper):
        for i in range(per):
            x, new = xlstm.apply_mlstm_decode(
                _layer(params["mlstm"], s, i), cfg, x,
                {k: a[s, i] for k, a in mc.items()})
            for k, a in new.items():
                mc[k][s, i] = a
        x, new = xlstm.apply_slstm_decode(_layer(params["slstm"], s), cfg, x,
                                          {k: a[s] for k, a in sc.items()})
        for k, a in new.items():
            sc[k][s] = a
    return x, cache

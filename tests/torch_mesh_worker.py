"""The port's zoo on a (2, 2) ("data", "model") mesh of 4 gloo processes
on the CPU: the worker :func:`run` that ``tests/test_torch_mesh_model.py``
spawns, and the one-device runs it is held to.

Each case lays the smoke config's params (f32) out by
``sharding.rules.param_specs``, the batch by ``batch_specs`` and the
decode cache by ``cache_specs``, installs the activation context and
runs the forward, one AdamW train step and a prefill then 2 decode steps;
rank 0 gathers every result whole and saves it.
"""

import os

import numpy as np
import torch

MESH = (2, 2)
B, S, MAX_LEN = 4, 16, 8
# AdamW's first step divides each gradient by its own size, so a
# gradient near 0 moves its param by up to the learning rate whatever its
# rounding: at eps 1e-8 the updated params of the two one-device runs
# differ by up to 5.7e-4 (zamba2-2.7b; 3.5e-4 gemma-2b) and the mesh's
# xlstm-125m params by 1.2e-3 from both.  An eps above the gradients'
# rounding keeps the step a function of the gradient alone.
LR, EPS = 1e-3, 1e-5
# (arch, residual layout, attn_qseq, moe_shardmap, parts run, Heroes
# composition); the part "fwd_cm" is the forward with the composed weight
# built first (``module.set_compose_then_matmul``)
CASES = (
    ("gemma-2b", "d_sharded", False, False, ("fwd", "train", "decode"),
     False),
    ("gemma-2b", "seq_sharded", False, False, ("fwd", "train", "decode"),
     False),
    ("gemma-2b", "replicated", False, False, ("fwd", "train", "decode"),
     False),
    ("gemma-2b", "d_sharded", True, False, ("fwd", "train"), False),
    ("gemma-2b", "d_sharded", False, False,
     ("fwd", "fwd_cm", "train", "decode"), True),
    ("zamba2-2.7b", "d_sharded", False, False, ("fwd", "train", "decode"),
     False),
    ("zamba2-2.7b", "seq_sharded", True, False, ("fwd",), False),
    ("olmoe-1b-7b", "d_sharded", False, False, ("fwd", "train", "decode"),
     False),
    ("olmoe-1b-7b", "d_sharded", False, True, ("fwd", "train", "decode"),
     False),
    ("olmoe-1b-7b", "replicated", True, True, ("fwd",), False),
    ("xlstm-125m", "d_sharded", False, False, ("fwd", "train", "decode"),
     False),
    ("xlstm-125m", "seq_sharded", False, False, ("fwd",), False),
)


def case_name(case) -> str:
    arch, residual, qseq, moe_sm, _, comp = case
    return (f"{arch}-{residual}" + ("-qseq" if qseq else "")
            + ("-moe_shardmap" if moe_sm else "")
            + ("-composition" if comp else ""))


def config(case, configs=None):
    """The case's smoke config in f32 (``configs``: the port's package,
    or the reference's).  An MoE takes capacity for every token (no
    drops), and under ``moe_shardmap``, which has no aux loss (as the
    reference's), an aux weight of 0 in both runs.  Under composition
    every projection is factorized at width 2."""
    import dataclasses
    import importlib
    if configs is None:
        from repro_torch import configs
    cfg = configs.get_smoke(case[0]).replace(compute_dtype="float32")
    if case[5]:
        base = importlib.import_module(configs.__name__ + ".base")
        cfg = cfg.replace(composition=base.CompositionConfig(
            enabled=True, max_width=2))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0,
            router_aux_weight=0.0 if case[3] else cfg.moe.router_aux_weight))
    return cfg


def flat(tree, prefix=""):
    """Nested dicts -> {dotted path: leaf}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}.{key}" if prefix
                                 else key).items()}
    return {prefix: tree}


def inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S + 2)).astype(np.int64)
    return {"tokens": torch.from_numpy(toks[:, :S]),
            "labels": torch.from_numpy(toks[:, 1:S + 1]),
            "steps": torch.from_numpy(toks[:, S:S + 2])}


def one_case(cfg, params, data, parts, *, lay=None, full=None):
    """The case's results as plain tensors.  ``lay(tree, specs_fn)`` lays a
    tree out on the mesh and ``full`` gathers a result whole; both are
    identities on one device."""
    from repro_torch.core.estimator import tree_map
    from repro_torch.launch.steps import (make_prefill, make_serve_step,
                                          make_train_step)
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer

    lay = lay or (lambda tree, kind: tree)
    full = full or (lambda t: t)
    out = {}
    batch = {"tokens": data["tokens"]}
    if "fwd" in parts:
        p = lay(params, "params")
        out["logits"] = full(make_prefill(cfg)(p, lay(batch, "batch")))
    if "fwd_cm" in parts:
        from repro_torch.models import module
        module.set_compose_then_matmul(True)
        try:
            out["logits_compose_matmul"] = full(make_prefill(cfg)(
                lay(params, "params"), lay(batch, "batch")))
        finally:
            module.set_compose_then_matmul(False)
    if "train" in parts:
        p = lay(tree_map(torch.clone, params), "params")
        opt = make_optimizer("adamw", LR, eps=EPS)
        state = opt.init(p)
        tb = lay({"tokens": data["tokens"], "labels": data["labels"]},
                 "batch")
        p, state, m = make_train_step(cfg, opt)(p, state, tb)
        out["loss"] = full(m["loss"])
        out["grad_norm"] = full(m["grad_norm"])
        from repro_torch.core.estimator import tree_leaves
        out["params"] = {k: full(t.detach()) for k, t in flat(p).items()}
        out["mu"] = {k: full(t) for k, t in flat(state["mu"]).items()}
        out["placements_kept"] = all(
            getattr(a, "placements", None) == getattr(b, "placements", None)
            for a, b in zip(tree_leaves(state["mu"]), tree_leaves(p)))
    if "decode" in parts:
        p = lay(params, "params")
        cache = lay(model.init_cache(cfg, B, MAX_LEN, "cpu"), "cache")
        step = make_serve_step(cfg)
        logits = []
        for t in range(2):
            lg, cache = step(p, lay({"tokens": data["steps"][:, t:t + 1]},
                                    "batch"), cache, t)
            logits.append(full(lg))
        out["decode"] = torch.stack(logits)
    return out


def one_device(case):
    """The port's one-device run of ``case``."""
    from repro_torch.models import model
    cfg = config(case)
    return one_case(cfg, model.init(0, cfg, "cpu"), inputs(cfg), case[4])


def reference(case):
    """The reference's one-device run of ``case`` on the port's params."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import model as jmodel
    from repro.optim import make_optimizer as jopt
    from repro_torch.convert import to_numpy
    from repro_torch.models import model

    cfg = config(case, jconfigs)
    tp = model.init(0, config(case), "cpu")
    params = jax.tree_util.tree_map(jnp.asarray, to_numpy(tp))
    data = {k: jnp.asarray(v.numpy().astype(np.int32))
            for k, v in inputs(cfg).items()}
    parts, out = case[4], {}
    if "fwd" in parts:
        out["logits"] = jsteps.make_prefill(cfg)(params,
                                                 {"tokens": data["tokens"]})
    if "fwd_cm" in parts:
        from repro.models import module as jmodule
        jmodule.set_compose_then_matmul(True)
        try:
            out["logits_compose_matmul"] = jsteps.make_prefill(cfg)(
                params, {"tokens": data["tokens"]})
        finally:
            jmodule.set_compose_then_matmul(False)
    if "train" in parts:
        opt = jopt("adamw", LR, eps=EPS)
        p, state, m = jax.jit(jsteps.make_train_step(cfg, opt))(
            params, opt.init(params),
            {"tokens": data["tokens"], "labels": data["labels"]})
        # the gradient's norm in f64: XLA's jitted f32 vdot on the CPU
        # reads ~1e-3 below it (tests/test_torch_launchers.py)
        grads = jax.grad(lambda q: jmodel.loss_fn(q, cfg, {
            "tokens": data["tokens"], "labels": data["labels"]})[0])(params)
        out["loss"], out["grad_norm"] = m["loss"], np.sqrt(sum(
            (np.asarray(g, np.float64) ** 2).sum()
            for g in jax.tree_util.tree_leaves(grads)))
        out["params"], out["mu"] = flat(p), flat(state["mu"])
    if "decode" in parts:
        step = jax.jit(jsteps.make_serve_step(cfg))
        cache = jmodel.init_cache(cfg, B, MAX_LEN)
        logits = []
        for t in range(2):
            lg, cache = step(params, {"tokens": data["steps"][:, t:t + 1]},
                             cache, jnp.int32(t))
            logits.append(lg)
        out["decode"] = jnp.stack(logits)
    return out


def run(rank: int, world: int, init_file: str, out_dir: str,
        names=None) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.core.estimator import tree_map
    from repro_torch.models import model
    from repro_torch.sharding import context, rules

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data",
                                                             "model"))
        axes = rules.mesh_axes(mesh)
        results = {}
        for case in CASES:
            if names is not None and case_name(case) not in names:
                continue
            arch, residual, qseq, moe_sm, parts, _ = case
            cfg = config(case)

            def lay(tree, kind, cfg=cfg, moe_sm=moe_sm):
                if kind == "params":
                    specs = rules.param_specs(tree, axes, moe_ep=moe_sm)
                elif kind == "batch":
                    specs = rules.batch_specs(tree, "data", axes)
                else:
                    specs = rules.cache_specs(tree, cfg, "data", axes)
                return tree_map(lambda t, s: distribute_tensor(
                    t, mesh, rules.to_placements(s, mesh)), tree, specs)

            def full(t):
                return t.full_tensor() if isinstance(t, DTensor) else t

            params = model.init(0, cfg, "cpu")
            context.set_context(mesh, "data", residual, attn_qseq=qseq,
                                moe_shardmap=moe_sm)
            try:
                results[case_name(case)] = one_case(
                    cfg, params, inputs(cfg), parts, lay=lay, full=full)
            finally:
                context.clear_context()
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "mesh.pt"))
    finally:
        dist.destroy_process_group()

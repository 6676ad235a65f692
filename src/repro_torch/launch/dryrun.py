"""Production-mesh dry run: rank 0's share of one step of every (arch x
input shape) on the 16x16 and 2x16x16 meshes (the reference:
``repro/launch/dryrun.py``, which lowers and compiles the step for 256
or 512 forced host devices).

    python -m repro_torch.launch.dryrun --arch A --shape S [--multi-pod]
        [--device cpu] [--out DIR]

The process becomes rank 0 of a *fake* world of 256 (``16x16``) or 512
(``2x16x16``) ranks (:func:`fake_world`, ``torch.distributed``'s fake
process group, destroyed at the end): the counterpart of the reference's
``--xla_force_host_platform_device_count=512``.  The params and the
optimizer state are laid out by :mod:`repro_torch.sharding.rules` from
their ``meta`` trees (:mod:`repro_torch.launch.specs`), and only rank 0's
local shard of each leaf is materialised, drawn from a
``torch.Generator`` (never the whole tensor: kimi-k2 is 1T); so are the
batch and the decode cache.  Then the shape's step (``train_step``,
``prefill`` or ``serve_step`` of :mod:`repro_torch.launch.steps`) runs
once, on the card unless given ``--device cpu``, every kernel on its
local shard.

Under the fake group the collectives leave their outputs unfilled, so the
step's values mean nothing and no loss is recorded.  Recorded per pair,
under the reference's field names, into ``--out``:

  * memory.argument_bytes — local bytes of params, optimizer state,
    batch and cache (what the specs reckon, :func:`reckon`)
  * memory.peak_bytes     — ``torch.cuda.max_memory_allocated`` over the
    step (None on the CPU)
  * cost.flops / loop_scaled / collectives — the ops the step ran
    (:mod:`repro_torch.launch.op_analysis`), kernels included
  * params, devices, mesh, kind, and the step's seconds
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.estimator import tree_leaves, tree_map
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import module
from repro_torch.optim import make_optimizer
from repro_torch.sharding import context, rules

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` (0 unless given) of a fake
    ``torch.distributed`` world of ``world_size`` ranks: collectives
    return at once with their outputs unfilled.  The group is destroyed
    on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def optimizer_for(arch_id: str):
    if arch_id == "kimi-k2-1t-a32b":
        return make_optimizer("sgdm_bf16", 1e-3), "sgdm_bf16"
    return make_optimizer("adamw", 1e-3), "adamw"


def pair_config(arch_id: str, shape_name: str, *, no_remat=False,
                kv_int8=False, composition=False, compose_matmul=False):
    cfg = configs.config_for_shape(arch_id, shape_name)
    if no_remat:
        cfg = cfg.replace(remat=False)
    if kv_int8:
        cfg = cfg.replace(kv_cache_quant="int8")
    if composition:
        from repro_torch.configs.base import CompositionConfig
        cfg = cfg.replace(composition=CompositionConfig(
            enabled=True, max_width=2, rank=cfg.d_model // 4,
            factorized_forward=not compose_matmul))
    return cfg


def plan(cfg, shape_name: str, mesh, *, zero_pod=False, moe_shardmap=False):
    """The ``meta`` trees of one pair and their specs on ``mesh`` (a
    DeviceMesh or :class:`rules.MeshAxes`): {"params", "opt", "batch",
    "cache"} each a (tree, specs) pair or None, and the optimizer's name."""
    shape = SHAPES[shape_name]
    axes = rules.mesh_axes(mesh)
    dp = rules.dp_axes_for(axes)
    pshape = specs_lib.params_shape(cfg)
    out = {"params": (pshape, rules.param_specs(
        pshape, mesh=axes, zero_pod=zero_pod, moe_ep=moe_shardmap)),
        "opt": None, "cache": None}
    ins = specs_lib.input_specs(cfg, shape)
    out["batch"] = (ins["batch"], rules.batch_specs(ins["batch"], dp,
                                                    mesh=axes))
    opt_name = None
    if shape.kind == "train":
        opt, opt_name = optimizer_for(cfg.arch_id)
        oshape = specs_lib.opt_state_shape(cfg, opt)
        out["opt"] = (oshape, rules.param_specs(oshape, mesh=axes,
                                                zero_pod=zero_pod))
    if shape.kind == "decode":
        out["cache"] = (ins["cache"], rules.cache_specs(ins["cache"], cfg,
                                                        dp, mesh=axes))
    return out, opt_name


def reckon(trees, mesh) -> int:
    """Local bytes on one device of every tree of :func:`plan`, from the
    specs alone."""
    return sum(rules.spec_bytes(tree, spec, mesh)
               for tree, spec in (t for t in trees.values() if t))


def _local(meta, spec, mesh, fill):
    """Rank 0's shard of the ``meta`` tensor laid out by ``spec``, made by
    ``fill(shape, dtype)``, as a DTensor of the whole shape."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    placements = rules.to_placements(spec, mesh)
    shape, _ = compute_local_shape_and_global_offset(meta.shape, mesh,
                                                     placements)
    return DTensor.from_local(fill(tuple(shape), meta.dtype), mesh,
                              placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def materialise(tree, specs, mesh, fill):
    return tree_map(lambda t, s: _local(t, s, mesh, fill), tree, specs)


def _fills(cfg, device, gen):
    def params(shape, dtype):
        if dtype.is_floating_point:
            return module.normal(gen, shape, dtype, 0.02)
        return torch.zeros(shape, dtype=dtype, device=device)

    def batch(shape, dtype):
        if dtype == torch.bool:
            return torch.ones(shape, dtype=dtype, device=device)
        if dtype.is_floating_point:
            return module.normal(gen, shape, dtype, 1.0)
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device=device, dtype=dtype)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return params, batch, zeros


def run_pair(arch_id: str, shape_name: str, multi_pod: bool, *,
             device=None, skip_blocks: bool = False,
             moe_sorted: bool = False, residual: str = "d_sharded",
             composition: bool = False, compose_matmul: bool = False,
             attn_qseq: bool = False, no_remat: bool = False,
             kv_int8: bool = False, moe_shardmap: bool = False) -> dict:
    """Rank 0's share of one step of (arch, shape) on the production mesh,
    inside a running fake world of its size; returns the analysis dict."""
    shape = SHAPES[shape_name]
    dev = resolve_device(device)
    cfg = pair_config(arch_id, shape_name, no_remat=no_remat,
                      kv_int8=kv_int8, composition=composition,
                      compose_matmul=compose_matmul)
    module.set_compose_then_matmul(composition and compose_matmul)
    if moe_sorted:
        from repro_torch.models import moe as moe_mod  # perf variant toggle
        moe_mod.apply_moe, moe_mod._apply_moe_orig = (
            moe_mod.apply_moe_sorted, moe_mod.apply_moe)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    dp = rules.dp_axes_for(rules.mesh_axes(mesh))
    zero_pod = multi_pod and arch_id == "kimi-k2-1t-a32b"
    trees, opt_name = plan(cfg, shape_name, mesh, zero_pod=zero_pod,
                           moe_shardmap=moe_shardmap)
    gen = torch.Generator(dev).manual_seed(0)
    pfill, bfill, zfill = _fills(cfg, dev, gen)
    t0 = time.perf_counter()
    params = materialise(*trees["params"], mesh, pfill)
    batch = materialise(*trees["batch"], mesh, bfill)
    args = [params, batch]
    if trees["opt"]:
        args.insert(1, materialise(*trees["opt"], mesh, zfill))
    if trees["cache"]:
        args.append(materialise(*trees["cache"], mesh, zfill))
    argument_bytes = sum(t.to_local().numel() * t.element_size()
                         for a in args for t in tree_leaves(a))
    setup_s = time.perf_counter() - t0

    context.set_context(mesh, dp, residual, attn_qseq=attn_qseq,
                        moe_shardmap=moe_shardmap)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        with OpCounter() as counter:
            if shape.kind == "train":
                opt, _ = optimizer_for(arch_id)
                step = steps_lib.make_train_step(cfg, opt,
                                                 skip_blocks=skip_blocks)
                step(*args)
            elif shape.kind == "prefill":
                steps_lib.make_prefill(cfg, skip_blocks=skip_blocks)(*args)
            else:
                steps_lib.make_serve_step(cfg)(*args, shape.seq_len - 1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0
    finally:
        context.clear_context()
        module.set_compose_then_matmul(False)
        if moe_sorted:
            from repro_torch.models import moe as moe_mod
            moe_mod.apply_moe = moe_mod._apply_moe_orig
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    loop = counter.result()
    coll = dict(loop["collective_bytes"])
    coll["counts"] = loop["collective_counts"]
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": 512 if multi_pod else 256,
        "kind": shape.kind,
        "optimizer": opt_name,
        "skip_blocks": skip_blocks,
        "residual": residual,
        "composition": composition,
        "compose_matmul": compose_matmul,
        "attn_qseq": attn_qseq,
        "moe_shardmap": moe_shardmap,
        "device": str(dev),
        "setup_s": setup_s,
        "step_s": step_s,
        "memory": {"argument_bytes": argument_bytes,
                   "reckoned_argument_bytes": reckon(trees, mesh),
                   "peak_bytes": peak},
        "cost": {"flops": loop["dot_flops"] + counter.elementwise_flops,
                 "bytes_accessed": loop["traffic_bytes"]},
        "collectives": coll,
        "loop_scaled": loop,
        "params": sum(t.numel() for t in tree_leaves(trees["params"][0])),
    }


def lower_pair(arch_id: str, shape_name: str, multi_pod: bool,
               **kw) -> dict:
    """:func:`run_pair` inside its own fake world of 256 or 512 ranks."""
    with fake_world(512 if multi_pod else 256):
        return run_pair(arch_id, shape_name, multi_pod, **kw)


def pairs_to_run():
    out = []
    for arch in configs.list_archs():
        for shape in SHAPES:
            if shape == "long_500k" and arch in configs.LONG_CONTEXT_SKIP:
                continue
            out.append((arch, shape))
    return out


def tag_for(arch, shape, multi_pod, args) -> str:
    tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
    if args.skip_blocks:
        tag += "__skipblocks"
    if args.moe_sorted:
        tag += "__moesorted"
    if args.residual != "d_sharded":
        tag += f"__{args.residual}"
    if args.composition:
        tag += "__composed" + ("_matmul" if args.compose_matmul else "_ff")
    if args.attn_qseq:
        tag += "__attnqseq"
    if args.no_remat:
        tag += "__noremat"
    if args.kv_int8:
        tag += "__kvint8"
    if args.moe_shardmap:
        tag += "__moeshardmap"
    return tag


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="rank 0's share of one step on the production meshes")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--skip-blocks", action="store_true",
                    help="perf variant: skip fully-masked attention blocks")
    ap.add_argument("--moe-sorted", action="store_true",
                    help="perf variant: sort-based MoE dispatch")
    ap.add_argument("--residual", default="d_sharded",
                    choices=["d_sharded", "seq_sharded", "replicated"],
                    help="residual-stream activation layout")
    ap.add_argument("--composition", action="store_true",
                    help="Heroes-factorized parameterisation (P=2, rank=d/4)")
    ap.add_argument("--compose-matmul", action="store_true",
                    help="paper-faithful compose-then-matmul forward")
    ap.add_argument("--attn-qseq", action="store_true",
                    help="context-parallel attention (q-seq over model axis)")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-layer activation checkpointing")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache with per-token scales (decode)")
    ap.add_argument("--moe-shardmap", action="store_true",
                    help="weight-stationary expert parallelism (local_map)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=str(OUT_DIR))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        pairs = pairs_to_run()
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch, shape in pairs:
        for mp in meshes:
            tag = tag_for(arch, shape, mp, args)
            path = outdir / f"{tag}.json"
            if args.skip_existing and path.exists():
                print(f"[skip] {tag}")
                continue
            print(f"[rank 0 step] {tag} ...", flush=True)
            try:
                res = lower_pair(
                    arch, shape, mp, device=args.device,
                    skip_blocks=args.skip_blocks, moe_sorted=args.moe_sorted,
                    residual=args.residual, composition=args.composition,
                    compose_matmul=args.compose_matmul,
                    attn_qseq=args.attn_qseq, no_remat=args.no_remat,
                    kv_int8=args.kv_int8, moe_shardmap=args.moe_shardmap)
                path.write_text(json.dumps(res, indent=1))
                m = res["memory"]
                print(f"  ok: step {res['step_s']:.2f}s  argument "
                      f"{m['argument_bytes'] / 2**30:.3f} GiB  peak "
                      f"{(m['peak_bytes'] or 0) / 2**30:.3f} GiB  dot_flops "
                      f"{res['loop_scaled']['dot_flops']:.3e}  coll "
                      f"{res['collectives']['total'] / 2**20:.1f} MiB",
                      flush=True)
            except Exception as e:  # noqa: BLE001 (record and continue)
                failures.append((tag, repr(e)))
                print(f"  FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(f"  {t}: {e}")
        return 1
    print("\nAll dry runs ran OK.")
    return 0


if __name__ == "__main__":
    sys.exit(main())

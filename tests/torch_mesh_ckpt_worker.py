"""``launch/train.py --ckpt-dir`` on a (2, 2) ("data", "model") mesh of 4
``gloo`` processes on the CPU: the worker :func:`run` that
``tests/test_torch_mesh_ckpt.py`` spawns.

Each process runs the launcher's own ``main`` with ``--mesh pod``, the
production mesh swapped for the (2, 2) one and gemma-2b's smoke config
in f32, so the layout, the step, the collective save and the restore
into the fresh layout are the launcher's.  The jobs, each in a directory
of its name under ``base``:

* ``full``: 4 steps, a checkpoint at steps 2 and 4;
* ``fresh``: the freshly laid-out params and AdamW state saved as step 0
  (``_on_production_mesh``, then ``save_checkpoint``);
* ``ref``: steps 2 and 3 from the reference's step-2 checkpoint that the
  test put there, saved at step 4;
* ``cut``: the same from ``full``'s step-2 checkpoint alone, in new
  processes.

Each rank records, a job at a time, every step's loss and gradient norm,
whether the step directory existed when each save returned, and for
each restored leaf whether its local shard equals
``distribute_tensor(whole leaf, mesh, placements,
src_data_rank=None).to_local()`` bit for bit with the fresh layout's
placements; rank r saves them to ``<first job>.rank<r>.pt``.
"""

from pathlib import Path

import torch

MESH = (2, 2)
STEPS, STOP = 4, 2
BATCH, SEQ, LR = 2, 16, 3e-3
ARGV = ["--arch", "gemma-2b", "--smoke", "--mesh", "pod", "--steps",
        str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ), "--device",
        "cpu", "--ckpt-every", str(STOP)]


def config(configs):
    """gemma-2b's smoke config in f32 (``configs``: either package's)."""
    return configs.get_smoke("gemma-2b").replace(compute_dtype="float32")


def same_bits(a, b) -> bool:
    """Whether two tensors (or arrays) hold the same dtype, shape and
    bytes."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def run(rank: int, world: int, init_file: str, base: str, jobs) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.core.estimator import tree_map
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import cosine_schedule, make_optimizer
    from repro_torch.sharding.context import clear_context

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data",
                                                             "model"))
        rec = {}
        real_step, real_save = train.make_train_step, train.save_checkpoint
        real_into = train._into_layout

        def recording_step(cfg, opt):
            step = real_step(cfg, opt)

            def go(p, s, b):
                p, s, m = step(p, s, b)
                rec["steps"].append((train._value(m["loss"]),
                                     train._value(m["grad_norm"])))
                return p, s, m
            return go

        def save(directory, step, state):
            path = real_save(directory, step, state)
            rec["saved"].append((step, path.is_dir()))
            return path

        def into(tree, like):
            got = real_into(tree, like)

            def held(ref, a, g):
                want = distribute_tensor(torch.as_tensor(a).to(ref.dtype),
                                         mesh, ref.placements,
                                         src_data_rank=None).to_local()
                rec["restored"].append(same_bits(g.to_local(), want)
                                       and g.placements == ref.placements)
            tree_map(held, like, tree, got)
            return got

        smoke = configs.get_smoke
        train.make_production_mesh = lambda **kw: mesh
        configs.get_smoke = lambda arch: smoke(arch).replace(
            compute_dtype="float32")
        train.make_train_step, train.save_checkpoint = recording_step, save
        train._into_layout = into
        out = {}
        for job in jobs:
            rec.update(steps=[], saved=[], restored=[])
            d = Path(base) / job
            if job == "fresh":
                cfg = config(configs)
                params = model.init(0, cfg, "cpu")
                opt = make_optimizer("adamw", cosine_schedule(LR, STEPS, 5))
                p, s, _ = train._on_production_mesh(mesh, "pod", cfg, params,
                                                    opt.init(params))
                clear_context()
                train.save_checkpoint(d, 0, {"params": p, "opt": s})
            else:
                train.main(ARGV + ["--ckpt-dir", str(d)])
            out[job] = {k: list(v) for k, v in rec.items()}
        torch.save(out, Path(base) / f"{jobs[0]}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()

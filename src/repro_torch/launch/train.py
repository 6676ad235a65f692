"""Training launcher for the model zoo.

``python -m repro_torch.launch.train --arch gemma-2b --smoke --steps 20
[--device cpu]``

Runs on the CUDA card unless given ``--device cpu``; ``--smoke`` takes
the reduced config.  Every family of the zoo trains (the vlm's vision
tower is the reference's stub: it trains on token streams, and its
M-RoPE positions default to text's; the audio family's encoder takes
``min(encoder_seq, 64)`` stub frames of 0.02 N(0, 1), drawn each step
from a ``torch.Generator`` seeded by the step, so they differ from the
reference's ``jax.random`` frames by construction, with an all-true
mask).  Batches come from ``SyntheticTextTask`` through ``lm_batches``
with numpy seed 0, as in the reference's launcher;
Heroes composition is a switch (``--composition``), and
``--ckpt-dir``/``--ckpt-every`` checkpoint ``{"params", "opt"}`` and
resume from the newest checkpoint there.  A resumed run continues bit
for bit: it also draws past the batches of the steps it skips (the
reference starts its stream over).

``--mesh host`` trains on one device.  ``--mesh pod`` and ``--mesh
multipod`` train on the production mesh (16x16, or 2x16x16) of the
running process group: ``torchrun`` with a world of 256 or 512 ranks
(one CUDA device each), or the dry run's fake world
(:func:`repro_torch.launch.dryrun.fake_world`); without a world of that
size they raise.  Every rank draws the same params and batches from the
same seeds and keeps its own shard of each (``distribute_tensor`` with
``src_data_rank=None``: no collective); the params and the optimizer
state are laid out by :func:`repro_torch.sharding.rules.param_specs`
(``zero_pod`` for kimi-k2 on ``multipod``, as the dry run does), the
batch by ``batch_specs``, and the activation context is installed.
Checkpoints are one-device only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint.npz_ckpt import restore_latest, save_checkpoint
from repro_torch.configs.base import CompositionConfig
from repro_torch.core.estimator import tree_map
from repro_torch.data import SyntheticTextTask, lm_batches
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model
from repro_torch.models.frontends import audio_frame_embeddings
from repro_torch.models.module import count_params
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.sharding import rules
from repro_torch.sharding.context import clear_context, set_context


def _to_device(tree, like, device):
    """A restored checkpoint's leaves (numpy arrays, or CPU bf16 tensors)
    as tensors on ``device`` in the dtypes and key order of ``like``'s
    (the optimizers zip trees leaf by leaf)."""
    return tree_map(lambda ref, a: torch.as_tensor(a).to(device, ref.dtype),
                    like, tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--composition", action="store_true",
                    help="train the Heroes-factorized parameterisation")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = None
    if args.mesh != "host":
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod",
                                    device_type=dev.type)
        if args.ckpt_dir:
            raise ValueError("--ckpt-dir checkpoints a one-device run "
                             "(--mesh host) only")

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.composition:
        cfg = cfg.replace(composition=CompositionConfig(
            enabled=True, max_width=2, rank=cfg.d_model // 4))
    if cfg.family in ("vlm", "audio"):
        print(f"note: {args.arch} uses stub frontends; training on synthetic "
              "token streams with stub embeddings")
    params = model.init(0, cfg, dev)
    print(f"{cfg.arch_id}: {count_params(params):,} params "
          f"(composition={'on' if args.composition else 'off'}), "
          f"device={dev}")

    opt = make_optimizer(args.optimizer,
                         cosine_schedule(args.lr, args.steps, 5))
    opt_state = opt.init(params)
    if mesh is not None:
        params, opt_state, lay_batch = _on_production_mesh(
            mesh, args.mesh, cfg, params, opt_state)

    start = 0
    if args.ckpt_dir:
        restored = restore_latest(args.ckpt_dir)
        if restored:
            start, state = restored
            params = _to_device(state["params"], params, dev)
            opt_state = _to_device(state["opt"], opt_state, dev)
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt)
    task = SyntheticTextTask(vocab=min(cfg.vocab, 512), seq_len=args.seq)
    rng = np.random.default_rng(0)
    for _ in range(start):  # the batches of the steps already taken
        lm_batches(task.train, args.batch, rng)

    t0 = time.time()
    for i in range(start, args.steps):
        toks, labels = lm_batches(task.train, args.batch, rng)
        batch = {"tokens": torch.as_tensor(toks % cfg.vocab, device=dev),
                 "labels": torch.as_tensor(labels % cfg.vocab, device=dev)}
        if cfg.family == "audio":
            batch.update(audio_frame_embeddings(
                torch.Generator(dev).manual_seed(i), args.batch,
                min(cfg.encdec.encoder_seq, 64), cfg.d_model))
        if mesh is not None:
            batch = lay_batch(batch)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {_value(metrics['loss']):.4f}  "
                  f"grad_norm {_value(metrics['grad_norm']):.3f}  "
                  f"{(time.time() - t0):.1f}s")
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1,
                            {"params": params, "opt": opt_state})
    if mesh is not None:
        clear_context()
    print("done.")


def _value(t) -> float:
    """A metric as a float (a DTensor's whole value)."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _on_production_mesh(mesh, kind: str, cfg, params, opt_state):
    """Lay the params and the optimizer state out on ``mesh`` by the
    sharding rules (each rank keeps its shard of its own copy), install
    the activation context, and return them with the batch's layout."""
    from torch.distributed.tensor import distribute_tensor

    axes = rules.mesh_axes(mesh)
    dp = rules.dp_axes_for(axes)
    zero_pod = kind == "multipod" and cfg.arch_id == "kimi-k2-1t-a32b"

    def lay(tree, specs):
        return tree_map(lambda t, s: distribute_tensor(
            t, mesh, rules.to_placements(s, mesh), src_data_rank=None),
            tree, specs)

    params_d = lay(params, rules.param_specs(params, axes,
                                             zero_pod=zero_pod))
    opt_d = lay(opt_state, rules.param_specs(opt_state, axes,
                                             zero_pod=zero_pod))
    set_context(mesh, dp)
    print(f"mesh {kind}: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
    return params_d, opt_d, lambda b: lay(b, rules.batch_specs(b, dp, axes))


if __name__ == "__main__":
    main()

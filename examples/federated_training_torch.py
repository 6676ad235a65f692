"""End-to-end driver on PyTorch: federated training of the paper's CNN
with Heroes and every baseline, a few hundred aggregate local steps.

The port's counterpart of ``examples/federated_training.py``.  Produces
the accuracy-vs-time / accuracy-vs-traffic trajectories the paper plots
(Figs. 4/6) on the reduced synthetic CIFAR stand-in, plus a checkpoint of
the final global factors in the JAX package's msgpack format.

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.
"""

# Run with the package importable: ``pip install -e .`` or ``PYTHONPATH=src``.

import argparse
import pathlib

from repro_torch import resolve_device
from repro_torch.fl import (FLConfig, build_image_setup, build_runner,
                            run_scheme, summarize, time_to_accuracy)

ROUNDS = 30  # x 5 clients x ~5-20 local iterations ≈ O(10^3) local steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    model, px, py, test = build_image_setup(num_clients=20, gamma=40.0, seed=0,
                                            device=dev)
    cfg = FLConfig(num_clients=20, clients_per_round=5, eval_every=2,
                   tau_fixed=5, tau_max=25, lr=0.08)
    results = {}
    for scheme in ("heroes", "flanc", "heterofl", "adp", "fedavg"):
        hist = run_scheme(scheme, model, px, py, test, rounds=ROUNDS, cfg=cfg,
                          device=dev)
        results[scheme] = hist
        s = summarize(hist)
        print(f"{scheme:9s} final_acc={s['final_acc']:.3f} "
              f"best={s['best_acc']:.3f} time={s['wall_time']:.0f}s "
              f"traffic={s['traffic_gb']*1e3:.1f}MB wait={s['avg_wait']:.2f}s "
              f"mean_tau={s['mean_tau']:.1f}")

    target = 0.5
    t_heroes = time_to_accuracy(results["heroes"], target)
    print(f"\ntime-to-{target:.0%}:")
    for scheme, hist in results.items():
        t = time_to_accuracy(hist, target)
        note = ""
        if t and t_heroes and scheme != "heroes":
            note = f"  (heroes speedup {t/t_heroes:.2f}x)"
        print(f"  {scheme:9s} {f'{t:.0f}s' if t else 'unreached':>10}{note}")

    print("\ntrajectories (scheme, round, virtual_s, traffic_MB, acc):")
    for scheme, hist in results.items():
        for h in hist:
            if h.accuracy is not None:
                print(f"  {scheme},{h.round},{h.wall_time:.1f},"
                      f"{h.traffic_bytes/1e6:.2f},{h.accuracy:.4f}")

    ckpt_dir = (pathlib.Path(__file__).resolve().parents[1] / "experiments"
                / "ckpt_torch")
    # persist the full ServerState via a fresh short run: the engine
    # checkpoints at round boundaries (msgpack, the JAX package's format)
    # and resumes bit for bit
    print(f"\n(checkpointing demo state to {ckpt_dir})")
    import dataclasses
    ckpt_cfg = dataclasses.replace(cfg, checkpoint_every=1,
                                   checkpoint_dir=str(ckpt_dir))
    runner = build_runner("heroes", model, px, py, test, cfg=ckpt_cfg, seed=0,
                          device=dev)
    runner.run(3)
    resumed = build_runner("heroes", model, px, py, test, cfg=ckpt_cfg,
                           seed=0, device=dev)
    assert resumed.restore_latest() and resumed.round == runner.round
    print("done.")


if __name__ == "__main__":
    main()

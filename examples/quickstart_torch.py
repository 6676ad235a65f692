"""Quickstart on PyTorch: the Heroes pipeline end to end, on the card.

The port's counterpart of ``examples/quickstart.py``:

1. Factorize a weight into (basis, coefficient blocks)  — Eq. (4)
2. Select the least-trained blocks and compose a p-width weight — Fig. 1
3. Run one federated round (width+frequency assignment, local training,
   block-wise aggregation) on a 10-client simulation — Alg. 1/2

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.
"""

# Run with the package importable: ``pip install -e .`` or ``PYTHONPATH=src``.

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (BoundState, CompositionSpec, HeroesScheduler,
                              SchedulerConfig, compose, gather_blocks,
                              init_factors, select_blocks)
from repro_torch.fl import FLConfig, build_image_setup, run_scheme, summarize


def composition_demo(device=None):
    print("== 1. neural composition (paper Eq. 4 / Fig. 1) ==")
    dev = resolve_device(device)
    spec = CompositionSpec(max_width=3, rank=8, base_in=16, base_out=12, ksq=9)
    basis, coeff = init_factors(torch.Generator(dev).manual_seed(0), spec,
                                dev)
    print(f"basis {tuple(basis.shape)}  complete coefficient "
          f"{tuple(coeff.shape)} ({spec.num_blocks} blocks)")
    counters = np.array([3, 6, 9, 5, 12, 7, 8, 10, 11])
    ids = select_blocks(counters, p=2, spec=spec)
    print(f"update counters {counters} -> least-trained blocks {ids}")
    w = compose(basis, gather_blocks(coeff, ids), p=2, spec=spec)
    print(f"composed 2-width weight: {tuple(w.shape)}  "
          f"(vs full {spec.weight_shape(3)})")
    fac = spec.params_factorized(2)
    mat = spec.params_materialized(2)
    print(f"shipped params: factorized {fac} vs materialised {mat} "
          f"({100*(1-fac/mat):.0f}% smaller)\n")


def scheduler_demo():
    print("== 2. adaptive tensor+frequency assignment (Alg. 1) ==")
    spec = CompositionSpec(max_width=3, rank=8, base_in=16, base_out=12)
    sched = HeroesScheduler(
        spec,
        SchedulerConfig(mu_max=0.3, rho=1.0, eps=1.0),
        iter_time_fn=lambda n, p: 0.02 * p * p * (1 + n % 4),  # tiers
        comm_time_fn=lambda n, p: 0.2 + 0.05 * p * p,
    )
    state = BoundState(loss0=2.3, smoothness=0.8, grad_sq=1.5, noise_sq=0.4,
                       lr=0.05)
    plan = sched.plan_round(list(range(6)), state)
    for n, a in sorted(plan.assignments.items()):
        print(f"  client {n}: width p={a.width}  tau={a.tau:3d}  "
              f"blocks={a.block_ids.tolist()}  T={a.est_completion:.2f}s")
    print(f"  pacesetter={plan.pacesetter}  makespan={plan.makespan:.2f}s  "
          f"avg wait={plan.avg_waiting():.2f}s\n")


def federated_round_demo(device=None):
    print("== 3. five federated rounds, Heroes vs FedAvg ==")
    dev = resolve_device(device)
    model, px, py, test = build_image_setup(num_clients=10, seed=0,
                                            device=dev)
    cfg = FLConfig(num_clients=10, clients_per_round=4, eval_every=5,
                   tau_fixed=5, tau_max=20)
    for scheme in ("heroes", "fedavg"):
        hist = run_scheme(scheme, model, px, py, test, rounds=5, cfg=cfg,
                          device=dev)
        s = summarize(hist)
        print(f"  {scheme:7s}: acc={s['final_acc']:.3f}  "
              f"virtual time={s['wall_time']:.1f}s  "
              f"traffic={s['traffic_gb']*1e3:.2f}MB  "
              f"avg wait={s['avg_wait']:.2f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    composition_demo(args.device)
    scheduler_demo()
    federated_round_demo(args.device)


if __name__ == "__main__":
    main()

"""Federated composed transformer on PyTorch: train through the engine,
then serve.

The port's counterpart of ``examples/composed_llm_training.py``.  Heroes'
neural composition IS low-rank adaptation, so the transformer trains
through the *real* federated engine like any other model def: the
``"transformer"`` registry entry maps decoder blocks onto
``CompositionSpec``s (q/k/v/o and MLP projections as square rank-R
blocks, embedding + LM head anchored — docs/TRANSFORMERS.md), and every
registered scheme / trainer / round mode applies unchanged.

This example
  1. builds the synthetic-text federation with the transformer def,
  2. runs Heroes (factorized, width+frequency assignment) and FedAvg
     (dense) for a few rounds each,
  3. composes the trained factors ONCE per width and serves greedy
     decode through the decode-attention kernel.

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.
"""

# Run with the package importable: ``pip install -e .`` or ``PYTHONPATH=src``.

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.fl import (FLConfig, build_runner, build_text_setup,
                            greedy_decode, run_scheme, serving_weights,
                            summarize)


def train(scheme: str, model, parts_x, parts_y, test_batch, cfg, rounds,
          device):
    t0 = time.time()
    history = run_scheme(scheme, model, parts_x, parts_y, test_batch,
                         rounds, cfg=cfg, seed=0, device=device)
    s = summarize(history)
    print(f"  [{scheme}] {rounds} rounds in {time.time() - t0:.1f}s wall "
          f"(virtual {s['wall_time']:.1f}s) acc={s['final_acc']:.3f} "
          f"traffic={s['traffic_gb'] * 1e3:.2f} MB")
    return history


def serve(model, params, width: int, steps: int):
    """Compose width-p weights once, then greedy-decode a continuation."""
    weights = serving_weights(model, params, width)
    prompt = np.arange(8, dtype=np.int32)[None, :] % model.num_classes
    t0 = time.time()
    tokens, _ = greedy_decode(model, weights, width, prompt, steps)
    dt = time.time() - t0
    print(f"  [serve] width={width} generated {tokens.shape[1]} tokens "
          f"({tokens.shape[1] / dt:.1f} tok/s incl. the first call): "
          f"{tokens[0].tolist()}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="2 rounds, tiny cohort (CI)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rounds = 2 if args.smoke else args.rounds
    num_clients = 8 if args.smoke else 24

    model, parts_x, parts_y, test_batch = build_text_setup(
        num_clients=num_clients, max_width=3, seed=0,
        model_name="transformer", device=dev)
    cfg = FLConfig(num_clients=num_clients,
                   clients_per_round=min(4, num_clients),
                   batch_size=8, eval_every=max(rounds // 2, 1), seed=0)

    print("federated transformer (composed rank-R blocks) through the engine:")
    train("heroes", model, parts_x, parts_y, test_batch, cfg, rounds, dev)
    train("fedavg", model, parts_x, parts_y, test_batch, cfg, rounds, dev)

    # Serving: run Heroes once more with the runner held open so the
    # server's factorized state is in hand, compose per-width dense
    # weights once, decode through the decode-attention kernel (its plain
    # version on the CPU).
    with build_runner("heroes", model, parts_x, parts_y, test_batch,
                      cfg=cfg, seed=0, device=dev) as runner:
        runner.run(rounds)
        params = runner.state.params
        print("serving the trained model (compose once, decode via the "
              "kernel):")
        for width in (1, model.specs["head"].max_width):
            serve(model, params, width, steps=4 if args.smoke else 16)


if __name__ == "__main__":
    main()

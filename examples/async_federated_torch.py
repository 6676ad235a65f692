"""Semi-asynchronous federated training through the port's round loop.

The port's counterpart of ``examples/async_federated.py``.  Runs Heroes
and FedAvg in both round modes on the synthetic image task:

  sync        paper Eq. 19 — every round waits for the slowest client
  semi_async  aggregate the fastest K of M; stragglers merge later with a
              staleness-discounted weight (decay ** staleness)

and prints the accuracy-vs-virtual-time trajectories plus the staleness
events the async loop logged.  The async mode trades per-merge freshness
for never paying the straggler makespan, which is exactly the waiting
time the paper's Fig. 2 shows fixed-tau schemes wasting.

Runs on the CUDA card; ``--device cpu`` runs it on the CPU.
"""

# Run with the package importable: ``pip install -e .`` or ``PYTHONPATH=src``.

import argparse

from repro_torch import resolve_device
from repro_torch.fl import FLConfig, build_image_setup, run_scheme, summarize

ROUNDS = 20


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    model, px, py, test = build_image_setup(num_clients=20, gamma=40.0, seed=0,
                                            device=dev)
    base = dict(num_clients=20, clients_per_round=5, eval_every=2,
                tau_fixed=5, tau_max=25, lr=0.08)

    for scheme in ("heroes", "fedavg"):
        print(f"=== {scheme} ===")
        hists = {
            "sync": run_scheme(scheme, model, px, py, test, rounds=ROUNDS,
                               cfg=FLConfig(**base), device=dev),
            "semi_async": run_scheme(
                scheme, model, px, py, test, rounds=ROUNDS,
                cfg=FLConfig(**base, round_mode="semi_async", async_k=2,
                             staleness_decay=0.5), device=dev),
        }
        for mode, hist in hists.items():
            s = summarize(hist)
            stale = sum(h.stale for h in hist)
            print(f"  {mode:10s} final_acc={s['final_acc']:.3f} "
                  f"time={s['wall_time']:.0f}s wait={s['avg_wait']:.2f}s "
                  f"stale_merges={stale}")
        print("  trajectories (mode, round, virtual_s, acc, stale):")
        for mode, hist in hists.items():
            for h in hist:
                if h.accuracy is not None:
                    print(f"    {mode},{h.round},{h.wall_time:.1f},"
                          f"{h.accuracy:.4f},{h.stale}")


if __name__ == "__main__":
    main()

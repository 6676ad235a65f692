"""The port's federated dataset subsystem: registries x partitioners x
schemes.

The port's counterpart of ``examples/federated_datasets.py``:

1. Load tasks through the dataset registry (synthetic fallbacks here —
   point ``--data-root`` at real CIFAR-10 binaries / a Shakespeare
   corpus to train on files; docs/DATA.md).
2. Compose any dataset with any Non-IID partitioner.
3. Drive schemes — including the FedProx bundle — over streaming
   client shards with ``run_scheme``.

Run:  PYTHONPATH=src python examples/federated_datasets_torch.py
      [--data-root D] [--device cpu]
(on the CUDA card unless given ``--device cpu``).
"""

import argparse
# Run with the package importable: ``pip install -e .`` or ``PYTHONPATH=src``.

import numpy as np

from repro_torch import resolve_device
from repro_torch.data import load_dataset, partition_dataset
from repro_torch.fl import FLConfig, build_text_setup, run_scheme, summarize


def registry_tour(data_root):
    print("== 1. dataset registry ==")
    for task in ("synthetic_image", "cifar10", "synthetic_text",
                 "shakespeare"):
        ds = load_dataset(task, seed=0, data_root=data_root,
                          train_size=512, test_size=128) \
            if task in ("cifar10", "shakespeare") else \
            load_dataset(task, seed=0)
        extra = f" speakers={ds.metadata['num_speakers']}" \
            if "num_speakers" in ds.metadata else ""
        print(f"  {task:16} train={ds.x.shape} source="
              f"{ds.metadata['source']}{extra}")

    print("\n== 2. one dataset x three partitioners ==")
    ds = load_dataset("cifar10", seed=0, data_root=data_root,
                      train_size=512, test_size=128)
    for name, kw in (("iid", {}), ("dirichlet", {"gamma_pct": 80.0}),
                     ("class_skew", {"missing": 4})):
        parts = partition_dataset(ds, name, 8, seed=0, **kw)
        spread = [len(np.unique(ds.y[p])) for p in parts[:4]]
        print(f"  {name:10} {kw or ''} classes-per-client={spread}...")


def train_demo(data_root, device=None):
    print("\n== 3. schemes over streaming shards ==")
    dev = resolve_device(device)
    cfg = FLConfig(num_clients=12, clients_per_round=4, tau_fixed=4,
                   eval_every=2, trainer="cohort", prox_mu=0.05)
    model, px, py, test = build_text_setup(
        num_clients=12, seed=0, task="shakespeare", max_width=2,
        data_root=data_root, task_kw={"train_size": 960, "test_size": 240},
        device=dev)
    for scheme in ("fedavg", "fedprox", "heroes"):
        hist = run_scheme(scheme, model, px, py, test, rounds=4, cfg=cfg,
                          device=dev)
        s = summarize(hist)
        print(f"  {scheme:8} acc={s['final_acc']:.3f} "
              f"traffic={s['traffic_gb']*1e3:.2f}MB wall={s['wall_time']:.0f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None,
                    help="directory with real CIFAR-10 / Shakespeare files "
                         "(default: deterministic synthetic fallbacks)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise first
    registry_tour(args.data_root)
    train_demo(args.data_root, args.device)


if __name__ == "__main__":
    main()

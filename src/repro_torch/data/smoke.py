"""Dataset-subsystem smoke: one ``run_scheme`` round per registry loader.

The port of the JAX package's ``data/smoke.py`` (offline by construction:
the loaders fall back to deterministic synthetic data), driving dataset
registry -> partitioner registry -> streaming shards -> cohort engine
round -> eval for each loader::

    PYTHONPATH=src python -m repro_torch.data.smoke [--cache-dir DIR] \\
        [--data-root DIR] [--scheme S] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given, and never
falls back to the CPU.  Each loader's failure is reported on its own
line; the exit code is non-zero on any loader failure or non-finite
accuracy.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

# the JAX package's smoke configuration, shared by every loader
CFG = dict(num_clients=8, clients_per_round=3, tau_fixed=2, tau_max=6,
           eval_every=1, batch_size=8, trainer="cohort")
SMALL = {"train_size": 512, "test_size": 128}


def setups(data_root=None, cache_dir=None):
    """Loader name -> (setup builder name, its keyword arguments)."""
    return {
        "synthetic_image": ("image", dict(num_clients=8, seed=0,
                                          task="synthetic_image")),
        "cifar10": ("image", dict(num_clients=8, seed=0, task="cifar10",
                                  max_width=2, data_root=data_root,
                                  cache_dir=cache_dir, task_kw=SMALL)),
        "synthetic_text": ("text", dict(num_clients=8, seed=0,
                                        task="synthetic_text")),
        "shakespeare": ("text", dict(num_clients=8, seed=0,
                                     task="shakespeare", max_width=2,
                                     data_root=data_root,
                                     cache_dir=cache_dir, task_kw=SMALL)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cache-dir", default=None,
                    help="npz cache directory (shared across CI runs)")
    ap.add_argument("--data-root", default=None,
                    help="optional real-data directory (default: fallback)")
    ap.add_argument("--scheme", default="heroes",
                    help="scheme to drive each loader with")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.fl import FLConfig, run_scheme
    from repro_torch.fl.simulation import build_image_setup, build_text_setup

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"FAIL  device: {e}")
        return 1
    build = {"image": build_image_setup, "text": build_text_setup}
    cfg = FLConfig(**CFG)
    failures = 0
    for name, (kind, kw) in setups(args.data_root, args.cache_dir).items():
        t0 = time.time()
        try:
            model, px, py, test = build[kind](device=device, **kw)
            hist = run_scheme(args.scheme, model, px, py, test, rounds=1,
                              cfg=cfg, device=device)
            acc = hist[-1].accuracy
            ok = acc is not None and math.isfinite(acc)
        except Exception as e:  # noqa: BLE001 — smoke must report, not die
            print(f"FAIL  {name}: {type(e).__name__}: {e}")
            failures += 1
            continue
        status = "ok" if ok else "FAIL (non-finite accuracy)"
        failures += 0 if ok else 1
        print(f"{status:4}  {name}: acc={acc!r} clients={len(px)} "
              f"device={device} ({time.time() - t0:.1f}s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end FL simulation entry points (paper Sec. VI setup, reduced scale).

The entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit request they raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.data import load_dataset, make_shards, partition_dataset
from repro_torch.fl.engine import build_engine
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.fl.models import FLModelDef, get_model
from repro_torch.fl.population import PopulationRegistry, VirtualPartition
from repro_torch.fl.transformer import make_transformer  # noqa: F401 — registers "transformer"
from repro_torch.fl.types import FLConfig, RoundLog


def build_setup(task: str, model_name: Optional[str] = None,
                num_clients: int = 100, max_width: int = 3, seed: int = 0, *,
                partitioner: Optional[str] = None, partition_kw=None,
                data_root=None, cache_dir=None, streaming: bool = True,
                task_kw=None, population: Optional[int] = None,
                model_kw=None, device=None):
    """Registry-driven setup: dataset x partitioner x model.

    Returns the ``(model, parts_x, parts_y, test_batch)`` tuple every
    caller feeds :func:`run_scheme`; the shards are host numpy (gathered
    per minibatch), the test batch is on ``device``.  ``streaming=True``
    (default) hands out :class:`~repro_torch.data.ShardView`s over one
    global array instead of per-client copies; gathered batches are
    byte-identical either way.  ``data_root`` is where the loader looks
    for real files and ``cache_dir`` where it caches its arrays
    (:mod:`repro_torch.data`).

    ``population=N`` virtualizes the client set (10^4–10^6 clients): the
    partition becomes a pure index function
    (:class:`~repro_torch.fl.population.VirtualPartition`) evaluated per
    *sampled* client, the shard lists are O(1)-resident
    :class:`~repro_torch.data.streaming.VirtualShardList`s, and they carry
    a :class:`~repro_torch.fl.population.PopulationRegistry` that
    :func:`build_runner` binds the heterogeneity model and participation
    bookkeeping to.  ``num_clients`` is ignored in favour of ``N``;
    ``partition_kw`` feeds the virtual partition (``samples_per_client``,
    ``gamma_pct``, ``missing``).
    """
    device = resolve_device(device)
    ds = load_dataset(task, seed=seed, data_root=data_root,
                      cache_dir=cache_dir, **(task_kw or {}))
    if partitioner is None:
        partitioner = "natural" if ds.modality == "text" else "dirichlet"
    if population is not None:
        vp = VirtualPartition(ds.partition_labels, int(population),
                              seed=seed, kind=partitioner,
                              **(partition_kw or {}))
        parts_x, parts_y = make_shards(ds.x, ds.y, vp, streaming=True)
        registry = PopulationRegistry(int(population), seed=seed,
                                      partition=vp)
        parts_x.registry = registry
        parts_y.registry = registry
    else:
        parts = partition_dataset(ds, partitioner, num_clients, seed,
                                  **(partition_kw or {}))
        parts_x, parts_y = make_shards(ds.x, ds.y, parts, streaming)
    if model_name is None:
        model_name = "rnn" if ds.modality == "text" else "cnn"
    entry = get_model(model_name)
    if entry.modality != ds.modality:
        raise ValueError(
            f"model {model_name!r} expects {entry.modality} data but "
            f"dataset {task!r} is {ds.modality}")
    model = entry.build(max_width, ds.metadata, **(model_kw or {}))
    return model, parts_x, parts_y, ds.test_batch(device)


def build_image_setup(model_name: str = "cnn", num_clients: int = 100,
                      gamma: float = 40.0, max_width: int = 3, seed: int = 0,
                      noise: float = 1.2, *, task: str = "synthetic_image",
                      partitioner: str = "dirichlet", partition_kw=None,
                      data_root=None, cache_dir=None, streaming: bool = True,
                      task_kw=None, device=None):
    """Image-task setup (default: the synthetic stand-in under the paper's
    Γ partition)."""
    task_kw = dict(task_kw or {})
    if task == "synthetic_image":
        task_kw.setdefault("noise", noise)
    partition_kw = dict(partition_kw or {})
    if partitioner == "dirichlet":
        partition_kw.setdefault("gamma_pct", gamma)
    return build_setup(task, model_name, num_clients, max_width, seed,
                       partitioner=partitioner, partition_kw=partition_kw,
                       data_root=data_root, cache_dir=cache_dir,
                       streaming=streaming, task_kw=task_kw, device=device)


def build_text_setup(num_clients: int = 100, max_width: int = 3,
                     seed: int = 0, *, task: str = "synthetic_text",
                     model_name: Optional[str] = None,
                     partitioner: str = "natural", partition_kw=None,
                     data_root=None, cache_dir=None, streaming: bool = True,
                     task_kw=None, model_kw=None, device=None):
    """Char-LM setup as a registry lookup.

    The default ``natural`` partitioner groups by speaker when the
    dataset carries ids (Shakespeare) and falls back to contiguous shards
    of the synthetic corpus.  ``model_name`` picks a registered text model
    (``"rnn"`` by default, ``"transformer"`` for the composed-LLM path).
    """
    return build_setup(task, model_name, num_clients, max_width, seed,
                       partitioner=partitioner, partition_kw=partition_kw,
                       data_root=data_root, cache_dir=cache_dir,
                       streaming=streaming, task_kw=task_kw,
                       model_kw=model_kw, device=device)


def build_runner(scheme: str, model: FLModelDef, parts_x, parts_y, test_batch,
                 cfg: Optional[FLConfig] = None, seed: int = 0,
                 tier_weights=(0.05, 0.15, 0.30, 0.50), device=None):
    """Construct a ready-to-run runner for ``scheme`` on ``device``.

    For a virtual population (shards from ``build_setup(population=N)``)
    the heterogeneity model resolves profiles on demand through the
    population's registry, and ``cfg.num_clients`` must be ``N``.
    """
    cfg = cfg or FLConfig(num_clients=len(parts_x), seed=seed)
    registry = getattr(parts_x, "registry", None)
    if registry is not None:
        if cfg.num_clients != len(registry):
            raise ValueError(
                f"cfg.num_clients={cfg.num_clients} does not match the "
                f"virtual population of {len(registry)} clients")
        het = registry.heterogeneity(seed=seed, tier_weights=tier_weights)
    else:
        het = HeterogeneityModel(cfg.num_clients, seed=seed,
                                 tier_weights=tier_weights)
    eval_width = next(iter(model.specs.values())).max_width
    return build_engine(scheme, model, parts_x, parts_y, test_batch, het, cfg,
                        eval_width, device=device)


def run_scheme(scheme: str, model: FLModelDef, parts_x, parts_y, test_batch,
               rounds: int, cfg: Optional[FLConfig] = None,
               seed: int = 0,
               tier_weights=(0.05, 0.15, 0.30, 0.50),
               device=None) -> List[RoundLog]:
    """Run ``rounds`` rounds of ``scheme``.  tier_weights follow the
    paper's premise: high-performance clients are a small fraction of the
    edge fleet."""
    runner = build_runner(scheme, model, parts_x, parts_y, test_batch,
                          cfg=cfg, seed=seed, tier_weights=tier_weights,
                          device=device)
    return runner.run(rounds)


def summarize(history: List[RoundLog]) -> Dict[str, float]:
    """Run summary; an empty history yields an empty dict."""
    if not history:
        return {}
    accs = [h.accuracy for h in history if h.accuracy is not None]
    return {
        "final_acc": accs[-1] if accs else float("nan"),
        "best_acc": max(accs) if accs else float("nan"),
        "wall_time": history[-1].wall_time,
        "traffic_gb": history[-1].traffic_bytes / 1e9,
        "traffic_up_gb": float(sum(h.up_bytes for h in history)) / 1e9,
        "traffic_down_gb": float(sum(h.down_bytes for h in history)) / 1e9,
        "avg_wait": float(np.mean([h.avg_wait for h in history])),
        "mean_tau": float(np.mean([h.mean_tau for h in history])),
    }


def time_to_accuracy(history: List[RoundLog],
                     target: float) -> Optional[float]:
    """Virtual wall time at which ``target`` accuracy was first reached,
    or ``None`` (also on an empty history)."""
    for h in history or []:
        if h.accuracy is not None and h.accuracy >= target:
            return h.wall_time
    return None


def traffic_to_accuracy(history: List[RoundLog],
                        target: float) -> Optional[float]:
    """Cumulative traffic at which ``target`` accuracy was first reached,
    or ``None`` (also on an empty history)."""
    for h in history or []:
        if h.accuracy is not None and h.accuracy >= target:
            return h.traffic_bytes
    return None

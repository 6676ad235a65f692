"""On-disk npz cache for loader outputs.

The JAX package's cache, copied: the same layout, key and environment
variable, so one cache directory may serve both packages (the arrays are
the same bit for bit).

Layout: ``<cache_dir>/<task>/<sha1-of-key>.npz`` where the key is the
canonical JSON of ``(task, seed, preprocessing...)`` — every field that
changes the produced arrays.  Writes are atomic (tmp file + rename) so
concurrent CI shards can share one directory, and the resolved key is
stored inside the archive (``__key__``) for debuggability.

The cache directory resolves, in order: the explicit ``cache_dir``
argument, the ``REPRO_DATA_CACHE`` environment variable, else caching
is disabled (loaders regenerate from files / the synthetic fallback).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

ENV_VAR = "REPRO_DATA_CACHE"


def resolve_cache_dir(cache_dir=None) -> Optional[Path]:
    if cache_dir is not None:
        return Path(cache_dir)
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else None


def cache_key(**fields) -> str:
    """Deterministic hex key from the (task, seed, preprocessing) fields."""
    canon = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha1(canon.encode()).hexdigest()


def cache_path(cache_dir, task: str, key: str) -> Path:
    return Path(cache_dir) / task / f"{key}.npz"


def load_arrays(path: Path) -> Optional[Dict[str, np.ndarray]]:
    """Arrays from a cache file, or None when absent/corrupt."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files if k != "__key__"}
    except (OSError, ValueError, KeyError):
        return None  # truncated/corrupt entries regenerate silently


def save_arrays(path: Path, arrays: Dict[str, np.ndarray], key: str = "") -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __key__=np.frombuffer(key.encode(), np.uint8),
                     **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def cached(task: str, fields: Dict, builder, cache_dir=None):
    """``builder() -> Dict[str, np.ndarray]`` memoized through the cache.

    Returns ``(arrays, hit)``; a disabled cache always rebuilds.
    """
    root = resolve_cache_dir(cache_dir)
    if root is None:
        return builder(), False
    key = cache_key(task=task, **fields)
    path = cache_path(root, task, key)
    arrays = load_arrays(path)
    if arrays is not None:
        return arrays, True
    arrays = builder()
    save_arrays(path, arrays, key)
    return arrays, False

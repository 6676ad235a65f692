"""Checkpointing for nested dicts of tensors and arrays, in one npz file.

The port's counterpart of the JAX package's ``checkpoint/msgpack_ckpt.py``,
with the same interface (``save_checkpoint``, ``load_checkpoint``,
``restore_latest``) and the same directory layout: one directory per
step (``step_00000120/``) holding the payload and a ``manifest.json``.
The payload differs: it is ``state.npz``, one ``np.savez``-format file
whose keys are the flattened ``a/b/c`` leaf paths, because the port must
not need ``msgpack`` (the machines it runs on do not all have it).  numpy
writes and reads it, with ``allow_pickle=False``.

Leaves may be torch tensors on any device, numpy arrays or scalars; they
are brought to the host here.  numpy has no bfloat16, so a bf16 leaf is
stored as its uint16 bits and the manifest's ``dtypes`` entry names it,
as the reference stores its bf16 leaves; it loads back as a CPU
``torch.bfloat16`` tensor, every other leaf as a numpy array.

Writes are atomic at the step-directory level: the payload is staged in a
``step_XXXXXXXX.tmp.<pid>`` sibling and renamed into place with
``os.replace`` once fully written, so an interrupted save never leaves a
partial ``step_*`` directory for ``restore_latest`` to trip over (stale
``.tmp`` leftovers are ignored by the strict step pattern and swept on
the next successful save).
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_PAYLOAD = "state.npz"


def _host(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a host numpy array, and "bfloat16" for a bf16 tensor
    (returned as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _npz_bytes(flat: Dict[str, np.ndarray]) -> bytes:
    """The arrays as ``np.savez`` lays them out (a stored zip of ``.npy``
    members), built in memory; written member by member, so no key can
    collide with ``np.savez``'s own keyword arguments."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, v in flat.items():
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, v, allow_pickle=False)
    return buf.getvalue()


def _list_steps(directory: Path) -> List[Tuple[int, Path]]:
    """(step, path) pairs for complete checkpoints, ascending by step.

    Numeric sort on the strict ``step_<digits>`` pattern, so staging
    ``.tmp`` directories and unrelated entries are never candidates and
    unpadded step names still order correctly.
    """
    steps = []
    for p in directory.iterdir():
        m = _STEP_RE.match(p.name)
        if m and p.is_dir():
            steps.append((int(m.group(1)), p))
    return sorted(steps)


def save_checkpoint(directory: str | Path, step: int, state: Any,
                    keep: int = 3) -> Path:
    """Write ``state`` as ``directory/step_<step>/`` and keep the newest
    ``keep`` checkpoints.  Returns the step directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat, dtypes = {}, {}
    for k, leaf in _flatten(state).items():
        flat[k], dtype = _host(leaf)
        if dtype is not None:
            dtypes[k] = dtype
    blob = _npz_bytes(flat)  # serialize before touching disk
    path = directory / f"step_{step:08d}"
    tmp = directory / f"{path.name}.tmp.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    try:
        (tmp / _PAYLOAD).write_bytes(blob)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": len(flat), "dtypes": dtypes}))
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # prune old checkpoints + any stale staging dirs from dead writers
    for _, old in _list_steps(directory)[:-keep]:
        shutil.rmtree(old)
    for stale in directory.glob("step_*.tmp.*"):
        if stale != tmp:
            shutil.rmtree(stale, ignore_errors=True)
    return path


def load_checkpoint(path: str | Path) -> Any:
    """The nested dict a step directory holds: numpy arrays, and CPU
    ``torch.bfloat16`` tensors for bf16 leaves."""
    path = Path(path)
    dtypes = json.loads((path / "manifest.json").read_text()).get(
        "dtypes", {})
    flat: Dict[str, Any] = {}
    with np.load(path / _PAYLOAD, allow_pickle=False) as z:
        for k in z.files:
            arr = z[k]
            if dtypes.get(k) == "bfloat16":
                arr = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            flat[k] = arr
    return _unflatten(flat)


def restore_latest(directory: str | Path) -> Optional[tuple]:
    """``(step, state)`` of the newest complete checkpoint under
    ``directory``, or None when there is none."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _list_steps(directory)
    if not steps:
        return None
    step, last = steps[-1]
    return step, load_checkpoint(last)

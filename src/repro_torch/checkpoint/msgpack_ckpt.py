"""Msgpack checkpointing for nested dicts of tensors and arrays.

The port's counterpart of the JAX package's ``checkpoint/msgpack_ckpt.py``,
in the same format: a directory per step (``step_00000120/``) holding
``state.msgpack``, a flattened ``{"path/to/leaf": {dtype, shape, data}}``
map, and a ``manifest.json`` (``{"step", "leaves"}``).  Leaf paths join
dict keys (sorted) and list indices with ``/``; ``dtype`` is numpy's name
for the leaf's type, ``shape`` a list of ints and ``data`` the leaf's raw
C-order bytes.  A bfloat16 leaf is stored as its uint16 bits under the
dtype ``"bfloat16"``.  For the same state the file is byte for byte the
one the JAX package writes, and each package restores the other's.

The codec is this module's own (no ``msgpack`` package).  The writer
emits exactly what ``msgpack.packb`` emits for the payload (the smallest
form of each map, str, bin, array and unsigned int) and streams it to the
file leaf by leaf, so the whole blob is never held in memory; a leaf of
2^32 bytes or more has no msgpack form and raises ``ValueError``.  The
reader maps the file (``mmap``) and takes every leaf as an ``np.frombuffer``
view of it; it accepts every width of the types above, signed ints, nil,
bools and floats, and bytes or str keys.

Leaves may be torch tensors on any device, numpy arrays or scalars; they
are brought to the host here.  A bf16 leaf loads back as a CPU
``torch.bfloat16`` tensor, every other leaf as a numpy array (numpy has no
bfloat16).

A state laid out on a device mesh (DTensor leaves, as ``launch/train.py
--mesh pod|multipod`` trains it) is saved by every rank together: rank 0
gathers each leaf whole, one at a time, and writes the file a one-device
save of the same values writes (the reference's ``jax.device_get`` then
``packb``); only rank 0 touches the directory, which every rank must
see.  Each rank restores its own block of each leaf from the map
(:func:`local_shard`), with no collective.

Writes are atomic at the step-directory level: the payload is staged in a
``step_XXXXXXXX.tmp.<pid>`` sibling and renamed into place with
``os.replace`` once fully written, so an interrupted save never leaves a
partial ``step_*`` directory for ``restore_latest`` to trip over (stale
``.tmp`` leftovers are ignored by the strict step pattern and swept on
the next successful save).
"""

from __future__ import annotations

import itertools
import json
import math
import mmap
import os
import re
import shutil
import struct
from pathlib import Path
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_PAYLOAD = "state.msgpack"
_BIN_LIMIT = 1 << 32  # bin32's length field


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _sized(n: int, fix_max: int, fix_base: int, *codes) -> bytes:
    """A length header: the fix form up to ``fix_max``, else the first of
    ``codes`` ((code, struct format, limit) widest last) that holds ``n``."""
    if n <= fix_max:
        return bytes((fix_base | n,))
    for code, fmt, limit in codes:
        if n < limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} has no msgpack form")


def _map_header(n: int) -> bytes:
    return _sized(n, 15, 0x80, (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _array_header(n: int) -> bytes:
    return _sized(n, 15, 0x90, (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))


def _bin_header(n: int) -> bytes:
    return _sized(n, -1, 0, (0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                  (0xC6, ">I", _BIN_LIMIT))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 31, 0xA0, (0xD9, ">B", 1 << 8),
                  (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)) + b


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"{n}: the payload holds unsigned ints only")
    return _sized(n, 127, 0, (0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                  (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64))


_FIXED = {  # code -> (struct format, kind)
    0xCA: (">f", "num"), 0xCB: (">d", "num"),
    0xCC: (">B", "num"), 0xCD: (">H", "num"), 0xCE: (">I", "num"),
    0xCF: (">Q", "num"), 0xD0: (">b", "num"), 0xD1: (">h", "num"),
    0xD2: (">i", "num"), 0xD3: (">q", "num"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_CONST = {0xC0: None, 0xC2: False, 0xC3: True}


def _take(buf: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return buf[pos:pos + n]


def _unpack(buf: memoryview, pos: int = 0) -> Tuple[Any, int]:
    """(object, position after it) of the msgpack value at ``pos``.  A bin
    value comes back as a memoryview slice of ``buf`` (no copy)."""
    code = _take(buf, pos, 1)[0]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code in _CONST:
        return _CONST[code], pos
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in _FIXED:
        fmt, kind = _FIXED[code]
        size = struct.calcsize(fmt)
        (n,) = struct.unpack_from(fmt, _take(buf, pos, size))
        pos += size
        if kind == "num":
            return n, pos
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")
    if kind == "bin":
        return _take(buf, pos, n), pos + n
    if kind == "str":
        return str(_take(buf, pos, n), "utf-8"), pos + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        if isinstance(k, memoryview):  # a bin key (unhashable view)
            k = k.tobytes()
        out[k], pos = _unpack(buf, pos)
    return out, pos


# ---------------------------------------------------------------------------
# the payload
# ---------------------------------------------------------------------------


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


def _leaf_meta(leaf: Any) -> Tuple[str, List[int], int]:
    """(dtype name, shape, bytes) of a leaf as it will be stored."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            dtype = "bfloat16"
        else:
            dtype = str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
        return dtype, list(leaf.shape), leaf.numel() * leaf.element_size()
    a = np.asarray(leaf)
    return str(a.dtype), list(a.shape), a.nbytes


def _host_bytes(leaf: Any) -> np.ndarray:
    """A leaf's C-order bytes on the host, as a flat uint8 array (a bf16
    tensor's are its uint16 bits; a DTensor's, its whole value's, gathered
    to rank 0 by :func:`_gather_leaf`)."""
    if _is_dtensor(leaf):
        leaf = _gather_leaf(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return a.reshape(-1).view(np.uint8)


def _write_payload(f: BinaryIO, flat: Dict[str, Any],
                   metas: Dict[str, Tuple[str, List[int], int]]) -> None:
    """``msgpack.packb`` of the payload map, written header by header and
    leaf buffer by leaf buffer."""
    f.write(_map_header(len(flat)))
    for k, leaf in flat.items():
        dtype, shape, nbytes = metas[k]
        head = [_str(k), _map_header(3), _str("dtype"), _str(dtype),
                _str("shape"), _array_header(len(shape))]
        head += [_uint(int(d)) for d in shape]
        head += [_str("data"), _bin_header(nbytes)]
        f.write(b"".join(head))
        f.write(_host_bytes(leaf))


def _field(meta: Dict, name: str) -> Any:
    """A leaf record's field under a str or a bytes key."""
    key = name.encode()
    return meta[key] if key in meta else meta[name]


def _text(v: Any) -> str:
    return bytes(v).decode() if isinstance(v, (bytes, memoryview)) else v


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


# ---------------------------------------------------------------------------
# a state laid out on a device mesh
# ---------------------------------------------------------------------------


def _is_dtensor(leaf: Any) -> bool:
    if type(leaf) is torch.Tensor or not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _region(shape, offset) -> tuple:
    """The index of the block of ``shape`` at ``offset`` in a whole leaf."""
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))


def _shards(leaf) -> List[Tuple[int, tuple, tuple]]:
    """(rank, local shape, global offset) of every distinct shard of the
    DTensor ``leaf``, in the mesh's order: one rank for each coordinate
    that equals rank 0's on every mesh dim the leaf is replicated over.
    Their blocks tile the whole leaf once."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)

    placements = leaf.placements
    for p in placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"a {p} leaf has no whole value to save")
    ranks = leaf.device_mesh.mesh
    (home,) = (ranks == 0).nonzero().tolist() or [None]
    if home is None:
        raise ValueError("rank 0 writes the checkpoint: it must be on the "
                         "leaf's mesh")
    out = []
    for coord in itertools.product(*map(range, ranks.shape)):
        if any(isinstance(p, Replicate) and c != h
               for p, c, h in zip(placements, coord, home)):
            continue
        shape, offset = _compute_local_shape_and_global_offset(
            leaf.shape, tuple(ranks.shape), list(coord), placements)
        out.append((int(ranks[coord]), tuple(shape), tuple(offset)))
    return out


def _gather_leaf(leaf: Any) -> Any:
    """The whole value of ``leaf`` on rank 0, gathered one leaf at a time.

    A plain leaf, or a DTensor replicated over its whole mesh, is rank 0's
    own (no collective).  Otherwise rank 0 fills one whole CPU tensor:
    its own block by a local copy, every other distinct shard's block from
    a ``recv`` into a buffer of that shard's size on rank 0's device,
    while each rank holding such a shard ``send``s it.  So rank 0 holds
    at most one whole leaf on the host and one shard on its device beyond
    the state.  Ranks other than 0 return None."""
    import torch.distributed as dist

    rank = dist.get_rank()
    if not _is_dtensor(leaf):
        return leaf if rank == 0 else None
    local = leaf.to_local()
    shards = _shards(leaf)
    if len(shards) == 1:
        return local if rank == 0 else None
    if rank != 0:
        if local.numel() and any(r == rank for r, _, _ in shards):
            dist.send(local.contiguous(), dst=0)
        return None
    whole = torch.empty(tuple(leaf.shape), dtype=leaf.dtype)
    for r, shape, offset in shards:
        if not math.prod(shape):
            continue
        if r == 0:
            part = local
        else:
            part = torch.empty(shape, dtype=local.dtype, device=local.device)
            dist.recv(part, src=r)
        whole[_region(shape, offset)].copy_(part)
        del part  # the next shard's buffer takes this one's place
    return whole


def local_shard(leaf: Any, like: torch.Tensor) -> torch.Tensor:
    """A restored leaf (a numpy array or CPU tensor over the file's map,
    as :func:`load_checkpoint` gives it) laid out as ``like``: a plain
    ``like`` takes the whole leaf on its device in its dtype; a DTensor
    ``like`` takes this rank's block of it by ``like``'s placements
    (``compute_local_shape_and_global_offset``), copied to its device in
    its dtype, as a DTensor of ``like``'s shape and placements.  No
    collective, and only the pages of this rank's block are read."""
    src = torch.as_tensor(leaf)
    if tuple(src.shape) != tuple(like.shape):
        raise ValueError(f"a leaf of shape {tuple(src.shape)} cannot take "
                         f"the place of one of {tuple(like.shape)}")
    if not _is_dtensor(like):
        return src.to(like.device, like.dtype)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh, placements = like.device_mesh, like.placements
    shape, offset = compute_local_shape_and_global_offset(like.shape, mesh,
                                                          placements)
    local = torch.empty(shape, dtype=like.dtype,
                        device=like.to_local().device)
    local.copy_(src[_region(shape, offset)])
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def save_checkpoint(directory: str | Path, step: int, state: Any,
                    keep: int = 3) -> Path:
    """Write ``state`` as ``directory/step_<step>/`` and keep the newest
    ``keep`` checkpoints.  Returns the step directory.

    A state whose leaves include DTensors (a run laid out on a device
    mesh) is saved collectively: every rank of the process group calls
    this, rank 0 alone writes the whole state (the same file a one-device
    save of the whole values writes) and every rank returns once the step
    directory is in place (:func:`_gather_leaf`)."""
    directory = Path(directory)
    flat = _flatten(state)
    # every leaf's form, checked before touching disk
    metas = {k: _leaf_meta(v) for k, v in flat.items()}
    for k, (_, _, nbytes) in metas.items():
        if nbytes >= _BIN_LIMIT:
            raise ValueError(f"leaf {k!r} holds {nbytes} bytes: msgpack's "
                             "bin32 takes fewer than 2^32")
    path = directory / f"step_{step:08d}"
    if not any(_is_dtensor(v) for v in flat.values()):
        _write_step(directory, path, step, flat, metas, keep)
        return path
    import torch.distributed as dist
    if dist.get_rank() == 0:
        _write_step(directory, path, step, flat, metas, keep)
    else:
        for leaf in flat.values():
            _gather_leaf(leaf)
    dist.barrier()
    return path


def _write_step(directory: Path, path: Path, step: int,
                flat: Dict[str, Any], metas: Dict, keep: int) -> None:
    """Stage the payload and the manifest in a ``.tmp`` sibling, rename it
    to ``path`` and prune."""
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"{path.name}.tmp.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    try:
        with open(tmp / _PAYLOAD, "wb") as f:
            _write_payload(f, flat, metas)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": len(flat)}))
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


def load_checkpoint(path: str | Path) -> Any:
    """The nested dict a step directory holds: numpy arrays over a
    copy-on-write map of the file, and CPU ``torch.bfloat16`` tensors for
    bf16 leaves."""
    path = Path(path)
    file = path / _PAYLOAD
    if not file.exists() and (path / "state.npz").exists():
        raise ValueError(
            f"{path} holds an npz checkpoint (state.npz): read it with "
            "repro_torch.checkpoint.npz_ckpt.load_checkpoint")
    with open(file, "rb") as f:
        buf = memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY))
    payload, end = _unpack(buf)
    if end != len(buf):
        raise ValueError(f"{file}: {len(buf) - end} bytes after the payload")
    flat: Dict[str, Any] = {}
    for k, meta in payload.items():
        dtype = _text(_field(meta, "dtype"))
        shape = [int(d) for d in _field(meta, "shape")]
        data = _field(meta, "data")
        if dtype == "bfloat16":
            arr = np.frombuffer(data, np.int16).reshape(shape)
            flat[_text(k)] = torch.from_numpy(arr).view(torch.bfloat16)
        else:
            flat[_text(k)] = np.frombuffer(data, np.dtype(dtype)).reshape(
                shape)
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

"""Hand-written Hopper kernels of the port, and their build.

Each kernel is CUDA C++ under ``repro_torch/csrc/`` with a plain C
launcher.  It is compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library per source under ``repro_torch/_build/`` (git-ignored)
and loaded with :mod:`ctypes`.  Nothing is built or imported from CUDA
when this package is imported: the CPU tests import every module.

  compose        the paper's composition product
                 (:mod:`repro_torch.kernels.compose`)
  rank_apply     fused rank-space dense application (x.v).u2
  compose_apply  fused compose+apply, the weight built in shared memory
  conv_rank      fused conv rank path: basis conv + coefficient contraction
                 (:mod:`repro_torch.kernels.conv_rank`)

These four take an optional leading client axis C (a cohort of clients
in one launch).  Their autograd Functions take it always, and under
``torch.func.vmap`` a :class:`ClientVmap` rule folds ``vmap``'s axis into
it, so a cohort trained under ``vmap`` launches each kernel once per
layer, whatever its client count.
  decode_attention  one query per row over a ragged KV cache, split over
                 the keys and shared by the query group, online softmax
                 (:mod:`repro_torch.kernels.decode_attention`)
  flash_attention   blockwise streaming-softmax attention with causal and
                 window masks and per-row key counts, and the row
                 log-sum-exp when training asks for it
                 (:mod:`repro_torch.kernels.flash_attention`)
  flash_attention_bwd  its gradient for bf16 tensors: dq, then dk and dv,
                 from the forward's output and log-sum-exp, deterministic
                 (the same module)
  rmsnorm        per-row RMS normalisation, f32 statistics
                 (:mod:`repro_torch.kernels.rmsnorm`)
  ssd_chunk      the Mamba2 SSD intra-chunk block plus its carry-in
                 (:mod:`repro_torch.kernels.ssd_chunk`)

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device; any other device
raises.  :data:`LAUNCHES` counts kernel launches per kernel name, and
each function in :data:`LAUNCH_HOOKS` is called with every launch's
name, tensors and scalars (:mod:`repro_torch.launch.op_analysis` counts
the kernels' FLOPs and bytes so: a ctypes launch never reaches
PyTorch's dispatcher).  A DTensor never reaches a kernel: on a device
mesh :mod:`repro_torch.kernels.ops` hands each kernel its local shard
(``local_map``), and :func:`launch` raises on a DTensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C launcher name and argument types per source file
_SIGNATURES = {
    "compose": ("compose_f32", [_P, _P, _P] + [_I] * 9 + [_P]),
    "rank_apply": ("rank_apply_f32", [_P] * 5 + [_I] * 8 + [_P]),
    "compose_apply": ("compose_apply_f32", [_P] * 5 + [_I] * 9 + [_P]),
    "conv_rank": ("conv_rank_f32", [_P] * 4 + [_I] * 16 + [_P]),
    "decode_attention": ("decode_attention", [_P] * 7 + [_I] * 8 + [_P]),
    "flash_attention": ("flash_attention", [_P] * 6 + [_I] * 8 + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_P] * 11 + [_I] * 8 + [_P]),
    "rmsnorm": ("rmsnorm", [_P] * 3 + [_I] * 3 + [_F, _P]),
    "ssd_chunk": ("ssd_chunk", [_P] * 7 + [_I] * 6 + [_P]),
}
KERNELS = tuple(_SIGNATURES)

# kernel launches per kernel name: each wrapper adds one where it launches
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# hook(name, tensors, scalars) called at every launch
LAUNCH_HOOKS: List[Callable] = []

_fns: Dict[str, ctypes._CFuncPtr] = {}  # each kernel's C launcher, bound once
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(t: torch.Tensor) -> bool:
    """The platform gate: True for a CUDA tensor (launch the kernel), False
    for a CPU tensor (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {t.device}")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    """Build output keyed by the source, every shared header and the
    flags, so an edited source or header is never served a stale
    library."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns the seconds each took (0 for
    one already built).  The library is written under a temporary name
    and renamed into place, so concurrent builders never see half a file.
    """
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, secs = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for\n" + "\n".join(failed))
    return secs


def _launcher(name: str) -> ctypes._CFuncPtr:
    """Kernel ``name``'s C launcher: built, loaded and bound (argument
    types set) on first use."""
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            build([name])
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(_lib_path(name))), fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return fn


def launch(name: str, tensors, *scalars) -> None:
    """Call kernel ``name``'s C launcher on the current stream of the
    tensors' device, raise on a launch error, and count the launch.
    ``tensors`` may hold None for a pointer the launcher takes as
    optional; ``scalars`` are the sizes (ints) and, where the launcher
    takes one, a float, in the launcher's order."""
    if any(t is not None and is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: a DTensor reached the kernel launch; a "
                        "kernel takes the local shard (kernels.ops wraps "
                        "each call in local_map on a device mesh)")
    fn = _fns.get(name) or _launcher(name)
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in tensors],
                 *[x if isinstance(x, float) else int(x) for x in scalars],
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    for hook in LAUNCH_HOOKS:
        hook(name, tensors, scalars)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor laid out on a device mesh).  A
    plain tensor answers from its type alone: this runs at every launch."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


# shared memory a block may use: without the opt-in of ``allow_dynamic_smem``
# (csrc/common.cuh), and at most after it (H100)
SMEM_DEFAULT = 48 * 1024
SMEM_MAX = 227 * 1024


def round4(v: int) -> int:
    """v rounded up to a multiple of 4 (a float4)."""
    return -(-v // 4) * 4


# element type codes of the kernels that take more than float32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(name: str, dtypes=(torch.float32,),
                   **tensors: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous tensor on one CUDA
    device, all of one type among ``dtypes`` — what the kernels take."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    if len({t.dtype for t in tensors.values()}) != 1:
        raise TypeError(f"{name}: operands must share one type")
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is not on a CUDA device")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes "
                            f"{', '.join(str(d) for d in dtypes)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def has_storage(*tensors: torch.Tensor) -> bool:
    """Whether every tensor has storage a kernel can be handed: False for
    the batched tensors ``torch.func.vmap`` passes a function (their
    ``data_ptr()`` raises), which reach a kernel only through a
    :class:`ClientVmap` rule."""
    try:
        for t in tensors:
            t.data_ptr()
    except RuntimeError:
        return False
    return True


def on_clients(real, vmapped, tensors, rest=()):
    """``real(*tensors, *rest)`` on client-batched operands with storage;
    under ``torch.func.vmap`` (operands without storage) the
    :class:`ClientVmap` ``vmapped``, whose rule folds ``vmap``'s axis into
    the client axis and comes back here."""
    if has_storage(*tensors):
        return real(*tensors, *rest)
    return vmapped.apply(*tensors, *rest)


class ClientVmap(torch.autograd.Function):
    """The ``torch.func.vmap`` entry of a composition primitive.

    A subclass names ``real``, the primitive on operands that have
    storage (its autograd Function, or the kernel alone without a graph),
    which takes them with or without a leading client axis, and ``rank``,
    the rank of its first operand without that axis.  The ``vmap`` rule
    moves ``vmap``'s axis of each tensor operand to the front (expanding
    an unbatched one), where it becomes the client axis, or is folded
    into the client axis the call already carries (:func:`fold_clients`),
    and applies ``real`` once: a cohort under ``vmap`` takes one kernel
    launch.  It runs only under ``vmap``: operands with storage go to
    ``real`` directly (:func:`on_clients`), which keeps the calls outside
    ``vmap`` free of the host cost of ``setup_context``-style Functions
    (an ``inspect.signature`` a call)."""

    real = None
    rank = 0

    @staticmethod
    def forward(*args):
        raise RuntimeError("ClientVmap is applied only to batched operands "
                           "under torch.func.vmap (see on_clients)")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @classmethod
    def vmap(cls, info, in_dims, *args):
        n = sum(isinstance(a, torch.Tensor) for a in args)  # tensors first
        # the call carries its own client axis: fold vmap's into it
        merge = args[0].dim() - (in_dims[0] is not None) > cls.rank
        tensors = fold_clients(info.batch_size, in_dims[:n], args[:n], merge)
        y = on_clients(cls.real, cls, tensors, args[n:])
        return (unfold_clients(info.batch_size, y) if merge else y), 0


def fold_clients(batch: int, in_dims, tensors, merge: bool) -> list:
    """The tensor operands of a :class:`ClientVmap` rule with ``vmap``'s
    axis in front: each tensor with that axis at ``in_dims[i]`` (or
    without it, None: shared by every member, so expanded) comes back as
    (batch, ...), or with ``merge`` (the operands carry a client axis C
    already) as (batch * C, ...)."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.movedim(d, 0) if d is not None else t.expand(batch, *t.shape)
        out.append(t.reshape((-1,) + t.shape[2:]) if merge else t)
    return out


def unfold_clients(batch: int, t: torch.Tensor) -> torch.Tensor:
    """Inverse of a merging :func:`fold_clients` for an output:
    (batch * C, ...) -> (batch, C, ...), ``vmap``'s axis at 0."""
    return t.reshape((batch, -1) + t.shape[1:])


def no_grad_guard(name: str, *tensors: torch.Tensor) -> None:
    """For kernel wrappers with no backward (attention, rmsnorm,
    ssd_chunk, like the reference's ``pallas_call``): refuse to build a
    graph through them.  :mod:`repro_torch.kernels.ops` gives the three
    that the model zoo trains through a backward: attention's kernel pair
    for bf16 on the card, else their plain versions'."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")


# the public wrappers and the plain oracles, as the reference's package
# exports them (imported last: both import names defined above)
from repro_torch.kernels import ops, ref  # noqa: E402, F401

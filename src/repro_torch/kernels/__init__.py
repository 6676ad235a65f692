"""Hand-written Hopper kernels for the composition hot path, and their build.

Each kernel is CUDA C++ under ``repro_torch/csrc/`` with a plain C
launcher.  It is compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library per source under ``repro_torch/_build/`` (git-ignored)
and loaded with :mod:`ctypes`.  Nothing is built or imported from CUDA
when this package is imported: the CPU tests import every module.

  compose        the paper's composition product, optional client axis
                 (:mod:`repro_torch.kernels.compose`)
  rank_apply     fused rank-space dense application (x.v).u2
  compose_apply  fused compose+apply, the weight built in shared memory
  conv_rank      fused conv rank path: basis conv + coefficient contraction
                 (:mod:`repro_torch.kernels.conv_rank`)

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device; any other device
raises.  :data:`LAUNCHES` counts kernel launches per kernel name.
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
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C launcher name and argument types per source file
_SIGNATURES = {
    "compose": ("compose_f32", [_P, _P, _P] + [_I] * 6 + [_P]),
    "rank_apply": ("rank_apply_f32", [_P] * 4 + [_I] * 6 + [_P]),
    "compose_apply": ("compose_apply_f32", [_P] * 4 + [_I] * 7 + [_P]),
    "conv_rank": ("conv_rank_f32", [_P] * 4 + [_I] * 14 + [_P]),
}
KERNELS = tuple(_SIGNATURES)

# kernel launches per kernel name: each wrapper adds one where it launches
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
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
    """Build output keyed by the source, the shared header and the flags,
    so an edited source is never served a stale library."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
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


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(name: str, tensors, *ints: int) -> None:
    """Call kernel ``name``'s C launcher on the current stream of the
    tensors' device, raise on a launch error, and count the launch."""
    dev = tensors[0].device
    fn = getattr(library(name), _SIGNATURES[name][0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *[int(i) for i in ints],
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def check_operands(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous f32 tensor on one CUDA
    device — what the kernels take."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is not on a CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")

"""Production meshes on ``torch.distributed`` (the reference:
``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (not a module-level constant), so
importing this module touches no device and no process group.  A mesh
needs a running process group whose world size is the mesh's size: a
``torchrun`` world of 256 or 512 ranks, or the fake world of
:func:`repro_torch.launch.dryrun.fake_world`, in which one process is
rank 0 of 256 or 512.
"""

from __future__ import annotations

import math


def _mesh(shape, names, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{need} ranks: none is initialised (run under torchrun with "
            f"{need} processes, or inside dryrun.fake_world)")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{need} ranks; the running one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """One pod = (data=16, model=16) = 256 devices; multi-pod adds a
    leading pod axis (2, 16, 16) = 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """Degenerate one-device mesh, for a world of one rank."""
    return _mesh((1, 1), ("data", "model"), device_type)

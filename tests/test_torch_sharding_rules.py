"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``): for every arch, mesh and flag the
param, batch and cache specs equal the reference's leaf for leaf (the
reference's ``PartitionSpec`` padded with ``None`` to the leaf's rank),
and under a fake world of 256 (or 512) ranks each leaf's local shard has
the shape its spec implies."""

import functools

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import specs
from repro_torch.sharding import rules


class FakeMesh:
    """Minimal stand-in exposing .shape / .axis_names like jax.Mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = {"data": 16, "model": 16}
PODMESH = {"pod": 2, "data": 16, "model": 16}
# (mesh, zero_pod, moe_ep), as tests/test_sharding_rules.py uses them
VARIANTS = {"none": (None, False, False), "pod": (MESH, False, False),
            "pod_moe_ep": (MESH, False, True),
            "multipod": (PODMESH, False, False),
            "multipod_zero_pod": (PODMESH, True, False),
            "multipod_zero_pod_moe_ep": (PODMESH, True, True)}
ARCHS = configs.list_archs()


@functools.lru_cache(maxsize=None)
def _pshapes(arch):
    return (specs.params_shape(configs.get_config(arch)),
            jspecs.params_shape(jconfigs.get_config(arch)))


def _flat_ref(tree, is_leaf=None):
    """{dotted path: leaf} of a reference pytree."""
    return {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_leaf)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}.{key}" if prefix
                                  else key).items()}
    return {prefix: tree}


def _is_pspec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _same(port_specs, ref_specs, ref_shapes):
    got = _flat(port_specs)
    want = _flat_ref(ref_specs, _is_pspec)
    shapes = _flat_ref(ref_shapes)
    assert set(got) == set(want)
    for path, spec in want.items():
        ndim = len(shapes[path].shape)
        assert isinstance(got[path], rules.Spec)
        assert tuple(got[path]) == tuple(spec) + (None,) * (
            ndim - len(spec)), path


def _local_shape(shape, spec, mesh_shape):
    """Rank 0's shard of a tensor of ``shape`` laid out by ``spec``: each
    dim over the product of its mesh axes (every split dim divides, as the
    rules leave it), at offset 0."""
    sizes = []
    for dim, axis in zip(shape, tuple(spec)):
        n = 1
        for a in (() if axis is None else
                  axis if isinstance(axis, tuple) else (axis,)):
            n *= mesh_shape[a]
        sizes.append(dim // n)
    return tuple(sizes), (0,) * len(shape)


def _meshes(mesh):
    if mesh is None:
        return None, None
    return rules.MeshAxes(mesh), FakeMesh(mesh)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, variant):
    mesh, zero_pod, moe_ep = VARIANTS[variant]
    tmesh, jmesh = _meshes(mesh)
    tp, jp = _pshapes(arch)
    _same(rules.param_specs(tp, mesh=tmesh, zero_pod=zero_pod,
                            moe_ep=moe_ep),
          jrules.param_specs(jp, mesh=jmesh, zero_pod=zero_pod,
                             moe_ep=moe_ep), jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_shape_matches_reference(arch):
    tp, jp = _pshapes(arch)
    got, want = _flat(tp), _flat_ref(jp)
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert got[path].device.type == "meta"
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path


def _pairs():
    return [(a, s) for a in ARCHS for s in SHAPES
            if not (s == "long_500k" and a in configs.LONG_CONTEXT_SKIP)]


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", _pairs())
def test_batch_and_cache_specs_match_reference(arch, shape, mesh_name):
    mesh = MESH if mesh_name == "pod" else PODMESH
    tmesh, jmesh = _meshes(mesh)
    dp = rules.dp_axes_for(tmesh)
    assert dp == jrules.dp_axes_for(jmesh)
    tcfg = configs.config_for_shape(arch, shape)
    jcfg = jconfigs.config_for_shape(arch, shape)
    tins = specs.input_specs(tcfg, SHAPES[shape])
    jins = jspecs.input_specs(jcfg, SHAPES[shape])
    _same(rules.batch_specs(tins["batch"], dp, mesh=tmesh),
          jrules.batch_specs(jins["batch"], dp, mesh=jmesh), jins["batch"])
    if "cache" in jins:
        _same(rules.cache_specs(tins["cache"], tcfg, dp, mesh=tmesh),
              jrules.cache_specs(jins["cache"], jcfg, dp, mesh=jmesh),
              jins["cache"])


def test_placements_of_a_tuple_axis():
    """A dim split over ("pod", "model") takes Shard(i) on both mesh
    dims; the rest replicate."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert rules.to_placements(rules.Spec(("pod", "model"), "data", None),
                               Mesh()) == (Shard(0), Shard(1), Shard(0))
    assert rules.to_placements(rules.Spec(None, None), Mesh()) == (
        Replicate(),) * 3


@pytest.mark.parametrize("arch,multi_pod", [
    ("gemma-2b", False), ("zamba2-2.7b", False), ("xlstm-125m", False),
    ("olmoe-1b-7b", False), ("kimi-k2-1t-a32b", True)])
def test_local_shapes_in_a_fake_world(arch, multi_pod):
    """Rank 0's shard of every full-size leaf has the shape its spec
    implies (the dims over each mesh axis divided, tuple axes by their
    product), as DTensor computes it on the production mesh."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        axes = rules.mesh_axes(mesh)
        tp, _ = _pshapes(arch)
        pspecs = rules.param_specs(tp, mesh=axes, zero_pod=multi_pod)
        leaves, split = _flat(tp), 0
        for path, spec in _flat(pspecs).items():
            shape = leaves[path].shape
            got, offset = compute_local_shape_and_global_offset(
                shape, mesh, rules.to_placements(spec, mesh))
            want, want_offset = _local_shape(shape, spec, axes.shape)
            assert tuple(got) == want and tuple(offset) == want_offset, path
            split += tuple(got) != tuple(shape)
        assert split > 0

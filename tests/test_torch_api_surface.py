"""The port's public surface against the JAX package's.

Every module of ``repro`` (walked by file) maps by path to its
counterpart in ``repro_torch`` (``launch/hlo_analysis`` ->
``launch/op_analysis``).  The counterpart must have each public name of
the reference module: what a package ``__init__`` binds (its
re-exports, submodules included, bound in the port's ``__init__`` too),
and what any other module defines at its top level or re-exports on a
``noqa: F401`` line.  Each public class defined in a reference module
must keep its public methods, properties and dataclass fields in the
port's class.  ``ALLOWED`` lists the names with no counterpart of that
name, each with what stands in for it or why it has none.

The names this slice added are held to live ``repro`` calls on the same
numpy inputs: ``core.aggregate_factorized`` (a 3-client CNN tree, 1e-6),
``core.estimator.aggregate_estimates`` (exactly),
``ClientDataLoader.from_dataset`` and ``.shard`` (bit for bit), the
cohort specs, ``EngineRunner.rng`` and ``eval_accuracy``, and
``CohortStack.tree`` / ``host``.
"""

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent / "src"
RENAMED = {"hlo_analysis": "op_analysis"}

_JAX_ALIAS = "a JAX type alias (jax.Array); the port annotates torch.Tensor"
_PALLAS = ("a Pallas launcher; the port's CUDA wrapper of the same kernel "
           "is {}")
_INTERPRET = ("Pallas's interpret switch; a port wrapper takes its plain "
              "version for a CPU tensor and its kernel for a CUDA one")
_HLO = ("HLO-text parsing; the port counts dispatched ops instead "
        "(repro_torch.launch.op_analysis.OpCounter and analyze)")

ALLOWED = {
    **{(m, "Array"): _JAX_ALIAS for m in (
        "core.aggregation", "core.composition", "fl.client", "fl.models",
        "fl.transformer", "kernels.compose", "kernels.conv_rank",
        "kernels.ops", "kernels.ref", "models.attention", "models.encdec",
        "models.frontends", "models.layers", "models.model",
        "models.module", "models.moe", "models.moe_shardmap",
        "models.sampling", "models.ssm", "models.transformer",
        "models.xlstm")},
    ("core.estimator", "PyTree"):
        "a type alias of Any; the port's is repro_torch.core.estimator.Tree",
    ("launch.specs", "SDS"):
        "jax.ShapeDtypeStruct; the port's specs are meta-device tensors "
        "(repro_torch.launch.specs.META)",
    ("launch.dryrun", "collective_bytes"):
        "HLO-text parsing; the port counts collective bytes from DTensor's "
        "functional collectives (repro_torch.launch.op_analysis.OpCounter)",
    **{("launch.hlo_analysis", n): _HLO for n in (
        "Computation", "Op", "build_multipliers", "flat_cost_analysis",
        "parse_computations")},
    ("kernels.compose", "compose_pallas"):
        _PALLAS.format("repro_torch.kernels.compose.compose_kernel"),
    ("kernels.compose", "rank_apply_pallas"):
        _PALLAS.format("repro_torch.kernels.compose.rank_apply_kernel"),
    ("kernels.compose", "compose_apply_pallas"):
        _PALLAS.format("repro_torch.kernels.compose.compose_apply_kernel"),
    ("kernels.conv_rank", "conv_rank_pallas"):
        _PALLAS.format("repro_torch.kernels.conv_rank.conv_rank_kernel"),
    ("kernels.decode_attention", "decode_attention_pallas"):
        _PALLAS.format("repro_torch.kernels.decode_attention."
                       "decode_attention"),
    ("kernels.flash_attention", "flash_attention_pallas"):
        _PALLAS.format("repro_torch.kernels.flash_attention."
                       "flash_attention"),
    ("kernels.rmsnorm", "rmsnorm_pallas"):
        _PALLAS.format("repro_torch.kernels.rmsnorm.rmsnorm"),
    ("kernels.ssd_chunk", "ssd_chunk_pallas"):
        _PALLAS.format("repro_torch.kernels.ssd_chunk.ssd_chunk"),
    ("kernels.compose", "default_interpret"): _INTERPRET,
}


def _modules():
    out = []
    for f in sorted((ROOT / "repro").rglob("*.py")):
        parts = list(f.relative_to(ROOT / "repro").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _is_package(mod) -> bool:
    return Path(mod.__file__).name == "__init__.py"


def _bound(mod) -> set:
    """The public names ``mod``'s source binds at its top level (for a
    package every import; for a module its definitions and its
    ``noqa: F401`` re-exports)."""
    src = Path(mod.__file__).read_text()
    lines = src.splitlines()
    package = _is_package(mod)
    names = set()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:  # names, not subscripts or attributes
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                names |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and node.module != \
                "__future__":
            text = "\n".join(lines[node.lineno - 1:node.end_lineno])
            if package or "noqa: F401" in text:
                names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _members(cls) -> set:
    out = set()
    for c in cls.__mro__:
        if not c.__module__.startswith("repro."):
            continue
        out |= {k for k in vars(c) if not k.startswith("_")}
        if dataclasses.is_dataclass(c):
            out |= {f for f in c.__dataclass_fields__
                    if not f.startswith("_")}
    return out


def _has_member(cls, name: str) -> bool:
    return hasattr(cls, name) or (dataclasses.is_dataclass(cls)
                                  and name in cls.__dataclass_fields__)


MODULES = _modules()


def test_every_reference_module_has_a_counterpart():
    for rel in MODULES:
        port = ".".join(RENAMED.get(p, p) for p in rel.split(".")) \
            if rel else ""
        path = ROOT / "repro_torch" / Path(*port.split(".")) \
            if port else ROOT / "repro_torch"
        assert path.with_suffix(".py").exists() or \
            (path / "__init__.py").exists(), rel


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_have_counterparts(rel):
    ref = importlib.import_module("repro" + (f".{rel}" if rel else ""))
    port_rel = ".".join(RENAMED.get(p, p) for p in rel.split(".")) \
        if rel else ""
    port = importlib.import_module("repro_torch"
                                   + (f".{port_rel}" if port_rel else ""))
    missing = []
    port_bound = _bound(port) if _is_package(port) else None
    for name in sorted(_bound(ref)):
        if (rel, name) in ALLOWED:
            assert not hasattr(port, name), \
                f"{rel}.{name} is allow-listed but the port has it"
            continue
        if not hasattr(port, name) or (port_bound is not None
                                       and name not in port_bound):
            missing.append(name)
            continue
        obj = getattr(ref, name)
        if inspect.isclass(obj) and obj.__module__ == ref.__name__:
            missing += [f"{name}.{m}" for m in sorted(_members(obj))
                        if not _has_member(getattr(port, name), m)]
    assert not missing, f"repro_torch.{port_rel} lacks {missing}"


def test_allow_list_names_real_gaps():
    """Every entry names a reference name that exists, and says what
    stands in for it or why it has none."""
    for (rel, name), why in ALLOWED.items():
        assert rel in MODULES, rel
        assert name in _bound(importlib.import_module(f"repro.{rel}")), \
            (rel, name)
        assert len(why) > 20, (rel, name)


# --- the names this slice added, against the reference's -----------------


def test_aggregate_factorized_matches_reference():
    from repro.core import aggregate_factorized as jagg
    from repro.fl import build_image_setup as j_setup
    from repro_torch.convert import from_jax_params, to_numpy
    from repro_torch.core import aggregate_factorized as tagg

    jm = j_setup(num_clients=4)[0]
    gp = jax.device_get(jm.init_factorized(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    ids = [np.sort(rng.choice(3, size=k, replace=False)) for k in (1, 2, 3)]
    clients = [{name: {
        "basis": (layer["basis"] + 0.1 * rng.standard_normal(
            layer["basis"].shape)).astype(np.float32),
        "coeff": (layer["coeff"][i] + 0.1 * rng.standard_normal(
            layer["coeff"][i].shape)).astype(np.float32)}
        for name, layer in gp.items()} for i in ids]
    want = jax.device_get(jagg(gp, clients, ids))
    got = to_numpy(tagg(from_jax_params(gp, "cpu"),
                        [from_jax_params(c, "cpu") for c in clients], ids))
    assert got.keys() == want.keys()
    for name in want:
        for key in ("basis", "coeff"):
            np.testing.assert_allclose(got[name][key], want[name][key],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 10, 32])
def test_aggregate_estimates_matches_reference_exactly(n):
    from repro.core.estimator import aggregate_estimates as jagg
    from repro_torch.core.estimator import aggregate_estimates as tagg

    rng = np.random.default_rng(n)
    per_client = [{"L": float(rng.standard_normal() * 10 ** rng.uniform(
                       -3, 3)),
                   "sigma_sq": np.float32(rng.random()),
                   "grad_sq": np.float64(rng.random() * 100)}
                  for _ in range(n)]
    assert tagg(per_client) == jagg(per_client)


@pytest.mark.parametrize("streaming", [True, False])
def test_loader_from_dataset_and_shard_match_reference(streaming):
    from repro.data import ClientDataLoader as JLoader
    from repro.data import load_dataset as jload
    from repro.data import partition_dataset as jpart
    from repro_torch.data import ClientDataLoader as TLoader
    from repro_torch.data import load_dataset as tload
    from repro_torch.data import partition_dataset as tpart

    jds, tds = jload("synthetic_image", seed=0), tload("synthetic_image",
                                                       seed=0)
    jparts = jpart(jds, "dirichlet", 6, seed=0)
    tparts = tpart(tds, "dirichlet", 6, seed=0)
    jl = JLoader.from_dataset(jds, jparts, streaming=streaming)
    tl = TLoader.from_dataset(tds, tparts, streaming=streaming,
                              device="cpu")
    assert tl.device == torch.device("cpu")
    assert tl.num_clients == jl.num_clients == 6
    for n in range(6):
        (jx, jy), (tx, ty) = jl.shard(n), tl.shard(n)
        for a, b in ((jx, tx), (jy, ty)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cohort_specs_match_reference():
    from repro.sharding import fl as jfl
    from repro_torch.sharding import fl as tfl
    from repro_torch.sharding.rules import Spec

    for name in ("contribution_spec", "replicated_spec", "block_spec"):
        got = getattr(tfl, name)()
        assert isinstance(got, Spec)
        assert tuple(got) == tuple(getattr(jfl, name)())
    for axis in range(4):
        assert tuple(tfl.client_axis_spec(axis)) == \
            tuple(jfl.client_axis_spec(axis))


def test_runner_rng_and_eval_accuracy_match_reference():
    import dataclasses

    from repro.fl import FLConfig as JConfig
    from repro.fl import build_image_setup as j_setup
    from repro.fl import build_runner as j_build
    from repro_torch.convert import from_jax_params
    from repro_torch.fl import FLConfig as TConfig
    from repro_torch.fl import build_image_setup as t_setup
    from repro_torch.fl import build_runner as t_build

    kw = dict(num_clients=8, clients_per_round=3)
    jm, jx, jy, jt = j_setup(num_clients=8)
    jr = j_build("heroes", jm, jx, jy, jt, cfg=JConfig(**kw))
    tr = t_build("heroes", *t_setup(num_clients=8, device="cpu"),
                 cfg=TConfig(**kw), device="cpu")
    tr.state = dataclasses.replace(tr.state, params=from_jax_params(
        jax.device_get(jm.init_factorized(jax.random.PRNGKey(0))), "cpu"))
    assert tr.rng is tr.state.rng
    assert tr.rng.bit_generator.state == jr.rng.bit_generator.state
    n_test = int(jt["labels"].shape[0])
    assert abs(tr.eval_accuracy() - jr.eval_accuracy()) <= 2.0 / n_test


def test_cohort_stack_tree_and_host():
    from repro_torch.fl.engine import CohortStack
    from repro_torch.sharding import CohortMesh

    cpu = torch.device("cpu")
    rows = torch.arange(24.0).reshape(4, 3, 2)
    stack = CohortStack([{"w": rows[:2]}, {"w": rows[2:]}], n_real=3,
                        mesh=CohortMesh((cpu, cpu)))
    assert torch.equal(stack.tree["w"], rows)
    host = stack.host()
    assert isinstance(host["w"], np.ndarray)
    np.testing.assert_array_equal(host["w"], rows.numpy())
    assert stack.host() is host  # copied once
    one = CohortStack([{"w": rows}], n_real=4, mesh=CohortMesh((cpu,)))
    assert one.tree["w"] is rows

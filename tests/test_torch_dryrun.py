"""The port's production-mesh layer on the CPU: the meshes
(``launch.mesh``) and the fake world, the dry run
(``launch.dryrun``: its CLI, and xlstm-125m ``long_500k`` end to end as
rank 0 of 256), the op counter (``launch.op_analysis``) against the
reference's HLO analysis, the activation context's no-op paths and its
reshapes on a mesh, the chunked factorized linear, the kernels' refusal
of a DTensor, ``launch/train.py --mesh pod`` inside a
fake world of 256, and ``fl/server.py``'s deprecated shim."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.sharding import context, rules
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def _module(args, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=timeout)


# --------------------------------------------------------------------------
# meshes and the fake world
# --------------------------------------------------------------------------


def test_meshes_need_a_world_of_their_size():
    with pytest.raises(RuntimeError, match="none is initialised"):
        make_production_mesh(device_type="cpu")
    with fake_world(16):
        with pytest.raises(RuntimeError, match="256 ranks; the running "
                                               "one has 16"):
            make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_in_a_fake_world(multi_pod, shape, names):
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.mesh.shape) == shape
        assert mesh.mesh_dim_names == names
        assert rules.dp_axes_for(rules.mesh_axes(mesh)) == (
            ("pod", "data") if multi_pod else "data")
    import torch.distributed as dist
    assert not dist.is_initialized()  # the world is gone


def test_host_mesh():
    with fake_world(1):
        mesh = make_host_mesh(device_type="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1)


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------


def test_dryrun_help_surface():
    r = _module(["repro_torch.launch.dryrun", "--help"], timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    for flag in ("--both-meshes", "--skip-blocks", "--moe-sorted",
                 "--residual", "--composition", "--compose-matmul",
                 "--attn-qseq", "--no-remat", "--skip-existing",
                 "--kv-int8", "--moe-shardmap", "--multi-pod", "--out"):
        assert flag in r.stdout, flag


def test_dryrun_single_pair_end_to_end(tmp_path):
    """xlstm-125m long_500k (the reference's own test pair) as rank 0 of
    a fake world of 256, on the CPU."""
    r = _module(["repro_torch.launch.dryrun", "--arch", "xlstm-125m",
                 "--shape", "long_500k", "--device", "cpu", "--out",
                 str(tmp_path)])
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    out = list(tmp_path.glob("*.json"))
    assert [p.name for p in out] == ["xlstm-125m__long_500k__16x16.json"]
    rec = json.loads(out[0].read_text())
    assert rec["devices"] == 256 and rec["kind"] == "decode"
    assert rec["mesh"] == "16x16"
    assert rec["loop_scaled"]["dot_flops"] > 0
    assert rec["cost"]["flops"] >= rec["loop_scaled"]["dot_flops"]
    # the argument bytes are the specs' reckoning, made here anew
    cfg = dryrun.pair_config("xlstm-125m", "long_500k")
    axes = rules.MeshAxes({"data": 16, "model": 16})
    trees, _ = dryrun.plan(cfg, "long_500k", axes)
    assert rec["memory"]["argument_bytes"] == sum(
        rules.spec_bytes(tree, spec, axes) for tree, spec in
        (trees["params"], trees["batch"], trees["cache"]))
    assert rec["params"] == 167748864
    assert rec["collectives"]["total"] > 0


def test_reckoned_bytes_split_by_the_mesh():
    """gemma-2b train_4k: params and AdamW's two f32 moments over 256
    devices come to the whole trees' bytes over the devices their specs
    split them over."""
    cfg = dryrun.pair_config("gemma-2b", "train_4k")
    axes = rules.MeshAxes({"data": 16, "model": 16})
    trees, opt = dryrun.plan(cfg, "train_4k", axes)
    assert opt == "adamw"
    whole = sum(t.numel() * t.element_size() for t in
                jax.tree_util.tree_leaves(trees["params"][0]))
    local = rules.spec_bytes(*trees["params"], axes)
    assert whole / 256 <= local < whole / 16
    assert rules.spec_bytes(*trees["opt"], axes) == 2 * local + 4


# --------------------------------------------------------------------------
# the op counter
# --------------------------------------------------------------------------


def test_op_counter_counts_nested_loops_exactly():
    """The reference's nested-scan case (tests/test_system.py): 7 outer
    steps of 3 inner 32x32 products."""
    def f(xs, w):
        c = xs[0]
        for x in xs:
            c = c + x
            for _ in range(3):
                c = c @ w
        return c

    _, res = op_analysis.analyze(f, torch.randn(7, 32, 32),
                                 torch.randn(32, 32))
    assert res["dot_flops"] == 2 * 32 * 32 * 32 * 7 * 3


def test_op_counter_against_the_reference_hlo_analysis():
    """stablelm-3b's smoke forward: the ops the port runs against the
    dot FLOPs the reference's compiled HLO holds, within 10 %."""
    from repro import configs as jconfigs
    from repro.launch.hlo_analysis import analyze
    from repro.models import model as jmodel
    from repro_torch.models import model

    jcfg = jconfigs.get_smoke("stablelm-3b")
    pshape = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg))
    comp = jax.jit(lambda p, b: jmodel.forward(p, jcfg, b)[0]).lower(
        pshape, {"tokens": jax.ShapeDtypeStruct((2, 32), jnp.int32)}).compile()
    want = analyze(comp.as_text())["dot_flops"]

    cfg = configs.get_smoke("stablelm-3b")
    params = model.init(0, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)))
    with torch.no_grad():
        _, res = op_analysis.analyze(model.forward, params, cfg,
                                     {"tokens": toks})
    assert abs(res["dot_flops"] - want) <= 0.10 * want


def test_kernel_cost_formulas():
    """A launch's FLOPs: causal attention over the visible pairs, the SSD
    block's causal half, rank_apply's two products."""
    q = torch.empty(8, 4, 16)
    kv = torch.empty(2, 4, 16)
    flops, nbytes = op_analysis.kernel_cost(
        "flash_attention", (q, kv, kv, q, None),
        (8, 4, 4, 16, 4, 1, 0, 0))
    assert flops == 4 * 16 * 8 * 10  # 10 causal pairs of 4 x 4
    assert nbytes == 4 * (2 * q.numel() + 2 * kv.numel())
    flops, _ = op_analysis.kernel_cost(
        "rank_apply", (torch.empty(5, 2, 3), None, None, None, None),
        (1, 5, 2, 3, 4, 6, 1, 1))
    assert flops == 2 * 5 * 2 * 3 * 4 + 2 * 5 * 2 * 4 * 6


# --------------------------------------------------------------------------
# the context and the kernels on a mesh
# --------------------------------------------------------------------------


def test_context_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert context.constrain_residual(x) is x
    q, k, v = torch.randn(2, 3, 1, 2, 4), torch.randn(2, 3, 1, 4), \
        torch.randn(2, 3, 1, 4)
    assert context.constrain_attention_q(q, k, v) == (q, k, v)
    with fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        with context.activation_sharding(mesh, "data"):
            assert context.get_context()["mesh"] is mesh
            assert context.constrain_residual(x) is x  # a plain tensor
        assert context.get_context()["mesh"] is None


def test_a_dtensor_never_reaches_a_kernel_launch():
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import launch
    with fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        t = distribute_tensor(torch.ones(4), mesh, (Replicate(),) * 2)
        with pytest.raises(TypeError, match="DTensor reached"):
            launch("rmsnorm", (t, t, t), 1, 4, 0, 1e-6)


def _laid(mesh, shape, placements):
    """A DTensor of global ``shape`` laid out by ``placements``, holding
    rank 0's shard (zeros)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(torch.zeros(local), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _p(*dims):
    """Placements on a (data, model) mesh: a dim index shards it there,
    None replicates."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if d is None else Shard(d) for d in dims)


@pytest.mark.parametrize("old,placed,new,want", [
    # gemma-2b's query heads: 8 heads of 256 over 16 devices gather
    ((16, 4, 2048), (0, 2), (16, 4, 8, 256), (0, None)),
    # 16 heads of 256 stay split, by heads
    ((16, 4, 4096), (0, 2), (16, 4, 16, 256), (0, 2)),
    # xlstm-125m: 768 into 4 heads of 192
    ((16, 4, 768), (0, 2), (16, 4, 4, 192), (0, None)),
    # the heads merged back, split by heads
    ((16, 4, 16, 256), (0, 2), (16, 4, 4096), (0, 2)),
    # a single KV head: the size-1 dims move, the split stays
    ((16, 4, 256), (0, 2), (16, 4, 1, 1, 256), (0, 4)),
    # batch and sequence flattened, the batch first and split evenly
    ((16, 4, 2048), (0, 2), (64, 2048), (0, 1)),
    # a merge with the inner dim split: that dim gathers
    ((16, 4, 8, 256), (0, 3), (16, 4, 2048), (0, None)),
])
def test_reshape_gathers_only_the_dims_dtensor_cannot_carry(old, placed,
                                                            new, want):
    """On a (16, 16) mesh, ``context._reshaped`` gathers a split dim only
    where the reshape cuts it unevenly or merges it behind another; the
    batch stays split."""
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        y = context._reshaped(_laid(mesh, old, _p(*placed)), new)
        assert tuple(y.shape) == new
        assert y.placements == _p(*want)


def test_reshaped_takes_every_layout():
    """Every layout of these shapes on a (16, 16) mesh reshapes without
    an error: the gathers ``_reshape_placements`` picks are enough."""
    import itertools

    from torch.distributed.tensor import Replicate, Shard
    pairs = [((16, 4, 768), (16, 4, 4, 192)), ((16, 4, 8, 256), (16, 4, 2048)),
             ((32, 6, 64), (32, 384)), ((16, 12, 32), (16, 32, 12)),
             ((16, 16, 16), (256, 16)), ((256, 16), (16, 16, 16))]
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        for old, new in pairs:
            choices = [Replicate()] + [Shard(i) for i in range(len(old))]
            for placements in itertools.product(choices, repeat=2):
                y = context._reshaped(_laid(mesh, old, placements), new)
                assert tuple(y.shape) == new, (old, placements)


def test_implicit_replication_stays_on_until_the_outermost_exit():
    """A nested ``on_mesh`` (a replay in autograd's own thread) leaves
    DTensor's process-wide implicit replication on for the step around
    it: a plain tensor still meets a DTensor after the inner exit."""
    import threading

    from torch.distributed.tensor import Replicate, distribute_tensor
    with fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        d = distribute_tensor(torch.ones(4), mesh, (Replicate(),) * 2)
        with context.on_mesh():
            inner = threading.Thread(target=lambda: context.on_mesh()
                                     .__enter__().close())
            inner.start()
            inner.join()
            assert torch.equal((d + torch.ones(4)).to_local(),
                               torch.full((4,), 2.0))
        with pytest.raises(Exception):
            d + torch.ones(4)


def test_chunked_rank_apply_is_the_factorized_linear():
    """gemma-2b's factorized projection at width 2 (I = 1024, R = 512)
    takes rank_apply in 128 basis chunks of 64 x 64 on the card; their
    sum, on the CPU through each chunk's plain version, is the one-device
    einsum of ``module.linear``."""
    from repro_torch.kernels import ops
    from repro_torch.models import module

    p, I, R, O = 2, 1024, 512, 1024
    assert ops._rank_chunks(I, R, p) == (64, 64)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, p * I, generator=g)
    basis = torch.randn(I, R, generator=g) / I ** 0.5
    coeff = torch.randn(p * p, R, O, generator=g) / R ** 0.5
    got = ops._rank_apply_chunked(x, basis, coeff, p)
    want = module.linear({"basis": basis, "coeff": coeff}, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    # one chunk left out reads far outside that tolerance
    part = ops.rank_dense_apply(x.reshape(6, p, I)[..., :64].reshape(6, -1),
                                basis[None, :64, :64], coeff[:, :64], p)
    assert (got - part - want).abs().max() > 1e-2


# --------------------------------------------------------------------------
# the train launcher on the production mesh
# --------------------------------------------------------------------------


def test_train_launcher_on_the_pod_mesh(capsys):
    from repro_torch.launch import train
    argv = ["--mesh", "pod", "--smoke", "--steps", "1", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="process group of 256 ranks"):
        train.main(argv)
    with fake_world(256):
        train.main(argv)
    out = capsys.readouterr().out
    assert "mesh pod: {'data': 16, 'model': 16}" in out
    assert out.rstrip().endswith("done.")
    assert context.get_context()["mesh"] is None


# --------------------------------------------------------------------------
# the deprecated runner shim
# --------------------------------------------------------------------------


def test_legacy_shims_resolve_and_warn():
    from repro_torch.fl import FLConfig, build_image_setup
    from repro_torch.fl.engine import build_engine
    from repro_torch.fl.heterogeneity import HeterogeneityModel
    from repro_torch.fl.server import RUNNERS

    assert set(RUNNERS) == {"fedavg", "adp", "heterofl", "flanc", "heroes"}
    model, px, py, test = build_image_setup(num_clients=8, device="cpu")
    cfg = FLConfig(num_clients=8, clients_per_round=3, eval_every=1,
                   conv_rank_overhead=1.0, fused_compose_gain=0.5)

    def het():
        return HeterogeneityModel(cfg.num_clients, seed=0,
                                  tier_weights=(0.05, 0.15, 0.30, 0.50))

    with pytest.warns(DeprecationWarning, match="deprecated"):
        shim = RUNNERS["heroes"](model, px, py, test, het(), cfg, 3,
                                 device="cpu")
    direct = build_engine("heroes", model, px, py, test, het(), cfg, 3,
                          device="cpu")
    a, b = shim.run(2), direct.run(2)
    assert len(a) == 2
    assert [(h.round, h.accuracy, h.traffic_bytes, h.wall_time)
            for h in a] == [(h.round, h.accuracy, h.traffic_bytes,
                             h.wall_time) for h in b]

"""Step 9's multi-device part against the JAX package, on logical shards.

The port shards a cohort over an ordered list of devices; here they are
4 or 8 logical shards of the CPU (``sharding.fl.logical_devices``, the
counterpart of the reference's ``--xla_force_host_platform_device_count``),
so the shard arithmetic runs as it would across devices: the padding to
a multiple of the shard count, each shard's ordered partial sums, the
fold of the partials, the block slices of a split coefficient, and the
masked clone rows.  Each check is held to a live ``repro`` call: the
sharding helpers and the stacked primitives to the reference's functions,
the engine's mesh merge to its host rules (the reference's own
``ENGINE_SCRIPT`` checks) and the expert-parallel MoE to the reference's
``apply_moe``.  The reference's own 4-device engine run is in
``test_torch_mesh_reference.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.data.streaming import stack_client_shards as j_stack
from repro.models import moe as jmoe
from repro.sharding import fl as jflsh
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core.estimator import tree_leaves
from repro_torch.data.streaming import stack_client_shards
from repro_torch.fl import FLConfig, build_image_setup, build_runner
from repro_torch.fl import run_scheme
from repro_torch.fl.client import ClientResult
from repro_torch.fl.engine.collective import (CohortSlice, CohortStack,
                                              CollectiveMerger)
from repro_torch.fl.population.hierarchy import HierarchicalMerger
from repro_torch.models import moe
from repro_torch.models.moe_shardmap import apply_moe_shardmap
from repro_torch.sharding import fl as flsh
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

CPU = torch.device("cpu")
# ENGINE_SCRIPT's and SHARDED_SCRIPT's schedule
BASE = dict(num_clients=8, clients_per_round=3, eval_every=2, tau_fixed=2,
            tau_max=15, estimate=True)
ASYNC = dict(num_clients=10, clients_per_round=4, eval_every=100,
             tau_fixed=3, tau_max=15, estimate=False,
             round_mode="semi_async", async_k=2)
SCHEMES = ("fedavg", "heterofl", "flanc", "heroes")
MESH_TOL = 1e-5  # ENGINE_SCRIPT's


def _build(scheme, setup, shards=4, **knobs):
    with flsh.logical_devices(shards, "cpu"):
        return build_runner(scheme, *setup, cfg=FLConfig(**knobs),
                            device="cpu")


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in
               zip(tree_leaves(flsh.assemble(a)), tree_leaves(
                   flsh.assemble(b))))


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(flsh.assemble(a)), tree_leaves(flsh.assemble(b))))


@pytest.fixture(scope="module")
def setup_w4():
    return build_image_setup(num_clients=8, max_width=4, seed=0,
                             device="cpu")


@pytest.fixture(scope="module")
def setup_w3():
    return build_image_setup(num_clients=8, seed=0, device="cpu")


# --- sharding.fl's helpers -------------------------------------------------


def _stand_in(n):
    """A reference mesh of ``n`` devices as its helpers read it."""
    if n < 2:
        return None
    return types.SimpleNamespace(devices=np.empty((n,), object))


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_sharding_helpers_match_reference(shards):
    with flsh.logical_devices(shards, "cpu"):
        mesh = flsh.cohort_mesh(0, "cpu")
        capped = flsh.cohort_mesh(2, "cpu")
    ref = _stand_in(shards)
    assert (mesh is None) == (ref is None)
    if mesh is not None:
        assert mesh.size == shards and mesh.devices == (CPU,) * shards
        assert capped.size == 2
    for k in range(1, 11):
        assert flsh.pad_cohort(k, mesh) == jflsh.pad_cohort(k, ref)
    for nb in (1, 3, 4, 8, 9, 16):
        assert flsh.can_shard_blocks(nb, mesh) == \
            jflsh.can_shard_blocks(nb, ref)
    # without the override a CPU run has one device: no shards
    assert flsh.cohort_mesh(0, "cpu") is None
    if mesh is not None:
        rng = np.random.default_rng(shards)
        chunks = [rng.normal(size=(2, 3)).astype(np.float32)
                  for _ in range(shards)]
        got = flsh.assemble_from_host_shards(chunks, mesh)
        assert [t.device for t in got] == list(mesh.devices)
        for t, c in zip(got, chunks):
            np.testing.assert_array_equal(t.numpy(), c)
        whole = torch.arange(4.0 * shards).reshape(2 * shards, 2)
        parts = flsh.split_rows(whole, mesh)
        assert torch.equal(torch.cat(parts), whole)


def test_split_blocks_gather_and_whole():
    mesh = flsh.CohortMesh((CPU,) * 4)
    whole = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 2, 3)
    split = flsh.SplitBlocks.split(whole, mesh)
    assert len(split.parts) == 4 and split.shape == whole.shape
    assert all(p.shape[0] == 4 for p in split.parts)
    assert torch.equal(split.whole(), whole)
    for ids in ([0], [15, 0, 7], [5, 4, 12, 13, 1], list(range(16))[::-1]):
        assert torch.equal(split.take_blocks(ids), whole[ids])


# --- the stacked primitives -----------------------------------------------


def _clients(seed, k=8, nb=4, r=3, o=5, dup=False):
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=(nb, r, o)).astype(np.float32)
    ids, blocks = [], []
    for _ in range(k):
        take = np.sort(rng.choice(nb, size=rng.integers(1, nb + 1),
                                  replace=False))
        if dup:
            take = np.concatenate([take, take[:1]])
        ids.append(take)
        blocks.append(rng.normal(size=(len(take), r, o)).astype(np.float32))
    return prev, ids, blocks


@pytest.mark.parametrize("dup", [False, True])
def test_stacked_primitives_match_reference(dup):
    prev, ids, blocks = _clients(1, dup=dup)
    nb = prev.shape[0]
    t_blocks = [torch.from_numpy(b) for b in blocks]
    d, m = tagg.scatter_contribution(t_blocks[0], ids[0], nb)
    jd, jm = jagg.scatter_contribution(jnp.asarray(blocks[0]),
                                       jnp.asarray(ids[0]), nb)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    dense, mask = tagg.scatter_contributions_host(t_blocks, ids, nb)
    jdense, jmask = jagg.scatter_contributions_host(blocks, ids, nb)
    np.testing.assert_allclose(dense.numpy(), jdense, atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    # the stacked form: one width, so every client holds m rows
    same = [i[:2] for i in ids if len(i) >= 2]
    stk = np.stack([b[:2] for b, i in zip(blocks, ids) if len(i) >= 2])
    sd, sm = tagg.scatter_contributions_host(torch.from_numpy(stk),
                                             np.stack(same), nb)
    jsd, jsm = jagg.scatter_contributions_host(jnp.asarray(stk),
                                               np.stack(same), nb)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), atol=1e-6)
    np.testing.assert_array_equal(sm.numpy(), np.asarray(jsm))
    np.testing.assert_allclose(
        tagg.ordered_sum(dense).numpy(),
        np.asarray(jagg.ordered_sum(jnp.asarray(jdense))), atol=1e-6)
    got = tagg.masked_block_merge(dense, mask, torch.from_numpy(prev))
    want = jagg.masked_block_merge(jnp.asarray(jdense), jnp.asarray(jmask),
                                   jnp.asarray(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # without shards (and without duplicate ids, whose rows the dense
    # form adds first) the stacked merge is the host rule bit for bit
    host = tagg.aggregate_coefficient(torch.from_numpy(prev), t_blocks, ids)
    if dup:
        np.testing.assert_allclose(got.numpy(), host.numpy(), atol=1e-6)
    else:
        assert torch.equal(got, host)


def test_masked_block_merge_over_8_shards_matches_host_rule():
    """The reference's ``SCRIPT``: 8 clients, one on each of 8 shards,
    against the reference's host ``aggregate_coefficient``."""
    prev, ids, blocks = _clients(0)
    nb = prev.shape[0]
    want = np.asarray(jagg.aggregate_coefficient(
        jnp.asarray(prev), [jnp.asarray(b) for b in blocks], ids))
    with flsh.logical_devices(8, "cpu"):
        mesh = flsh.cohort_mesh(0, "cpu")
    dense, mask = tagg.scatter_contributions_host(
        [torch.from_numpy(b) for b in blocks], ids, nb)
    tprev = torch.from_numpy(prev)
    merged = tagg.masked_block_merge(flsh.split_rows(dense, mesh),
                                     flsh.split_rows(mask, mesh), tprev,
                                     mesh=mesh)
    np.testing.assert_allclose(merged.numpy(), want, atol=MESH_TOL)
    mean = tagg.masked_block_mean(list(dense.unbind(0)),
                                  list(mask.unbind(0)), tprev, mesh)
    np.testing.assert_allclose(mean.numpy(), want, atol=MESH_TOL)
    # two clients a shard on 4 shards: the same within float tolerance
    mesh4 = flsh.CohortMesh((CPU,) * 4)
    merged4 = tagg.masked_block_merge(flsh.split_rows(dense, mesh4),
                                      flsh.split_rows(mask, mesh4), tprev,
                                      mesh=mesh4)
    np.testing.assert_allclose(merged4.numpy(), want, atol=MESH_TOL)


def test_stack_pass_through_respects_n_real():
    """A merge of a strict subset of a stack's rows (a fastest-K event)
    must not let the other rows in, and a merge of exactly its real rows
    takes the stack as it lies."""
    mesh = flsh.CohortMesh((CPU,) * 4)
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.normal(size=(4, 3, 2)).astype(np.float32))
    stack = CohortStack([{"w": r} for r in flsh.split_rows(rows, mesh)],
                        n_real=4, mesh=mesh)

    def res(j):
        return ClientResult(CohortSlice(stack, j), {}, 0.0, 0.0)

    merger = CollectiveMerger(mesh)
    prev = {"w": torch.zeros(3, 2)}
    sub = merger.merge_dense_mean(prev, {10: res(0), 11: res(1)})
    np.testing.assert_allclose(sub["w"].numpy(), rows[:2].mean(0).numpy(),
                               atol=1e-6)
    full = merger.merge_dense_mean(prev, {n: res(n) for n in range(4)})
    np.testing.assert_allclose(full["w"].numpy(), rows.mean(0).numpy(),
                               atol=1e-6)
    out_of_order = merger.merge_dense_mean(prev, {1: res(3), 2: res(0)})
    np.testing.assert_allclose(out_of_order["w"].numpy(),
                               rows[[3, 0]].mean(0).numpy(), atol=1e-6)


@pytest.mark.parametrize("chunks", [1, 4])
def test_stack_client_shards_chunks_match_reference(chunks):
    rng = np.random.default_rng(chunks)
    per = [rng.normal(size=(3, 5, 2)).astype(np.float32) for _ in range(8)]
    for lead in (False, True):
        got = stack_client_shards(per, chunks, step_leading=lead)
        want = j_stack(per, chunks, step_leading=lead)
        assert len(got) == len(want) == chunks
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        stack_client_shards(per, 3)


# --- the engine over shards -----------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_mesh_merge_matches_host_rules(scheme, setup_w4):
    """ENGINE_SCRIPT: 2 rounds of the collective merge over 4 shards
    against the host rules: wall times equal, params within 1e-5."""
    host = build_runner(scheme, *setup_w4, device="cpu",
                        cfg=FLConfig(**BASE, agg_backend="host"))
    coll = _build(scheme, setup_w4, **BASE)
    assert coll.merger.mesh.size == 4 and host.merger is None
    for _ in range(2):
        a, b = host.run_round(), coll.run_round()
        assert a.wall_time == b.wall_time
        assert a.traffic_bytes == b.traffic_bytes
    assert _max_diff(host.params, coll.params) <= MESH_TOL


def test_eight_clients_a_round_fill_every_shard(setup_w4):
    """Every shard holding real rows (8 a round on 4 shards): the fold of
    all four partials matches the host rules."""
    knobs = dict(BASE, clients_per_round=8)
    for scheme in ("fedavg", "heroes"):
        host = build_runner(scheme, *setup_w4, device="cpu",
                            cfg=FLConfig(**knobs, agg_backend="host"))
        coll = _build(scheme, setup_w4, **knobs)
        for _ in range(2):
            assert host.run_round().wall_time == coll.run_round().wall_time
        assert _max_diff(host.params, coll.params) <= MESH_TOL


@pytest.mark.parametrize("width,shards", [(4, 4), (3, 3)])
def test_split_server_state(width, shards, setup_w4, setup_w3, tmp_path):
    """``shard_server_state``: every factorized coefficient stays split
    into one slice a shard across rounds; params and history equal the
    unsplit mesh run bit for bit; a checkpoint saves the whole tensor, a
    restore brings it back whole (the reference's restore does the
    same), and the next merge splits it again."""
    setup = setup_w4 if width == 4 else setup_w3
    ck = str(tmp_path / "ck")
    split = _build("heroes", setup, shards, **BASE, shard_server_state=True,
                   checkpoint_every=1, checkpoint_dir=ck)
    plain = _build("heroes", setup, shards, **BASE)
    for _ in range(2):
        a, b = split.run_round(), plain.run_round()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for name, t in split.params.items():
            assert isinstance(t["coeff"], flsh.SplitBlocks), name
            assert len(t["coeff"].parts) == shards
            assert t["coeff"].shape == plain.params[name]["coeff"].shape
        assert _bit_equal(split.params, plain.params)
    assert split.aggregator.evaluate(split.state) == \
        plain.aggregator.evaluate(plain.state)
    resumed = _build("heroes", setup, shards, **BASE,
                     shard_server_state=True, checkpoint_dir=ck)
    assert resumed.restore_latest() and resumed.round == 2
    assert not any(isinstance(t["coeff"], flsh.SplitBlocks)
                   for t in resumed.params.values())
    assert _bit_equal(resumed.params, split.params)
    a, b = resumed.run_round(), plain.run_round()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert all(isinstance(t["coeff"], flsh.SplitBlocks)
               for t in resumed.params.values())
    assert _bit_equal(resumed.params, plain.params)


def test_hierarchy_on_shards_is_the_flat_mesh_merge(setup_w4):
    for scheme in ("fedavg", "heterofl", "heroes"):
        flat = _build(scheme, setup_w4, **BASE)
        edge = _build(scheme, setup_w4, **BASE, edge_groups=2)
        assert isinstance(edge.merger, HierarchicalMerger)
        assert edge.merger.mesh.size == 4
        for _ in range(2):
            a, b = flat.run_round(), edge.run_round()
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert _bit_equal(flat.params, edge.params)


# --- the sharded cohort trainer (SHARDED_SCRIPT's four checks) -------------


def test_sharded_trainer_hands_over_slices(setup_w3):
    eng = _build("heroes", setup_w3, **BASE, trainer="cohort")
    assert eng.trainer.mesh.size == 4
    _, assigns = eng.assignment.assign(eng.state, [0, 1, 2])
    results = eng.trainer.train_all(eng.state, assigns)
    assert all(isinstance(r.params, CohortSlice) for r in results.values())
    stacks = {id(r.params.stack) for r in results.values()}
    for r in results.values():
        stack = r.params.stack
        assert stack.rows % 4 == 0 and stack.n_real <= stack.rows
        # the rows after n_real are zeroed clones
        for leaf in tree_leaves(stack.as_sharded()):
            assert not torch.cat(leaf)[stack.n_real:].any()
    assert len(stacks) >= 1
    leaves = tree_leaves(results[0].host_params())
    assert all(np.isfinite(v).all() for v in leaves)
    # without a merge over shards the trainer hands over plain tensors
    host = _build("heroes", setup_w3, **BASE, trainer="cohort",
                  agg_backend="host")
    _, assigns = host.assignment.assign(host.state, [0, 1, 2])
    out = host.trainer.train_all(host.state, assigns)
    assert all(isinstance(r.params, dict) for r in out.values())


@pytest.mark.parametrize("scheme", ["fedavg", "heroes"])
def test_sharded_cohort_matches_sequential(scheme, setup_w3):
    with flsh.logical_devices(4, "cpu"):
        h_seq = run_scheme(scheme, *setup_w3, rounds=2, device="cpu",
                           cfg=FLConfig(**BASE))
        h_coh = run_scheme(scheme, *setup_w3, rounds=2, device="cpu",
                           cfg=FLConfig(**BASE, trainer="cohort"))
    for a, b in zip(h_seq, h_coh):
        assert a.wall_time == b.wall_time
        assert a.traffic_bytes == b.traffic_bytes
        if a.accuracy is not None:
            assert abs(a.accuracy - b.accuracy) <= 2e-3


def test_odd_cohort_matches_one_shard(setup_w3):
    """3 of 8 clients on 4 shards (one masked clone row) give the same
    per-client params as the cohort on one shard."""
    coh = _build("fedavg", setup_w3, **BASE, trainer="cohort")
    ref = _build("fedavg", setup_w3, **BASE, trainer="cohort",
                 trainer_mesh_devices=1)
    assert coh.trainer.mesh is not None and ref.trainer.mesh is None
    _, a4 = coh.assignment.assign(coh.state, [0, 1, 2])
    _, a1 = ref.assignment.assign(ref.state, [0, 1, 2])
    r4 = coh.trainer.train_all(coh.state, a4)
    r1 = ref.trainer.train_all(ref.state, a1)
    for n in r1:
        for x, y in zip(tree_leaves(r4[n].host_params()),
                        tree_leaves(r1[n].host_params())):
            np.testing.assert_allclose(x, y, atol=MESH_TOL, rtol=MESH_TOL)


@pytest.mark.parametrize("scheme", ["fedavg", "heroes"])
def test_fastest_k_semi_async_mesh_matches_host(scheme):
    """Fastest-K semi-async: an all-fresh event merges a strict subset of
    a trained stack; stragglers leave the event as plain tensors."""
    setup = build_image_setup(num_clients=10, seed=0, device="cpu")
    host = _build(scheme, setup, **ASYNC, agg_backend="host",
                  trainer="cohort")
    coll = _build(scheme, setup, **ASYNC, trainer="cohort")
    seen = []  # (a strict subset of a stack's real rows, passed through)
    stacked = coll.merger._device_stacked

    def spy(results, k_pad):
        out = stacked(results, k_pad)
        slices = [r.params for r in results.values()]
        if all(isinstance(p, CohortSlice) for p in slices):
            seen.append((len(slices) < slices[0].stack.n_real,
                         out is not None))
        return out

    coll.merger._device_stacked = spy
    for _ in range(4):
        a, b = host.run_round(), coll.run_round()
        assert a.wall_time == b.wall_time
        assert all(not isinstance(t.result.params, CohortSlice)
                   for t in coll.state.in_flight)
    if scheme == "fedavg":
        # an all-fresh event merged a strict subset of a stack, and that
        # subset did not take the stack as it lies
        assert (True, False) in seen and (True, True) not in seen, seen
    assert _max_diff(host.params, coll.params) <= MESH_TOL


# --- the expert-parallel MoE ----------------------------------------------


def test_moe_shardmap_matches_reference_and_port():
    """``apply_moe_shardmap`` on a 2x4 grid at capacity factor 8 (nothing
    drops) against a numpy dense per-token reference, the reference's
    ``apply_moe`` on the same params and the port's ``apply_moe``."""
    cfg = ModelConfig(arch_id="t", family="moe", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=16, vocab=64,
                      moe=MoEConfig(num_experts=8, top_k=2, d_expert=16,
                                    capacity_factor=8.0))
    rng = np.random.default_rng(0)
    p_np = {"router": {"w": rng.normal(size=(32, 8)).astype(np.float32)
                       / np.sqrt(32)},
            "gate": rng.normal(size=(8, 32, 16)).astype(np.float32) / 6,
            "up": rng.normal(size=(8, 32, 16)).astype(np.float32) / 6,
            "down": rng.normal(size=(8, 16, 32)).astype(np.float32) / 4}
    x_np = rng.normal(size=(4, 16, 32)).astype(np.float32)
    p_t = {"router": {"w": torch.from_numpy(p_np["router"]["w"])},
           **{k: torch.from_numpy(p_np[k]) for k in ("gate", "up", "down")}}
    x = torch.from_numpy(x_np)
    y = apply_moe_shardmap(p_t, cfg, x, [[CPU] * 4] * 2).numpy()

    # dense per-token reference in numpy: every expert on every token
    x2 = x_np.reshape(-1, 32).astype(np.float64)
    logits = x2 @ p_np["router"]["w"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, -1, kind="stable")[:, :2]
    gates = np.take_along_axis(probs, ids, -1)
    gates /= gates.sum(-1, keepdims=True)
    g = np.einsum("td,edf->tef", x2, p_np["gate"])
    u = np.einsum("td,edf->tef", x2, p_np["up"])
    h = g / (1 + np.exp(-g)) * u
    ye = np.einsum("tef,efd->ted", h, p_np["down"])
    dense = sum(gates[:, k, None] * ye[np.arange(len(x2)), ids[:, k]]
                for k in range(2)).reshape(x_np.shape)
    np.testing.assert_allclose(y, dense, atol=2e-5)

    jcfg = jax_cfg(cfg)
    jy, _ = jmoe.apply_moe(jax.tree_util.tree_map(jnp.asarray, p_np), jcfg,
                           jnp.asarray(x_np))
    np.testing.assert_allclose(y, np.asarray(jy), atol=2e-5)
    ty, _ = moe.apply_moe(p_t, cfg, x)
    np.testing.assert_allclose(y, ty.numpy(), atol=2e-5)
    # one data row (the grid's columns alone) gives the same output
    y1 = apply_moe_shardmap(p_t, cfg, x, [[CPU] * 8])
    np.testing.assert_allclose(y1.numpy(), dense, atol=2e-5)


def jax_cfg(cfg):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import MoEConfig as JMoEConfig

    return JModelConfig(
        arch_id=cfg.arch_id, family=cfg.family, num_layers=cfg.num_layers,
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
        moe=JMoEConfig(num_experts=cfg.moe.num_experts,
                       top_k=cfg.moe.top_k, d_expert=cfg.moe.d_expert,
                       capacity_factor=cfg.moe.capacity_factor))
